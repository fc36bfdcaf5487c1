"""Kernel K1 (``csrc/gf_linear.cu``) in the scrub: its share of its memory
bound over the window's launches (``_util.k1_roofline``)."""

from ecbench.layers._util import k1_roofline


def read(layer: dict):
    return k1_roofline(layer)
