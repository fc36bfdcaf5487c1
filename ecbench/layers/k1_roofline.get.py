"""Kernel K1 (``csrc/gf_linear.cu``) under the GETs: its share of its
memory bound over the launches the volume servers made in the window
(``_util.k1_roofline``)."""

from ecbench.layers._util import k1_roofline


def read(layer: dict):
    return k1_roofline(layer)
