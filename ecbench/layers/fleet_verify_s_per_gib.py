"""Fleet verify (``ec/fleet.py`` under ``scrub/daemon.py``): seconds of
the program's ``scrub.verify`` spans (one fused verify of every volume)
per GiB the window's passes scrubbed."""

from ecbench.layers._util import span_s_per_gib


def read(layer: dict):
    return span_s_per_gib(layer, "scrub.verify")
