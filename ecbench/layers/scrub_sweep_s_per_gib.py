"""Scrub scanner (``scrub/scanner.py``): seconds of the program's
``scrub.scan_ec`` spans (the needle sweep of one EC volume) per GiB the
window's passes scrubbed."""

from ecbench.layers._util import span_s_per_gib


def read(layer: dict):
    return span_s_per_gib(layer, "scrub.scan_ec")
