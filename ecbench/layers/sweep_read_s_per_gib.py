"""Scrub scanner (``scrub/scanner.py``): seconds of the program's
``scrub.sweep.read`` spans (each needle's lookup, interval reads and
join) per GiB the window's passes scrubbed. None when the trace ring
dropped spans in the window."""

from ecbench.layers._util import span_s_per_gib

DROPPED = "SeaweedFS_trace_spans_dropped_total"


def read(layer: dict):
    if layer.get("prom_delta", {}).get(DROPPED, 0.0) > 0:
        return None
    return span_s_per_gib(layer, "scrub.sweep.read")
