"""Codec (``ops/rs_code.py``): seconds of the program's ``codec.alloc``,
``codec.pack`` and ``codec.submit`` spans (the host's pinned
allocations, the pack into pinned memory and the queueing of H2D, K1,
D2H and the event) per GiB the window's passes scrubbed. None when the
trace ring dropped spans in the window."""

from ecbench.layers._util import GIB

DROPPED = "SeaweedFS_trace_spans_dropped_total"
NAMES = ("codec.alloc", "codec.pack", "codec.submit")


def read(layer: dict):
    if layer.get("prom_delta", {}).get(DROPPED, 0.0) > 0:
        return None
    total = sum(d for n, d in layer.get("spans", ()) if n in NAMES)
    scrubbed = layer.get("bytes_scrubbed", 0)
    if not total or not scrubbed:
        return None
    return total / (scrubbed / GIB)
