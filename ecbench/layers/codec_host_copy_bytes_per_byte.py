"""Codec (``ops/rs_code.py``): the window's growth of
``SeaweedFS_codec_host_copy_bytes_total`` (bytes the card codec copied on
the host before their H2D: ``pack``'s output and the pinned staging of a
pageable input) over the bytes the window's passes scrubbed. 0.0 when the
counter is there and did not grow; None when the program has no such
counter, or when the trace ring dropped spans in the window."""

DROPPED = "SeaweedFS_trace_spans_dropped_total"
COPIES = "SeaweedFS_codec_host_copy_bytes_total"


def read(layer: dict):
    prom = layer.get("prom_delta", {})
    scrubbed = layer.get("bytes_scrubbed", 0)
    if prom.get(DROPPED, 0.0) > 0 or COPIES not in prom or not scrubbed:
        return None
    return prom[COPIES] / scrubbed
