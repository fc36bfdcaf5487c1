"""Codec (``ops/rs_code.py``): the window's growth of
``SeaweedFS_codec_h2d_bytes_total`` plus ``SeaweedFS_codec_d2h_bytes_total``
(every byte the card codec copied in and out) over the bytes the
window's passes scrubbed. None when neither counter grew, or when the
trace ring dropped spans in the window."""

DROPPED = "SeaweedFS_trace_spans_dropped_total"
COPIES = ("SeaweedFS_codec_h2d_bytes_total",
          "SeaweedFS_codec_d2h_bytes_total")


def read(layer: dict):
    prom = layer.get("prom_delta", {})
    copied = sum(prom.get(k, 0.0) for k in COPIES)
    scrubbed = layer.get("bytes_scrubbed", 0)
    if prom.get(DROPPED, 0.0) > 0 or copied <= 0 or not scrubbed:
        return None
    return copied / scrubbed
