"""Decode fleet (``reads/decode_fleet.py``): reconstructions fused into
one K1 dispatch, the window's growth of
``SeaweedFS_reads_degraded_batch_spans`` sum over its count."""


def read(layer: dict):
    d = layer.get("prom_delta", {})
    n = d.get("SeaweedFS_reads_degraded_batch_spans_count", 0.0)
    s = d.get("SeaweedFS_reads_degraded_batch_spans_sum", 0.0)
    if n <= 0:
        return None
    return s / n
