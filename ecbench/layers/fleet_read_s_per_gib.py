"""Fleet readers (``ec/fleet.py``): the window's growth of
``SeaweedFS_fleet_stage_seconds_sum{stage="read"}``, reader-thread
seconds summed over the pool, per GiB the window's passes scrubbed."""

from ecbench.layers._util import GIB


def read(layer: dict):
    total = layer.get("prom_delta", {}).get(
        'SeaweedFS_fleet_stage_seconds_sum{stage="read"}', 0.0)
    scrubbed = layer.get("bytes_scrubbed", 0)
    if total <= 0 or not scrubbed:
        return None
    return total / (scrubbed / GIB)
