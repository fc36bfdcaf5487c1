"""Tiered read cache for the serving path.

`SegmentedLRU` is the byte-bounded scan-resistant RAM tier,
`DiskCacheTier` the optional spill directory, and `TieredReadCache`
the volume-server-facing cache: needle- and span-keyed entries with
per-volume invalidation and single-flight reconstruction.
"""

from seaweedfs_tpu_torch.cache.read_cache import (  # noqa: F401
    DiskCacheTier, SegmentedLRU, TieredReadCache)
