"""Erasure coding of volumes: RS(10,4) striping across 14 shard files.

Disk layout (the same as ``seaweedfs_tpu.ec`` and the reference
weed/storage/erasure_coding): ``.ec00``-``.ec13`` shard files, the
key-sorted ``.ecx`` index and the ``.ecj`` delete journal. One volume at
a time goes through ``encoder``; many volumes at once, fused into shared
dispatches, through ``fleet``.
"""

from seaweedfs_tpu_torch.ec.ec_volume import EcShardNotFound, EcVolume  # noqa: F401
from seaweedfs_tpu_torch.ec.encoder import (  # noqa: F401
    LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, find_dat_file_size,
    rebuild_ec_files, rebuild_ecx_file, shard_file_name, write_dat_file,
    write_ec_files, write_idx_file_from_ec_index,
    write_sorted_file_from_idx)
from seaweedfs_tpu_torch.ec.fleet import (  # noqa: F401
    VerifyResult, fleet_rebuild_ec_files, fleet_verify_ec_files,
    fleet_write_ec_files)
from seaweedfs_tpu_torch.ec.store_ec import (  # noqa: F401
    generate_ec_shards, generate_ec_shards_batch)
