"""Erasure coding of volumes: RS(10,4) striping across 14 shard files.

Disk layout (the same as ``seaweedfs_tpu.ec`` and the reference
weed/storage/erasure_coding): ``.ec00``-``.ec13`` shard files, the
key-sorted ``.ecx`` index and the ``.ecj`` delete journal.
"""
