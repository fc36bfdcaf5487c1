"""Core on-disk scalar types.

Mirrors the reference's weed/storage/types (needle_types.go:34-39,
offset_4bytes.go / offset_5bytes.go):
  - NeedleId: 8 bytes big-endian
  - Offset: 4 bytes big-endian (default), in units of 8
    (NEEDLE_PADDING) -> 32GB volumes; setting
    SEAWEEDFS_TPU_5BYTE_OFFSET=1 in the environment selects the
    reference's `-tags 5BytesOffset` build variant: a 5th HIGH byte after
    the big-endian low 32 bits -> 8TB volumes. A process-lifetime,
    deployment-wide format choice — .idx files written by the two
    variants are incompatible.
  - Size: 4 bytes big-endian, int32 semantics; -1 (0xFFFFFFFF) = tombstone
"""

from __future__ import annotations

import os
import struct

NEEDLE_ID_SIZE = 8
OFFSET_SIZE = 5 if os.environ.get("SEAWEEDFS_TPU_5BYTE_OFFSET") == "1" \
    else 4
SIZE_SIZE = 4
COOKIE_SIZE = 4
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16 or 17
TIMESTAMP_SIZE = 8
NEEDLE_PADDING = 8
NEEDLE_CHECKSUM_SIZE = 4
TOMBSTONE_SIZE = -1  # Size(-1) marks a deleted needle in the index
# (2^(8*OFFSET_SIZE)) padding units: 32GB at 4 bytes, 8TB at 5
MAX_POSSIBLE_VOLUME_SIZE = (1 << (8 * OFFSET_SIZE)) * NEEDLE_PADDING


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_SIZE


def size_to_int32(size: int) -> int:
    """Reinterpret a uint32 read from disk as int32 Size semantics."""
    return size - (1 << 32) if size >= (1 << 31) else size


def offset_units_to_bytes(units: int) -> bytes:
    """Padding-unit offset -> wire bytes. 4-byte: plain big-endian.
    5-byte: big-endian low 32 bits THEN the high byte (reference
    offset_5bytes.go OffsetToBytes)."""
    if OFFSET_SIZE == 4:
        return struct.pack(">I", units)
    return struct.pack(">I", units & 0xFFFFFFFF) + bytes([units >> 32])


def bytes_to_offset_units(b: bytes) -> int:
    """Wire bytes -> padding-unit offset (the inverse of
    offset_units_to_bytes)."""
    low = struct.unpack(">I", b[:4])[0]
    if OFFSET_SIZE == 4:
        return low
    return (b[4] << 32) | low
