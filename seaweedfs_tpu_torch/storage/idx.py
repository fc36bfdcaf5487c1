""".idx file codec: an append log of (key, offset, size) entries.

Reference: weed/storage/idx/walk.go:12-50. Entries are big-endian:
key(8) offset(OFFSET_SIZE, unit of 8 bytes) size(4, int32 semantics) —
16 bytes in the default build, 17 with the 5-byte-offset variant
(types.OFFSET_SIZE). A tombstone is size == -1 (0xFFFFFFFF); its offset
points at the delete marker appended to the .dat file.
"""

from __future__ import annotations

import struct

import numpy as np

from seaweedfs_tpu_torch.storage import types as t

_KEY = struct.Struct(">Q")
_SIZE = struct.Struct(">I")


def entry_to_bytes(key: int, actual_offset: int, size: int) -> bytes:
    return _KEY.pack(key) + \
        t.offset_units_to_bytes(actual_offset // t.NEEDLE_PADDING) + \
        _SIZE.pack(size & 0xFFFFFFFF)


def parse_entry(b: bytes) -> tuple:
    """(key, actual offset, size) of one 16-byte entry."""
    key = _KEY.unpack(b[:8])[0]
    off_u = t.bytes_to_offset_units(b[8:8 + t.OFFSET_SIZE])
    size_u = _SIZE.unpack(b[8 + t.OFFSET_SIZE:8 + t.OFFSET_SIZE + 4])[0]
    return key, off_u * t.NEEDLE_PADDING, t.size_to_int32(size_u)


def entries_to_bytes(keys: np.ndarray, actual_offsets: np.ndarray,
                     sizes: np.ndarray) -> bytes:
    """``entry_to_bytes`` over whole arrays: the inverse of
    ``parse_index_bytes``."""
    n = len(keys)
    out = np.empty((n, t.NEEDLE_MAP_ENTRY_SIZE), dtype=np.uint8)
    out[:, :8] = np.asarray(keys, dtype=">u8").view(np.uint8).reshape(n, 8)
    units = np.asarray(actual_offsets, dtype=np.int64) // t.NEEDLE_PADDING
    out[:, 8:12] = (units & 0xFFFFFFFF).astype(">u4").view(
        np.uint8).reshape(n, 4)
    if t.OFFSET_SIZE == 5:
        out[:, 12] = (units >> 32).astype(np.uint8)
    so = 8 + t.OFFSET_SIZE
    out[:, so:so + 4] = (np.asarray(sizes, dtype=np.int64) & 0xFFFFFFFF
                         ).astype(">u4").view(np.uint8).reshape(n, 4)
    return out.tobytes()


def final_live_entries(arr: np.ndarray) -> np.ndarray:
    """Replay a parsed .idx log: the last entry of each key is its final
    state, and a tombstone drops the key. Returns the live entries sorted
    by key (np.unique sorts)."""
    _, first_of_reversed = np.unique(arr["key"][::-1], return_index=True)
    last = len(arr) - 1 - first_of_reversed
    return arr[last[arr["size"][last] >= 0]]


def parse_index_bytes(buf: bytes) -> np.ndarray:
    """Parse a whole .idx blob into a structured array.

    Returns a record array with fields key(u8), offset(i8, actual bytes),
    size(i4). Truncates any torn trailing partial entry.
    """
    es = t.NEEDLE_MAP_ENTRY_SIZE
    usable = len(buf) - (len(buf) % es)
    raw = np.frombuffer(buf[:usable], dtype=np.uint8).reshape(-1, es)
    keys = raw[:, :8].copy().view(">u8").reshape(-1)
    offsets = raw[:, 8:12].copy().view(">u4").reshape(-1).astype(np.int64)
    if t.OFFSET_SIZE == 5:
        # 5th byte carries bits 32..39 (reference offset_5bytes.go)
        offsets |= raw[:, 12].astype(np.int64) << 32
    offsets *= t.NEEDLE_PADDING
    so = 8 + t.OFFSET_SIZE
    sizes = raw[:, so:so + 4].copy().view(">u4").reshape(-1).astype(np.int64)
    sizes = np.where(sizes >= (1 << 31), sizes - (1 << 32), sizes).astype(np.int32)
    out = np.zeros(len(keys), dtype=[("key", np.uint64), ("offset", np.int64),
                                     ("size", np.int32)])
    out["key"] = keys.astype(np.uint64)
    out["offset"] = offsets
    out["size"] = sizes
    return out
