"""In-memory needle id -> (offset, size) index bound to a volume's .idx.

The reference's compact in-memory map kind (weed/storage/needle_map.go),
as a Python dict with numpy-vectorized .idx loading.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t


@dataclass
class NeedleValue:
    offset: int  # actual byte offset in .dat
    size: int    # body size; TOMBSTONE/negative = deleted


def read_index_array(path: str):
    """Read a .idx file as a parsed numpy record array, truncating any
    torn trailing partial entry (crash mid-append) on disk first — the
    file is about to be reopened for append, and a torn tail would land
    every later entry misaligned. Returns None if the file is absent."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        buf = f.read()
    usable = len(buf) - (len(buf) % t.NEEDLE_MAP_ENTRY_SIZE)
    if usable != len(buf):
        with open(path, "r+b") as f:
            f.truncate(usable)
        buf = buf[:usable]
    return idx_codec.parse_index_bytes(buf)


class NeedleMap:
    """Dict-backed needle map bound to an append-only .idx file."""

    def __init__(self, index_path: Optional[str] = None):
        # point reads are GIL-atomic and lock-free; put/delete take the lock
        self._map: dict[int, Tuple[int, int]] = {}  # guarded_by(self._lock, writes)
        self._lock = threading.Lock()
        self.index_path = index_path
        self._index_file = None
        # the volume's heartbeat numbers (JAX storage/needle_map.py): the
        # puts since overwritten or deleted, their bytes, the largest key
        self.deleted_count = 0
        self.deleted_size = 0
        self.max_key = 0
        if index_path is not None:
            self._load(index_path)
            self._index_file = open(index_path, "ab")

    def _load(self, path: str) -> None:
        arr = read_index_array(path)
        if arr is None or not len(arr):
            return
        live = idx_codec.final_live_entries(arr)
        # lint: guard-ok(_load runs from __init__ only, before the map is published)
        self._map = dict(zip(live["key"].tolist(),
                             zip(live["offset"].tolist(),
                                 live["size"].tolist())))
        sizes = arr["size"].astype("int64")
        puts = sizes >= 0
        self.max_key = int(arr["key"].max())
        self.deleted_count = int(puts.sum()) - len(live)
        self.deleted_size = int(sizes[puts].sum()) - \
            int(live["size"].astype("int64").sum())

    def put(self, key: int, offset: int, size: int) -> None:
        with self._lock:
            prev = self._map.get(key)
            if prev is not None and not t.size_is_deleted(prev[1]):
                self.deleted_count += 1
                self.deleted_size += prev[1]
            self._map[key] = (offset, size)
            self.max_key = max(self.max_key, key)
            self._append_entry(key, offset, size)

    def get(self, key: int) -> Optional[NeedleValue]:
        v = self._map.get(key)
        if v is None or t.size_is_deleted(v[1]):
            return None
        return NeedleValue(offset=v[0], size=v[1])

    def delete(self, key: int, marker_offset: int) -> int:
        """Record a tombstone; returns the freed size (0 if absent)."""
        with self._lock:
            prev = self._map.pop(key, None)
            if prev is None or t.size_is_deleted(prev[1]):
                return 0
            self.deleted_count += 1
            self.deleted_size += prev[1]
            self._append_entry(key, marker_offset, t.TOMBSTONE_SIZE)
            return prev[1]

    def __len__(self) -> int:
        return len(self._map)

    def _append_entry(self, key: int, offset: int, size: int) -> None:
        if self._index_file is not None:
            self._index_file.write(idx_codec.entry_to_bytes(key, offset, size))

    def flush(self) -> None:
        if self._index_file is not None:
            self._index_file.flush()

    def sync(self) -> None:
        if self._index_file is not None:
            self._index_file.flush()
            os.fsync(self._index_file.fileno())

    def close(self) -> None:
        if self._index_file is not None:
            self._index_file.close()
            self._index_file = None

    def destroy(self) -> None:
        self.close()
        if self.index_path and os.path.exists(self.index_path):
            os.remove(self.index_path)
