"""Needle id -> (offset, size) indexes bound to a volume's .idx.

The counterpart of ``seaweedfs_tpu.storage.needle_map``. Two of the
reference's NeedleMapper kinds (weed/storage/needle_map*.go): the compact
in-memory map (``NeedleMap``, a Python dict with numpy-vectorized .idx
loading) and the persistent map for large volumes (``KvNeedleMap``, over
the LogKV engine; the volume server's ``-index kv``). ``SortedIndex`` is
binary search over a key-sorted index blob, the .ecx access pattern.
"""

from __future__ import annotations

import os
import shutil
import struct
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

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
        # puts ever made and their bytes, the puts since overwritten or
        # deleted and their bytes, the largest key
        self.file_count = 0
        self.content_size = 0
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
        self.file_count = int(puts.sum())
        self.content_size = int(sizes[puts].sum())
        self.deleted_count = self.file_count - len(live)
        self.deleted_size = self.content_size - \
            int(live["size"].astype("int64").sum())

    def put(self, key: int, offset: int, size: int) -> None:
        with self._lock:
            prev = self._map.get(key)
            if prev is not None and not t.size_is_deleted(prev[1]):
                self.deleted_count += 1
                self.deleted_size += prev[1]
            self._map[key] = (offset, size)
            self.file_count += 1
            self.content_size += size
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

    def keys(self):
        return self._map.keys()

    def items(self):
        for k, (off, size) in self._map.items():
            yield k, NeedleValue(offset=off, size=size)

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


class SortedIndex:
    """Binary search over a key-sorted 16-byte-entry index (.ecx pattern),
    backed by a numpy view; lookup is O(log n) via searchsorted."""

    def __init__(self, buf: bytes):
        arr = idx_codec.parse_index_bytes(buf)
        self.keys = arr["key"]
        self.offsets = arr["offset"]
        self.sizes = arr["size"]
        if len(self.keys) > 1 and not np.all(self.keys[:-1] <= self.keys[1:]):
            raise ValueError("index not sorted by key")

    @classmethod
    def from_file(cls, path: str) -> "SortedIndex":
        with open(path, "rb") as f:
            return cls(f.read())

    def __len__(self) -> int:
        return len(self.keys)

    def find(self, key: int) -> Optional[Tuple[int, int, int]]:
        """Return (entry_index, offset, size) or None."""
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if i < len(self.keys) and self.keys[i] == key:
            return i, int(self.offsets[i]), int(self.sizes[i])
        return None


class KvNeedleMap(NeedleMap):
    """Persistent needle map over the LogKV engine: the leveldb-class
    ``-index`` kind for large volumes (reference needle_map_leveldb.go,
    selected in command/volume.go:203-211).

    The append-only .idx stays canonical (EC encode and ``fix`` read
    it); the id -> (offset, size) map lives in a compacting LogKV in
    ``<base>.idx.nmkv``, so a reopen replays the compacted live set
    instead of the .idx's whole history. The stats come from one
    vectorized pass over the .idx, as in the memory map.

    Crash reconciliation: every KV record carries the 1-based .idx
    sequence number of the op that made it, in ONE LogKV record per op
    (a delete is a tombstone put, so it carries one too). On load the
    high-water mark is the largest sequence in the KV: a KV that lags the
    .idx replays the missing tail (idempotent, in order); a KV AHEAD of
    the durable .idx is wiped and rebuilt, because the .idx is canon; a
    KV with no .idx at all is a phantom and is wiped.
    """

    ENTRY = struct.Struct(">QiQ")  # offset u64, size i32, idx-seq u64
    _PFX = b"n"                    # needle entries: b"n" + u64 key

    def __init__(self, index_path: str):
        # the engine's module is imported here, not at the top: a server
        # on the memory kind never loads it
        from seaweedfs_tpu_torch.filer.stores.kv_store import LogKV
        self._kv = LogKV(index_path + ".nmkv")
        # NeedleMap.__init__ would replay the .idx into a dict; only its
        # vectorized stats pass runs here
        self._map = None
        self._lock = threading.Lock()
        self.index_path = index_path
        self._index_file = None
        self.file_count = 0
        self.content_size = 0
        self.deleted_count = 0
        self.deleted_size = 0
        self.max_key = 0
        self._live_count = 0  # guarded_by(self._lock, writes)
        # .idx entries, durable and buffered
        self._idx_entries = 0  # guarded_by(self._lock, writes)
        self._load_stats(index_path)
        self._index_file = open(index_path, "ab")

    @classmethod
    def _key(cls, key: int) -> bytes:
        return cls._PFX + struct.pack(">Q", key)

    def _load_stats(self, path: str) -> None:
        arr = read_index_array(path)
        if arr is None or not len(arr):
            # no .idx: any KV content is a phantom of a lost file
            if len(self._kv):
                self._kv.delete_prefix(b"")
            return
        sizes = arr["size"].astype(np.int64)
        # one scan over the KV: the high-water mark and the live stats
        applied = live = live_size = 0
        for _, v in self._kv.scan(self._PFX):
            _, size, seq = self.ENTRY.unpack(v)
            applied = max(applied, seq)
            if not t.size_is_deleted(size):
                live += 1
                live_size += size
        n_idx = len(arr)
        if applied > n_idx:
            # the KV outran the durable .idx: rebuild from the .idx
            self._kv.delete_prefix(b"")
            applied = live = live_size = 0
        for i in range(applied, n_idx):
            size = int(sizes[i])
            key = int(arr["key"][i])
            prev = self._kv.get(self._key(key))
            if prev is not None:
                _, psize, _ = self.ENTRY.unpack(prev)
                if not t.size_is_deleted(psize):
                    live -= 1
                    live_size -= psize
            if size >= 0:
                self._kv.put(self._key(key),
                             self.ENTRY.pack(int(arr["offset"][i]),
                                             size, i + 1))
                live += 1
                live_size += size
            else:
                self._kv.put(self._key(key),
                             self.ENTRY.pack(0, t.TOMBSTONE_SIZE, i + 1))
        # lint: guard-ok(_load_stats runs from __init__ only, before the map is published)
        self._idx_entries = n_idx
        puts = sizes >= 0
        self.file_count = int(puts.sum())
        self.content_size = int(sizes[puts].sum())
        self.max_key = int(arr["key"].max())
        # lint: guard-ok(_load_stats runs from __init__ only, before the map is published)
        self._live_count = live
        self.deleted_count = self.file_count - live
        self.deleted_size = self.content_size - live_size

    def put(self, key: int, offset: int, size: int) -> None:
        with self._lock:
            prev = self._kv.get(self._key(key))
            prev_size = None if prev is None else self.ENTRY.unpack(prev)[1]
            if prev_size is not None and not t.size_is_deleted(prev_size):
                self.deleted_count += 1
                self.deleted_size += prev_size
            else:
                self._live_count += 1
            self._idx_entries += 1
            self._kv.put(self._key(key),
                         self.ENTRY.pack(offset, size, self._idx_entries))
            self.file_count += 1
            self.content_size += size
            self.max_key = max(self.max_key, key)
            self._append_entry(key, offset, size)

    def get(self, key: int) -> Optional[NeedleValue]:
        blob = self._kv.get(self._key(key))
        if blob is None:
            return None
        offset, size, _ = self.ENTRY.unpack(blob)
        if t.size_is_deleted(size):
            return None
        return NeedleValue(offset=offset, size=size)

    def delete(self, key: int, marker_offset: int) -> int:
        with self._lock:
            blob = self._kv.get(self._key(key))
            if blob is None:
                return 0
            _, size, _ = self.ENTRY.unpack(blob)
            if t.size_is_deleted(size):
                return 0
            self._idx_entries += 1
            self._kv.put(self._key(key),
                         self.ENTRY.pack(0, t.TOMBSTONE_SIZE,
                                         self._idx_entries))
            self._live_count -= 1
            self.deleted_count += 1
            self.deleted_size += size
            self._append_entry(key, marker_offset, t.TOMBSTONE_SIZE)
            return size

    def sync(self) -> None:
        super().sync()
        self._kv.sync()

    def close(self) -> None:
        super().close()
        self._kv.close()

    def destroy(self) -> None:
        super().destroy()
        shutil.rmtree(self.index_path + ".nmkv", ignore_errors=True)

    def __len__(self) -> int:
        return self._live_count

    def keys(self):
        return [k for k, _ in self.items()]

    def items(self):
        for k, v in self._kv.scan(self._PFX):
            offset, size, _ = self.ENTRY.unpack(v)
            if not t.size_is_deleted(size):
                yield struct.unpack(">Q", k[1:])[0], \
                    NeedleValue(offset=offset, size=size)


def make_needle_map(index_path: Optional[str],
                    kind: str = "memory") -> NeedleMap:
    """The ``-index`` flag (reference command/volume.go:203-211): memory
    (a dict, the default) or kv (persistent LogKV for large volumes;
    ``leveldb`` and ``large`` are its aliases)."""
    if kind in ("kv", "leveldb", "large"):
        if index_path is None:
            raise ValueError("kv needle map needs an index path")
        return KvNeedleMap(index_path)
    if kind in ("memory", ""):
        return NeedleMap(index_path)
    raise ValueError(f"unknown needle map kind {kind!r} (memory | kv)")
