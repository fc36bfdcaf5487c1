"""Tiered chunk cache: memory SLRU + size-classed on-disk tiers
(reference: weed/util/chunk_cache/chunk_cache.go:16-130).

The reference caches chunks ≤1MB in memory, and on disk in three tiers
keyed by chunk size (≤1MB, ≤4MB, bigger). Here the on-disk tiers are
directories of fid-named files with byte-budget LRU eviction, and the
memory tier rides `cache.SegmentedLRU` — the same scan-resistant
probation/protected policy the volume server's read cache uses, so one
`filer.copy` of a large tree can no longer flush the filer's hot chunk
set.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional

from seaweedfs_tpu_torch.cache.read_cache import SegmentedLRU

MEM_UNIT = 1 << 20        # chunks up to 1MB may live in memory
DISK_UNITS = (1 << 20, 4 << 20)   # tier boundaries


class MemCache:
    """Byte-bounded RAM tier over SegmentedLRU (scan-resistant: new
    chunks enter probation; only a second touch protects them)."""

    def __init__(self, limit_bytes: int):
        self.limit = limit_bytes
        # items up to the full budget stay admissible (the historical
        # MemCache contract; TieredChunkCache already routes oversized
        # chunks to disk by size class)
        self._lru = SegmentedLRU(limit_bytes, max_item_bytes=limit_bytes)

    def get(self, key: str) -> Optional[bytes]:
        return self._lru.get(key)

    def set(self, key: str, value: bytes) -> None:
        self._lru.set(key, value)


class DiskTier:
    def __init__(self, directory: str, limit_bytes: int):
        self.dir = directory
        self.limit = limit_bytes
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._lru: OrderedDict[str, int] = OrderedDict()  # guarded_by(self._lock)
        self._bytes = 0  # guarded_by(self._lock)
        for name in os.listdir(directory):
            p = os.path.join(directory, name)
            if os.path.isfile(p):
                sz = os.path.getsize(p)
                self._lru[name] = sz
                self._bytes += sz

    @staticmethod
    def _fname(key: str) -> str:
        return key.replace("/", "_").replace(",", "_")

    def get(self, key: str) -> Optional[bytes]:
        name = self._fname(key)
        with self._lock:
            if name not in self._lru:
                return None
            self._lru.move_to_end(name)
        try:
            with open(os.path.join(self.dir, name), "rb") as f:
                return f.read()
        except OSError:
            return None

    def set(self, key: str, value: bytes) -> None:
        name = self._fname(key)
        tmp = os.path.join(self.dir, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, os.path.join(self.dir, name))
        with self._lock:
            self._bytes -= self._lru.pop(name, 0)
            self._lru[name] = len(value)
            self._bytes += len(value)
            while self._bytes > self.limit and self._lru:
                victim, sz = self._lru.popitem(last=False)
                self._bytes -= sz
                try:
                    os.unlink(os.path.join(self.dir, victim))
                except OSError:
                    pass


class TieredChunkCache:
    """get/set by fileId; routes by chunk size like the reference."""

    def __init__(self, mem_limit_bytes: int = 64 << 20,
                 disk_dir: Optional[str] = None,
                 disk_limit_bytes: int = 256 << 20):
        self.mem = MemCache(mem_limit_bytes)
        self.tiers = []
        if disk_dir:
            per = disk_limit_bytes // 4
            self.tiers = [
                DiskTier(os.path.join(disk_dir, "t0"), per),
                DiskTier(os.path.join(disk_dir, "t1"), per),
                DiskTier(os.path.join(disk_dir, "t2"), disk_limit_bytes - 2 * per),
            ]

    def _tier(self, size: int) -> Optional[DiskTier]:
        if not self.tiers:
            return None
        if size <= DISK_UNITS[0]:
            return self.tiers[0]
        if size <= DISK_UNITS[1]:
            return self.tiers[1]
        return self.tiers[2]

    def get(self, file_id: str, size_hint: int = 0) -> Optional[bytes]:
        v = self.mem.get(file_id)
        if v is not None:
            return v
        for t in self.tiers:
            v = t.get(file_id)
            if v is not None:
                if len(v) <= MEM_UNIT:
                    self.mem.set(file_id, v)
                return v
        return None

    def set(self, file_id: str, data: bytes) -> None:
        if len(data) <= MEM_UNIT:
            self.mem.set(file_id, data)
        t = self._tier(len(data))
        if t is not None:
            t.set(file_id, data)
