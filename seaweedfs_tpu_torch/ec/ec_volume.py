"""EcVolume: runtime state of one erasure-coded volume on a server.

Holds the mounted local shard files, the key-sorted .ecx index and the
.ecj delete journal. Needle reads resolve by binary search plus interval
math; an interval whose shard is not mounted (or reads short) is
reconstructed from ten other shards through the RS codec, on the card by
default.

Reference: weed/storage/erasure_coding/ec_volume.go, ec_shard.go,
ec_volume_delete.go; counterpart of ``seaweedfs_tpu.ec.ec_volume``.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from seaweedfs_tpu_torch.ec import locate as ec_locate
from seaweedfs_tpu_torch.ec.encoder import (
    LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, shard_file_name)
from seaweedfs_tpu_torch.ec.shard_bits import (
    DATA_SHARDS, TOTAL_SHARDS, ShardBits)
from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon
from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import (
    CookieMismatch, Needle, NeedleError, actual_size)

log = logging.getLogger(__name__)


class EcShardNotFound(NeedleError):
    pass


_default_rs: Optional[ReedSolomon] = None
_default_rs_lock = threading.Lock()


def _card_codec() -> ReedSolomon:
    """The codec degraded reads use when the caller passes none: one per
    process on the card (it owns a side stream and a decode-matrix
    cache), made at the first degraded read."""
    global _default_rs
    if _default_rs is None:
        with _default_rs_lock:
            if _default_rs is None:
                _default_rs = ReedSolomon()
    return _default_rs


class EcVolumeShard:
    """One mounted local .ecNN shard (reference ec_shard.go:16-95)."""

    def __init__(self, directory: str, collection: str, vid: int,
                 shard_id: int):
        self.collection = collection
        self.volume_id = vid
        self.shard_id = shard_id
        name = f"{collection}_{vid}" if collection else str(vid)
        self.path = shard_file_name(os.path.join(directory, name), shard_id)
        self._fd = os.open(self.path, os.O_RDONLY)
        self.size = os.fstat(self._fd).st_size

    def read_at(self, offset: int, length: int) -> bytes:
        fd = self._fd
        if fd < 0:
            raise ValueError(f"shard {self.path} is closed")
        return os.pread(fd, length, offset)

    def close(self) -> None:
        fd, self._fd = self._fd, -1
        if fd >= 0:
            os.close(fd)


class EcVolume:
    def __init__(self, directory: str, collection: str, vid: int,
                 large_block: int = LARGE_BLOCK_SIZE,
                 small_block: int = SMALL_BLOCK_SIZE):
        self.directory = directory
        self.collection = collection
        self.volume_id = vid
        self.large_block = large_block
        self.small_block = small_block
        name = f"{collection}_{vid}" if collection else str(vid)
        self.base_name = os.path.join(directory, name)
        if not os.path.exists(self.base_name + ".ecx"):
            raise FileNotFoundError(self.base_name + ".ecx")
        self._ecx = open(self.base_name + ".ecx", "r+b")
        self._ecj = open(self.base_name + ".ecj", "a+b")
        self._lock = threading.RLock()
        self.shards: Dict[int, EcVolumeShard] = {}
        # shards whose short local read was already logged (once each)
        self._short_logged: set = set()
        self._load_ecx()

    # -- index ---------------------------------------------------------------

    def _load_ecx(self) -> None:
        self._ecx.seek(0)
        arr = idx_codec.parse_index_bytes(self._ecx.read())
        self._keys = arr["key"].copy()
        self._offsets = arr["offset"].copy()
        self._sizes = arr["size"].copy()

    def find_needle(self, needle_id: int) -> Tuple[int, int]:
        """Return (dat_offset, size); raises NeedleError if absent/deleted."""
        i = int(np.searchsorted(self._keys, np.uint64(needle_id)))
        if i >= len(self._keys) or self._keys[i] != needle_id:
            raise NeedleError(f"needle {needle_id:x} not in ecx")
        size = int(self._sizes[i])
        if t.size_is_deleted(size):
            raise NeedleError(f"needle {needle_id:x} deleted")
        return int(self._offsets[i]), size

    def delete_needle(self, needle_id: int) -> None:
        """Tombstone in the sorted .ecx in place + journal to .ecj
        (reference ec_volume_delete.go:13-49)."""
        with self._lock:
            i = int(np.searchsorted(self._keys, np.uint64(needle_id)))
            if i >= len(self._keys) or self._keys[i] != needle_id:
                return
            self._sizes[i] = t.TOMBSTONE_SIZE
            entry_off = i * t.NEEDLE_MAP_ENTRY_SIZE
            self._ecx.seek(entry_off + t.NEEDLE_ID_SIZE + t.OFFSET_SIZE)
            self._ecx.write((t.TOMBSTONE_SIZE & 0xFFFFFFFF).to_bytes(4, "big"))
            self._ecx.flush()
            self._ecj.seek(0, os.SEEK_END)
            self._ecj.write(needle_id.to_bytes(8, "big"))
            self._ecj.flush()

    # -- shards --------------------------------------------------------------

    def mount_shard(self, shard_id: int) -> EcVolumeShard:
        with self._lock:
            if shard_id not in self.shards:
                self.shards[shard_id] = EcVolumeShard(
                    self.directory, self.collection, self.volume_id, shard_id)
            return self.shards[shard_id]

    def unmount_shard(self, shard_id: int) -> bool:
        with self._lock:
            s = self.shards.pop(shard_id, None)
            if s is None:
                return False
            s.close()
            return True

    @property
    def shard_bits(self) -> ShardBits:
        return ShardBits.of(*self.shards.keys())

    @property
    def shard_size(self) -> int:
        for s in self.shards.values():
            return s.size
        for i in range(TOTAL_SHARDS):
            p = shard_file_name(self.base_name, i)
            if os.path.exists(p):
                return os.path.getsize(p)
        return 0

    # -- needle read ---------------------------------------------------------

    def locate_needle(self, needle_id: int, version: int = 3):
        """(offset, size, intervals) for the WHOLE needle record."""
        offset, size = self.find_needle(needle_id)
        dat_size = DATA_SHARDS * self.shard_size
        intervals = ec_locate.locate_data(
            self.large_block, self.small_block, dat_size,
            offset, actual_size(size, version))
        return offset, size, intervals

    def read_needle(self, n: Needle, version: int = 3,
                    rs: Optional[ReedSolomon] = None) -> Needle:
        """Read and CRC-check a needle from the local shards, rebuilding
        the intervals of missing shards through ``rs`` (the card's codec
        when None)."""
        got = Needle.from_bytes(self.read_needle_blob(n.id, version, rs),
                                version)
        if n.cookie and got.cookie != n.cookie:
            raise CookieMismatch(
                f"needle {n.id:x}: cookie {n.cookie:08x} != {got.cookie:08x}")
        return got

    def read_needle_blob(self, needle_id: int, version: int = 3,
                         rs: Optional[ReedSolomon] = None) -> bytes:
        """The raw stored record bytes of one needle."""
        _, _, intervals = self.locate_needle(needle_id, version)
        return b"".join(self._read_interval(iv, rs) for iv in intervals)

    def _read_interval(self, iv: ec_locate.Interval,
                       rs: Optional[ReedSolomon]) -> bytes:
        shard_id, off = iv.to_shard_and_offset(self.large_block,
                                               self.small_block)
        s = self.shards.get(shard_id)
        if s is not None:
            err = None
            try:
                data = s.read_at(off, iv.size)
            except (OSError, ValueError) as e:
                # failing disk, or the shard closed by a concurrent
                # unmount: demote to reconstruction like a short read
                err, data = e, b""
            if len(data) == iv.size:
                return data
            if shard_id not in self._short_logged:
                self._short_logged.add(shard_id)
                log.warning(
                    "ec volume %d shard %d: %s at %d; serving via "
                    "reconstruction until repaired", self.volume_id,
                    shard_id, f"read error ({err})" if err is not None else
                    f"short read ({len(data)} < {iv.size})", off)
        return self._recover_interval(shard_id, off, iv.size, rs)

    def _recover_interval(self, missing_shard: int, off: int, length: int,
                          rs: Optional[ReedSolomon]) -> bytes:
        """On-the-fly RS reconstruction of one interval (reference
        store_ec.go:322-376; the JAX package's in-place fallback, without
        its span cache and decode fleet): read the interval from the
        first ten other local shards that return it whole, in shard-id
        order, and solve the one-row reconstruction. Any ten valid rows
        give the same bytes."""
        rs = rs or _card_codec()
        shards = dict(self.shards)  # snapshot against concurrent unmounts
        ids: List[int] = []
        src = np.empty((DATA_SHARDS, length), dtype=np.uint8)
        for sid in range(TOTAL_SHARDS):
            if len(ids) == DATA_SHARDS:
                break
            if sid == missing_shard or sid not in shards:
                continue
            try:
                b = shards[sid].read_at(off, length)
            except (OSError, ValueError):
                continue
            if len(b) == length:
                src[len(ids)] = np.frombuffer(b, dtype=np.uint8)
                ids.append(sid)
        if len(ids) < DATA_SHARDS:
            raise EcShardNotFound(
                f"vid {self.volume_id} shard {missing_shard}: only "
                f"{len(ids)} shards reachable, need {DATA_SHARDS}")
        return rs.reconstruct_some(ids, [missing_shard], src)[0].tobytes()

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            for s in self.shards.values():
                s.close()
            self.shards.clear()
            self._ecx.close()
            self._ecj.close()

    def file_count(self) -> int:
        return int((self._sizes >= 0).sum())
