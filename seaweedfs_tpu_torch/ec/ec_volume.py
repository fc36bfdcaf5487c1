"""EcVolume: runtime state of one erasure-coded volume on a server.

Holds the mounted local shard files, the key-sorted .ecx index and the
.ecj delete journal. Needle reads resolve by binary search plus interval
math; an interval whose shard is not mounted is fetched from a remote
reader when one is given, and an interval no one serves whole is
reconstructed from ten other shards through the RS codec, on the card by
default: in place, or fused with concurrent reads by a decode fleet.

Reference: weed/storage/erasure_coding/ec_volume.go, ec_shard.go,
ec_volume_delete.go; counterpart of ``seaweedfs_tpu.ec.ec_volume``.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from seaweedfs_tpu_torch.ec import locate as ec_locate
from seaweedfs_tpu_torch.ec.encoder import (
    LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, shard_file_name)
from seaweedfs_tpu_torch.ec.shard_bits import (
    DATA_SHARDS, TOTAL_SHARDS, ShardBits)
from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon
from seaweedfs_tpu_torch.stats.metrics import (
    ReadsDecodedBytesCounter, ReadsDegradedCounter, ReadsShortShardCounter)
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


# Shared fetch pool of the in-place (fleet-less) recovery: made at the
# first degraded read, so a healthy server never spawns these threads.
_recover_pool: Optional[ThreadPoolExecutor] = None
_recover_pool_lock = threading.Lock()


def _get_recover_pool() -> ThreadPoolExecutor:
    global _recover_pool
    if _recover_pool is None:
        with _recover_pool_lock:
            if _recover_pool is None:
                # lint: thread-ok(shared recover pool takes explicit work items; the read seam enforces deadlines)
                _recover_pool = ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="ec-recover")
    return _recover_pool


class EcVolumeShard:
    """One mounted .ecNN shard (reference ec_shard.go:16-95).

    A shard is local (a file, read with pread) or remote: its bytes were
    moved to an object store (``storage/volume_tier``, recorded in the
    ``<base>.ectier`` sidecar) and reads are ranged reads of it. A remote
    shard stays mounted and in the heartbeat, so needle reads, scrub,
    remote shard reads and reconstructions read it like a local one."""

    def __init__(self, directory: str, collection: str, vid: int,
                 shard_id: int, remote=None):
        self.collection = collection
        self.volume_id = vid
        self.shard_id = shard_id
        name = f"{collection}_{vid}" if collection else str(vid)
        self.path = shard_file_name(os.path.join(directory, name), shard_id)
        self._lock = threading.Lock()
        # read_at peeks both lock-free; a swap sets the new handle before
        # it clears the old one, so a read finds one of them
        self._remote = None  # guarded_by(self._lock, writes)
        self._fd = -1  # guarded_by(self._lock, writes)
        if remote is not None:
            storage, key, size = remote
            self._remote = (storage, key)
            self.size = size
        else:
            self._fd = os.open(self.path, os.O_RDONLY)
            self.size = os.fstat(self._fd).st_size

    @property
    def is_remote(self) -> bool:
        return self._remote is not None

    def read_at(self, offset: int, length: int) -> bytes:
        fd = self._fd
        if fd >= 0:
            try:
                return os.pread(fd, length, offset)
            except OSError:
                # swapped to the backend (and the file closed) mid-read
                if self._remote is None:
                    raise
        remote = self._remote
        if remote is None:
            raise ValueError(f"shard {self.path} is closed")
        storage, key = remote
        try:
            return storage.read_range(key, offset, length)
        except Exception:
            # swapped back to a local file (and the object deleted)
            # between the peek and the read: read the file, if so
            fd = self._fd
            if fd < 0:
                raise
            return os.pread(fd, length, offset)

    def swap_to_remote(self, storage, key: str, size: int) -> None:
        """Read from the backend from now on (the tier upload's handle
        swap; the caller removes the local file afterwards)."""
        with self._lock:
            self._remote = (storage, key)
            self.size = size
            fd, self._fd = self._fd, -1
        if fd >= 0:
            os.close(fd)

    def swap_to_local(self) -> None:
        """Back to the local file (the tier download put it back)."""
        fd = os.open(self.path, os.O_RDONLY)
        with self._lock:
            self._fd = fd
            self.size = os.fstat(fd).st_size
            self._remote = None

    def close(self) -> None:
        with self._lock:
            fd, self._fd = self._fd, -1
        if fd >= 0:
            os.close(fd)

    def destroy(self) -> None:
        self.close()
        if os.path.exists(self.path):
            os.remove(self.path)


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
        # find_needle/file_count read lock-free (single-element numpy
        # stores are atomic under the GIL); mutation takes the lock
        # lint: guard-ok(_load_ecx runs from __init__ only, before the volume is published)
        self._sizes = arr["size"].copy()  # guarded_by(self._lock, writes)

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
                    self.directory, self.collection, self.volume_id,
                    shard_id, remote=self._remote_info(shard_id))
            return self.shards[shard_id]

    def _remote_info(self, shard_id: int):
        """(storage, key, size) of a shard this server moved to a backend
        (the ``<base>.ectier`` sidecar), else None: a restart remounts
        tiered shards without their local files."""
        if os.path.exists(shard_file_name(self.base_name, shard_id)):
            return None             # a local file wins
        from seaweedfs_tpu_torch.storage import backend as bk
        info = bk.read_ec_tier_info(self.base_name)
        if info is None:
            return None
        rec = info["shards"].get(shard_id)
        if rec is None:
            return None
        return bk.get_backend(info["backend"]), rec["key"], rec["size"]

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
                    remote_reader: Optional[Callable] = None,
                    rs: Optional[ReedSolomon] = None,
                    decoder=None, span_cache=None) -> Needle:
        """Read and CRC-check a needle from the local shards, remote
        shards, or by live RS reconstruction of missing intervals.

        ``remote_reader(shard_id, shard_offset, length) -> bytes | None``
        serves shards that are not local. ``decoder``
        (``reads.DegradedReadFleet``) routes reconstructions to the fused
        batch path; without one they are solved in place through ``rs``
        (the card's codec when None). ``span_cache``
        (``cache.TieredReadCache``) serves repeat reconstructions of a
        span without solving again."""
        got = Needle.from_bytes(
            self.read_needle_blob(n.id, version, remote_reader, rs, decoder,
                                  span_cache),
            version)
        if n.cookie and got.cookie != n.cookie:
            raise CookieMismatch(
                f"needle {n.id:x}: cookie {n.cookie:08x} != {got.cookie:08x}")
        return got

    def read_needle_blob(self, needle_id: int, version: int = 3,
                         remote_reader: Optional[Callable] = None,
                         rs: Optional[ReedSolomon] = None,
                         decoder=None, span_cache=None) -> bytes:
        """The raw stored record bytes of one needle: the unit the read
        cache keeps (every parse of it checks the CRC)."""
        _, _, intervals = self.locate_needle(needle_id, version)
        return b"".join(self._read_interval(iv, remote_reader, rs, decoder,
                                            span_cache)
                        for iv in intervals)

    def _read_interval(self, iv: ec_locate.Interval,
                       remote_reader: Optional[Callable],
                       rs: Optional[ReedSolomon], decoder=None,
                       span_cache=None) -> bytes:
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
            # short read (a shard truncated by a crashed rebuild) or read
            # error: reconstruct from the others, but count it and log
            # once per shard, so recovery traffic is told from decay
            ReadsShortShardCounter.labels(
                str(self.volume_id), str(shard_id)).inc()
            if shard_id not in self._short_logged:
                self._short_logged.add(shard_id)
                log.warning(
                    "ec volume %d shard %d: %s at %d; serving via "
                    "reconstruction until repaired", self.volume_id,
                    shard_id, f"read error ({err})" if err is not None else
                    f"short read ({len(data)} < {iv.size})", off)
        elif remote_reader is not None:
            try:
                data = remote_reader(shard_id, off, iv.size)
            # lint: swallow-ok(failure demotes to RS reconstruction, counted by SeaweedFS_reads_degraded_total)
            except Exception:
                data = None
            if data is not None and len(data) == iv.size:
                return data
        return self._recover_interval(shard_id, off, iv.size, remote_reader,
                                      rs, decoder, span_cache)

    def _recover_interval(self, missing_shard: int, off: int, length: int,
                          remote_reader: Optional[Callable],
                          rs: Optional[ReedSolomon], decoder=None,
                          span_cache=None) -> bytes:
        """On-the-fly RS reconstruction of one interval (reference
        store_ec.go:322-376): through the fused ``decoder`` fleet when
        one is given, else the in-place parallel fetch and one-row
        solve. With a ``span_cache`` the span is served from it, and a
        reconstructed span is published to it."""
        gen = None
        if span_cache is not None:
            key = span_cache.span_key(self.volume_id, missing_shard, off,
                                      length)
            hit = span_cache.get(key)
            if hit is not None:
                if len(hit) == length:
                    return hit
                # a torn span (a disk-tier file cut short by power
                # loss): drop it and reconstruct
                span_cache.drop(key)
            # snapshot before solving: a rebuild or scrub invalidation
            # racing this reconstruction must win (set refuses stale)
            gen = span_cache.generation(key)
        if decoder is not None:
            data = decoder.decode(self, missing_shard, off, length,
                                  remote_reader)
        else:
            data = self._recover_in_place(missing_shard, off, length,
                                          remote_reader, rs)
        if span_cache is not None:
            span_cache.set(key, data, gen=gen)
        return data

    def _recover_in_place(self, missing_shard: int, off: int, length: int,
                          remote_reader: Optional[Callable],
                          rs: Optional[ReedSolomon]) -> bytes:
        """The fleet-less path: fetch 10 source rows and solve the one-row
        reconstruction. Any 10 valid rows give the same bytes. With a
        ``remote_reader`` the fetches run on the shared reader pool (all
        local reads in parallel, then the remote deficit in parallel).
        Without one there is no remote wait to overlap, and a pool handoff
        costs more than a page-cached pread: the local rows are read
        inline, in shard-id order, stopping at the tenth."""
        rs = rs or _card_codec()
        rows: List[np.ndarray] = []
        ids: List[int] = []
        # snapshot: a concurrent unmount between the membership test and
        # the element access must degrade the row, not raise KeyError
        shards = dict(self.shards)
        local = [sid for sid in range(TOTAL_SHARDS)
                 if sid != missing_shard and sid in shards]

        def row(fetch) -> bytes:
            try:
                return fetch()
            except (OSError, ValueError):  # failing disk / closed by
                return b""                 # a concurrent unmount

        if remote_reader is None:
            fetched = ((sid, row(functools.partial(
                shards[sid].read_at, off, length))) for sid in local)
        else:
            pool = _get_recover_pool()
            futs = [(sid, pool.submit(shards[sid].read_at, off, length))
                    for sid in local]
            fetched = ((sid, row(fut.result)) for sid, fut in futs)
        for sid, b in fetched:  # lazy: the inline reads stop at ten rows
            if len(b) == length:
                ids.append(sid)
                rows.append(np.frombuffer(b, dtype=np.uint8))
                if len(ids) == DATA_SHARDS:
                    break
        if len(ids) < DATA_SHARDS and remote_reader is not None:
            remote_futs = [(sid, pool.submit(remote_reader, sid, off, length))
                           for sid in range(TOTAL_SHARDS)
                           if sid != missing_shard and sid not in ids]
            for sid, fut in remote_futs:
                if len(ids) >= DATA_SHARDS:
                    break
                try:
                    b = fut.result()
                # lint: swallow-ok(a dead peer fails rows, not reads; deficit rows top up below)
                except Exception:
                    b = None
                if b is not None and len(b) == length:
                    ids.append(sid)
                    rows.append(np.frombuffer(b, dtype=np.uint8))
        if len(ids) < DATA_SHARDS:
            raise EcShardNotFound(
                f"vid {self.volume_id} shard {missing_shard}: only "
                f"{len(ids)} shards reachable, need {DATA_SHARDS}")
        # rows were appended local first: restore canonical sid order so
        # the decode matrix (and its cache key) is deterministic
        order = np.argsort(ids)
        src = np.stack([rows[i] for i in order], axis=0)
        ids = [ids[i] for i in order]
        out = rs.reconstruct_some(ids, [missing_shard], src)
        ReadsDegradedCounter.inc()
        ReadsDecodedBytesCounter.inc(float(length))
        return out[0].tobytes()

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            for s in self.shards.values():
                s.close()
            self.shards.clear()
            self._ecx.close()
            self._ecj.close()

    def destroy(self) -> None:
        """Remove this volume's local EC files: its mounted shards, the
        .ecx/.ecj and the .ectier sidecar."""
        with self._lock:
            for s in list(self.shards.values()):
                s.destroy()
            self.shards.clear()
            self._ecx.close()
            self._ecj.close()
            for ext in (".ecx", ".ecj", ".ectier"):
                p = self.base_name + ext
                if os.path.exists(p):
                    os.remove(p)

    def file_count(self) -> int:
        return int((self._sizes >= 0).sum())
