"""Volume: one append-only .dat + .idx pair.

Behavioral parity with the reference volume engine
(weed/storage/volume_read_write.go, volume_loading.go,
volume_checking.go): cookie-checked overwrites, tombstone deletes (an
empty needle appended to .dat + a size=-1 .idx entry), TTL expiry on
read, torn-tail truncation at load.

Writes ride a per-volume group-commit writer, the counterpart of
``seaweedfs_tpu.storage.volume`` and the reference's async write path
(volume_read_write.go:331-405): while a batch is in flight, requests
queue; one drain takes at most 128 requests or 4 MiB, stages every
append into one buffer, commits it with one write (and one fsync when a
request asked for it), then publishes the index entries and wakes the
waiters. A failed physical write truncates the .dat back to the batch
start and fails every request of the batch. An uncontended write that
wants no fsync is applied inline under the volume lock; the writer
thread is made at the first fsync'd or contended write (one that finds
the volume lock taken, where the reference waits for the lock and
applies the write alone).

A volume whose .dat was moved to an object store (``volume_tier``) has a
``<base>.tier`` sidecar: it loads read-only on a ``RemoteFile``, and a
load first resolves what a vacuum cut short (``vacuum.recover_compaction``).
"""

from __future__ import annotations

import collections
import os
import struct
import threading
import time
from typing import Optional

import numpy as np

from seaweedfs_tpu_torch.native import crc
from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage import backend as bk
from seaweedfs_tpu_torch.storage.backend import (
    BackendError, BackendStorageFile, DiskFile)
from seaweedfs_tpu_torch.storage.needle import (
    Needle, NeedleError, CookieMismatch, actual_size, VERSION3,
    verify_needle_integrity,
)
from seaweedfs_tpu_torch.storage.needle_map import make_needle_map
from seaweedfs_tpu_torch.storage.superblock import (
    SuperBlock, ReplicaPlacement, TTL,
)
from seaweedfs_tpu_torch.util import wlog

_log = wlog.logger("storage.volume")


# SEAWEED_VERIFY_READS=1: read_needle re-verifies the masked CRC of every
# needle it returns through the shared integrity predicate and raises the
# typed DataCorruptionError on mismatch. Resolved once at import; tests
# flip it with set_verify_reads().
_VERIFY_READS = os.environ.get("SEAWEED_VERIFY_READS", "") not in ("", "0")


def set_verify_reads(on: bool) -> None:
    global _VERIFY_READS
    _VERIFY_READS = bool(on)


def verify_reads_enabled() -> bool:
    return _VERIFY_READS


class VolumeError(Exception):
    pass


class _WriteRequest:
    """One write or delete, committed inline or by the group-commit
    writer. Only a request handed to the writer gets an event to wait on
    (an inline commit is done when _apply_batch returns)."""

    __slots__ = ("kind", "needle", "fsync", "event", "done", "result",
                 "error")

    def __init__(self, kind: str, needle: Needle, fsync: bool = False):
        self.kind = kind
        self.needle = needle
        self.fsync = fsync
        self.event: Optional[threading.Event] = None
        self.done = False
        self.result = None
        self.error: Optional[BaseException] = None

    def complete(self, result=None, error: Optional[BaseException] = None):
        self.result = result
        self.error = error
        self.done = True
        if self.event is not None:
            self.event.set()

    def wait(self):
        # no timeout: a waiter that gave up would leave a request the
        # writer later commits anyway. The writer completes every
        # request, stop() included.
        if not self.done:
            self.event.wait()
        if self.error is not None:
            raise self.error
        return self.result


class _GroupCommitWriter:
    """The volume's one writer thread, committing queued requests in
    batches of at most MAX_BATCH_REQS requests or MAX_BATCH_BYTES of
    payload (see Volume._apply_batch for one batch's protocol)."""

    MAX_BATCH_REQS = 128
    MAX_BATCH_BYTES = 4 * 1024 * 1024

    def __init__(self, volume: "Volume"):
        self.volume = volume
        # backlog() peeks lock-free (a deque's len is GIL-atomic; the
        # routing heuristic tolerates a stale answer)
        self._queue: collections.deque = collections.deque()  # guarded_by(self._cond, writes)
        self._cond = threading.Condition()
        self._stopped = False  # guarded_by(self._cond)
        self.batches = 0  # batches this thread committed
        # lint: gate-ok(made lazily by Volume._get_writer at the first fsync'd or contended write) # lint: thread-ok(group-commit writer; requests rendezvous on their events)
        self._thread = threading.Thread(
            target=self._run, name=f"vol-{volume.id}-writer", daemon=True)
        self._thread.start()

    def backlog(self) -> int:
        return len(self._queue)

    def submit(self, req: _WriteRequest):
        req.event = threading.Event()
        with self._cond:
            if self._stopped:
                raise VolumeError(
                    f"volume {self.volume.id}: writer is stopped")
            self._queue.append(req)
            self._cond.notify()
        return req.wait()

    def stop(self) -> None:
        """Commit what is queued, then end the thread; a request that
        arrives later is refused by submit()."""
        with self._cond:
            self._stopped = True
            self._cond.notify()
        self._thread.join(timeout=10)
        while self._queue:
            # lint: guard-ok(post-join drain: the thread has exited and submit refuses once stopped)
            self._queue.popleft().complete(
                error=VolumeError("volume closed"))

    def _drain(self) -> Optional[list]:
        with self._cond:
            while not self._queue and not self._stopped:
                self._cond.wait()
            if not self._queue:
                return None
            batch, payload = [], 0
            while self._queue and len(batch) < self.MAX_BATCH_REQS and \
                    payload < self.MAX_BATCH_BYTES:
                req = self._queue.popleft()
                batch.append(req)
                payload += len(req.needle.data)
            return batch

    def _run(self) -> None:
        while True:
            batch = self._drain()
            if batch is None:
                return
            self.batches += 1
            try:
                self.volume._apply_batch(batch)
            except BaseException as e:  # never kill the writer thread
                for req in batch:
                    if not req.done:
                        req.complete(error=e)


class Volume:
    def __init__(self, dirname: str, collection: str, vid: int,
                 replica_placement: ReplicaPlacement = ReplicaPlacement(),
                 ttl: TTL = TTL.empty(),
                 create_if_missing: bool = True,
                 async_write: bool = True,
                 needle_map_kind: str = "memory"):
        # every needle write and read checksums through the native CRC
        # library: fail here, at open, if it cannot be built
        crc.load()
        self.dir = dirname
        self.collection = collection
        self.id = vid
        self.needle_map_kind = needle_map_kind
        self.version = VERSION3
        self.read_only = False
        # the newest append, for the heartbeat's modified_at_second
        self.last_append_at_ns = 0
        self._lock = threading.RLock()
        self.async_write = async_write
        # _use_worker peeks lock-free (a stale None only routes one
        # request inline, which is valid)
        self._writer: Optional[_GroupCommitWriter] = None  # guarded_by(self._writer_lock, writes)
        self._writer_lock = threading.Lock()
        # batches committed (one .dat write each, inline or by the
        # writer) and the requests they held
        self.batches = 0  # guarded_by(self._lock, writes)
        self.batched_requests = 0  # guarded_by(self._lock, writes)
        base = self.file_name()
        self.dat_path = base + ".dat"
        self.idx_path = base + ".idx"
        if os.path.exists(self.dat_path) or \
                bk.read_tier_info(base) is not None:
            self._load()
        elif not create_if_missing:
            raise VolumeError(f"volume file {self.dat_path} missing")
        else:
            self.super_block = SuperBlock(
                version=VERSION3, replica_placement=replica_placement, ttl=ttl)
            self._dat: BackendStorageFile = DiskFile(self.dat_path,
                                                     create=True)
            self._dat.write_at(self.super_block.to_bytes(), 0)
            self.nm = make_needle_map(self.idx_path, needle_map_kind)

    def file_name(self) -> str:
        name = f"{self.collection}_{self.id}" if self.collection else str(self.id)
        return os.path.join(self.dir, name)

    @property
    def ttl(self) -> TTL:
        return self.super_block.ttl

    @property
    def replica_placement(self) -> ReplicaPlacement:
        return self.super_block.replica_placement

    @property
    def content_size(self) -> int:
        return self._dat.size()

    @property
    def file_count(self) -> int:
        return len(self.nm)

    @property
    def deleted_count(self) -> int:
        return self.nm.deleted_count

    @property
    def deleted_size(self) -> int:
        return self.nm.deleted_size

    # -- loading / integrity -------------------------------------------------

    def _load(self) -> None:
        # vacuum imports this module: resolve it at call time
        from seaweedfs_tpu_torch.storage.vacuum import recover_compaction
        recover_compaction(self.file_name())
        tier = bk.read_tier_info(self.file_name())
        if tier is not None and not os.path.exists(self.dat_path):
            # tiered: the .dat lives in an object store, reads are ranged
            # reads of it, and the volume is sealed (reference
            # volume_tier.go LoadRemoteFile)
            self._dat = bk.RemoteFile(bk.get_backend(tier["backend"]),
                                      tier["key"], tier["size"])
            self.read_only = True
        else:
            self._dat = DiskFile(self.dat_path)
            if tier is not None:
                # tiered with the local copy kept: reads stay local, but
                # a write would diverge from the remote object
                self.read_only = True
        header = self._dat.read_at(8, 0)
        if len(header) < 8:
            raise VolumeError(f"{self.dat_path}: truncated superblock")
        self.super_block = SuperBlock.from_bytes(header)
        self.version = self.super_block.version
        self.nm = make_needle_map(self.idx_path, self.needle_map_kind)
        if not self._dat.is_remote:
            self._check_and_fix_integrity()
        self._restore_last_append_ns()

    def _restore_last_append_ns(self) -> None:
        """The newest record's append time, from the last .idx entry: the
        quiet-period guard of ec.encode and incremental backup both need
        it to survive a restart (the reference reads it at load too)."""
        if not os.path.exists(self.idx_path):
            return
        n_entries = os.path.getsize(self.idx_path) // t.NEEDLE_MAP_ENTRY_SIZE
        if n_entries == 0:
            return
        with open(self.idx_path, "rb") as f:
            f.seek((n_entries - 1) * t.NEEDLE_MAP_ENTRY_SIZE)
            entry = f.read(t.NEEDLE_MAP_ENTRY_SIZE)
        _, offset, _ = idx_codec.parse_entry(entry)
        header = self._dat.read_at(t.NEEDLE_HEADER_SIZE, offset)
        if len(header) < t.NEEDLE_HEADER_SIZE:
            return
        _, _, size_u = struct.unpack(">IQI", header)
        body = t.size_to_int32(size_u)
        if t.size_is_deleted(body):
            body = 0
        blob = self._dat.read_at(
            8, offset + t.NEEDLE_HEADER_SIZE + body + t.NEEDLE_CHECKSUM_SIZE)
        if len(blob) == 8:
            self.last_append_at_ns = struct.unpack(">Q", blob)[0]

    def _check_and_fix_integrity(self) -> None:
        """Truncate a torn tail: the .dat must end exactly after the last
        needle recorded in the .idx (reference volume_checking.go:16-66).
        An absent/empty .idx means nothing is known about the volume, so
        nothing is truncated."""
        if not os.path.exists(self.idx_path) or \
                os.path.getsize(self.idx_path) == 0:
            return
        with open(self.idx_path, "rb") as f:
            arr = idx_codec.parse_index_bytes(f.read())
        if not len(arr):
            return
        # a tombstone's record is an empty needle
        body = np.maximum(arr["size"].astype(np.int64), 0)
        ends = arr["offset"] + actual_size(body, self.version)
        expected = int(max(ends.max(), 8))
        dat_size = self._dat.size()
        if dat_size > expected:
            self._dat.truncate(expected)
        elif dat_size < expected:
            raise VolumeError(
                f"{self.dat_path}: data file shorter ({dat_size}) than the "
                f"index implies ({expected})")

    # -- write path ----------------------------------------------------------

    def write_needle(self, n: Needle, fsync: bool = False) -> tuple[int, int]:
        """Append a needle; returns (offset, size). Cookie-checked overwrite.

        An fsync'd write, one that arrives while the writer has a
        backlog, and one that finds the volume lock taken ride the
        group-commit writer, so concurrent requests share one write (and
        one fsync); an uncontended write without fsync is applied inline,
        which is cheaper than a thread handoff. Either way the call
        returns once the bytes are committed."""
        if len(n.data) == 0:
            raise VolumeError(
                "zero-byte writes are not storable (indistinguishable from "
                "a delete marker); reject at the write path")
        return self._commit(_WriteRequest("write", n, fsync))

    def delete_needle(self, n: Needle) -> int:
        """Tombstone a needle; returns freed size (0 if absent)."""
        return self._commit(_WriteRequest("delete", n))

    def _commit(self, req: _WriteRequest):
        if self._use_worker(req.fsync):
            return self._get_writer().submit(req)
        if not self._lock.acquire(blocking=not self.async_write):
            # contended: join the writer's next batch (the reference
            # waits for the lock and applies the write alone)
            return self._get_writer().submit(req)
        try:
            self._apply_batch([req])
        finally:
            self._lock.release()
        return req.wait()

    def _use_worker(self, fsync: bool) -> bool:
        if not self.async_write:
            return False
        if fsync:
            return True
        w = self._writer
        return w is not None and w.backlog() > 0

    def _get_writer(self) -> _GroupCommitWriter:
        with self._writer_lock:
            if self._writer is None:
                self._writer = _GroupCommitWriter(self)
            return self._writer

    def commit_stats(self) -> tuple[int, int, int]:
        """(batches, requests, batches by the writer thread) committed
        since the volume was opened."""
        w = self._writer
        return (self.batches, self.batched_requests,
                w.batches if w is not None else 0)

    def _lookup_for_batch(self, key: int, pending: dict):
        """The index as a batch sees it: entries staged earlier in the
        batch first (None for a staged delete), then the needle map.
        Returns (offset, size) or None."""
        if key in pending:
            return pending[key]
        nv = self.nm.get(key)
        if nv is None or not t.size_is_valid(nv.size):
            return None
        return (nv.offset, nv.size)

    def _read_old_needle(self, offset: int, size: int, batch_start: int,
                         buf: bytearray) -> Needle:
        """A needle for a cookie check: one staged earlier in this batch
        lives in ``buf``, not on disk."""
        if offset >= batch_start:
            start = offset - batch_start
            blob = bytes(buf[start:start + actual_size(size, self.version)])
            return Needle.from_bytes(blob, self.version, check_crc=False)
        return self._read_needle_at(offset, size, check_crc=False)

    def _apply_batch(self, batch: list) -> None:
        """Commit a batch of write/delete requests with one append.

        Every request is staged into one buffer (cookie checks see the
        batch's own earlier entries); the buffer is written once (and
        fsync'd once if any request asked); only then are the index
        entries published, so a reader never finds an entry that points
        at unwritten bytes. On a write error the .dat is truncated back
        to the batch start (reference volume_read_write.go:385-399) and
        every staged request fails."""
        with self._lock:
            self.batches += 1
            self.batched_requests += len(batch)
            batch_start = self._dat.size()
            buf = bytearray()
            staged = []  # (req, needle or delete marker, offset, result)
            pending: dict = {}
            any_fsync = False
            for req in batch:
                try:
                    if self.read_only:
                        raise VolumeError(f"volume {self.id} is read-only")
                    if req.kind == "write":
                        staged.append(self._stage_write(
                            req, batch_start, buf, pending))
                        any_fsync = any_fsync or req.fsync
                    else:
                        item = self._stage_delete(
                            req, batch_start, buf, pending)
                        if item is None:
                            req.complete(result=0)
                        else:
                            staged.append(item)
                except Exception as e:  # noqa: BLE001 - the request's own error
                    req.complete(error=e)
            if buf:
                try:
                    self._dat.write_at(buf, batch_start)
                    if any_fsync:
                        self._dat.sync()
                except (OSError, BackendError) as e:
                    try:
                        self._dat.truncate(batch_start)
                    except (OSError, BackendError):
                        pass
                    err = VolumeError(
                        f"volume {self.id}: batch write failed: {e}")
                    for req, _, _, _ in staged:
                        req.complete(error=err)
                    return
            for req, n, offset, result in staged:
                try:
                    if req.kind == "write":
                        self.nm.put(n.id, offset, n.size)
                    else:
                        self.nm.delete(n.id, offset)
                    if n.append_at_ns > self.last_append_at_ns:
                        self.last_append_at_ns = n.append_at_ns
                except OSError as e:
                    req.complete(error=VolumeError(
                        f"volume {self.id}: index publish failed: {e}"))
                    continue
                req.complete(result=result)
            try:
                # .idx entries are buffered: one flush per batch. On a
                # failure the map is already right and a later flush or
                # sync() retries, so acknowledged writes stay readable.
                self.nm.flush()
            except OSError as e:
                _log.warning("volume %d: idx flush failed (will retry "
                             "on next batch/sync): %s", self.id, e)

    def _stage_write(self, req: _WriteRequest, batch_start: int,
                     buf: bytearray, pending: dict):
        n = req.needle
        if (n.ttl is None or n.ttl.is_empty) and not self.ttl.is_empty:
            n.ttl = self.ttl
        existing = self._lookup_for_batch(n.id, pending)
        if existing is not None:
            old = self._read_old_needle(existing[0], existing[1],
                                        batch_start, buf)
            if old.cookie != n.cookie:
                raise CookieMismatch(
                    f"needle {n.id:x}: cookie mismatch {n.cookie:08x}")
        n.append_at_ns = time.time_ns()
        offset = self._stage_blob(batch_start, buf, n.to_bytes(self.version))
        pending[n.id] = (offset, n.size)
        return req, n, offset, (offset, n.size)

    def _stage_delete(self, req: _WriteRequest, batch_start: int,
                      buf: bytearray, pending: dict):
        n = req.needle
        existing = self._lookup_for_batch(n.id, pending)
        if existing is None:
            return None
        if n.cookie:
            old = self._read_old_needle(existing[0], existing[1],
                                        batch_start, buf)
            if old.cookie != n.cookie:
                raise CookieMismatch(
                    f"needle {n.id:x}: delete cookie mismatch")
        marker = Needle(id=n.id, cookie=n.cookie, data=b"")
        marker.append_at_ns = time.time_ns()
        offset = self._stage_blob(batch_start, buf,
                                  marker.to_bytes(self.version))
        pending[n.id] = None
        return req, marker, offset, existing[1]

    def _stage_blob(self, batch_start: int, buf: bytearray,
                    blob: bytes) -> int:
        """Pad the batch to the 8-byte needle alignment and append one
        record; returns its .dat offset."""
        tail = batch_start + len(buf)
        pad = (-tail) % t.NEEDLE_PADDING
        if pad:
            buf += b"\x00" * pad
            tail += pad
        if tail + len(blob) > t.MAX_POSSIBLE_VOLUME_SIZE:
            raise VolumeError(f"volume {self.id} exceeds max size")
        buf += blob
        return tail

    # -- read path -----------------------------------------------------------

    def read_needle(self, n: Needle) -> Needle:
        """Fill a needle by id; raises NeedleError if absent/expired,
        CookieMismatch if the cookie doesn't match."""
        with self._lock:
            nv = self.nm.get(n.id)
            if nv is None or not t.size_is_valid(nv.size):
                raise NeedleError(f"needle {n.id:x} not found")
            got = self._read_needle_at(nv.offset, nv.size)
        if n.cookie and got.cookie != n.cookie:
            raise CookieMismatch(
                f"needle {n.id:x}: cookie {n.cookie:08x} != {got.cookie:08x}")
        if got.has_expired():
            raise NeedleError(f"needle {n.id:x} expired")
        if _VERIFY_READS:
            verify_needle_integrity(got)
        return got

    def read_needle_span(self, n: Needle):
        """Zero-copy read: the needle's metadata from two small preads,
        its payload left on disk. Returns (needle, FileSpan): the needle
        carries cookie, flags, name, mime, checksum and ttl but empty
        data; the span (a dup'd fd, the payload's offset and length) is
        the caller's to sendfile and close. Returns None when this volume
        cannot serve spans: a .dat in an object store or the memory tier
        (a RemoteFile), or SEAWEED_VERIFY_READS, which asks for a payload
        CRC check that a copy-free send never reads. Raises what
        read_needle raises (NeedleError, CookieMismatch). The span trades
        the read-time CRC check for the copy-free send; the scrub owns
        integrity at rest."""
        from seaweedfs_tpu_torch.util.http_server import FileSpan
        if _VERIFY_READS:
            return None
        with self._lock:
            dat = self._dat
            if dat is None or dat.is_remote or \
                    not isinstance(dat, DiskFile):
                return None
            nv = self.nm.get(n.id)
            if nv is None or not t.size_is_valid(nv.size):
                raise NeedleError(f"needle {n.id:x} not found")
            offset = nv.offset
            hdr = dat.read_at(t.NEEDLE_HEADER_SIZE + 4, offset)
            if len(hdr) < t.NEEDLE_HEADER_SIZE:
                raise NeedleError(
                    f"short read at {offset}: {len(hdr)} < "
                    f"{t.NEEDLE_HEADER_SIZE}")
            size = t.size_to_int32(
                int.from_bytes(hdr[12:16], "big"))
            if size > 0:
                if len(hdr) < t.NEEDLE_HEADER_SIZE + 4:
                    raise NeedleError(
                        f"short read at {offset}: {len(hdr)} < "
                        f"{t.NEEDLE_HEADER_SIZE + 4}")
                data_size = int.from_bytes(hdr[16:20], "big")
                data_off = offset + t.NEEDLE_HEADER_SIZE + 4
            else:
                data_size = 0
                data_off = offset + t.NEEDLE_HEADER_SIZE
            meta_off = data_off + data_size
            # attrs + checksum (+ts on v3); the padding tail is
            # irrelevant to the parse
            meta_len = (size - 4 - data_size if size > 0 else 0) + \
                4 + (t.TIMESTAMP_SIZE if self.version == VERSION3
                     else 0)
            meta = dat.read_at(meta_len, meta_off)
            if len(meta) < meta_len:
                raise NeedleError(
                    f"short read at {meta_off}: {len(meta)} < "
                    f"{meta_len}")
            got = Needle.from_disk_meta(hdr, meta, data_size,
                                        self.version)
            span_fd = os.dup(dat.fileno())
        span = FileSpan(span_fd, data_off, data_size)
        try:
            if n.cookie and got.cookie != n.cookie:
                raise CookieMismatch(
                    f"needle {n.id:x}: cookie {n.cookie:08x} != "
                    f"{got.cookie:08x}")
            if got.has_expired():
                raise NeedleError(f"needle {n.id:x} expired")
        except NeedleError:
            span.close()
            raise
        return got, span

    def _read_needle_at(self, offset: int, size: int,
                        check_crc: bool = True) -> Needle:
        length = actual_size(size, self.version)
        blob = self._dat.read_at(length, offset)
        if len(blob) < length:
            raise NeedleError(
                f"short read at {offset}: {len(blob)} < {length}")
        return Needle.from_bytes(blob, self.version, check_crc=check_crc)

    # -- scanning ------------------------------------------------------------

    def scan_needles(self, include_deleted: bool = False):
        """Yield (offset, Needle) for every record in the .dat, in order,
        parsed without the CRC check.

        Opens its own read-only fd, so a long scan (scrub) never races
        reads and writes on the shared handle. A garbled record is
        skipped, never raised. The scan ends where the .dat ended when
        no batch was in flight (taken under the volume lock). A tiered
        volume has no local .dat to scan: download it first."""
        with self._lock:
            if self._dat.is_remote:
                raise VolumeError(
                    f"volume {self.id} is tiered; download it first "
                    "(VolumeTierMoveDatFromRemote) before scanning")
            size = self._dat.size()
        offset = 8
        with open(self.dat_path, "rb") as f:
            while offset + t.NEEDLE_HEADER_SIZE <= size:
                f.seek(offset)
                header = f.read(t.NEEDLE_HEADER_SIZE)
                if len(header) < t.NEEDLE_HEADER_SIZE:
                    break
                _, _, size_u = struct.unpack(">IQI", header)
                body_size = t.size_to_int32(size_u)
                if t.size_is_deleted(body_size):
                    body_size = 0
                length = actual_size(body_size, self.version)
                f.seek(offset)
                blob = f.read(length)
                if len(blob) < length:
                    break
                try:
                    n = Needle.from_bytes(blob, self.version,
                                          check_crc=False)
                    if include_deleted or len(n.data) > 0:
                        yield offset, n
                except (NeedleError, struct.error, IndexError, ValueError):
                    # a torn size field dies in struct/_parse_body, not
                    # only as a NeedleError: skip it like one
                    pass
                offset += length

    @property
    def is_remote(self) -> bool:
        return self._dat.is_remote

    # -- stats / admin -------------------------------------------------------

    def garbage_ratio(self) -> float:
        cs = self.content_size
        return (self.nm.deleted_size / cs) if cs > 8 else 0.0

    def configure_replication(self, rp: ReplicaPlacement) -> None:
        """Rewrite the superblock's replica placement in place (reference
        store.go:431 ConfigureVolume). A tiered volume's superblock lives
        in the object store and is not rewritten."""
        with self._lock:
            if self._dat.is_remote:
                raise VolumeError(
                    f"volume {self.id} is tiered; download it first")
            self.super_block = SuperBlock(
                version=self.super_block.version,
                replica_placement=rp,
                ttl=self.super_block.ttl,
                compaction_revision=self.super_block.compaction_revision)
            self._dat.write_at(self.super_block.to_bytes(), 0)
            self._dat.sync()

    # -- lifecycle -----------------------------------------------------------

    def sync(self) -> None:
        """fsync the .dat and the index. Under the volume lock, so a
        batch in flight is committed and published first (the freeze
        before ec.encode: read_only, then sync)."""
        with self._lock:
            self._dat.sync()
            self.nm.sync()

    def close(self) -> None:
        # the writer first: what it has queued is committed before the
        # files close (reference storage/volume.py:700-711)
        with self._writer_lock:
            writer, self._writer = self._writer, None
        if writer is not None:
            writer.stop()
        with self._lock:
            self._dat.close()
            self.nm.close()

    def destroy(self) -> None:
        self.close()
        self.nm.destroy()  # the .idx, and the .nmkv directory of a kv map
        for p in (self.dat_path, bk.tier_info_path(self.file_name())):
            if os.path.exists(p):
                os.remove(p)
