"""Volume: one append-only .dat + .idx pair.

Behavioral parity with the reference volume engine
(weed/storage/volume_read_write.go, volume_loading.go,
volume_checking.go): cookie-checked overwrites, tombstone deletes (an
empty needle appended to .dat + a size=-1 .idx entry), TTL expiry on
read, torn-tail truncation at load. Writes are applied inline under the
volume lock; a failed physical write truncates the .dat back to where the
record started, so no index entry points at torn bytes.
"""

from __future__ import annotations

import os
import struct
import threading
import time

import numpy as np

from seaweedfs_tpu_torch.native import crc
from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.backend import BackendStorageFile, DiskFile
from seaweedfs_tpu_torch.storage.needle import (
    Needle, NeedleError, CookieMismatch, actual_size, VERSION3,
    verify_needle_integrity,
)
from seaweedfs_tpu_torch.storage.needle_map import NeedleMap
from seaweedfs_tpu_torch.storage.superblock import (
    SuperBlock, ReplicaPlacement, TTL,
)


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


class Volume:
    def __init__(self, dirname: str, collection: str, vid: int,
                 replica_placement: ReplicaPlacement = ReplicaPlacement(),
                 ttl: TTL = TTL.empty(),
                 create_if_missing: bool = True):
        # every needle write and read checksums through the native CRC
        # library: fail here, at open, if it cannot be built
        crc.load()
        self.dir = dirname
        self.collection = collection
        self.id = vid
        self.version = VERSION3
        self.read_only = False
        # the newest append, for the heartbeat's modified_at_second
        self.last_append_at_ns = 0
        self._lock = threading.RLock()
        base = self.file_name()
        self.dat_path = base + ".dat"
        self.idx_path = base + ".idx"
        if os.path.exists(self.dat_path):
            self._load()
        elif not create_if_missing:
            raise VolumeError(f"volume file {self.dat_path} missing")
        else:
            self.super_block = SuperBlock(
                version=VERSION3, replica_placement=replica_placement, ttl=ttl)
            self._dat: BackendStorageFile = DiskFile(self.dat_path,
                                                     create=True)
            self._dat.write_at(self.super_block.to_bytes(), 0)
            self.nm = NeedleMap(self.idx_path)

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
        self._dat = DiskFile(self.dat_path)
        header = self._dat.read_at(8, 0)
        if len(header) < 8:
            raise VolumeError(f"{self.dat_path}: truncated superblock")
        self.super_block = SuperBlock.from_bytes(header)
        self.version = self.super_block.version
        self.nm = NeedleMap(self.idx_path)
        self._check_and_fix_integrity()

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
        """Append a needle; returns (offset, size). Cookie-checked overwrite."""
        if len(n.data) == 0:
            raise VolumeError(
                "zero-byte writes are not storable (indistinguishable from "
                "a delete marker); reject at the write path")
        with self._lock:
            if self.read_only:
                raise VolumeError(f"volume {self.id} is read-only")
            if (n.ttl is None or n.ttl.is_empty) and not self.ttl.is_empty:
                n.ttl = self.ttl
            self._check_cookie(n)
            n.append_at_ns = time.time_ns()
            offset = self._append(n.to_bytes(self.version), fsync)
            self.last_append_at_ns = n.append_at_ns
            self.nm.put(n.id, offset, n.size)
            self.nm.flush()
            return offset, n.size

    def delete_needle(self, n: Needle) -> int:
        """Tombstone a needle; returns freed size (0 if absent)."""
        with self._lock:
            if self.read_only:
                raise VolumeError(f"volume {self.id} is read-only")
            nv = self.nm.get(n.id)
            if nv is None or not t.size_is_valid(nv.size):
                return 0
            if n.cookie:
                self._check_cookie(n)
            marker = Needle(id=n.id, cookie=n.cookie, data=b"")
            marker.append_at_ns = time.time_ns()
            offset = self._append(marker.to_bytes(self.version), False)
            self.last_append_at_ns = marker.append_at_ns
            self.nm.delete(n.id, offset)
            self.nm.flush()
            return nv.size

    def _check_cookie(self, n: Needle) -> None:
        nv = self.nm.get(n.id)
        if nv is None or not t.size_is_valid(nv.size):
            return
        old = self._read_needle_at(nv.offset, nv.size, check_crc=False)
        if old.cookie != n.cookie:
            raise CookieMismatch(
                f"needle {n.id:x}: cookie mismatch {n.cookie:08x}")

    def _append(self, blob: bytes, fsync: bool) -> int:
        """Write one record at the 8-aligned tail; returns its offset.
        On a physical write error the .dat is truncated back
        (reference volume_read_write.go:385-399)."""
        start = self._dat.size()
        offset = start + (-start) % t.NEEDLE_PADDING
        if offset + len(blob) > t.MAX_POSSIBLE_VOLUME_SIZE:
            raise VolumeError(f"volume {self.id} exceeds max size")
        try:
            self._dat.write_at(b"\x00" * (offset - start) + blob, start)
            if fsync:
                self._dat.sync()
        except OSError as e:
            self._dat.truncate(start)
            raise VolumeError(f"volume {self.id}: write failed: {e}") from e
        return offset

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
        skipped, never raised."""
        size = os.path.getsize(self.dat_path)
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

    # -- lifecycle -----------------------------------------------------------

    def sync(self) -> None:
        self._dat.sync()
        self.nm.sync()

    def close(self) -> None:
        with self._lock:
            self._dat.close()
            self.nm.close()

    def destroy(self) -> None:
        self.close()
        self.nm.destroy()
        if os.path.exists(self.dat_path):
            os.remove(self.dat_path)
