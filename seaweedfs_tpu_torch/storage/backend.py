"""Positional IO on one volume data file.

Mirrors the reference SPI (weed/storage/backend/backend.go:15-23):
``BackendStorageFile`` is the ReadAt/WriteAt/Truncate/Sync/GetStat
handle, ``DiskFile`` the local implementation (os.pread/os.pwrite —
thread-safe, no shared seek pointer).
"""

from __future__ import annotations

import os
import threading

from seaweedfs_tpu_torch.resilience import failpoint as _failpoint


class BackendStorageFile:
    """Positional-IO interface over a volume's data bytes
    (reference backend/backend.go:15-23)."""

    def read_at(self, size: int, offset: int) -> bytes:
        raise NotImplementedError

    def write_at(self, data, offset: int) -> int:
        raise NotImplementedError

    def truncate(self, size: int) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    @property
    def is_remote(self) -> bool:
        """True when the bytes live in a remote tier (none in the port)."""
        return False


class DiskFile(BackendStorageFile):
    """Local file via pread/pwrite — no shared seek pointer, so readers
    never race the writer for the fd position (the reference gets this
    from Go's ReadAt/WriteAt contracts)."""

    def __init__(self, path: str, create: bool = False):
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._fd = os.open(path, flags)
        self._path = path
        # size() reads lock-free (an int load); extensions and truncates
        # serialize on the lock
        self._size = os.fstat(self._fd).st_size  # guarded_by(self._size_lock, writes)
        self._size_lock = threading.Lock()

    def read_at(self, size: int, offset: int) -> bytes:
        return os.pread(self._fd, size, offset)

    def write_at(self, data, offset: int) -> int:
        # pwrite may return a short count (e.g. ENOSPC mid-write); loop so
        # callers get all-or-exception — the volume's truncate-on-error
        # path depends on partial writes raising
        if _failpoint._armed:
            # injected torn write (short), bit flip (corrupt), EIO
            # (error) or stall (delay)
            data = _failpoint.mangle("backend.write_at", data,
                                     path=self._path)
        view = memoryview(data)
        total = len(view)
        written = 0
        while written < total:
            n = os.pwrite(self._fd, view[written:], offset + written)
            if n <= 0:
                raise OSError(
                    f"pwrite returned {n} at {offset + written} "
                    f"({self._path})")
            written += n
            with self._size_lock:
                if offset + written > self._size:
                    self._size = offset + written
        return written

    def truncate(self, size: int) -> None:
        os.ftruncate(self._fd, size)
        with self._size_lock:
            self._size = size

    def sync(self) -> None:
        os.fsync(self._fd)

    def size(self) -> int:
        return self._size

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
