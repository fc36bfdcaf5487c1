"""Backend storage: where a volume's .dat bytes live.

Mirrors the reference SPI (weed/storage/backend/backend.go:15-74), as
``seaweedfs_tpu.storage.backend`` does:

- ``BackendStorageFile`` is the positional-IO handle of one volume data
  file. ``DiskFile`` is the local implementation (os.pread/os.pwrite,
  thread-safe, no shared seek pointer); ``RemoteFile`` serves the reads
  of a tiered volume from an object store, by ranged reads.
- ``BackendStorage`` is one configured object-store target that sealed
  volume files move to, registered under a ``scheme.id`` name like the
  reference's ``[storage.backend.<scheme>.<id>]`` master.toml sections.

The ``memory`` scheme (``MemoryBackendStorage``, an in-process object
store) is the one this port carries. The ``s3`` scheme needs the S3
client and a gateway to test against, which arrive with the S3 gateway
(ROADMAP Queue 1 item 13): until then, configuring it is an error that
says so.

The ``<base>.tier`` sidecar records which backend holds a volume's .dat,
and ``<base>.ectier`` which backend holds a server's .ecNN shards.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, Optional

from seaweedfs_tpu_torch.resilience import failpoint as _failpoint


class BackendError(Exception):
    pass


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
        """True when the bytes live in an object store."""
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

    def fileno(self) -> int:
        """The raw fd for zero-copy readers: the volume read path dup()s
        it into a FileSpan, so a close or a vacuum's file swap cannot
        pull it from under a sendfile in flight."""
        return self._fd

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class RemoteFile(BackendStorageFile):
    """Read-only view of a tiered volume's .dat: every read_at is a ranged
    read of the owning BackendStorage (reference s3_backend.go ReadAt).
    Writes are refused: a tiered volume is sealed."""

    def __init__(self, backend: "BackendStorage", key: str, size: int):
        self.backend = backend
        self.key = key
        self._size = size

    def read_at(self, size: int, offset: int) -> bytes:
        return self.backend.read_range(self.key, offset, size)

    def write_at(self, data, offset: int) -> int:
        raise BackendError(f"{self.name()}: tiered volume is read-only")

    def truncate(self, size: int) -> None:
        raise BackendError(f"{self.name()}: tiered volume is read-only")

    def sync(self) -> None:
        pass

    def size(self) -> int:
        return self._size

    def name(self) -> str:
        return f"{self.backend.name}:{self.key}"

    def close(self) -> None:
        pass

    @property
    def is_remote(self) -> bool:
        return True


# -- BackendStorage: a configured object-store target -------------------------


class BackendStorage:
    """One object-store target for sealed volume files
    (reference backend/backend.go:32-46)."""

    name: str = ""

    def copy_file(self, local_path: str, key: str,
                  progress: Optional[Callable[[int], None]] = None) -> int:
        """Upload local_path under key; returns the bytes uploaded."""
        raise NotImplementedError

    def download_file(self, key: str, local_path: str,
                      progress: Optional[Callable[[int], None]] = None
                      ) -> int:
        """Download key to local_path; returns the bytes downloaded."""
        raise NotImplementedError

    def read_range(self, key: str, offset: int, length: int) -> bytes:
        raise NotImplementedError

    def delete_file(self, key: str) -> None:
        raise NotImplementedError


class MemoryBackendStorage(BackendStorage):
    """An object store in this process's memory: the ``memory`` scheme."""

    def __init__(self, name: str = "memory.default"):
        self.name = name
        self._objects: Dict[str, bytes] = {}  # guarded_by(self._lock)
        self._lock = threading.Lock()

    def copy_file(self, local_path, key, progress=None):
        with open(local_path, "rb") as f:
            data = f.read()
        with self._lock:
            self._objects[key] = data
        if progress:
            progress(len(data))
        return len(data)

    def download_file(self, key, local_path, progress=None):
        with self._lock:
            data = self._objects.get(key)
        if data is None:
            raise BackendError(f"{self.name}: no object {key}")
        with open(local_path, "wb") as f:
            f.write(data)
        if progress:
            progress(len(data))
        return len(data)

    def read_range(self, key, offset, length):
        with self._lock:
            data = self._objects.get(key)
        if data is None:
            raise BackendError(f"{self.name}: no object {key}")
        return data[offset:offset + length]

    def delete_file(self, key):
        with self._lock:
            self._objects.pop(key, None)

    def object_size(self, key) -> Optional[int]:
        with self._lock:
            data = self._objects.get(key)
        return None if data is None else len(data)


# -- the registry (reference backend.go:48-74) --------------------------------

_factories: Dict[str, Callable[[str, dict], BackendStorage]] = {}
_backends: Dict[str, BackendStorage] = {}  # guarded_by(_registry_lock)
_registry_lock = threading.Lock()

S3_REFUSAL = ("the s3 storage backend is not carried by this port: it "
              "arrives with the S3 client and gateway (ROADMAP Queue 1 "
              "item 13); use a memory.<id> backend")


def register_backend_factory(
        scheme: str, factory: Callable[[str, dict], BackendStorage]) -> None:
    _factories[scheme] = factory


def load_configuration(conf: dict) -> None:
    """``conf`` maps backend names to properties, e.g.
    ``{"memory.cold": {}}``; the scheme is the name up to the first dot
    (reference master.toml ``[storage.backend.<scheme>.<id>]``)."""
    for name, props in (conf or {}).items():
        scheme = name.split(".", 1)[0]
        factory = _factories.get(scheme)
        if factory is None:
            raise BackendError(f"unknown storage backend scheme {scheme!r}")
        register_backend(factory(name, props or {}))


def register_backend(backend: BackendStorage) -> BackendStorage:
    with _registry_lock:
        _backends[backend.name] = backend
    return backend


def get_backend(name: str) -> BackendStorage:
    with _registry_lock:
        b = _backends.get(name)
    if b is None:
        if name.split(".", 1)[0] == "s3":
            raise BackendError(S3_REFUSAL)
        raise BackendError(f"storage backend {name!r} is not configured")
    return b


def clear_backends() -> None:
    with _registry_lock:
        _backends.clear()


def _memory_factory(name: str, props: dict) -> BackendStorage:
    return MemoryBackendStorage(name)


def _s3_factory(name: str, props: dict) -> BackendStorage:
    raise BackendError(S3_REFUSAL)


register_backend_factory("memory", _memory_factory)
register_backend_factory("s3", _s3_factory)


# -- <base>.tier: which backend holds the .dat (the reference keeps this in
# the .vif volume-info file) ---------------------------------------------------


def tier_info_path(base_name: str) -> str:
    return base_name + ".tier"


def _write_json(path: str, info: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_tier_info(base_name: str, backend_name: str, key: str,
                    size: int) -> None:
    _write_json(tier_info_path(base_name),
                {"backend": backend_name, "key": key, "size": size})


def read_tier_info(base_name: str) -> Optional[dict]:
    p = tier_info_path(base_name)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def remove_tier_info(base_name: str) -> None:
    p = tier_info_path(base_name)
    if os.path.exists(p):
        os.remove(p)


# -- <base>.ectier: which backend holds this server's .ecNN files. ``shards``
# maps shard id -> {key, size}; the .ecx/.ecj stay local, so needle lookups
# keep their speed and only shard reads pay the remote round trip ------------


def ec_tier_info_path(base_name: str) -> str:
    return base_name + ".ectier"


def write_ec_tier_info(base_name: str, backend_name: str,
                       shards: dict) -> None:
    _write_json(ec_tier_info_path(base_name),
                {"backend": backend_name,
                 "shards": {str(sid): rec for sid, rec in shards.items()}})


def read_ec_tier_info(base_name: str) -> Optional[dict]:
    p = ec_tier_info_path(base_name)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        info = json.load(f)
    info["shards"] = {int(sid): rec
                      for sid, rec in info.get("shards", {}).items()}
    return info


def remove_ec_tier_info(base_name: str) -> None:
    p = ec_tier_info_path(base_name)
    if os.path.exists(p):
        os.remove(p)
