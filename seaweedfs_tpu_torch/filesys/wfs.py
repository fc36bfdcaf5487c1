"""Wfs: the mount filesystem core (reference: weed/filesys/wfs.go,
file.go, filehandle.go, dir.go).

POSIX-shaped operations over the filer: open/read/write/flush with
write-back dirty pages, mkdir/readdir/unlink/rename, backed by the
MetaCache with live invalidation. A FUSE shim can map kernel ops 1:1
onto this class; without FUSE it serves as the programmatic mount API
(and the unit-test surface, like the reference's filehandle tests).

The port of ``seaweedfs_tpu_torch.filesys.wfs``: reads go through the port's
``filer/stream`` and ``TieredChunkCache``, so a chunk on a volume that
lost shards is read through the volume server's decode fleet.
"""

from __future__ import annotations

import os
import stat as stat_mod
import threading
import time
from typing import Dict, List, Optional

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.filer import filechunks, stream
from seaweedfs_tpu_torch.filer.filerstore import NotFound, split_path
from seaweedfs_tpu_torch.filesys.dirty_pages import ContinuousIntervals
from seaweedfs_tpu_torch.filesys.meta_cache import MetaCache
from seaweedfs_tpu_torch.operation import operations
from seaweedfs_tpu_torch.pb import filer_pb2, filer_stub
from seaweedfs_tpu_torch.util.chunk_cache import TieredChunkCache


class FuseError(OSError):
    pass


class FileHandle:
    """One open file: reads merge flushed chunks + dirty pages; writes
    land in dirty pages and flush() uploads them as new chunks."""

    def __init__(self, wfs: "Wfs", path: str, entry: filer_pb2.Entry):
        self.wfs = wfs
        self.path = path
        self.entry = entry
        self.dirty = ContinuousIntervals()
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        # attributes.file_size participates so a truncate-EXTEND's
        # zero hole is readable (POSIX: extended region reads as 0s)
        return max(filechunks.total_size(self.entry.chunks),
                   self.dirty.total_size,
                   self.entry.attributes.file_size)

    def read(self, offset: int, size: int) -> bytes:
        with self._lock:
            flushed_size = filechunks.total_size(self.entry.chunks)
            end = min(offset + size, self.size)
            if end <= offset:
                return b""
            want = end - offset
            base = b""
            if self.entry.chunks and offset < flushed_size:
                base = b"".join(stream.stream_content(
                    self.wfs.lookup, list(self.entry.chunks), offset,
                    min(want, flushed_size - offset),
                    cache=self.wfs.chunk_cache))
            if not self.dirty:
                return base[:want]
            # overlay dirty bytes on the flushed view
            buf = bytearray(want)
            buf[:len(base)] = base
            for iv in self.dirty.intervals:
                lo = max(offset, iv.offset)
                hi = min(end, iv.stop)
                if lo < hi:
                    buf[lo - offset:hi - offset] = \
                        iv.data[lo - iv.offset:hi - iv.offset]
            return bytes(buf)

    def write(self, data: bytes, offset: int) -> int:
        with self._lock:
            self.dirty.add_interval(data, offset)
            if sum(len(iv.data) for iv in self.dirty.intervals) \
                    >= self.wfs.flush_bytes:
                self._flush_locked()
        return len(data)

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if not self.dirty:
            return
        for iv in self.dirty.pop_all():
            chunk = self.wfs.upload_chunk(iv.data)
            chunk.offset = iv.offset
            nc = self.entry.chunks.add()
            nc.CopyFrom(chunk)
        self.entry.attributes.mtime = int(time.time())
        directory, _ = split_path(self.path)
        self.wfs.stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory=directory, entry=self.entry,
            signatures=[self.wfs.signature]))
        self.wfs.meta_cache.insert(directory, self.entry)

    def apply_truncate(self, length: int) -> None:
        """Clamp this handle's view to `length` (kernel truncate on a
        path with open handles — FUSE 2.x O_TRUNC arrives this way):
        drop/trim flushed chunks AND dirty pages past the cut, or the
        next flush would resurrect the pre-truncate bytes."""
        with self._lock:
            kept = filechunks.truncate_chunks(self.entry.chunks, length)
            del self.entry.chunks[:]
            self.entry.chunks.extend(kept)
            self.entry.attributes.file_size = length
            for iv in self.dirty.pop_all():
                if iv.offset >= length:
                    continue
                self.dirty.add_interval(
                    iv.data[: length - iv.offset], iv.offset)

    def release(self) -> None:
        self.flush()


class Wfs:
    def __init__(self, filer_url: str, master_url: str = "",
                 collection: str = "", replication: str = "",
                 chunk_cache_dir: Optional[str] = None,
                 flush_bytes: int = 8 << 20):
        self.filer_url = filer_url
        self.master_url = master_url
        self.collection = collection
        self.replication = replication
        self.flush_bytes = flush_bytes
        # per-mount signature: rides every mutation so the metadata
        # subscription can SKIP this mount's own echoes — without it a
        # lagging self-event can clobber newer local state (the
        # reference's wfs.signature serves exactly this purpose,
        # weed/filesys/wfs.go + meta_cache_subscribe.go)
        import random
        self.signature = random.randint(1, 0x7FFFFFFF)
        self.meta_cache = MetaCache(filer_url, signature=self.signature)
        self.meta_cache.start_subscription(since_ns=time.time_ns())
        self.chunk_cache = TieredChunkCache(disk_dir=chunk_cache_dir)
        # fh keys are unique (allocated under the lock), so point
        # lookups on the read/write path stay lock-free
        self._handles: Dict[int, FileHandle] = {}  # guarded_by(self._lock, writes)
        self._next_fh = 1  # guarded_by(self._lock)
        self._lock = threading.Lock()

    @property
    def stub(self):
        return filer_stub(self.filer_url)

    def stop(self) -> None:
        for fh in list(self._handles.values()):
            fh.release()
        self.meta_cache.stop()

    # -- plumbing -------------------------------------------------------------

    def lookup(self, file_id: str) -> List[str]:
        vid = int(file_id.split(",")[0])
        lk = self.stub.LookupVolume(filer_pb2.LookupVolumeRequest(
            volume_ids=[str(vid)]))
        return [l.url for l in lk.locations_map[str(vid)].locations]

    def upload_chunk(self, data: bytes) -> filer_pb2.FileChunk:
        a = self.stub.AssignVolume(filer_pb2.AssignVolumeRequest(
            count=1, collection=self.collection,
            replication=self.replication))
        if a.error:
            raise FuseError(5, a.error)
        resp = operations.upload_data(f"{a.url}/{a.file_id}", data)
        return filer_pb2.FileChunk(
            file_id=a.file_id, size=len(data), mtime=time.time_ns(),
            e_tag=resp.get("eTag", ""))

    # -- namespace ops --------------------------------------------------------

    def getattr(self, path: str) -> filer_pb2.Entry:
        try:
            return self.meta_cache.find_entry(path)
        except NotFound:
            raise FuseError(2, f"ENOENT: {path}") from None

    def readdir(self, path: str) -> List[filer_pb2.Entry]:
        return self.meta_cache.list_entries(path)

    def mkdir(self, path: str, mode: int = 0o755) -> None:
        directory, name = split_path(path)
        entry = filer_pb2.Entry(name=name, is_directory=True)
        entry.attributes.file_mode = mode
        entry.attributes.crtime = int(time.time())
        entry.attributes.mtime = entry.attributes.crtime
        self.stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory=directory, entry=entry,
            signatures=[self.signature]))
        self.meta_cache.insert(directory, entry)

    def create(self, path: str, mode: int = 0o644) -> int:
        directory, name = split_path(path)
        entry = filer_pb2.Entry(name=name)
        entry.attributes.file_mode = mode
        entry.attributes.crtime = int(time.time())
        entry.attributes.mtime = entry.attributes.crtime
        self.stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory=directory, entry=entry,
            signatures=[self.signature]))
        self.meta_cache.insert(directory, entry)
        return self.open(path)

    def open(self, path: str) -> int:
        entry = self.getattr(path)
        if entry.is_directory:
            raise FuseError(21, f"EISDIR: {path}")
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            self._handles[fh] = FileHandle(self, path, entry)
        return fh

    def handle(self, fh: int) -> FileHandle:
        h = self._handles.get(fh)
        if h is None:
            raise FuseError(9, f"EBADF: {fh}")
        return h

    def read(self, fh: int, offset: int, size: int) -> bytes:
        return self.handle(fh).read(offset, size)

    def write(self, fh: int, data: bytes, offset: int) -> int:
        return self.handle(fh).write(data, offset)

    def flush(self, fh: int) -> None:
        self.handle(fh).flush()

    def release(self, fh: int) -> None:
        # pop under the lock: a release racing open() must not drop a
        # just-allocated sibling's table slot mid-resize (guard check)
        with self._lock:
            h = self._handles.pop(fh, None)
        if h is not None:
            h.release()

    def unlink(self, path: str) -> None:
        directory, name = split_path(path)
        self.stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
            directory=directory, name=name, is_delete_data=True,
            is_recursive=True, ignore_recursive_error=True,
            signatures=[self.signature]))
        self.meta_cache.delete(directory, name)

    def rmdir(self, path: str) -> None:
        """POSIX rmdir: refuses non-empty directories (ENOTEMPTY) —
        never silently recursive like unlink would be."""
        if self.readdir(path):
            raise FuseError(39, f"ENOTEMPTY: {path}")
        directory, name = split_path(path)
        self.stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
            directory=directory, name=name, is_delete_data=False,
            is_recursive=False, signatures=[self.signature]))
        self.meta_cache.delete(directory, name)

    def _update_entry(self, path: str, mutate,
                      touch: bool = True) -> filer_pb2.Entry:
        entry = self.getattr(path)
        e2 = filer_pb2.Entry()
        e2.CopyFrom(entry)
        mutate(e2)
        if touch:
            e2.attributes.mtime = int(time.time())
        directory, name = split_path(path)
        self.stub.UpdateEntry(filer_pb2.UpdateEntryRequest(
            directory=directory, entry=e2,
            signatures=[self.signature]))
        self.meta_cache.insert(directory, e2)
        return e2

    def truncate(self, path: str, length: int) -> None:
        """O_TRUNC / ftruncate: drop chunks past `length`, clamp a
        straddling chunk's visible size (the chunk-interval read path
        honors per-chunk sizes, so no data rewrite is needed)."""
        entry = self.getattr(path)
        if entry.is_directory:
            raise FuseError(21, f"EISDIR: {path}")

        def mutate(e2):
            kept = filechunks.truncate_chunks(e2.chunks, length)
            del e2.chunks[:]
            e2.chunks.extend(kept)
            e2.attributes.file_size = length

        # clamp open handles FIRST: once they hold the trimmed view, a
        # racing flush writes the post-truncate chunk list instead of
        # resurrecting the old one on the filer
        with self._lock:
            handles = [h for h in self._handles.values()
                       if h.path == path]
        for h in handles:
            h.apply_truncate(length)
        self._update_entry(path, mutate)

    def chmod(self, path: str, mode: int) -> None:
        def mutate(e2):
            # preserve the file-type bits (symlinks store S_IFLNK here)
            e2.attributes.file_mode = \
                (e2.attributes.file_mode & ~0o7777) | (mode & 0o7777)
        self._update_entry(path, mutate)

    def chown(self, path: str, uid: int, gid: int) -> None:
        def mutate(e2):
            # FUSE passes -1 (as unsigned 0xffffffff) for "leave as is"
            if uid != 0xFFFFFFFF:
                e2.attributes.uid = uid
            if gid != 0xFFFFFFFF:
                e2.attributes.gid = gid
        self._update_entry(path, mutate)

    def utimens(self, path: str, mtime: int) -> None:
        self._update_entry(
            path, lambda e2: setattr(e2.attributes, "mtime", mtime),
            touch=False)

    # -- symlinks / hardlinks (reference filesys/dir_link.go) -----------------

    def symlink(self, target: str, path: str) -> None:
        directory, name = split_path(path)
        entry = filer_pb2.Entry(name=name)
        entry.attributes.file_mode = stat_mod.S_IFLNK | 0o777
        entry.attributes.symlink_target = target
        entry.attributes.crtime = int(time.time())
        entry.attributes.mtime = entry.attributes.crtime
        entry.attributes.uid = os.getuid()
        entry.attributes.gid = os.getgid()
        self.stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory=directory, entry=entry,
            signatures=[self.signature]))
        self.meta_cache.insert(directory, entry)

    def readlink(self, path: str) -> str:
        entry = self.getattr(path)
        if not stat_mod.S_ISLNK(entry.attributes.file_mode):
            raise FuseError(22, f"EINVAL: {path} is not a symlink")
        return entry.attributes.symlink_target

    HARD_LINK_MARKER = b"\x01"

    def link(self, old: str, new: str) -> None:
        """Hard link: both entries share a hard_link_id; the filer
        stores the chunk list once under that id (reference
        dir_link.go Link + filer/filerstore hardlink metadata)."""
        old_entry = self.getattr(old)
        if old_entry.is_directory:
            raise FuseError(1, f"EPERM: cannot hardlink directory {old}")
        e2 = filer_pb2.Entry()
        e2.CopyFrom(old_entry)
        if not e2.hard_link_id:
            e2.hard_link_id = os.urandom(16) + self.HARD_LINK_MARKER
            e2.hard_link_counter = 1
        e2.hard_link_counter += 1
        od, _ = split_path(old)
        self.stub.UpdateEntry(filer_pb2.UpdateEntryRequest(
            directory=od, entry=e2,
            signatures=[self.signature]))
        self.meta_cache.insert(od, e2)
        nd, nn = split_path(new)
        ne = filer_pb2.Entry(
            name=nn, is_directory=False,
            hard_link_id=e2.hard_link_id,
            hard_link_counter=e2.hard_link_counter)
        ne.attributes.CopyFrom(e2.attributes)
        ne.chunks.extend(e2.chunks)
        for k, v in e2.extended.items():
            ne.extended[k] = v
        self.stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory=nd, entry=ne,
            signatures=[self.signature]))
        self.meta_cache.insert(nd, ne)

    # -- xattrs (reference filesys/xattr.go) ----------------------------------

    XATTR_CREATE = 1
    XATTR_REPLACE = 2

    def setxattr(self, path: str, name: str, value: bytes,
                 flags: int = 0) -> None:
        def mutate(e2):
            exists = name in e2.extended
            if flags == self.XATTR_CREATE and exists:
                raise FuseError(17, f"EEXIST: xattr {name}")
            if flags == self.XATTR_REPLACE and not exists:
                raise FuseError(61, f"ENODATA: xattr {name}")
            e2.extended[name] = value
        self._update_entry(path, mutate)

    def getxattr(self, path: str, name: str) -> bytes:
        entry = self.getattr(path)
        if name not in entry.extended:
            raise FuseError(61, f"ENODATA: xattr {name}")
        return bytes(entry.extended[name])

    def listxattr(self, path: str) -> List[str]:
        return sorted(self.getattr(path).extended.keys())

    def removexattr(self, path: str, name: str) -> None:
        def mutate(e2):
            if name not in e2.extended:
                raise FuseError(61, f"ENODATA: xattr {name}")
            del e2.extended[name]
        self._update_entry(path, mutate)

    def rename(self, old: str, new: str) -> None:
        od, on = split_path(old)
        nd, nn = split_path(new)
        try:
            self.stub.AtomicRenameEntry(filer_pb2.AtomicRenameEntryRequest(
                old_directory=od, old_name=on,
                new_directory=nd, new_name=nn))
        except rpc.RpcError as e:
            raise FuseError(2, f"rename {old}: {e}") from None
        self.meta_cache.delete(od, on)
        # mirror the move synchronously; the subscription would also
        # deliver it, but callers expect the new name immediately
        try:
            moved = self.stub.LookupDirectoryEntry(
                filer_pb2.LookupDirectoryEntryRequest(
                    directory=nd, name=nn)).entry
            self.meta_cache.insert(nd, moved)
        except rpc.RpcError:
            pass
