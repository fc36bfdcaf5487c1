"""Filer core: path→Entry CRUD over a FilerStore, with parent-dir
auto-creation, recursive delete, atomic rename, TTL expiry, buckets,
and the metadata event log (reference: weed/filer/filer.go:30-300,
filer_rename.go, filer_delete_entry.go, filer_buckets.go).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from seaweedfs_tpu_torch.filer import filechunk_manifest, filechunks
from seaweedfs_tpu_torch.filer import filer_notify as filer_notify_mod
from seaweedfs_tpu_torch.filer.filer_notify import MetaLog
from seaweedfs_tpu_torch.filer.filerstore import (
    FilerStore, FilerStoreWrapper, NotFound, join_path, normalize_path,
    split_path,
)
from seaweedfs_tpu_torch.pb import filer_pb2

DIR_BUCKETS = "/buckets"


class FilerError(Exception):
    pass


def _now() -> int:
    return int(time.time())


def new_entry(name: str, is_directory: bool = False, mode: int = 0o770,
              uid: int = 0, gid: int = 0, mime: str = "",
              ttl_sec: int = 0, collection: str = "",
              replication: str = "") -> filer_pb2.Entry:
    e = filer_pb2.Entry(name=name, is_directory=is_directory)
    now = _now()
    e.attributes.crtime = now
    e.attributes.mtime = now
    e.attributes.file_mode = mode | (0o20000000000 if is_directory else 0)
    e.attributes.uid = uid
    e.attributes.gid = gid
    e.attributes.mime = mime
    e.attributes.ttl_sec = ttl_sec
    e.attributes.collection = collection
    e.attributes.replication = replication
    return e


def entry_expired(entry: filer_pb2.Entry, now: Optional[int] = None) -> bool:
    ttl = entry.attributes.ttl_sec
    if ttl <= 0:
        return False
    base = entry.attributes.crtime or entry.attributes.mtime
    return (now or _now()) > base + ttl


class Filer:
    def __init__(self, store: FilerStore, log_dir: Optional[str] = None,
                 flush_seconds: float = 2.0):
        self.store = FilerStoreWrapper(store)
        self.meta_log = MetaLog(log_dir, flush_seconds=flush_seconds)
        # appends are a read-modify-write of one entry: concurrent ones
        # to the same file would each keep only their own chunks
        # (upstream takes a lock around AppendToEntry for this)
        self._append_lock = threading.Lock()
        # blobs of deleted/shadowed entries are handed to this hook
        # (wired to operation.delete_files by the filer server)
        self.on_delete_chunks: Callable[[List[filer_pb2.FileChunk]], None] = \
            lambda chunks: None
        # chunk-bytes reader used to expand manifest chunks before delete
        # (wired to the read path by the filer server; without it only the
        # manifest blob itself can be GCed)
        self.fetch_chunk_fn: Optional[
            Callable[[filer_pb2.FileChunk], bytes]] = None
        # optional external queue: every event also published there
        # (reference filer.notify → weed/notification)
        self.notification_queue = None
        # store signature for multi-filer loop prevention + merged-view
        # fast path (wired by FilerServer / MetaAggregator)
        self.signature: int = 0
        self.on_meta_event: Optional[Callable[[], None]] = None
        # listing cache (-meta.listingCacheMB): ABSENT — not merely
        # empty — unless attached, so the disabled list path is one
        # None check (attach_listing_cache wires the event log to it)
        self.listing_cache = None

    def attach_listing_cache(self, cache) -> None:
        """Arm the listing cache: list_entries consults it, and the
        METADATA EVENT LOG invalidates it — every appended event fires
        the log's on_append hook into the cache, so a listing served
        from cache can never predate the newest recorded mutation of
        its directory (filer/listing_cache.py)."""
        self.listing_cache = cache
        self.meta_log.on_append = \
            lambda directory, ev: cache.apply_event(directory, ev,
                                                    reason="local")

    def _delete_chunks(self, chunks: List[filer_pb2.FileChunk]) -> None:
        """Hand chunks to the GC hook, expanding manifest chunks first.

        For manifestized files (>1000 chunks) the entry holds only
        manifest-blob chunks; the data chunks they reference must be
        resolved and deleted too, or they are orphaned forever
        (reference: weed/filer/filer_delete_entry.go ResolveChunkManifest).
        The manifest blobs themselves stay in the delete list.
        """
        if (self.fetch_chunk_fn is not None
                and filechunk_manifest.has_chunk_manifest(chunks)):
            manifests, _ = filechunk_manifest.separate_manifest_chunks(chunks)
            try:
                chunks = filechunk_manifest.resolve_chunk_manifest(
                    self.fetch_chunk_fn, list(chunks)) + manifests
            except Exception:
                # delete what we can rather than fail the namespace op
                from seaweedfs_tpu_torch.stats import metrics
                metrics.swallowed("filer.resolve_manifest")
        self.on_delete_chunks(chunks)

    # -- event log ------------------------------------------------------------

    def _notify(self, directory: str,
                old: Optional[filer_pb2.Entry],
                new: Optional[filer_pb2.Entry],
                delete_chunks: bool = False,
                new_parent_path: str = "",
                from_other_cluster: bool = False,
                signatures=()) -> None:
        ev = filer_pb2.EventNotification(
            delete_chunks=delete_chunks,
            is_from_other_cluster=from_other_cluster)
        # client signatures ride the event so the ORIGINATING mount can
        # skip its own echo instead of clobbering newer local state
        # (reference filer_grpc_server.go passes req.Signatures through)
        ev.signatures.extend(signatures)
        if old is not None:
            ev.old_entry.CopyFrom(old)
        if new is not None:
            ev.new_entry.CopyFrom(new)
        if new_parent_path:
            ev.new_parent_path = new_parent_path
        if self.signature:
            # store-signature loop guard: peers recognize and drop this
            # filer's own events (reference meta_aggregator.go:94-118)
            ev.signatures.append(self.signature)
        self.meta_log.append_event(directory, ev)
        if self.on_meta_event is not None:
            try:
                self.on_meta_event()  # wake merged-view subscribers
            except Exception:
                # the merged view is best-effort; local log is canonical
                from seaweedfs_tpu_torch.stats import metrics
                metrics.swallowed("filer.meta_event_wake")
        if self.notification_queue is not None:
            try:
                self.notification_queue.send_message(
                    filer_notify_mod.event_key(directory, ev), ev)
            except Exception:
                # the write already committed; a broken external queue
                # must not turn it into a client-visible failure —
                # but it must be VISIBLE on dashboards
                from seaweedfs_tpu_torch.stats import metrics
                metrics.swallowed("filer.notify_queue")

    # -- CRUD -----------------------------------------------------------------

    def create_entry(self, directory: str, entry: filer_pb2.Entry,
                     o_excl: bool = False,
                     from_other_cluster: bool = False,
                     signatures=()) -> None:
        directory = normalize_path(directory)
        self._ensure_parents(directory, from_other_cluster)
        old = None
        try:
            old = self.store.find_entry(directory, entry.name)
        except NotFound:
            pass
        if old is not None:
            if o_excl:
                raise FilerError(
                    f"EEXIST: {join_path(directory, entry.name)}")
            if old.is_directory and not entry.is_directory:
                raise FilerError(
                    f"existing directory {join_path(directory, entry.name)}")
        if not entry.attributes.crtime:
            entry.attributes.crtime = _now()
        if not entry.attributes.mtime:
            entry.attributes.mtime = _now()
        self.store.insert_entry(directory, entry)
        self._notify(directory, old, entry,
                     from_other_cluster=from_other_cluster,
                     signatures=signatures)
        if old is not None and not old.is_directory:
            unused = filechunks.find_unused_file_chunks(
                list(old.chunks), list(entry.chunks))
            if unused:
                self._delete_chunks(unused)

    def _ensure_parents(self, directory: str,
                        from_other_cluster: bool = False) -> None:
        if directory == "/":
            return
        parent, name = split_path(directory)
        try:
            e = self.store.find_entry(parent, name)
            if not e.is_directory:
                raise FilerError(f"{directory} exists as a file")
            return
        except NotFound:
            pass
        self._ensure_parents(parent, from_other_cluster)
        d = new_entry(name, is_directory=True)
        self.store.insert_entry(parent, d)
        self._notify(parent, None, d,
                     from_other_cluster=from_other_cluster)

    def find_entry(self, full_path: str) -> filer_pb2.Entry:
        directory, name = split_path(full_path)
        if name == "":  # root
            return new_entry("/", is_directory=True)
        e = self.store.find_entry(directory, name)
        if entry_expired(e):
            # lazy TTL expiry like the reference: purge and report missing
            self.store.delete_entry(directory, name)
            if e.chunks:
                self._delete_chunks(list(e.chunks))
            raise NotFound(full_path)
        return e

    def update_entry(self, directory: str, entry: filer_pb2.Entry,
                     from_other_cluster: bool = False,
                     signatures=()) -> None:
        directory = normalize_path(directory)
        old = None
        try:
            old = self.store.find_entry(directory, entry.name)
        except NotFound:
            pass
        self.store.update_entry(directory, entry)
        self._notify(directory, old, entry,
                     from_other_cluster=from_other_cluster,
                     signatures=signatures)
        if old is not None and not old.is_directory:
            unused = filechunks.find_unused_file_chunks(
                list(old.chunks), list(entry.chunks))
            if unused:
                self._delete_chunks(unused)

    def append_chunks(self, full_path: str,
                      chunks: List[filer_pb2.FileChunk]) -> filer_pb2.Entry:
        directory, name = split_path(full_path)
        with self._append_lock:
            try:
                e = self.store.find_entry(directory, name)
            except NotFound:
                self._ensure_parents(directory)
                e = new_entry(name)
            offset = filechunks.total_size(e.chunks)
            for c in chunks:
                nc = e.chunks.add()
                nc.CopyFrom(c)
                nc.offset = offset
                offset += c.size
            e.attributes.mtime = _now()
            self.store.insert_entry(directory, e)  # upsert
            self._notify(directory, None, e)
        return e

    def list_entries(self, directory: str, start_name: str = "",
                     inclusive: bool = False, limit: int = 1024,
                     prefix: str = "") -> List[filer_pb2.Entry]:
        directory = normalize_path(directory)
        cache = self.listing_cache
        if cache is not None:
            page = cache.get(directory, start_name, inclusive, limit,
                             prefix)
            if page is None:
                # generation BEFORE the walk: a mutation landing
                # mid-walk bumps it and the put below is refused —
                # the cache can never hold a page older than the
                # newest logged event of this directory
                gen = cache.generation(directory)
                from seaweedfs_tpu_torch.stats import trace
                sp = trace.span("meta.listing_fill", dir=directory) \
                    if trace.is_enabled() else trace.NOOP
                with sp:
                    page = list(self.store.list_directory_entries(
                        directory, start_name, inclusive, limit,
                        prefix))
                cache.put(directory, start_name, inclusive, limit,
                          prefix, page, gen)
            # the TTL-expiry filter runs on EVERY serve (hit or miss):
            # lazy expiry emits no event, so cached raw pages may
            # still hold entries whose clock ran out
            now = _now()
            return [e for e in page if not entry_expired(e, now)]
        out = []
        now = _now()
        for e in self.store.list_directory_entries(
                directory, start_name, inclusive, limit, prefix):
            if entry_expired(e, now):
                continue
            out.append(e)
        return out

    # -- delete ---------------------------------------------------------------

    def delete_entry(self, full_path: str, recursive: bool = False,
                     ignore_recursive_error: bool = False,
                     delete_data: bool = True,
                     from_other_cluster: bool = False,
                     signatures=()) -> None:
        directory, name = split_path(full_path)
        try:
            entry = self.store.find_entry(directory, name)
        except NotFound:
            return
        chunks: List[filer_pb2.FileChunk] = []
        if entry.is_directory:
            chunks.extend(self._collect_children(
                join_path(directory, name), recursive,
                ignore_recursive_error))
            self.store.delete_folder_children(join_path(directory, name))
        self.store.delete_entry(directory, name)
        # hardlinked entries share their chunks: the wrapper just
        # dropped this link's reference — only the LAST unlink may
        # delete the data (reference filer_delete_entry.go checks the
        # hard link counter the same way)
        if not entry.hard_link_id or \
                self.store.hardlink_counter(entry.hard_link_id) == 0:
            chunks.extend(entry.chunks)
        self._notify(directory, entry, None, delete_chunks=delete_data,
                     from_other_cluster=from_other_cluster,
                     signatures=signatures)
        if delete_data and chunks:
            self._delete_chunks(chunks)

    def _collect_children(self, directory: str, recursive: bool,
                          ignore_error: bool) -> List[filer_pb2.FileChunk]:
        children = self.store.list_directory_entries(directory,
                                                     limit=1 << 31)
        if children and not recursive:
            raise FilerError(f"ENOTEMPTY: {directory}")
        chunks: List[filer_pb2.FileChunk] = []
        for c in children:
            if c.is_directory:
                try:
                    chunks.extend(self._collect_children(
                        join_path(directory, c.name), recursive,
                        ignore_error))
                except FilerError:
                    if not ignore_error:
                        raise
                chunks.extend(c.chunks)
            elif c.hard_link_id:
                # folder wipe bypasses per-entry deletes: account the
                # link here, and reclaim chunks only on the last one
                if self.store.release_hardlink(c.hard_link_id) == 0:
                    chunks.extend(c.chunks)
            else:
                chunks.extend(c.chunks)
        return chunks

    # -- rename ---------------------------------------------------------------

    def atomic_rename(self, old_dir: str, old_name: str,
                      new_dir: str, new_name: str) -> None:
        """Move an entry (and its whole subtree for directories) in one
        store transaction (reference filer_rename.go)."""
        old_dir, new_dir = normalize_path(old_dir), normalize_path(new_dir)
        self.store.begin_transaction()
        try:
            entry = self.store.find_entry(old_dir, old_name)
            self._ensure_parents(new_dir)
            moved = filer_pb2.Entry()
            moved.CopyFrom(entry)
            moved.name = new_name
            moved.attributes.mtime = _now()
            self.store.insert_entry(new_dir, moved)
            if entry.is_directory:
                self._move_children(join_path(old_dir, old_name),
                                    join_path(new_dir, new_name))
            self.store.delete_entry(old_dir, old_name)
        except Exception:
            self.store.rollback_transaction()
            raise
        self.store.commit_transaction()
        self._notify(old_dir, entry, moved, new_parent_path=new_dir)

    def _move_children(self, old_dir: str, new_dir: str) -> None:
        for c in self.store.list_directory_entries(old_dir, limit=1 << 31):
            self.store.insert_entry(new_dir, c)
            if c.is_directory:
                self._move_children(join_path(old_dir, c.name),
                                    join_path(new_dir, c.name))
            self.store.delete_entry(old_dir, c.name)

    # -- buckets --------------------------------------------------------------

    def list_buckets(self) -> List[str]:
        return [e.name for e in self.list_entries(DIR_BUCKETS)
                if e.is_directory]

    def create_bucket(self, name: str) -> None:
        self.create_entry(DIR_BUCKETS, new_entry(name, is_directory=True))

    def delete_bucket(self, name: str) -> None:
        self.delete_entry(join_path(DIR_BUCKETS, name), recursive=True,
                          ignore_recursive_error=True)

    def close(self):
        self.meta_log.close()
        self.store.close()
