"""Local metadata cache for the mount (reference:
weed/filesys/meta_cache — a local store populated on demand and
invalidated by the filer's SubscribeMetadata stream). The port of
``seaweedfs_tpu_torch.filesys.meta_cache`` on the port's RPC plane."""

from __future__ import annotations

import threading
from typing import List, Optional

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.filer.filerstore import (FilerStoreWrapper,
                                            split_path)
from seaweedfs_tpu_torch.filer.stores.memory_store import MemoryStore
from seaweedfs_tpu_torch.pb import filer_pb2, filer_stub


class MetaCache:
    def __init__(self, filer_url: str, signature: int = 0):
        self.filer_url = filer_url
        # events carrying this signature originated from THIS mount:
        # the local mirror already applied them synchronously, and a
        # lagging echo must not clobber newer local state (reference
        # meta_cache_subscribe.go skips own-signature messages)
        self.signature = signature
        # the wrapper stores hardlinked entries as stubs over shared
        # KV meta, so a flush through one link name is visible through
        # every sibling name (reference meta_cache.go:50 wraps its
        # local store in FilerStoreWrapper for exactly this)
        self.store = FilerStoreWrapper(MemoryStore(),
                                       trust_link_counters=True)
        self._visited = set()          # directories already listed
        self._lock = threading.Lock()
        self._sub_thread: Optional[threading.Thread] = None
        self._sub_call = None
        self._stopping = False

    @property
    def stub(self):
        return filer_stub(self.filer_url)

    # -- read-through ---------------------------------------------------------

    def _ensure_dir(self, directory: str) -> None:
        with self._lock:
            if directory in self._visited:
                return
        try:
            for r in self.stub.ListEntries(filer_pb2.ListEntriesRequest(
                    directory=directory, limit=100000)):
                self.store.insert_entry(directory, r.entry)
        except rpc.RpcError:
            pass
        with self._lock:
            self._visited.add(directory)

    def find_entry(self, full_path: str) -> filer_pb2.Entry:
        directory, name = split_path(full_path)
        if not name:
            return filer_pb2.Entry(name="/", is_directory=True)
        self._ensure_dir(directory)
        return self.store.find_entry(directory, name)

    def list_entries(self, directory: str) -> List[filer_pb2.Entry]:
        self._ensure_dir(directory)
        return self.store.list_directory_entries(directory, limit=1 << 31)

    # -- local mutation mirror ------------------------------------------------

    def insert(self, directory: str, entry: filer_pb2.Entry) -> None:
        self._ensure_dir(directory)
        self.store.insert_entry(directory, entry)

    def delete(self, directory: str, name: str) -> None:
        self.store.delete_entry(directory, name)

    # -- subscription invalidation -------------------------------------------

    def start_subscription(self, since_ns: int = 0) -> None:
        # lint: thread-ok(mount-lifetime invalidation tail; no request context)
        self._sub_thread = threading.Thread(
            target=self._subscribe_loop, args=(since_ns,),
            name="meta-cache-sub", daemon=True)
        self._sub_thread.start()

    def _subscribe_loop(self, since_ns: int) -> None:
        while not self._stopping:
            try:
                self._sub_call = self.stub.SubscribeMetadata(
                    filer_pb2.SubscribeMetadataRequest(
                        client_name="mount", since_ns=since_ns,
                        signature=self.signature))
                for rec in self._sub_call:
                    self._apply(rec)
                    since_ns = max(since_ns, rec.ts_ns)
                    if self._stopping:
                        return
            except rpc.RpcError:
                if self._stopping:
                    return
                import time
                time.sleep(0.2)

    def _apply(self, rec: filer_pb2.SubscribeMetadataResponse) -> None:
        ev = rec.event_notification
        if self.signature and self.signature in ev.signatures:
            return  # own echo: already applied locally at mutation time
        directory = rec.directory
        if ev.old_entry.name and (
                not ev.new_entry.name
                or ev.new_entry.name != ev.old_entry.name
                or ev.new_parent_path not in ("", directory)):
            self.store.delete_entry(directory, ev.old_entry.name)
        if ev.new_entry.name:
            target_dir = ev.new_parent_path or directory
            with self._lock:
                known = target_dir in self._visited
            if known:
                self.store.insert_entry(target_dir, ev.new_entry)

    def stop(self) -> None:
        self._stopping = True
        if self._sub_call is not None:
            self._sub_call.cancel()
