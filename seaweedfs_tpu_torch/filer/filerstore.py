"""FilerStore SPI: pluggable metadata backends
(reference: weed/filer/filerstore.go:18-41 + filerstore_wrapper.go).

A store maps (directory, name) → serialized filer_pb2.Entry. Directory
listings iterate names in lexicographic order. Transactions gate the
atomic-rename subtree move; stores without real transactions provide a
coarse lock.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from seaweedfs_tpu_torch.pb import filer_pb2
from seaweedfs_tpu_torch.stats.metrics import REGISTRY

# lint: metric-ok(reference family name predates the lowercase rule; renaming breaks dashboards)
FilerStoreCounter = REGISTRY.counter(
    "SeaweedFS_filerStore_request_total", "filer store ops",
    ("store", "op"))


class NotFound(KeyError):
    pass


def split_path(full_path: str) -> Tuple[str, str]:
    """"/a/b/c" → ("/a/b", "c"); "/" → ("/", "")."""
    full_path = normalize_path(full_path)
    if full_path == "/":
        return "/", ""
    d, _, name = full_path.rpartition("/")
    return d or "/", name


def normalize_path(p: str) -> str:
    if not p.startswith("/"):
        p = "/" + p
    while "//" in p:
        p = p.replace("//", "/")
    if len(p) > 1 and p.endswith("/"):
        p = p[:-1]
    return p


def join_path(directory: str, name: str) -> str:
    return normalize_path(f"{directory}/{name}")


class FilerStore:
    """SPI. Entries are filer_pb2.Entry; the store persists
    SerializeToString bytes and must not mutate them."""

    name = "abstract"

    def insert_entry(self, directory: str, entry: filer_pb2.Entry) -> None:
        raise NotImplementedError

    def update_entry(self, directory: str, entry: filer_pb2.Entry) -> None:
        raise NotImplementedError

    def find_entry(self, directory: str, name: str) -> filer_pb2.Entry:
        raise NotImplementedError  # NotFound when missing

    def delete_entry(self, directory: str, name: str) -> None:
        raise NotImplementedError

    def delete_folder_children(self, directory: str) -> None:
        raise NotImplementedError

    def list_directory_entries(self, directory: str, start_name: str = "",
                               inclusive: bool = False, limit: int = 1024,
                               prefix: str = "") -> List[filer_pb2.Entry]:
        raise NotImplementedError

    # transactions (subtree rename); default: coarse re-entrant lock
    def begin_transaction(self) -> None:
        pass

    def commit_transaction(self) -> None:
        pass

    def rollback_transaction(self) -> None:
        pass

    # KV (used by weed mount + msg broker bookkeeping)
    def kv_put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def kv_get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


HARD_LINK_MARKER = b"\x01hardlink\x00"


class FilerStoreWrapper(FilerStore):
    """Counts ops per store (filerstore_wrapper.go) and resolves
    hardlinked entries (filerstore_hardlink.go): directory entries with
    a hard_link_id are stored as stubs; the shared metadata (chunks,
    attributes, link counter) lives once in the store's KV space, so
    every link sees one consistent inode and the last unlink reclaims
    it."""

    def __init__(self, store: FilerStore, trust_link_counters: bool = False):
        # trust_link_counters: store the incoming entry's
        # hard_link_counter verbatim instead of recomputing locally —
        # the mount's MetaCache mirrors the filer's authoritative
        # counters (reference meta_cache wraps its local store in
        # FilerStoreWrapper and setHardLink stores the entry as sent,
        # filerstore_hardlink.go:38-50)
        self.store = store
        self.name = store.name
        self.trust_link_counters = trust_link_counters

    def _count(self, op: str):
        FilerStoreCounter.labels(self.name, op).inc()

    # -- hardlink plumbing ---------------------------------------------------

    @staticmethod
    def _hl_key(hard_link_id: bytes) -> bytes:
        return HARD_LINK_MARKER + bytes(hard_link_id)

    def _read_hl_meta(self, hard_link_id: bytes):
        blob = self.store.kv_get(self._hl_key(hard_link_id))
        if not blob:  # absent or reclaimed (empty tombstone)
            return None
        meta = filer_pb2.Entry()
        meta.ParseFromString(blob)
        return meta

    def _write_hardlink(self, directory, entry, old) -> None:
        """Store shared meta in KV, a stub in the directory
        (filerstore_hardlink.go maybeUpdateHardLink). `old` is the
        pre-fetched previous directory entry (or None) — a name newly
        pointed at this link id counts as a new reference."""
        meta = self._read_hl_meta(entry.hard_link_id)
        counter = meta.hard_link_counter if meta is not None else 0
        is_new_link = old is None or \
            bytes(old.hard_link_id) != bytes(entry.hard_link_id)
        full = filer_pb2.Entry()
        full.CopyFrom(entry)
        if self.trust_link_counters:
            full.hard_link_counter = entry.hard_link_counter or \
                max(counter, 1)
        else:
            full.hard_link_counter = counter + 1 if is_new_link else \
                max(counter, 1)
        self.store.kv_put(self._hl_key(entry.hard_link_id),
                          full.SerializeToString())
        stub = filer_pb2.Entry(name=entry.name,
                               is_directory=entry.is_directory,
                               hard_link_id=bytes(entry.hard_link_id))
        self.store.insert_entry(directory, stub)

    def hardlink_counter(self, hard_link_id: bytes) -> int:
        meta = self._read_hl_meta(hard_link_id)
        return meta.hard_link_counter if meta is not None else 0

    def release_hardlink(self, hard_link_id: bytes) -> int:
        """Drop one reference; reclaim the shared meta at zero.
        Returns the remaining counter."""
        meta = self._read_hl_meta(hard_link_id)
        if meta is None:
            return 0
        meta.hard_link_counter -= 1
        if meta.hard_link_counter <= 0:
            self.store.kv_put(self._hl_key(hard_link_id), b"")
            return 0
        self.store.kv_put(self._hl_key(hard_link_id),
                          meta.SerializeToString())
        return meta.hard_link_counter

    def _resolve(self, entry):
        if entry is None or not entry.hard_link_id:
            return entry
        meta = self._read_hl_meta(entry.hard_link_id)
        if meta is None:
            return entry  # dangling link: serve the stub
        resolved = filer_pb2.Entry()
        resolved.CopyFrom(meta)
        resolved.name = entry.name
        return resolved

    # -- SPI -----------------------------------------------------------------

    def insert_entry(self, directory, entry):
        self._count("insert")
        # replacing a stub that pointed at a DIFFERENT link must drop
        # that link's reference, or its shared meta leaks forever
        try:
            old = self.store.find_entry(directory, entry.name)
        except NotFound:
            old = None
        if old is not None and old.hard_link_id and \
                bytes(old.hard_link_id) != bytes(entry.hard_link_id):
            self.release_hardlink(old.hard_link_id)
        if entry.hard_link_id:
            self._write_hardlink(directory, entry, old)
        else:
            self.store.insert_entry(directory, entry)

    def update_entry(self, directory, entry):
        self._count("update")
        try:
            old = self.store.find_entry(directory, entry.name)
        except NotFound:
            old = None
        if old is not None and old.hard_link_id and \
                bytes(old.hard_link_id) != bytes(entry.hard_link_id):
            self.release_hardlink(old.hard_link_id)
        if entry.hard_link_id:
            # same path as insert: counts a newly-pointed name as a
            # reference and replaces the directory record with a stub
            self._write_hardlink(directory, entry, old)
        else:
            self.store.update_entry(directory, entry)

    def find_entry(self, directory, name):
        self._count("find")
        return self._resolve(self.store.find_entry(directory, name))

    def delete_entry(self, directory, name):
        self._count("delete")
        try:
            raw = self.store.find_entry(directory, name)
        except NotFound:
            raw = None
        if raw is not None and raw.hard_link_id:
            self.release_hardlink(raw.hard_link_id)
        self.store.delete_entry(directory, name)

    def delete_folder_children(self, directory):
        self._count("deleteFolderChildren")
        self.store.delete_folder_children(directory)

    def list_directory_entries(self, directory, start_name="",
                               inclusive=False, limit=1024, prefix=""):
        self._count("list")
        return [self._resolve(e) for e in self.store.list_directory_entries(
            directory, start_name, inclusive, limit, prefix)]

    def begin_transaction(self):
        self.store.begin_transaction()

    def commit_transaction(self):
        self.store.commit_transaction()

    def rollback_transaction(self):
        self.store.rollback_transaction()

    def kv_put(self, key, value):
        self.store.kv_put(key, value)

    def kv_get(self, key):
        return self.store.kv_get(key)

    def close(self):
        self.store.close()
