"""In-memory FilerStore: dict of sorted directories. The test/default
store, and the model for the SPI semantics."""

from __future__ import annotations

import threading
from typing import Dict, List

from seaweedfs_tpu_torch.filer.filerstore import FilerStore, NotFound, normalize_path
from seaweedfs_tpu_torch.pb import filer_pb2


class MemoryStore(FilerStore):
    name = "memory"

    def __init__(self):
        self._lock = threading.RLock()
        self._dirs: Dict[str, Dict[str, bytes]] = {}
        self._kv: Dict[bytes, bytes] = {}

    def insert_entry(self, directory, entry):
        directory = normalize_path(directory)
        with self._lock:
            self._dirs.setdefault(directory, {})[entry.name] = \
                entry.SerializeToString()

    update_entry = insert_entry

    def find_entry(self, directory, name):
        directory = normalize_path(directory)
        with self._lock:
            blob = self._dirs.get(directory, {}).get(name)
        if blob is None:
            raise NotFound(f"{directory}/{name}")
        e = filer_pb2.Entry()
        e.ParseFromString(blob)
        return e

    def delete_entry(self, directory, name):
        directory = normalize_path(directory)
        with self._lock:
            self._dirs.get(directory, {}).pop(name, None)

    def delete_folder_children(self, directory):
        directory = normalize_path(directory)
        with self._lock:
            prefix = directory if directory.endswith("/") else directory + "/"
            for d in [d for d in self._dirs
                      if d == directory or d.startswith(prefix)]:
                del self._dirs[d]

    def list_directory_entries(self, directory, start_name="",
                               inclusive=False, limit=1024, prefix=""):
        directory = normalize_path(directory)
        with self._lock:
            names = sorted(self._dirs.get(directory, {}))
            out: List[filer_pb2.Entry] = []
            for n in names:
                if prefix and not n.startswith(prefix):
                    continue
                if start_name:
                    if n < start_name or (n == start_name and not inclusive):
                        continue
                e = filer_pb2.Entry()
                e.ParseFromString(self._dirs[directory][n])
                out.append(e)
                if len(out) >= limit:
                    break
            return out

    def begin_transaction(self):
        self._lock.acquire()

    def commit_transaction(self):
        self._lock.release()

    def rollback_transaction(self):
        self._lock.release()

    def kv_put(self, key, value):
        with self._lock:
            self._kv[bytes(key)] = bytes(value)

    def kv_get(self, key):
        with self._lock:
            return self._kv.get(bytes(key))
