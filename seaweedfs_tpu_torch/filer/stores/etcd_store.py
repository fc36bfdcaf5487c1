"""etcd FilerStore over the JSON gateway client: the port of
``seaweedfs_tpu.filer.stores.etcd_store`` (reference
weed/filer/etcd/etcd_store.go: full path as the key, prefix ranges for
listings). The client is ``util/etcd_client.py``.
"""

from __future__ import annotations

from typing import List

from seaweedfs_tpu_torch.filer.filerstore import (FilerStore, NotFound,
                                            join_path, normalize_path)
from seaweedfs_tpu_torch.pb import filer_pb2
from seaweedfs_tpu_torch.util.etcd_client import EtcdClient, prefix_range_end

KEY_PREFIX = b"seaweedfs_meta"
KV_PREFIX = b"seaweedfs_kv"


class EtcdStore(FilerStore):
    name = "etcd"

    def __init__(self, endpoint: str = "127.0.0.1:2379",
                 timeout: float = 10.0):
        self.client = EtcdClient(endpoint, timeout=timeout)

    @staticmethod
    def _key(directory: str, name: str) -> bytes:
        return KEY_PREFIX + join_path(
            normalize_path(directory), name).encode()

    def insert_entry(self, directory, entry):
        self.client.put(self._key(directory, entry.name),
                        entry.SerializeToString())

    update_entry = insert_entry

    def find_entry(self, directory, name):
        blob = self.client.get(self._key(directory, name))
        if blob is None:
            raise NotFound(join_path(normalize_path(directory), name))
        e = filer_pb2.Entry()
        e.ParseFromString(blob)
        return e

    def delete_entry(self, directory, name):
        self.client.delete_range(self._key(directory, name))

    def delete_folder_children(self, directory):
        prefix = KEY_PREFIX + \
            (normalize_path(directory).rstrip("/") + "/").encode()
        self.client.delete_range(prefix, prefix_range_end(prefix))

    def list_directory_entries(self, directory, start_name="",
                               inclusive=False, limit=1024, prefix=""):
        """Paged ranges, not one whole-subtree fetch: the range starts
        at max(prefix, start_name) and pulls bounded pages, so listing
        a huge tree costs O(page) per call, not O(subtree)."""
        dir_prefix = KEY_PREFIX + \
            (normalize_path(directory).rstrip("/") + "/").encode()
        end = prefix_range_end(dir_prefix)
        start = dir_prefix + max(prefix, start_name).encode()
        out: List[filer_pb2.Entry] = []
        page = max(limit, 256)
        while len(out) < limit:
            kvs = self.client.range(start, end, limit=page)
            if not kvs:
                break
            for key, blob in kvs:
                name = key[len(dir_prefix):].decode()
                if prefix and not name.startswith(prefix):
                    if name > prefix:
                        return out  # sorted: nothing more can match
                    continue
                if "/" in name:
                    continue  # grandchild key: not an immediate child
                if start_name and name == start_name and not inclusive:
                    continue
                e = filer_pb2.Entry()
                e.ParseFromString(blob)
                out.append(e)
                if len(out) >= limit:
                    break
            if len(kvs) < page:
                break
            start = kvs[-1][0] + b"\x00"
        return out

    def kv_put(self, key, value):
        self.client.put(KV_PREFIX + bytes(key), bytes(value))

    def kv_get(self, key):
        return self.client.get(KV_PREFIX + bytes(key))

    def close(self):
        pass
