"""Filer: the path→entry namespace over the blob store (reference:
weed/filer), the counterpart of ``seaweedfs_tpu.filer``.

Ported: ``Filer`` with its metadata event log (``filer_notify.MetaLog``),
``filer_conf``, the listing cache, chunk intervals and manifests
(``filechunks``, ``filechunk_manifest``), chunk reads (``stream``), the
HTTP client helpers and the ``-peers`` aggregator; the store SPI
(``filerstore``) with the stores that need no outside server: memory,
sqlite (with the mysql/postgres SQL flavours) and weedkv
(``stores.kv_store``, whose ``LogKV`` also backs the volume server's kv
needle map). The networked stores (redis, etcd, mongodb, elastic,
cassandra, hbase) answer with an error naming their ROADMAP item.
"""

from seaweedfs_tpu_torch.filer.filer import Filer, FilerError  # noqa: F401
from seaweedfs_tpu_torch.filer.filerstore import (  # noqa: F401
    FilerStore, FilerStoreWrapper, NotFound,
)
from seaweedfs_tpu_torch.filer.stores.kv_store import KvFilerStore, LogKV  # noqa: F401,E501
from seaweedfs_tpu_torch.filer.stores.memory_store import MemoryStore  # noqa: F401,E501
from seaweedfs_tpu_torch.filer.stores.sqlite_store import SqliteStore  # noqa: F401,E501
