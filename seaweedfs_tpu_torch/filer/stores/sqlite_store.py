"""SQLite FilerStore — the embedded persistent backend, now a thin
flavor of the shared abstract-SQL layer (reference
weed/filer/abstract_sql/abstract_sql_store.go; sqlite is the in-image
proof that the shared layer works — mysql/postgres are sibling
subclasses in abstract_sql.py gated on their drivers).
"""

from __future__ import annotations

import os
import sqlite3

from seaweedfs_tpu_torch.filer.stores.abstract_sql import AbstractSqlStore


class SqliteStore(AbstractSqlStore):
    name = "sqlite"

    def __init__(self, path: str = ":memory:"):
        self._path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        super().__init__()
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._migrate_legacy()

    def _migrate_legacy(self) -> None:
        """Upgrade a filer.db of the older layout in place: the filemeta table
        gained a dirhash PK column (caller holds the lock)."""
        cols = [r[1] for r in self._conn.execute(
            "PRAGMA table_info(filemeta)")]
        if "dirhash" in cols:
            return
        self._conn.executescript("""
            ALTER TABLE filemeta RENAME TO filemeta_v2;
        """)
        for stmt in self.create_tables:
            self._conn.execute(stmt)
        for directory, name, meta in self._conn.execute(
                "SELECT directory, name, meta FROM filemeta_v2"):
            self._conn.execute(
                self.upsert_sql,
                (self._dirhash(directory), directory, name, meta))
        self._conn.execute("DROP TABLE filemeta_v2")
        self._conn.commit()

    def _connect(self):
        # one connection guarded by the layer's lock: sqlite serializes
        # writers anyway, and this keeps transactions coherent across
        # threads
        return sqlite3.connect(self._path, check_same_thread=False)
