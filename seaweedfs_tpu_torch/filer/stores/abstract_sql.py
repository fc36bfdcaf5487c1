"""Shared SQL FilerStore layer (reference
weed/filer/abstract_sql/abstract_sql_store.go): every SQL-server-class
backend is ONE schema — `filemeta(directory, name, meta)` plus a
`filekv(k, v)` table — and a handful of statements; concrete backends
only supply a DB-API connection and flavor strings.

Backends in-image: sqlite (stdlib, the embedded default). MySQL and
Postgres are config-only subclasses that import their drivers lazily
and raise a clear error when the driver is absent (same gating pattern
as the notification queue factories).
"""

from __future__ import annotations

import hashlib
import struct
import threading
from typing import List

from seaweedfs_tpu_torch.filer.filerstore import FilerStore, NotFound, normalize_path
from seaweedfs_tpu_torch.pb import filer_pb2


class AbstractSqlStore(FilerStore):
    """DB-API-2 driven store. Subclasses set:

    - `paramstyle`: "qmark" (?) or "format" (%s)
    - `upsert_sql`: flavor-specific insert-or-replace for filemeta
    - `kv_upsert_sql`: same for filekv
    and provide a live connection via `_connect()`.
    """

    paramstyle = "qmark"
    upsert_sql = "INSERT OR REPLACE INTO filemeta VALUES ({p},{p},{p},{p})"
    kv_upsert_sql = "INSERT OR REPLACE INTO filekv VALUES ({p},{p})"
    # reference abstract_sql schema shape: the primary key is
    # (dirhash BIGINT, name) so it stays under index-size limits
    # (a (directory,name) PK at utf8mb4 overflows InnoDB's 3072B cap),
    # and directory itself is unbounded TEXT
    create_tables = [
        "CREATE TABLE IF NOT EXISTS filemeta ("
        " dirhash BIGINT NOT NULL,"
        " directory TEXT NOT NULL,"
        " name VARCHAR(512) NOT NULL,"
        " meta BLOB NOT NULL,"
        " PRIMARY KEY (dirhash, name))",
        "CREATE TABLE IF NOT EXISTS filekv ("
        " k VARBINARY(512) PRIMARY KEY,"
        " v BLOB NOT NULL)",
    ]
    # sqlite/postgres need an explicit ESCAPE clause; mysql's default
    # LIKE escape already IS backslash, and the literal '\\' would be
    # an unterminated string under its default sql_mode
    escape_clause = "ESCAPE '\\'"

    def __init__(self):
        self._conn = self._connect()
        self._lock = threading.RLock()
        self._in_tx = 0
        p = self._p
        with self._lock:
            for stmt in self.create_tables:
                self._exec(stmt)
            self._commit()
        self.upsert_sql = self.upsert_sql.format(p=p)
        self.kv_upsert_sql = self.kv_upsert_sql.format(p=p)

    # -- flavor hooks --------------------------------------------------------

    def _connect(self):
        raise NotImplementedError

    @property
    def _p(self) -> str:
        return "?" if self.paramstyle == "qmark" else "%s"

    def _exec(self, sql: str, args: tuple = ()):  # requires(self._lock)
        cur = self._conn.cursor()
        cur.execute(sql, args)
        return cur

    def _commit(self):  # requires(self._lock)
        self._conn.commit()

    def _maybe_commit(self):  # requires(self._lock)
        if not self._in_tx:
            self._commit()

    # -- FilerStore SPI ------------------------------------------------------

    @staticmethod
    def _dirhash(directory: str) -> int:
        """Stable signed 64-bit hash of the parent path (reference
        abstract_sql util.HashStringToLong)."""
        digest = hashlib.md5(directory.encode()).digest()
        return struct.unpack(">q", digest[:8])[0]

    def insert_entry(self, directory, entry):
        directory = normalize_path(directory)
        with self._lock:
            self._exec(self.upsert_sql,
                       (self._dirhash(directory), directory, entry.name,
                        entry.SerializeToString()))
            self._maybe_commit()

    update_entry = insert_entry

    def find_entry(self, directory, name):
        directory = normalize_path(directory)
        p = self._p
        with self._lock:
            row = self._exec(
                f"SELECT meta FROM filemeta WHERE dirhash={p} "
                f"AND directory={p} AND name={p}",
                (self._dirhash(directory), directory, name)).fetchone()
        if row is None:
            raise NotFound(f"{directory}/{name}")
        e = filer_pb2.Entry()
        e.ParseFromString(bytes(row[0]))
        return e

    def delete_entry(self, directory, name):
        directory = normalize_path(directory)
        p = self._p
        with self._lock:
            self._exec(
                f"DELETE FROM filemeta WHERE dirhash={p} "
                f"AND directory={p} AND name={p}",
                (self._dirhash(directory), directory, name))
            self._maybe_commit()

    def delete_folder_children(self, directory):
        directory = normalize_path(directory)
        prefix = directory if directory.endswith("/") else directory + "/"
        escaped = prefix.replace("\\", "\\\\") \
                        .replace("%", r"\%").replace("_", r"\_")
        p = self._p
        with self._lock:
            self._exec(
                f"DELETE FROM filemeta WHERE directory={p} "
                f"OR directory LIKE {p} {self.escape_clause}",
                (directory, escaped + "%"))
            self._maybe_commit()

    def list_directory_entries(self, directory, start_name="",
                               inclusive=False, limit=1024, prefix=""):
        directory = normalize_path(directory)
        op = ">=" if inclusive else ">"
        p = self._p
        sql = (f"SELECT meta FROM filemeta WHERE dirhash={p} "
               f"AND directory={p} AND name {op} {p} ")
        args: list = [self._dirhash(directory), directory, start_name]
        if prefix:
            sql += f"AND name LIKE {p} {self.escape_clause} "
            args.append(prefix.replace("\\", "\\\\")
                        .replace("%", r"\%").replace("_", r"\_") + "%")
        sql += f"ORDER BY name LIMIT {p}"
        args.append(limit)
        with self._lock:
            rows = self._exec(sql, tuple(args)).fetchall()
        out: List[filer_pb2.Entry] = []
        for (blob,) in rows:
            e = filer_pb2.Entry()
            e.ParseFromString(bytes(blob))
            out.append(e)
        return out

    # -- transactions --------------------------------------------------------

    def begin_transaction(self):
        self._lock.acquire()
        # lint: guard-ok(the acquire above holds the lock across the tx; a with-block cannot span it)
        self._in_tx += 1

    def commit_transaction(self):  # requires(self._lock)
        # the lock was taken by begin_transaction (acquire/release
        # spans the tx, which `with` cannot express)
        self._in_tx -= 1
        if not self._in_tx:
            self._commit()
        self._lock.release()

    def rollback_transaction(self):  # requires(self._lock)
        self._in_tx -= 1
        if not self._in_tx:
            self._conn.rollback()
        self._lock.release()

    # -- KV ------------------------------------------------------------------

    def kv_put(self, key, value):
        with self._lock:
            self._exec(self.kv_upsert_sql, (bytes(key), bytes(value)))
            self._maybe_commit()

    def kv_get(self, key):
        p = self._p
        with self._lock:
            row = self._exec(f"SELECT v FROM filekv WHERE k={p}",
                             (bytes(key),)).fetchone()
        return bytes(row[0]) if row else None

    def close(self):
        with self._lock:
            if self._conn is not None:
                self._commit()
                self._conn.close()
                self._conn = None


class MysqlStore(AbstractSqlStore):
    """MySQL backend (reference weed/filer/mysql) — config-only once a
    DB-API driver (pymysql or MySQLdb) is installed."""

    name = "mysql"
    paramstyle = "format"
    upsert_sql = ("INSERT INTO filemeta VALUES ({p},{p},{p},{p}) "
                  "ON DUPLICATE KEY UPDATE meta=VALUES(meta)")
    kv_upsert_sql = ("INSERT INTO filekv VALUES ({p},{p}) "
                     "ON DUPLICATE KEY UPDATE v=VALUES(v)")
    # backslash is already MySQL's default LIKE escape, and the
    # explicit clause would be an unterminated literal at default
    # sql_mode
    escape_clause = ""
    create_tables = [
        "CREATE TABLE IF NOT EXISTS filemeta ("
        " dirhash BIGINT NOT NULL,"
        " directory TEXT NOT NULL,"
        " name VARCHAR(512) NOT NULL,"
        " meta LONGBLOB NOT NULL,"       # entries exceed BLOB's 64KB
        " PRIMARY KEY (dirhash, name))",
        "CREATE TABLE IF NOT EXISTS filekv ("
        " k VARBINARY(512) PRIMARY KEY,"
        " v LONGBLOB NOT NULL)",
    ]

    def __init__(self, host: str = "localhost", port: int = 3306,
                 username: str = "", password: str = "",
                 database: str = "seaweedfs"):
        self._dsn = dict(host=host, port=port, user=username,
                         password=password, database=database)
        super().__init__()

    def _connect(self):
        try:
            import pymysql
        except ImportError:
            try:
                import MySQLdb as pymysql  # type: ignore
            except ImportError:
                raise RuntimeError(
                    "mysql filer store needs pymysql or MySQLdb "
                    "(not in this image)") from None
        return pymysql.connect(**self._dsn)


class PostgresStore(AbstractSqlStore):
    """Postgres backend (reference weed/filer/postgres) — config-only
    once psycopg2 is installed."""

    name = "postgres"
    paramstyle = "format"
    upsert_sql = ("INSERT INTO filemeta VALUES ({p},{p},{p},{p}) "
                  "ON CONFLICT (dirhash, name) "
                  "DO UPDATE SET meta=EXCLUDED.meta")
    kv_upsert_sql = ("INSERT INTO filekv VALUES ({p},{p}) "
                     "ON CONFLICT (k) DO UPDATE SET v=EXCLUDED.v")
    create_tables = [
        "CREATE TABLE IF NOT EXISTS filemeta ("
        " dirhash BIGINT NOT NULL,"
        " directory TEXT NOT NULL,"
        " name VARCHAR(512) NOT NULL,"
        " meta BYTEA NOT NULL,"
        " PRIMARY KEY (dirhash, name))",
        "CREATE TABLE IF NOT EXISTS filekv ("
        " k BYTEA PRIMARY KEY,"
        " v BYTEA NOT NULL)",
    ]

    def __init__(self, host: str = "localhost", port: int = 5432,
                 username: str = "", password: str = "",
                 database: str = "seaweedfs"):
        self._dsn = dict(host=host, port=port, user=username,
                         password=password, dbname=database)
        super().__init__()

    def _connect(self):
        try:
            import psycopg2
        except ImportError:
            raise RuntimeError(
                "postgres filer store needs psycopg2 "
                "(not in this image)") from None
        return psycopg2.connect(**self._dsn)
