"""Cassandra FilerStore over a CQL v4 binary-protocol client of its own:
the port of ``seaweedfs_tpu.filer.stores.cassandra_store``.

Reference weed/filer/cassandra/cassandra_store.go (+_kv.go) rides
gocql; here the frames are built by hand, as the redis, etcd and
mongodb clients do. Schema and statements follow the reference: table
``filemeta (directory, name, meta)`` with directory as the partition
key and name as the clustering column; KV pairs map through
genDirAndName's base64 split (cassandra_store_kv.go:53-61).

As in the JAX package, delete_folder_children also removes descendant
partitions (found via SELECT DISTINCT directory), because the FilerStore
contract wipes whole subtrees; the reference's cassandra store only
clears the exact partition.
"""

from __future__ import annotations

import base64
import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

from seaweedfs_tpu_torch.filer.filerstore import (FilerStore, NotFound,
                                            join_path, normalize_path)
from seaweedfs_tpu_torch.pb import filer_pb2

OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

RESULT_VOID = 0x0001
RESULT_ROWS = 0x0002
RESULT_SET_KEYSPACE = 0x0003

CONSISTENCY_LOCAL_QUORUM = 0x0006  # gocql.LocalQuorum, like the reference
CONSISTENCY_ONE = 0x0001


class CassandraError(Exception):
    pass


def _string(s: str) -> bytes:
    raw = s.encode("utf-8")
    return struct.pack(">H", len(raw)) + raw


def _long_string(s: str) -> bytes:
    raw = s.encode("utf-8")
    return struct.pack(">i", len(raw)) + raw


class CqlClient:
    """One CQL v4 connection; unprepared QUERY frames with positional
    values (the half-dozen statements the store needs)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9042,
                 username: str = "", password: str = "",
                 timeout: float = 10.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = self._sock.makefile("rb")
        self._lock = threading.Lock()
        self._stream = 0
        opcode, body = self._request(OP_STARTUP, _string_map(
            {"CQL_VERSION": "3.0.0"}))
        if opcode == OP_AUTHENTICATE:
            token = b"\x00" + username.encode() + b"\x00" + \
                password.encode()
            opcode, body = self._request(
                OP_AUTH_RESPONSE, struct.pack(">i", len(token)) + token)
            if opcode != OP_AUTH_SUCCESS:
                raise CassandraError("authentication failed")
        elif opcode != OP_READY:
            raise CassandraError(f"unexpected startup reply {opcode}")

    def _request(self, opcode: int, body: bytes) -> Tuple[int, bytes]:
        with self._lock:
            self._stream = (self._stream + 1) & 0x7FFF
            frame = struct.pack(">BBhBi", 0x04, 0, self._stream, opcode,
                                len(body)) + body
            # lint: block-ok(single-socket wire protocol: the lock IS the request/response serializer)
            self._sock.sendall(frame)
            header = self._read_exact(9)
            _ver, _flags, _stream, r_op, length = struct.unpack(
                ">BBhBi", header)
            payload = self._read_exact(length)
        if r_op == OP_ERROR:
            (code,) = struct.unpack_from(">i", payload, 0)
            (n,) = struct.unpack_from(">H", payload, 4)
            raise CassandraError(
                f"[{code:#06x}] {payload[6:6 + n].decode('utf-8')}")
        return r_op, payload

    def _read_exact(self, n: int) -> bytes:
        data = self._buf.read(n)
        if len(data) != n:
            raise CassandraError("connection closed")
        return data

    def query(self, cql: str, values: Tuple[bytes, ...] = (),
              consistency: int = CONSISTENCY_LOCAL_QUORUM):
        """Run one statement. Returns list-of-rows (each a list of
        cell bytes or None) for ROWS results, else None."""
        body = _long_string(cql) + struct.pack(">H", consistency)
        if values:
            body += b"\x01" + struct.pack(">H", len(values))
            for v in values:
                body += struct.pack(">i", len(v)) + v
        else:
            body += b"\x00"
        opcode, payload = self._request(OP_QUERY, body)
        if opcode != OP_RESULT:
            raise CassandraError(f"unexpected result opcode {opcode}")
        (kind,) = struct.unpack_from(">i", payload, 0)
        if kind != RESULT_ROWS:
            return None
        return _parse_rows(payload, 4)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


def _string_map(m: Dict[str, str]) -> bytes:
    out = struct.pack(">H", len(m))
    for k, v in m.items():
        out += _string(k) + _string(v)
    return out


def _parse_rows(buf: bytes, pos: int) -> List[List[Optional[bytes]]]:
    (flags, col_count) = struct.unpack_from(">ii", buf, pos)
    pos += 8
    if flags & 0x0004:  # has_more_pages: paging state
        (n,) = struct.unpack_from(">i", buf, pos)
        pos += 4 + max(0, n)
    if flags & 0x0001:  # global_tables_spec: keyspace + table
        for _ in range(2):
            (n,) = struct.unpack_from(">H", buf, pos)
            pos += 2 + n
    if not flags & 0x0002:  # no_metadata unset: column specs present
        for _ in range(col_count):
            if not flags & 0x0001:
                for _ in range(2):  # per-column ks + table
                    (n,) = struct.unpack_from(">H", buf, pos)
                    pos += 2 + n
            (n,) = struct.unpack_from(">H", buf, pos)  # column name
            pos += 2 + n
            (type_id,) = struct.unpack_from(">H", buf, pos)
            pos += 2
            if type_id in (0x0000, 0x0020, 0x0021, 0x0022, 0x0030,
                           0x0031):
                raise CassandraError(
                    f"parameterized CQL type {type_id:#06x} unsupported")
    (row_count,) = struct.unpack_from(">i", buf, pos)
    pos += 4
    rows: List[List[Optional[bytes]]] = []
    for _ in range(row_count):
        row: List[Optional[bytes]] = []
        for _ in range(col_count):
            (n,) = struct.unpack_from(">i", buf, pos)
            pos += 4
            if n < 0:
                row.append(None)
            else:
                row.append(buf[pos:pos + n])
                pos += n
        rows.append(row)
    return rows


class CassandraStore(FilerStore):
    name = "cassandra"

    def __init__(self, host: str = "127.0.0.1", port: int = 9042,
                 keyspace: str = "seaweedfs", username: str = "",
                 password: str = ""):
        self.ks = keyspace
        self.client = CqlClient(host, port, username=username,
                                password=password)
        self.table = f"{keyspace}.filemeta"

    # -- SPI -----------------------------------------------------------------

    def insert_entry(self, directory, entry):
        directory = normalize_path(directory)
        self.client.query(
            f"INSERT INTO {self.table} (directory,name,meta) "
            f"VALUES (?,?,?)",
            (directory.encode(), entry.name.encode(),
             entry.SerializeToString()))

    update_entry = insert_entry

    def find_entry(self, directory, name):
        directory = normalize_path(directory)
        rows = self.client.query(
            f"SELECT meta FROM {self.table} "
            f"WHERE directory=? AND name=?",
            (directory.encode(), name.encode()),
            consistency=CONSISTENCY_ONE)
        if not rows or rows[0][0] is None:
            raise NotFound(join_path(directory, name))
        e = filer_pb2.Entry()
        e.ParseFromString(rows[0][0])
        return e

    def delete_entry(self, directory, name):
        directory = normalize_path(directory)
        self.client.query(
            f"DELETE FROM {self.table} WHERE directory=? AND name=?",
            (directory.encode(), name.encode()))

    def delete_folder_children(self, directory):
        directory = normalize_path(directory)
        self.client.query(
            f"DELETE FROM {self.table} WHERE directory=?",
            (directory.encode(),))
        # descendant partitions (see module docstring)
        prefix = directory.rstrip("/") + "/"
        rows = self.client.query(
            f"SELECT DISTINCT directory FROM {self.table}") or []
        for (d,) in rows:
            if d is not None and d.decode("utf-8").startswith(prefix):
                self.client.query(
                    f"DELETE FROM {self.table} WHERE directory=?", (d,))

    def list_directory_entries(self, directory, start_name="",
                               inclusive=False, limit=1024, prefix=""):
        directory = normalize_path(directory)
        cql = f"SELECT name, meta FROM {self.table} WHERE directory=?"
        values: List[bytes] = [directory.encode()]
        if prefix:
            # name is the clustering column: constrain the range
            # server-side so LIMIT cannot starve the prefix filter
            lo = max(start_name, prefix) if start_name else prefix
            incl = inclusive if start_name and start_name >= prefix \
                else True
            cql += " AND name>=?" if incl else " AND name>?"
            values.append(lo.encode())
            cql += " AND name<?"
            values.append((prefix + "\uffff").encode())
        elif start_name:
            cql += " AND name>=?" if inclusive else " AND name>?"
            values.append(start_name.encode())
        cql += " LIMIT ?"
        values.append(struct.pack(">i", min(max(limit, 1), (1 << 31) - 1)))
        rows = self.client.query(cql, tuple(values),
                                 consistency=CONSISTENCY_ONE) or []
        out: List[filer_pb2.Entry] = []
        for name_b, meta in rows:
            name = (name_b or b"").decode("utf-8")
            if prefix and not name.startswith(prefix):
                continue
            if meta is None:
                continue
            e = filer_pb2.Entry()
            e.ParseFromString(meta)
            out.append(e)
            if len(out) >= limit:
                break
        return out

    # -- KV (reference cassandra_store_kv.go genDirAndName) ------------------

    @staticmethod
    def _kv_dir_name(key: bytes) -> Tuple[str, str]:
        key = bytes(key)
        if len(key) < 8:
            key = key + b"\x00" * (8 - len(key))
        return (base64.standard_b64encode(key[:8]).decode(),
                base64.standard_b64encode(key[8:]).decode())

    def kv_put(self, key, value):
        d, n = self._kv_dir_name(key)
        self.client.query(
            f"INSERT INTO {self.table} (directory,name,meta) "
            f"VALUES (?,?,?)",
            (d.encode(), n.encode(), bytes(value)))

    def kv_get(self, key):
        d, n = self._kv_dir_name(key)
        rows = self.client.query(
            f"SELECT meta FROM {self.table} "
            f"WHERE directory=? AND name=?",
            (d.encode(), n.encode()), consistency=CONSISTENCY_ONE)
        if not rows or rows[0][0] is None:
            return None
        return bytes(rows[0][0])

    def close(self):
        self.client.close()
