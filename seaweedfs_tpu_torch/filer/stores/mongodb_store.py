"""MongoDB FilerStore over an OP_MSG/BSON wire client of its own: the
port of ``seaweedfs_tpu.filer.stores.mongodb_store``.

Reference weed/filer/mongodb/mongodb_store.go (+_kv.go) rides the
official Go client; here the wire protocol is spoken directly, as the
redis (RESP) and etcd clients do. One collection ``filemeta`` with the
reference's schema: {directory, name, meta} and a unique (directory,
name) index; KV pairs map through the reference's genDirAndName split
(first 8 key bytes = directory, rest = name, mongodb_store_kv.go:63-71).

The BSON codec covers exactly the types this store and server replies
use: string, binary, document, array, bool, null, int32/64, double. A
Python int goes out as int32 when it fits, else int64, and a document's
keys in insertion order, as the JAX codec writes them. Binary key
material rides latin-1 string fields like the reference's Go
string(key) cast.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

from seaweedfs_tpu_torch.filer.filerstore import (FilerStore, NotFound,
                                            join_path, normalize_path)
from seaweedfs_tpu_torch.pb import filer_pb2

OP_MSG = 2013


class MongoError(Exception):
    pass


# -- minimal BSON -------------------------------------------------------------


def _enc_value(key: bytes, v) -> bytes:
    if isinstance(v, bool):
        return b"\x08" + key + b"\x00" + (b"\x01" if v else b"\x00")
    if isinstance(v, str):
        raw = v.encode("utf-8", "surrogateescape")
        return b"\x02" + key + b"\x00" + \
            struct.pack("<i", len(raw) + 1) + raw + b"\x00"
    if isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
        return b"\x05" + key + b"\x00" + \
            struct.pack("<i", len(raw)) + b"\x00" + raw
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"\x10" + key + b"\x00" + struct.pack("<i", v)
        return b"\x12" + key + b"\x00" + struct.pack("<q", v)
    if isinstance(v, float):
        return b"\x01" + key + b"\x00" + struct.pack("<d", v)
    if v is None:
        return b"\x0a" + key + b"\x00"
    if isinstance(v, dict):
        return b"\x03" + key + b"\x00" + encode_doc(v)
    if isinstance(v, (list, tuple)):
        return b"\x04" + key + b"\x00" + encode_doc(
            {str(i): item for i, item in enumerate(v)})
    raise TypeError(f"BSON cannot encode {type(v)!r}")


def encode_doc(doc: dict) -> bytes:
    body = b"".join(_enc_value(k.encode("utf-8"), v)
                    for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def decode_doc(buf: bytes, pos: int = 0) -> Tuple[dict, int]:
    try:
        return _decode_doc(buf, pos)
    except (struct.error, IndexError, ValueError) as e:
        # surface truncated/corrupt documents as protocol errors, not
        # parser internals
        raise MongoError(f"corrupt BSON document: {e}")


def _decode_doc(buf: bytes, pos: int = 0) -> Tuple[dict, int]:
    (total,) = struct.unpack_from("<i", buf, pos)
    if total < 5 or pos + total > len(buf):
        raise MongoError(
            f"corrupt BSON document: length {total} exceeds buffer")
    end = pos + total - 1  # trailing NUL
    pos += 4
    out: dict = {}
    while pos < end:
        t = buf[pos]
        pos += 1
        z = buf.index(0, pos)
        key = buf[pos:z].decode("utf-8", "surrogateescape")
        pos = z + 1
        if t == 0x02:
            (n,) = struct.unpack_from("<i", buf, pos)
            out[key] = buf[pos + 4:pos + 4 + n - 1].decode(
                "utf-8", "surrogateescape")
            pos += 4 + n
        elif t == 0x05:
            (n,) = struct.unpack_from("<i", buf, pos)
            out[key] = bytes(buf[pos + 5:pos + 5 + n])
            pos += 5 + n
        elif t == 0x10:
            (out[key],) = struct.unpack_from("<i", buf, pos)
            pos += 4
        elif t == 0x12:
            (out[key],) = struct.unpack_from("<q", buf, pos)
            pos += 8
        elif t == 0x01:
            (out[key],) = struct.unpack_from("<d", buf, pos)
            pos += 8
        elif t == 0x08:
            out[key] = buf[pos] != 0
            pos += 1
        elif t == 0x0A:
            out[key] = None
        elif t == 0x03:
            out[key], pos = decode_doc(buf, pos)
        elif t == 0x04:
            arr_doc, pos = decode_doc(buf, pos)
            out[key] = [arr_doc[str(i)] for i in range(len(arr_doc))]
        else:
            raise MongoError(f"unsupported BSON type 0x{t:02x}")
    return out, end + 1


# -- OP_MSG client ------------------------------------------------------------


class MongoClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 27017,
                 timeout: float = 10.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = self._sock.makefile("rb")
        self._lock = threading.Lock()
        self._req_id = 0

    def command(self, doc: dict) -> dict:
        with self._lock:
            self._req_id += 1
            body = struct.pack("<I", 0) + b"\x00" + encode_doc(doc)
            msg = struct.pack("<iiii", 16 + len(body), self._req_id, 0,
                              OP_MSG) + body
            # lint: block-ok(single-socket wire protocol: the lock IS the request/response serializer)
            self._sock.sendall(msg)
            header = self._read_exact(16)
            (length, _, _, opcode) = struct.unpack("<iiii", header)
            payload = self._read_exact(length - 16)
        if opcode != OP_MSG:
            raise MongoError(f"unexpected opcode {opcode}")
        # flagBits(4) + kind byte + doc
        reply, _ = decode_doc(payload, 5)
        if reply.get("ok") not in (1, 1.0, True):
            raise MongoError(reply.get("errmsg", str(reply)))
        return reply

    def _read_exact(self, n: int) -> bytes:
        data = self._buf.read(n)
        if len(data) != n:
            raise MongoError("connection closed")
        return data

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


# -- the store ----------------------------------------------------------------


class MongodbStore(FilerStore):
    name = "mongodb"
    COLLECTION = "filemeta"

    def __init__(self, host: str = "127.0.0.1", port: int = 27017,
                 database: str = "seaweedfs"):
        self.db = database
        self.client = MongoClient(host, port)
        # unique (directory, name) like the reference's indexUnique
        self.client.command({
            "createIndexes": self.COLLECTION, "$db": self.db,
            "indexes": [{"key": {"directory": 1, "name": 1},
                         "name": "directory_1_name_1", "unique": True}]})

    def _upsert(self, directory: str, name: str, meta: bytes) -> None:
        self.client.command({
            "update": self.COLLECTION, "$db": self.db,
            "updates": [{"q": {"directory": directory, "name": name},
                         "u": {"$set": {"meta": meta}},
                         "upsert": True}]})

    def _find_one(self, directory: str, name: str) -> Optional[bytes]:
        reply = self.client.command({
            "find": self.COLLECTION, "$db": self.db,
            "filter": {"directory": directory, "name": name},
            "limit": 1})
        batch = reply["cursor"]["firstBatch"]
        if not batch:
            return None
        return batch[0].get("meta")

    # -- SPI -----------------------------------------------------------------

    def insert_entry(self, directory, entry):
        directory = normalize_path(directory)
        self._upsert(directory, entry.name, entry.SerializeToString())

    update_entry = insert_entry

    def find_entry(self, directory, name):
        directory = normalize_path(directory)
        meta = self._find_one(directory, name)
        if meta is None:
            raise NotFound(join_path(directory, name))
        e = filer_pb2.Entry()
        e.ParseFromString(meta)
        return e

    def delete_entry(self, directory, name):
        directory = normalize_path(directory)
        self.client.command({
            "delete": self.COLLECTION, "$db": self.db,
            "deletes": [{"q": {"directory": directory, "name": name},
                         "limit": 1}]})

    def delete_folder_children(self, directory):
        directory = normalize_path(directory)
        prefix = directory.rstrip("/") + "/"
        self.client.command({
            "delete": self.COLLECTION, "$db": self.db,
            "deletes": [{"q": {"$or": [
                {"directory": directory},
                {"directory": {"$regex": "^" + _regex_escape(prefix)}},
            ]}, "limit": 0}]})

    def list_directory_entries(self, directory, start_name="",
                               inclusive=False, limit=1024, prefix=""):
        directory = normalize_path(directory)
        filt: Dict = {"directory": directory}
        name_cond: Dict = {}
        if start_name:
            name_cond["$gte" if inclusive else "$gt"] = start_name
        if prefix:
            # server-side: filtering after LIMIT would silently drop
            # matches in large directories
            name_cond["$regex"] = "^" + _regex_escape(prefix)
        if name_cond:
            filt["name"] = name_cond
        out: List[filer_pb2.Entry] = []
        reply = self.client.command({
            "find": self.COLLECTION, "$db": self.db, "filter": filt,
            "sort": {"name": 1}, "limit": limit, "batchSize": limit})
        cursor = reply["cursor"]
        docs = list(cursor["firstBatch"])
        while cursor.get("id"):
            reply = self.client.command({
                "getMore": cursor["id"], "$db": self.db,
                "collection": self.COLLECTION})
            cursor = reply["cursor"]
            docs.extend(cursor["nextBatch"])
        for doc in docs:
            if prefix and not doc["name"].startswith(prefix):
                continue
            e = filer_pb2.Entry()
            e.ParseFromString(doc["meta"])
            out.append(e)
            if len(out) >= limit:
                break
        return out

    # -- KV (reference mongodb_store_kv.go genDirAndName split) --------------

    @staticmethod
    def _kv_dir_name(key: bytes) -> Tuple[str, str]:
        key = bytes(key)
        if len(key) < 8:
            key = key + b"\x00" * (8 - len(key))
        return (key[:8].decode("latin-1"), key[8:].decode("latin-1"))

    def kv_put(self, key, value):
        d, n = self._kv_dir_name(key)
        self._upsert(d, n, bytes(value))

    def kv_get(self, key):
        d, n = self._kv_dir_name(key)
        return self._find_one(d, n)

    def close(self):
        self.client.close()


def _regex_escape(s: str) -> str:
    import re
    return re.escape(s)
