"""HBase FilerStore over a region-server RPC client of its own: the port
of ``seaweedfs_tpu.filer.stores.hbase_store``.

Reference weed/filer/hbase/hbase_store.go (+_kv.go) rides gohbase; here
the protobuf-framed RPC is spoken directly (messages in
``pb/hbase_pb2.py``, proto2). Wire shape (public Apache HBase protocol):
6-byte preamble "HBas" + version 0 + auth SIMPLE(0x50), a
length-prefixed ConnectionHeader, then per call a 4-byte-length frame of
varint-delimited RequestHeader + request message; responses mirror it
with ResponseHeader (+ exception) + response message. Cells ride inside
the protobuf Results (no cell-block codec is negotiated).

Layout matches the reference: one table, column families "kv"
(KvPut/KvGet) and "meta" (entries keyed by FULL path), single column
"a" (hbase_store.go:40-44); TTL rides the "_ttl" mutation attribute in
milliseconds and mutations use ASYNC_WAL durability like gohbase's
hrpc.Durability(hrpc.AsyncWal) (hbase_store_kv.go:26-45); values gzip
over 50 chunks (hbase_store.go:78-81 MaybeGzipData).

As in the JAX package: the configured address is the region server
itself (no ZooKeeper/hbase:meta walk; the RegionSpecifier names the
table, "<table>,,1"), and delete_folder_children removes the whole
subtree under the path prefix, as the FilerStore contract asks.
"""

from __future__ import annotations

import gzip
import socket
import struct
import threading
from typing import Iterator, List, Optional, Tuple

from seaweedfs_tpu_torch.filer.filerstore import (FilerStore, NotFound,
                                            join_path, normalize_path)
from seaweedfs_tpu_torch.pb import filer_pb2, hbase_pb2

PREAMBLE = b"HBas\x00\x50"  # magic + version 0 + AUTH_SIMPLE
COLUMN = b"a"
CF_KV = b"kv"
CF_META = b"meta"
GZIP_CHUNK_THRESHOLD = 50


class HBaseError(Exception):
    """Server-side exception surfaced from a ResponseHeader."""

    def __init__(self, class_name: str, detail: str = ""):
        super().__init__(f"{class_name}: {detail}" if detail
                         else class_name)
        self.class_name = class_name


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise HBaseError("CorruptFrame", "varint too long")


def _delimited(msg) -> bytes:
    raw = msg.SerializeToString()
    return _write_varint(len(raw)) + raw


class HBaseClient:
    """One connection to a region server; Get / Mutate / Scan calls."""

    def __init__(self, host: str = "127.0.0.1", port: int = 16020,
                 table: str = "seaweedfs", timeout: float = 10.0):
        self.table = table.encode()
        # a single-region table's region name: "<table>,<start>,<id>"
        self._region = hbase_pb2.RegionSpecifier(
            type=hbase_pb2.RegionSpecifier.REGION_NAME,
            value=self.table + b",,1")
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = self._sock.makefile("rb")
        self._lock = threading.Lock()
        self._call_id = 0
        hello = hbase_pb2.ConnectionHeader(
            user_info=hbase_pb2.UserInformation(
                effective_user="seaweedfs"),
            service_name="ClientService")
        raw = hello.SerializeToString()
        self._sock.sendall(PREAMBLE + struct.pack(">I", len(raw)) + raw)

    def close(self) -> None:
        try:
            self._buf.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def _read_exact(self, n: int) -> bytes:
        data = self._buf.read(n)
        if data is None or len(data) != n:
            raise HBaseError("ConnectionClosed", "short read")
        return data

    def _call(self, method: str, request, response_cls):
        with self._lock:
            self._call_id += 1
            header = hbase_pb2.RequestHeader(
                call_id=self._call_id, method_name=method,
                request_param=True)
            payload = _delimited(header) + _delimited(request)
            # lint: block-ok(single-socket wire protocol: the lock IS the request/response serializer)
            self._sock.sendall(struct.pack(">I", len(payload)) + payload)
            (total,) = struct.unpack(">I", self._read_exact(4))
            frame = self._read_exact(total)
        hlen, pos = _read_varint(frame, 0)
        resp_header = hbase_pb2.ResponseHeader()
        resp_header.ParseFromString(frame[pos:pos + hlen])
        pos += hlen
        if resp_header.HasField("exception"):
            exc = resp_header.exception
            raise HBaseError(exc.exception_class_name, exc.stack_trace)
        blen, pos = _read_varint(frame, pos)
        resp = response_cls()
        resp.ParseFromString(frame[pos:pos + blen])
        return resp

    # -- data ops -------------------------------------------------------------

    def get(self, family: bytes, row: bytes) -> Optional[bytes]:
        req = hbase_pb2.GetRequest(
            region=self._region,
            get=hbase_pb2.Get(row=row, column=[
                hbase_pb2.Column(family=family, qualifier=[COLUMN])]))
        resp = self._call("Get", req, hbase_pb2.GetResponse)
        for cell in resp.result.cell:
            return cell.value
        return None

    def _mutate(self, mutate_type, family: bytes, row: bytes,
                qualifier_value, ttl_sec: int = 0) -> None:
        mutation = hbase_pb2.MutationProto(
            row=row, mutate_type=mutate_type,
            durability=hbase_pb2.MutationProto.ASYNC_WAL,
            column_value=[hbase_pb2.MutationProto.ColumnValue(
                family=family, qualifier_value=[qualifier_value])])
        if ttl_sec > 0:
            # gohbase hrpc.TTL: "_ttl" attribute, int64 milliseconds
            mutation.attribute.add(
                name="_ttl",
                value=struct.pack(">q", int(ttl_sec) * 1000))
        self._call("Mutate",
                   hbase_pb2.MutateRequest(region=self._region,
                                           mutation=mutation),
                   hbase_pb2.MutateResponse)

    def put(self, family: bytes, row: bytes, value: bytes,
            ttl_sec: int = 0) -> None:
        self._mutate(
            hbase_pb2.MutationProto.PUT, family, row,
            hbase_pb2.MutationProto.ColumnValue.QualifierValue(
                qualifier=COLUMN, value=value),
            ttl_sec=ttl_sec)

    def delete(self, family: bytes, row: bytes) -> None:
        self._mutate(
            hbase_pb2.MutationProto.DELETE, family, row,
            hbase_pb2.MutationProto.ColumnValue.QualifierValue(
                qualifier=COLUMN,
                delete_type=hbase_pb2.MutationProto.
                DELETE_MULTIPLE_VERSIONS))

    def scan(self, family: bytes, start_row: bytes,
             batch: int = 64) -> Iterator[Tuple[bytes, bytes]]:
        """Yield (row, value) from start_row to the end of the table in
        key order; the caller breaks on its own prefix check, like the
        reference's scanner loops (hbase_store.go:115-147)."""
        req = hbase_pb2.ScanRequest(
            region=self._region,
            scan=hbase_pb2.Scan(start_row=start_row, column=[
                hbase_pb2.Column(family=family, qualifier=[COLUMN])]),
            number_of_rows=batch,
            client_handles_partials=False,
            client_handles_heartbeats=False)
        resp = self._call("Scan", req, hbase_pb2.ScanResponse)
        scanner_id = resp.scanner_id
        seq = 1
        try:
            while True:
                for result in resp.results:
                    for cell in result.cell:
                        yield cell.row, cell.value
                if not resp.more_results or not resp.results:
                    return
                resp = self._call(
                    "Scan",
                    hbase_pb2.ScanRequest(scanner_id=scanner_id,
                                          number_of_rows=batch,
                                          next_call_seq=seq),
                    hbase_pb2.ScanResponse)
                seq += 1
        finally:
            try:
                self._call("Scan",
                           hbase_pb2.ScanRequest(scanner_id=scanner_id,
                                                 close_scanner=True),
                           hbase_pb2.ScanResponse)
            except (HBaseError, OSError):
                pass  # best-effort close; server GCs leaked scanners


def _maybe_gzip(value: bytes, entry: filer_pb2.Entry) -> bytes:
    if len(entry.chunks) > GZIP_CHUNK_THRESHOLD:
        return gzip.compress(value)
    return value


def _maybe_gunzip(value: bytes) -> bytes:
    if value[:2] == b"\x1f\x8b":  # pb Entry never starts with gzip magic
        try:
            return gzip.decompress(value)
        except OSError:
            pass
    return value


class HBaseStore(FilerStore):
    """FilerStore over HBaseClient (reference hbase_store.go)."""

    name = "hbase"

    def __init__(self, host: str = "127.0.0.1", port: int = 16020,
                 table: str = "seaweedfs"):
        self.client = HBaseClient(host=host, port=port, table=table)
        # connectivity probe, like the reference's init-time Get with a
        # throwaway key (hbase_store.go:46-55)
        self.client.get(CF_META, b"whatever")

    # -- entries (rows keyed by full path, cf "meta") -------------------------

    def insert_entry(self, directory: str, entry: filer_pb2.Entry) -> None:
        directory = normalize_path(directory)
        path = join_path(directory, entry.name)
        value = _maybe_gzip(entry.SerializeToString(), entry)
        self.client.put(CF_META, path.encode(), value,
                        ttl_sec=entry.attributes.ttl_sec)

    update_entry = insert_entry

    def find_entry(self, directory: str, name: str) -> filer_pb2.Entry:
        directory = normalize_path(directory)
        path = join_path(directory, name)
        value = self.client.get(CF_META, path.encode())
        if value is None:
            raise NotFound(path)
        e = filer_pb2.Entry()
        e.ParseFromString(_maybe_gunzip(value))
        return e

    def delete_entry(self, directory: str, name: str) -> None:
        directory = normalize_path(directory)
        self.client.delete(CF_META,
                           join_path(directory, name).encode())

    def delete_folder_children(self, directory: str) -> None:
        directory = normalize_path(directory)
        prefix = (join_path(directory, "") or "/").encode()
        if not prefix.endswith(b"/"):
            prefix += b"/"
        doomed = []
        for row, _value in self.client.scan(CF_META, prefix):
            if not row.startswith(prefix):
                break
            doomed.append(row)
        for row in doomed:
            self.client.delete(CF_META, row)

    def list_directory_entries(self, directory: str, start_name: str = "",
                               inclusive: bool = False, limit: int = 1024,
                               prefix: str = "") -> List[filer_pb2.Entry]:
        directory = normalize_path(directory)
        child_prefix = join_path(directory, prefix).encode() if prefix \
            else (directory.rstrip("/") + "/").encode()
        start = join_path(directory, start_name).encode() if start_name \
            else child_prefix
        out: List[filer_pb2.Entry] = []
        for row, value in self.client.scan(CF_META, start):
            if not row.startswith(child_prefix):
                break
            full = row.decode("utf-8", "replace")
            d, _, fname = full.rpartition("/")
            if (d or "/") != directory:
                continue  # descendant row interleaved in the range
            if start_name and fname == start_name and not inclusive:
                continue
            e = filer_pb2.Entry()
            e.ParseFromString(_maybe_gunzip(value))
            out.append(e)
            if len(out) >= limit:
                break
        return out

    # -- KV (cf "kv", raw byte keys) ------------------------------------------

    def kv_put(self, key: bytes, value: bytes) -> None:
        self.client.put(CF_KV, bytes(key), value)

    def kv_get(self, key: bytes) -> Optional[bytes]:
        return self.client.get(CF_KV, bytes(key))

    def kv_delete(self, key: bytes) -> None:
        self.client.delete(CF_KV, bytes(key))

    def close(self) -> None:
        self.client.close()
