"""The port's networked filer stores against the JAX package's.

Every case runs the same seeded inputs through both packages and compares
what comes out. The store contract (``tests/test_torch_filer.py``'s
``_store_script``: inserts, updates, finds, deletes, prefix listings,
hard links, kv and a folder wipe) runs on each networked flavour against
its own instance of the matching fake server of ``tests/fake_backends.py``
over a real socket: the two transcripts must be equal, and so must the
two fakes' raw state (the bytes the store left there; for hbase with
gzip's MTIME masked) and, for the socket protocols, every byte each
client sent. A tree written by either package reads whole in the other.
The codecs are held to the JAX encoders on seeded inputs: BSON, OP_MSG,
CQL v4 frames, RESP commands and replies, the HBase preamble and call
frames, Azure SharedKey; ``pb/hbase_pb2`` (proto2: required fields,
presence, defaults, unpacked repeated numbers, two-byte enums) to
protobuf's bytes. The adapters' behaviours (redis cluster redirects and
a dead node, elastic basic auth, hbase scanners, TTL and gzip, the
cassandra authenticator and clustering order) give equal results in both.
"""

import base64
import gzip
import socket
import struct
import threading
import types
import urllib.parse
import zlib

import numpy as np
import pytest
from google.protobuf.descriptor import FieldDescriptor

from seaweedfs_tpu.filer import filer as jax_filer
from seaweedfs_tpu.filer import filerstore as jax_fstore
from seaweedfs_tpu.filer.stores import cassandra_store as jax_cassandra
from seaweedfs_tpu.filer.stores import elastic_store as jax_elastic
from seaweedfs_tpu.filer.stores import etcd_store as jax_etcd
from seaweedfs_tpu.filer.stores import memory_store as jax_mem
from seaweedfs_tpu.filer.stores import hbase_store as jax_hbase
from seaweedfs_tpu.filer.stores import mongodb_store as jax_mongo
from seaweedfs_tpu.filer.stores import redis_store as jax_redis
from seaweedfs_tpu.pb import filer_pb2 as jax_pb
from seaweedfs_tpu.pb import hbase_pb2 as jax_hbase_pb2
from seaweedfs_tpu.server import filer as jax_server
from seaweedfs_tpu.util import azure_client as jax_azure
from seaweedfs_tpu_torch.filer import filer as port_filer
from seaweedfs_tpu_torch.filer import filerstore as port_fstore
from seaweedfs_tpu_torch.filer.stores import cassandra_store as port_cassandra
from seaweedfs_tpu_torch.filer.stores import elastic_store as port_elastic
from seaweedfs_tpu_torch.filer.stores import etcd_store as port_etcd
from seaweedfs_tpu_torch.filer.stores import hbase_store as port_hbase
from seaweedfs_tpu_torch.filer.stores import mongodb_store as port_mongo
from seaweedfs_tpu_torch.filer.stores import redis_store as port_redis
from seaweedfs_tpu_torch.pb import filer_pb2 as port_pb
from seaweedfs_tpu_torch.pb import hbase_pb2 as port_hbase_pb2
from seaweedfs_tpu_torch.pb import wire
from seaweedfs_tpu_torch.server import filer as port_server
from seaweedfs_tpu_torch.util import azure_client as port_azure
from tests.fake_backends import (FakeCassandraServer, FakeElasticServer,
                                 FakeEtcdServer, FakeHBaseServer,
                                 FakeMongoServer, FakeRedisCluster,
                                 FakeRedisServer)
from tests.test_torch_filer import _dump, _store_script

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", pb=jax_pb, filer=jax_filer, fstore=jax_fstore,
        server=jax_server, redis=jax_redis, etcd=jax_etcd, mongo=jax_mongo,
        elastic=jax_elastic, cassandra=jax_cassandra, hbase=jax_hbase,
        hbase_pb2=jax_hbase_pb2, azure=jax_azure),
    "port": types.SimpleNamespace(
        name="port", pb=port_pb, filer=port_filer, fstore=port_fstore,
        server=port_server, redis=port_redis, etcd=port_etcd,
        mongo=port_mongo, elastic=port_elastic, cassandra=port_cassandra,
        hbase=port_hbase, hbase_pb2=port_hbase_pb2, azure=port_azure),
}

FLAVORS = ["redis", "redis_cluster", "etcd", "mongodb", "elastic",
           "cassandra", "hbase"]


@pytest.fixture(autouse=True)
def _frozen_entry_clock(monkeypatch):
    """Entry times (a parent directory made on the fly takes the clock)
    equal in both packages."""
    for mod in (jax_filer, port_filer):
        monkeypatch.setattr(mod, "_now", lambda: 1_760_000_000)


def both(fn):
    """fn(pkg) for the JAX package and the port; the results must be
    equal. Returns the port's."""
    want = fn(PKGS["jax"])
    got = fn(PKGS["port"])
    assert got == want
    return got


# -- fakes and stores ----------------------------------------------------------


def _fake(flavor, **kwargs):
    return {"redis": FakeRedisServer, "redis_cluster": FakeRedisCluster,
            "etcd": FakeEtcdServer, "mongodb": FakeMongoServer,
            "elastic": FakeElasticServer,
            "cassandra": FakeCassandraServer,
            "hbase": FakeHBaseServer}[flavor](**kwargs)


def _options(flavor, fake) -> dict:
    """The store's filer.toml section pointing at the fake."""
    if flavor == "redis_cluster":
        return {"addresses": fake.addresses}
    addr = f"127.0.0.1:{fake.port}"
    return {"redis": {"host": "127.0.0.1", "port": fake.port},
            "etcd": {"servers": addr},
            "mongodb": {"uri": f"mongodb://{addr}"},
            "elastic": {"servers": [addr]},
            "cassandra": {"hosts": [addr]},
            "hbase": {"zkquorum": addr}}[flavor]


def _open(pkg, flavor, fake):
    return pkg.server.make_filer_store(flavor, None, _options(flavor, fake))


class _Recorder:
    """A client socket that keeps every byte sent through it."""

    def __init__(self, sock):
        self._sock = sock
        self.sent = []

    def sendall(self, data):
        self.sent.append(bytes(data))
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def _record(store):
    """Wrap a socket client's connection; None for the HTTP stores and the
    cluster client (a connection per node)."""
    client = getattr(store, "client", None)
    if client is None or not hasattr(client, "_sock"):
        return None
    client._sock = _Recorder(client._sock)
    return client._sock


def _mask_gzip(v: bytes) -> bytes:
    """gzip's header bytes 4-7 hold the second it was written."""
    if v[:2] == b"\x1f\x8b":
        return v[:4] + b"\0\0\0\0" + v[8:]
    return v


def _state(flavor, fake):
    """The fake's raw state: what the store left on the server."""
    if flavor == "redis":
        return fake.data, {k: sorted(v) for k, v in fake.sets.items()}
    if flavor == "redis_cluster":
        return [(n["data"], {k: sorted(v) for k, v in n["sets"].items()})
                for n in fake.nodes]
    if flavor == "etcd":
        return fake.kv
    if flavor == "mongodb":
        # decoded documents: re-encode, so an int32 against an int64 or
        # a double shows
        return {k: jax_mongo.encode_doc(d) for k, d in fake.docs.items()}
    if flavor == "elastic":
        return fake.indices
    if flavor == "cassandra":
        return fake.partitions
    return {fam: {row: _mask_gzip(v) for row, v in rows.items()}
            for fam, rows in fake.rows.items()}


# -- the store contract ---------------------------------------------------------


class _DecodingElasticServer(FakeElasticServer):
    """The elastic fake, decoding each percent-encoded part of a request
    path as an Elasticsearch server does: an index created as
    ``/.seaweedfs_%E6%97%A5%E6%9C%AC`` is named ``.seaweedfs_日本``, and
    ``/_cat/indices`` lists it so."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        base = self._server.RequestHandlerClass

        class Handler(base):
            def _route(self):
                parts = super()._route()
                return None if parts is None else \
                    [urllib.parse.unquote(p) for p in parts]

        self._server.RequestHandlerClass = Handler


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("flavor", FLAVORS)
def test_store_contract_equals_jax(flavor, seed):
    """``_store_script`` on each package's store, each against its own
    fake: the transcripts, the fakes' raw state and every byte sent
    are equal. The elastic stores differ on purpose: the JAX store
    puts the index name, the top-level directory, raw into the request
    line, which is latin-1, so the script's "/日本" cannot be addressed;
    the port percent-encodes the path (its fake decodes it, as
    Elasticsearch does), agrees with the JAX transcript up to that call
    and then keeps the whole contract: its transcript is the JAX memory
    store's."""
    def run(pkg, fake_cls=None):
        fake = fake_cls() if fake_cls else _fake(flavor)
        try:
            store = _open(pkg, flavor, fake)
            rec = _record(store)
            log = []
            try:
                _store_script(pkg, store, seed, log)
            except UnicodeEncodeError as e:
                log.append(("raised", type(e).__name__, str(e)))
            finally:
                store.close()
            return log, _state(flavor, fake), rec and rec.sent
        finally:
            fake.stop()

    if flavor != "elastic":
        log, state, _ = both(run)
        assert len(log) > 100
        assert state
        return
    jax_log, jax_state, _ = run(PKGS["jax"])
    log, state, _ = run(PKGS["port"], _DecodingElasticServer)
    assert jax_log[-1][:2] == ("raised", "UnicodeEncodeError")
    assert jax_state
    assert log[:len(jax_log) - 1] == jax_log[:-1]
    assert log == _store_script(PKGS["jax"], jax_mem.MemoryStore(), seed)
    assert ".seaweedfs_日本" in state and len(log) > 100


def _write_tree(pkg, store):
    f = pkg.filer.Filer(store)
    f.meta_log.buffer._stopping = True
    for i in range(40):
        d = f"/t{i % 4}/s{i % 3}"
        e = pkg.filer.new_entry(f"f{i}", mime="a/b")
        e.chunks.add(file_id=f"{i % 5 + 1},{i:x}", size=i + 1, offset=0)
        f.create_entry(d, e)
    f.store.kv_put(b"\x01", b"one")
    f.store.kv_put(b"\x02", b"two" * 50)
    written = _dump(pkg, f.store.store)
    f.meta_log.close()
    return written


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("flavor", FLAVORS)
def test_tree_written_by_one_package_reads_in_the_other(flavor, writer,
                                                        reader):
    """The writer's filer builds a tree on the fake; the reader's store,
    opened on the same fake, lists every entry and kv value equal."""
    w_pkg, r_pkg = PKGS[writer], PKGS[reader]
    fake = _fake(flavor)
    try:
        store = _open(w_pkg, flavor, fake)
        try:
            written = _write_tree(w_pkg, store)
        finally:
            store.close()
        store = _open(r_pkg, flavor, fake)
        try:
            got = _dump(r_pkg, store)
        finally:
            store.close()
    finally:
        fake.stop()
    assert got == written and len(written[0]) > 40


def test_factory_builds_every_jax_store_name():
    """make_filer_store knows every name the JAX factory knows, with the
    same store names; an unknown one lists them all."""
    for flavor, names in (("redis", ["redis"]),
                          ("redis_cluster", ["redis_cluster",
                                             "redis_cluster2"]),
                          ("etcd", ["etcd"]), ("mongodb", ["mongodb"]),
                          ("elastic", ["elastic", "elastic7"]),
                          ("cassandra", ["cassandra"]),
                          ("hbase", ["hbase"])):
        fake = _fake(flavor)
        try:
            for n in names:
                got = []
                for pkg in PKGS.values():
                    s = pkg.server.make_filer_store(
                        n, None, _options(flavor, fake))
                    got.append((type(s).__name__, s.name))
                    s.close()
                assert got[0] == got[1]
        finally:
            fake.stop()
    errors = []
    for pkg in PKGS.values():
        with pytest.raises(ValueError) as ei:
            pkg.server.make_filer_store("bogus", None)
        errors.append(str(ei.value))
    # the port's list names the two redis cluster stores it builds; the
    # JAX list leaves them out (a difference kept on purpose)
    assert "redis_cluster | redis_cluster2" not in errors[0]
    assert errors[1].replace("redis_cluster | redis_cluster2 | ", "") == \
        errors[0]


# -- codecs ----------------------------------------------------------------------


def _bson_value(rng, depth=0):
    kind = int(rng.integers(0, 10 if depth < 2 else 8))
    if kind == 0:
        return bool(rng.integers(2))
    if kind == 1:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x3000, 5))
    if kind == 2:
        return bytes(rng.integers(0, 256, int(rng.integers(0, 9)),
                                  dtype=np.uint8))
    if kind == 3:
        return int(rng.choice([0, 1, -1, 2**31 - 1, -2**31, 2**31,
                               -2**31 - 1, 2**62]))
    if kind == 4:
        return int(rng.integers(-2**40, 2**40))
    if kind == 5:
        return float(rng.normal() * 1e6)
    if kind == 6:
        return None
    if kind == 7:
        return "ü\udcff"            # a lone surrogate escapes both ways
    if kind == 8:
        return {f"k{i}": _bson_value(rng, depth + 1)
                for i in range(int(rng.integers(0, 4)))}
    return [_bson_value(rng, depth + 1)
            for _ in range(int(rng.integers(0, 4)))]


@pytest.mark.parametrize("seed", range(4))
def test_bson_documents_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        doc = {f"f{i}": _bson_value(rng)
               for i in range(int(rng.integers(0, 8)))}
        doc["t"] = (1, 2.5, "x")       # a tuple goes out as an array
        blob = both(lambda pkg: pkg.mongo.encode_doc(doc))
        assert both(lambda pkg: pkg.mongo.decode_doc(blob)) == \
            port_mongo.decode_doc(blob)


def test_bson_bad_documents_raise_mongo_error_in_both():
    good = jax_mongo.encode_doc({"hello": "world"})
    for bad in (good[:10], struct.pack("<i", 1 << 20) + b"\0" * 16,
                b"\x15\x00\x00\x00\x07_id\x00" + b"\xaa" * 12 + b"\x00"):
        def run(pkg, bad=bad):
            with pytest.raises(pkg.mongo.MongoError) as ei:
                pkg.mongo.decode_doc(bad)
            return str(ei.value)
        both(run)
    # the spec's corpus documents
    assert port_mongo.encode_doc({"hello": "world"}) == (
        b"\x16\x00\x00\x00\x02hello\x00\x06\x00\x00\x00world\x00\x00")
    assert port_mongo.encode_doc({"BSON": ["awesome", 5.05, 1986]}) == (
        b"\x31\x00\x00\x00\x04BSON\x00\x26\x00\x00\x00"
        b"\x020\x00\x08\x00\x00\x00awesome\x00"
        b"\x011\x00\x33\x33\x33\x33\x33\x33\x14\x40"
        b"\x102\x00\xc2\x07\x00\x00\x00\x00")
    with pytest.raises(TypeError):
        port_mongo.encode_doc({"x": object()})


def _tcp_pair():
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    client = socket.create_connection(lst.getsockname())
    server, _ = lst.accept()
    lst.close()
    return client, server


def _wire(replies: bytes, run):
    """run() with every socket.create_connection answered by one TCP
    connection whose server side has ``replies`` queued and then hangs
    up; returns run()'s
    result (or its exception's type name and text) and every byte the
    client sent."""
    client, server = _tcp_pair()
    client.settimeout(10)
    server.sendall(replies)
    server.shutdown(socket.SHUT_WR)        # then the server hangs up
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(socket, "create_connection", lambda *a, **k: client)
        try:
            out = run()
        except Exception as e:             # compared between packages
            out = (type(e).__name__, str(e))
    try:
        client.shutdown(socket.SHUT_WR)    # a client's makefile holds it
    except OSError:
        pass
    client.close()
    server.settimeout(5)
    sent = b""
    while True:
        chunk = server.recv(1 << 16)
        if not chunk:
            break
        sent += chunk
    server.close()
    return out, sent


def _opmsg(doc, response_to):
    body = struct.pack("<I", 0) + b"\x00" + jax_mongo.encode_doc(doc)
    return struct.pack("<iiii", 16 + len(body), 99, response_to,
                       2013) + body


def test_opmsg_frames_and_error_reply_equal_jax():
    rng = np.random.default_rng(7)
    cmds = [{"find": "filemeta", "$db": "seaweedfs",
             "filter": {"directory": "/d", "name": {"$gt": "a"}},
             "limit": int(rng.integers(1, 1 << 33))},
            {"update": "filemeta", "$db": "x", "updates": [
                {"q": {"directory": "/", "name": "n"},
                 "u": {"$set": {"meta": bytes(rng.integers(
                     0, 256, 40, dtype=np.uint8))}}, "upsert": True}]},
            {"ping": 1, "$db": "x"}]
    replies = _opmsg({"ok": 1.0, "n": 2**40}, 1) + \
        _opmsg({"ok": 1, "cursor": {"id": 0, "firstBatch": []}}, 2) + \
        _opmsg({"ok": 0.0, "errmsg": "boom", "code": 11000}, 3) + \
        struct.pack("<iiii", 21, 9, 4, 1) + b"\0" * 5   # not OP_MSG

    def run(pkg):
        def calls():
            c = pkg.mongo.MongoClient()
            out = []
            for cmd in cmds + [{"ping": 2}]:
                try:
                    out.append(c.command(cmd))
                except pkg.mongo.MongoError as e:
                    out.append(str(e))
            c.close()
            return out
        return _wire(replies, calls)

    out, sent = both(run)
    assert out[0] == {"ok": 1.0, "n": 2**40} and out[2] == "boom"
    assert out[3] == "unexpected opcode 1"
    assert struct.unpack_from("<iiii", sent)[3] == 2013


def _cql(opcode, body, stream):
    return struct.pack(">BBhBi", 0x84, 0, stream, opcode, len(body)) + body


def _cql_string(s):
    return struct.pack(">H", len(s)) + s.encode()


def _rows(cols, rows, flags=0x0001):
    out = struct.pack(">i", 2) + struct.pack(">ii", flags, len(cols))
    if flags & 0x0004:
        out += struct.pack(">i", 3) + b"pgs"
    if flags & 0x0001:
        out += _cql_string("ks") + _cql_string("filemeta")
    if not flags & 0x0002:
        for c in cols:
            if not flags & 0x0001:
                out += _cql_string("ks") + _cql_string("filemeta")
            out += _cql_string(c) + struct.pack(">H", 0x0003)
    out += struct.pack(">i", len(rows))
    for row in rows:
        for cell in row:
            out += struct.pack(">i", -1) if cell is None else \
                struct.pack(">i", len(cell)) + cell
    return out


@pytest.mark.parametrize("auth", [False, True])
def test_cql_startup_auth_and_query_frames_equal_jax(auth):
    rng = np.random.default_rng(11)
    values = tuple(bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
                   for n in rng.integers(0, 30, 3))
    replies = (_cql(0x03, _cql_string("PasswordAuthenticator"), 1) +
               _cql(0x10, struct.pack(">i", -1), 2) if auth
               else _cql(0x02, b"", 1))
    s0 = 3 if auth else 2
    replies += _cql(0x08, _rows(["name", "meta"],
                                [[b"a", b"1"], [b"b", None]]), s0)
    replies += _cql(0x08, _rows(["meta"], [[b"m"]], flags=0x0004), s0 + 1)
    replies += _cql(0x08, _rows(["meta"], [[b"z"]], flags=0x0002), s0 + 2)
    replies += _cql(0x08, struct.pack(">i", 1), s0 + 3)
    replies += _cql(0x00, struct.pack(">i", 0x2200) +
                    _cql_string("keyspace does not exist"), s0 + 4)

    def run(pkg):
        def calls():
            c = pkg.cassandra.CqlClient(username="cassandra",
                                        password="s3cret")
            out = [c.query("SELECT name, meta FROM ks.filemeta WHERE "
                           "directory=?", values[:1]),
                   c.query("SELECT meta FROM t", values,
                           consistency=pkg.cassandra.CONSISTENCY_ONE),
                   c.query("SELECT meta FROM t"),
                   c.query("INSERT INTO t (directory,name,meta) VALUES "
                           "(?,?,?)", values)]
            with pytest.raises(pkg.cassandra.CassandraError) as ei:
                c.query("SELECT x FROM missing")
            out.append(str(ei.value))
            c.close()
            return out
        return _wire(replies, calls)

    out, sent = both(run)
    assert out[0] == [[b"a", b"1"], [b"b", None]] and out[3] is None
    assert "0x2200" in out[4] and "keyspace does not exist" in out[4]
    assert sent[:9] == struct.pack(">BBhBi", 4, 0, 1, 1, 22)
    if auth:
        assert b"\x00cassandra\x00s3cret" in sent


def test_cql_error_and_truncated_frames_raise_equal():
    for replies in (_cql(0x00, struct.pack(">i", 0x0100) +
                         _cql_string("bad credentials"), 1),
                    b"\x84\x00",
                    _cql(0x08, b"", 1)):
        def run(pkg, replies=replies):
            return _wire(replies, lambda: pkg.cassandra.CqlClient())
        out, _ = both(run)
        assert out[0] == "CassandraError", out


def test_resp_commands_and_every_reply_kind_equal_jax():
    rng = np.random.default_rng(3)
    args = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
            for n in rng.integers(0, 40, 6)]
    replies = (b"+PONG\r\n" b":42\r\n" b":-7\r\n" b"$5\r\nhe\r\no\r\n"
               b"$-1\r\n" b"$0\r\n\r\n"
               b"*3\r\n$1\r\na\r\n:1\r\n*2\r\n+x\r\n$-1\r\n"
               b"*-1\r\n" b"*0\r\n"
               b"-WRONGTYPE Operation against a key\r\n"
               b"+OK\r\n:1\r\n"       # ASKING's +OK, then the command's
               b"?bad\r\n")

    def run(pkg):
        def calls():
            c = pkg.redis.RespClient()
            out = []
            for i in range(9):
                out.append(c.command(b"CMD%d" % i, *args[:i % 6]))
            with pytest.raises(pkg.redis.RespError) as ei:
                c.command(b"GET", args[0])
            out.append(str(ei.value))
            out.append(c.command_asking(b"SET", b"k", args[1]))
            with pytest.raises(pkg.redis.RespError) as ei:
                c.command(b"PING")
            out.append(str(ei.value))
            with pytest.raises(pkg.redis.RespConnectionError):
                c.command(b"PING")
            c.close()
            return out
        return _wire(replies, calls)

    out, sent = both(run)
    assert out[:9] == [b"PONG", 42, -7, b"he\r\no", None, b"",
                       [b"a", 1, [b"x", None]], None, []]
    assert out[9].startswith("WRONGTYPE") and out[10] == 1
    assert sent.startswith(b"*1\r\n$4\r\nCMD0\r\n*2\r\n$4\r\nCMD1\r\n")


def test_resp_auth_select_and_scan_equal_jax():
    replies = (b"+OK\r\n+OK\r\n"
               b"*2\r\n$2\r\n17\r\n*1\r\n$2\r\nk1\r\n"
               b"*2\r\n$1\r\n0\r\n*2\r\n$2\r\nk2\r\n$2\r\nk3\r\n")

    def run(pkg):
        def calls():
            c = pkg.redis.RespClient(password="pw", database=3)
            got = list(c.scan_batches(b"/a[*]/*", count=7))
            c.close()
            return got
        return _wire(replies, calls)

    out, sent = both(run)
    assert out == [[b"k1"], [b"k2", b"k3"]]
    assert sent.startswith(b"*2\r\n$4\r\nAUTH\r\n$2\r\npw\r\n"
                           b"*2\r\n$6\r\nSELECT\r\n$1\r\n3\r\n")


def test_varints_and_hbase_call_frames_equal_jax():
    for n in (0, 1, 127, 128, 150, 300, 270, 2**32, 2**63 - 1):
        blob = both(lambda pkg: pkg.hbase._write_varint(n))
        assert both(lambda pkg: pkg.hbase._read_varint(blob, 0)) == \
            (n, len(blob))
    with pytest.raises(port_hbase.HBaseError, match="varint too long"):
        port_hbase._read_varint(b"\xff" * 11, 0)
    h = jax_hbase_pb2
    rh = [h.ResponseHeader(call_id=i + 1) for i in range(4)]
    get = h.GetResponse()
    get.result.cell.add(row=b"/row", family=b"meta", qualifier=b"a",
                        cell_type=h.PUT, value=b"V")
    exc = h.ResponseHeader(call_id=4)
    exc.exception.exception_class_name = "org.apache.hadoop.hbase." \
        "NotServingRegionException"
    exc.exception.stack_trace = "at region"

    def frame(*msgs):
        payload = b"".join(jax_hbase._delimited(m) for m in msgs)
        return struct.pack(">I", len(payload)) + payload

    replies = frame(rh[0], get) + frame(rh[1], h.MutateResponse(
        processed=True)) + frame(rh[2], h.MutateResponse()) + frame(exc)

    def run(pkg):
        def calls():
            c = pkg.hbase.HBaseClient(table="t")
            out = [c.get(b"meta", b"/row")]
            c.put(b"meta", b"/row", b"v" * 40, ttl_sec=90)
            c.delete(b"kv", b"\x01\x02")
            with pytest.raises(pkg.hbase.HBaseError) as ei:
                c.get(b"meta", b"/other")
            out.append((ei.value.class_name, str(ei.value)))
            c.close()
            return out
        return _wire(replies, calls)

    out, sent = both(run)
    assert out[0] == b"V" and "NotServingRegion" in out[1][0]
    assert sent[:6] == b"HBas\x00\x50"


@pytest.mark.parametrize("seed", range(3))
def test_azure_string_to_sign_and_sign_equal_jax(seed):
    rng = np.random.default_rng(seed)
    key = base64.b64encode(bytes(rng.integers(0, 256, 32,
                                              dtype=np.uint8))).decode()
    for _ in range(40):
        method = ["GET", "PUT", "DELETE", "HEAD"][int(rng.integers(4))]
        path = "/c/" + "/".join(f"p{int(x)}" for x in rng.integers(
            0, 99, int(rng.integers(1, 4))))
        query = [(["restype", "comp", "prefix", "Marker"][int(i)],
                  f"v{int(rng.integers(9))}")
                 for i in rng.integers(0, 4, int(rng.integers(0, 3)))]
        headers = {"x-ms-date": "Sat, 17 Oct 2026 18:00:00 GMT",
                   "x-ms-version": "2019-12-12"}
        for name in ("Content-Type", "X-MS-Blob-Type", "Range",
                     "If-Match", "Content-MD5", "x-ms-meta-a"):
            if rng.random() < 0.4:
                headers[name] = f"h{int(rng.integers(99))}"
        length = int(rng.choice([0, 1, int(rng.integers(2, 1 << 30))]))
        sts = both(lambda pkg: pkg.azure.string_to_sign(
            method, "acct", path, query, headers, length))
        assert both(lambda pkg: pkg.azure.sign("acct", key, sts))


# -- pb/hbase_pb2 against protobuf ----------------------------------------------

_KIND = {FieldDescriptor.TYPE_STRING: "string",
         FieldDescriptor.TYPE_BYTES: "bytes",
         FieldDescriptor.TYPE_BOOL: "bool",
         FieldDescriptor.TYPE_UINT32: "uint32",
         FieldDescriptor.TYPE_UINT64: "uint64",
         FieldDescriptor.TYPE_INT32: "int32",
         FieldDescriptor.TYPE_ENUM: "enum",
         FieldDescriptor.TYPE_MESSAGE: "message"}


def _label(f):
    return wire.REPEATED if f.is_repeated else \
        wire.REQUIRED if f.is_required else None


def _port_classes():
    out = []

    def walk(cls):
        out.append(cls)
        for sub in vars(cls).values():
            if isinstance(sub, type) and issubclass(sub, wire.Message):
                walk(sub)

    for v in vars(port_hbase_pb2).values():
        if isinstance(v, type) and issubclass(v, wire.Message) and \
                v.__module__ == port_hbase_pb2.__name__:
            walk(v)
    return out


def _jax_class(full_name):
    cls = jax_hbase_pb2
    for part in full_name.split(".")[1:]:
        cls = getattr(cls, part)
    return cls


CLASSES = _port_classes()


def test_every_hbase_message_and_enum_is_ported():
    names = {c.FULL_NAME for c in CLASSES}
    want = {d.full_name for d in jax_hbase_pb2.DESCRIPTOR
            .message_types_by_name.values()}
    for d in list(jax_hbase_pb2.DESCRIPTOR.message_types_by_name.values()):
        stack = list(d.nested_types)
        while stack:
            n = stack.pop()
            want.add(n.full_name)
            stack.extend(n.nested_types)
    assert names == want and len(names) == 22
    for enum in ("CellType", "RegionSpecifier.RegionSpecifierType",
                 "MutationProto.Durability", "MutationProto.MutationType",
                 "MutationProto.DeleteType"):
        jcls, pcls = jax_hbase_pb2, port_hbase_pb2
        for part in enum.split("."):
            jcls, pcls = getattr(jcls, part), getattr(pcls, part)
        assert dict(jcls.items()) == pcls._VALUES
        assert pcls.FULL_NAME == "hbase_pb." + enum
        holder_j = jax_hbase_pb2 if "." not in enum else getattr(
            jax_hbase_pb2, enum.split(".")[0])
        holder_p = port_hbase_pb2 if "." not in enum else getattr(
            port_hbase_pb2, enum.split(".")[0])
        for k, v in jcls.items():
            assert getattr(holder_j, k) == getattr(holder_p, k) == v


@pytest.mark.parametrize("cls", CLASSES, ids=[c.FULL_NAME for c in CLASSES])
def test_hbase_field_table_equals_jax_descriptor(cls):
    desc = _jax_class(cls.FULL_NAME).DESCRIPTOR
    want = sorted(
        (f.name, f.number, _KIND[f.type], _label(f),
         (f.message_type or f.enum_type).full_name
         if f.message_type or f.enum_type else None,
         None if f.is_repeated or f.message_type else f.default_value)
        for f in desc.fields)
    got = sorted(
        (f.name, f.number, f.kind,
         wire.REPEATED if f.repeated else
         wire.REQUIRED if f.required else None,
         f.cls.FULL_NAME if f.cls else None,
         None if f.repeated or f.kind == "message" else f.default)
        for f in cls._FIELDS)
    assert got == want


def _scalar(kind, enum_cls, rng):
    def pick(options):
        return options[int(rng.integers(len(options)))]

    if kind == "enum":
        return pick(list(enum_cls._VALUES.values()))
    if kind == "string":
        return pick(["", "a", "ü日本", "x" * 200])
    if kind == "bytes":
        return bytes(rng.integers(0, 256, int(rng.integers(0, 60)),
                                  dtype=np.uint8))
    if kind == "bool":
        return bool(rng.integers(2))
    if kind == "uint32":
        return pick([0, 1, 127, 128, 2**32 - 1,
                     int(rng.integers(0, 2**32))])
    if kind == "uint64":
        return pick([0, 1, 2**63, 2**64 - 1, int(rng.integers(0, 2**63))])
    return pick([0, -1, 1, -2**31, 2**31 - 1])


def _random_pair(cls, rng, depth=0):
    """The same random values as a port message and a protobuf one: an
    optional field is left unset about a third of the time (a field with
    a default is set to its default another third), a required one one
    time in ten."""
    kw = {}
    for f in cls._FIELDS:
        if rng.random() < (0.1 if f.required else 0.33):
            continue
        if f.kind == "message":
            if depth >= 3:
                continue
            n = int(rng.integers(0, 3)) if f.repeated else 1
            kw[f.name] = [_random_pair(f.cls, rng, depth + 1)
                          for _ in range(n)]
        elif f.repeated:
            kw[f.name] = [_scalar(f.kind, f.cls, rng)
                          for _ in range(int(rng.integers(0, 4)))]
        elif rng.random() < 0.33:
            kw[f.name] = f.default
        else:
            kw[f.name] = _scalar(f.kind, f.cls, rng)
    port_kw, jax_kw = {}, {}
    for name, v in kw.items():
        f = cls._BY_NAME[name]
        if f.kind == "message":
            port_kw[name] = [p for p, _ in v] if f.repeated else v[0][0]
            jax_kw[name] = [j for _, j in v] if f.repeated else v[0][1]
        else:
            port_kw[name] = jax_kw[name] = v
    return cls(**port_kw), _jax_class(cls.FULL_NAME)(**jax_kw)


def _presence(msg, cls):
    return [(f.name, msg.HasField(f.name)) for f in cls._FIELDS
            if not f.repeated]


@pytest.mark.parametrize("cls", CLASSES, ids=[c.FULL_NAME for c in CLASSES])
def test_hbase_messages_encode_to_protobuf_bytes(cls):
    """At least 200 seeded messages of the type: protobuf's bytes, or its
    EncodeError text for a required field left out; the parse of
    protobuf's bytes is equal, re-encodes the same, and says the same
    HasField for every singular field, a default set or not."""
    from google.protobuf.message import EncodeError
    rng = np.random.default_rng(zlib.crc32(cls.FULL_NAME.encode()))
    encoded = 0
    for _ in range(200):
        port_msg, jax_msg = _random_pair(cls, rng)
        assert _presence(port_msg, cls) == _presence(jax_msg, cls)
        assert port_msg.IsInitialized() == jax_msg.IsInitialized()
        try:
            want = jax_msg.SerializeToString()
        except EncodeError as e:
            with pytest.raises(wire.EncodeError) as ei:
                port_msg.SerializeToString()
            assert str(ei.value) == str(e)
            continue
        encoded += 1
        assert port_msg.SerializeToString() == want
        assert port_msg.ByteSize() == jax_msg.ByteSize()
        back = cls.FromString(want)
        assert back == port_msg
        assert back.SerializeToString() == want
        parsed = _jax_class(cls.FULL_NAME).FromString(want)
        assert _presence(back, cls) == _presence(parsed, cls)
        for f in cls._FIELDS:
            if not f.repeated and f.kind != "message":
                assert getattr(back, f.name) == getattr(parsed, f.name)
    assert encoded >= 50


def test_hbase_proto2_rules():
    p, j = port_hbase_pb2, jax_hbase_pb2
    # an unset optional field reads as its [default] and is not written
    g = p.Get(row=b"r")
    assert (g.max_versions, g.cache_blocks, g.existence_only) == (1, True,
                                                                  False)
    assert g.SerializeToString() == j.Get(row=b"r").SerializeToString()
    # set to its default: present and written
    g.max_versions, g.existence_only = 1, False
    assert g.HasField("max_versions") and g.HasField("existence_only")
    assert g.SerializeToString() == j.Get(
        row=b"r", max_versions=1, existence_only=False).SerializeToString()
    # two-byte enum varint
    assert p.Cell(cell_type=p.MAXIMUM).SerializeToString() == b"(\xff\x01"
    assert p.MutationProto().durability == p.MutationProto.USE_DEFAULT
    # repeated numbers unpacked in proto2
    assert p.ScanResponse(cells_per_result=[1, 300]).SerializeToString() \
        == j.ScanResponse(cells_per_result=[1, 300]).SerializeToString() \
        == b"\x08\x01\x08\xac\x02"
    # required fields, named as protobuf names them
    with pytest.raises(wire.EncodeError, match="missing required fields: "
                       "region,get.column\\[1\\].family"):
        p.GetRequest(get=p.Get(row=b"r", column=[
            p.Column(family=b"f"), p.Column()])).SerializeToString()
    assert str(p.Cell(cell_type=p.MAXIMUM, row=b"r")) == \
        str(j.Cell(cell_type=j.MAXIMUM, row=b"r"))


# -- the adapters' behaviours -----------------------------------------------------


def test_redis_cluster_key_slot_vectors():
    keys = [b"", b"123456789", b"foo{bar}baz", b"{bar}", b"bar",
            b"foo{}bar", b"{user1000}.following", b"{user1000}.followers",
            b"a{b}{c}", b"{}", b"}{", b"/\xff\x00"]
    rng = np.random.default_rng(5)
    keys += [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
             for n in rng.integers(0, 30, 200)]
    slots = both(lambda pkg: [pkg.redis.key_slot(k) for k in keys])
    assert port_redis.crc16(b"123456789") == 0x31C3
    assert slots[2] == slots[3] == slots[4]
    assert slots[6] == slots[7]


def _cluster_case(pkg, fn):
    cl = FakeRedisCluster()
    s = pkg.redis.RedisClusterStore(cl.addresses)
    try:
        return fn(pkg, cl, s)
    finally:
        s.close()
        cl.stop()


def _ports(cl, node):
    """A node address as the index of the fake's node (ports differ)."""
    return [n["port"] for n in cl.nodes].index(node[1])


def test_redis_cluster_survives_a_slot_migration():
    def case(pkg, cl, s):
        s.insert_entry("/m", pkg.filer.new_entry("moved.txt"))
        slot = cl.slot_of(b"/m/moved.txt")
        dst = (cl.owner[slot] + 1) % len(cl.nodes)
        cl.migrate_slot(slot, dst)
        got = s.find_entry("/m", "moved.txt").SerializeToString()
        return got, _ports(cl, s.client._node_for(slot)), dst
    _, routed, dst = both(lambda pkg: _cluster_case(pkg, case))
    assert routed == dst


def test_redis_cluster_ask_redirect():
    def case(pkg, cl, s):
        slot = pkg.redis.key_slot(b"/a/ask.txt")
        src = cl.owner[slot]
        dst = (src + 1) % len(cl.nodes)
        cl.begin_migration(slot, dst)
        s.insert_entry("/a", pkg.filer.new_entry("ask.txt"))
        return (b"/a/ask.txt" in cl.nodes[dst]["data"],
                _ports(cl, s.client._node_for(slot)) == src)
    assert both(lambda pkg: _cluster_case(pkg, case)) == (True, True)


def test_redis_cluster_delete_many_groups_by_slot():
    def case(pkg, cl, s):
        keys = [f"/cs/k{i}".encode() for i in range(12)]
        for k in keys:
            s.client.command(b"SET", k, b"x")
        s.client.delete_many(keys)
        return (len({pkg.redis.key_slot(k) for k in keys}),
                [s.client.command(b"GET", k) for k in keys],
                [sorted(n["data"]) for n in cl.nodes])
    n_slots, got, _ = both(lambda pkg: _cluster_case(pkg, case))
    assert n_slots > 1 and got == [None] * 12


def test_redis_cluster_fails_over_when_a_node_dies():
    def case(pkg, cl, s):
        s.insert_entry("/ha", pkg.filer.new_entry("survivor.txt"))
        slot = pkg.redis.key_slot(b"/ha/survivor.txt")
        src = cl.owner[slot]
        dst = (src + 1) % len(cl.nodes)
        cl.migrate_slot(slot, dst)
        cl.kill_node(src)
        got = s.find_entry("/ha", "survivor.txt").name
        return got, _ports(cl, s.client._node_for(slot)) == dst
    assert both(lambda pkg: _cluster_case(pkg, case)) == \
        ("survivor.txt", True)


@pytest.mark.parametrize("flavor", FLAVORS)
def test_prefix_listing_beyond_the_limit(flavor):
    """The prefix is applied before the limit: 30 names before the one
    match must not starve it."""
    def run(pkg):
        fake = _fake(flavor)
        s = _open(pkg, flavor, fake)
        try:
            for i in range(30):
                s.insert_entry("/big", pkg.filer.new_entry(f"a{i:04d}"))
            s.insert_entry("/big", pkg.filer.new_entry("z-last"))
            return [e.name for e in s.list_directory_entries(
                "/big", prefix="z", limit=10)]
        finally:
            s.close()
            fake.stop()
    assert both(run) == ["z-last"]


def test_elastic_basic_auth():
    def run(pkg):
        fake = FakeElasticServer(username="elastic", password="sekrit")
        try:
            with pytest.raises(pkg.elastic.ElasticError) as ei:
                pkg.elastic.ElasticStore(
                    servers=[f"http://127.0.0.1:{fake.port}"],
                    username="elastic", password="wrong")
            s = pkg.server.make_filer_store(
                "elastic", None, {"servers": [f"127.0.0.1:{fake.port}"],
                                  "username": "elastic",
                                  "password": "sekrit"})
            s.insert_entry("/es", pkg.filer.new_entry("doc"))
            got = s.find_entry("/es", "doc").SerializeToString()
            s.close()
            return str(ei.value).split(" ", 2)[2][:8], got, fake.indices
        finally:
            fake.stop()
    err, _, indices = both(run)
    assert err == "http 401" and ".seaweedfs_es" in indices


def test_hbase_scan_batching_and_scanner_close():
    def run(pkg):
        srv = FakeHBaseServer()
        s = pkg.hbase.HBaseStore(port=srv.port)
        try:
            for i in range(150):       # more than the client's 64-row batch
                s.insert_entry("/big", pkg.filer.new_entry(f"e{i:04d}"))
            got = [e.name for e in s.list_directory_entries("/big",
                                                            limit=1024)]
            left = [rows for rows in srv.scanners.values() if rows]
            return got, list(srv.calls), left
        finally:
            s.close()
            srv.stop()
    got, calls, left = both(run)
    assert got == [f"e{i:04d}" for i in range(150)] and not left
    assert calls.count("Scan") >= 4       # open, continuations, close


def test_hbase_ttl_attribute_and_gzip_threshold():
    """TTL rides the "_ttl" mutation attribute in ms; an entry of more
    than 50 chunks is stored gzipped (equal but for gzip's MTIME) and read
    back whole; one of 50 is not."""
    def run(pkg):
        srv = FakeHBaseServer()
        s = pkg.hbase.HBaseStore(port=srv.port)
        sent = []
        orig = pkg.hbase_pb2.MutateRequest.SerializeToString

        def spy(self):
            sent.append(self.mutation.attribute[0].SerializeToString()
                        if len(self.mutation.attribute) else None)
            return orig(self)

        mp = pytest.MonkeyPatch()
        mp.setattr(pkg.hbase_pb2.MutateRequest, "SerializeToString", spy)
        try:
            s.insert_entry("/t", pkg.filer.new_entry("timed", ttl_sec=90))
            for n, name in ((60, "many"), (50, "fifty")):
                e = pkg.filer.new_entry(name)
                for i in range(n):
                    e.chunks.add(file_id=f"3,{i:08x}ab", size=1)
                s.insert_entry("/t", e)
            raw = {k: _mask_gzip(v) for k, v in
                   srv.rows[pkg.hbase.CF_META].items()}
            back = [len(s.find_entry("/t", n).chunks)
                    for n in ("many", "fifty")]
            return sent, raw, back
        finally:
            mp.undo()
            s.close()
            srv.stop()
    sent, raw, back = both(run)
    assert sent[0] == jax_hbase_pb2.NameBytesPair(
        name="_ttl", value=struct.pack(">q", 90_000)).SerializeToString()
    assert raw[b"/t/many"][:2] == b"\x1f\x8b" and \
        raw[b"/t/fifty"][:2] != b"\x1f\x8b"
    assert gzip.decompress(raw[b"/t/many"])
    assert back == [60, 50]


def test_hbase_server_exception_surfaces():
    def run(pkg):
        srv = FakeHBaseServer()
        c = pkg.hbase.HBaseClient(port=srv.port)
        try:
            with pytest.raises(pkg.hbase.HBaseError) as ei:
                c._call("Scan", pkg.hbase_pb2.ScanRequest(
                    scanner_id=999, number_of_rows=1),
                    pkg.hbase_pb2.ScanResponse)
            return ei.value.class_name, str(ei.value)
        finally:
            c.close()
            srv.stop()
    assert "UnknownScannerException" in both(run)[0]


def test_cassandra_password_authenticator_and_clustering_order():
    def run(pkg):
        srv = FakeCassandraServer(require_auth=True)
        s = pkg.cassandra.CassandraStore(port=srv.port, username="cassandra",
                                         password="cassandra")
        try:
            s.kv_put(b"k", b"v")
            for n in ("zeta", "alpha", "mid"):
                s.insert_entry("/c", pkg.filer.new_entry(n))
            return (s.kv_get(b"k"),
                    [e.name for e in s.list_directory_entries("/c")],
                    [e.name for e in s.list_directory_entries(
                        "/c", start_name="alpha", inclusive=False,
                        limit=1)],
                    [e.name for e in s.list_directory_entries(
                        "/c", start_name="mid", inclusive=True)],
                    srv.partitions)
        finally:
            s.close()
            srv.stop()
    kv, names, after, incl, _ = both(run)
    assert (kv, names, after, incl) == (b"v", ["alpha", "mid", "zeta"],
                                        ["mid"], ["mid", "zeta"])


def test_mongodb_binary_and_hard_link_keys():
    def run(pkg):
        srv = FakeMongoServer()
        s = pkg.mongo.MongodbStore(port=srv.port)
        try:
            key = b"\x01" + bytes(range(16)) + b"\xfe"
            out = [s.kv_get(key)]
            s.kv_put(key, b"shared meta blob")
            s.kv_put(b"ab", b"v2")
            out += [s.kv_get(key), s.kv_get(b"ab")]
            return out, _state("mongodb", srv)
        finally:
            s.close()
            srv.stop()
    got, _ = both(run)
    assert got == [None, b"shared meta blob", b"v2"]


def test_stores_threads_share_one_connection():
    """Concurrent calls through one store's client (its lock serializes
    request and reply) all answer right."""
    srv = FakeRedisServer()
    s = port_redis.RedisStore(port=srv.port)
    errors = []

    def worker(i):
        try:
            for j in range(30):
                e = port_filer.new_entry(f"w{i}-{j}")
                s.insert_entry(f"/w{i}", e)
                assert s.find_entry(f"/w{i}", e.name).name == e.name
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    s.close()
    srv.stop()
    assert not any(t.is_alive() for t in threads) and not errors
