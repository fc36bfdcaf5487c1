"""The port's filer core against the JAX package's.

Every case runs the same seeded inputs through both packages and compares
what comes out, byte for byte: the ``filer_pb`` messages (field tables,
service methods and wire bytes, map fields and repeated chunks included),
the chunk interval math and manifests (``filechunks``,
``filechunk_manifest``), the store contract on the memory, sqlite and
weedkv stores (a seeded sequence of inserts, updates, finds, deletes,
prefix listings, hard links and kv; a ``filer.db`` and a ``weedkv``
directory written by one package opened by the other), the mysql and
postgres SQL flavours over a recording fake DB-API driver, ``MetaLog``'s
segment files under a fake clock, listings through the listing cache,
``filer_conf`` rules, the log buffer framing, compression, the chunk
cache, the cipher with and without ``cryptography``, the metric families
the filer adds and ``-cpuprofile`` (``util/grace``); the networked
stores are held in ``tests/test_torch_stores.py``.
"""

import builtins
import os
import re
import sqlite3
import types
import zlib

import numpy as np
import pytest
from google.protobuf.descriptor import FieldDescriptor

from seaweedfs_tpu.filer import filechunk_manifest as jax_manifest
from seaweedfs_tpu.filer import filechunks as jax_chunks
from seaweedfs_tpu.filer import filer as jax_filer
from seaweedfs_tpu.filer import filer_conf as jax_conf
from seaweedfs_tpu.filer import filer_notify as jax_notify
from seaweedfs_tpu.filer import listing_cache as jax_listing
from seaweedfs_tpu.filer import filerstore as jax_fstore
from seaweedfs_tpu.filer.stores import abstract_sql as jax_sql
from seaweedfs_tpu.filer.stores import kv_store as jax_kv
from seaweedfs_tpu.filer.stores import memory_store as jax_mem
from seaweedfs_tpu.filer.stores import sqlite_store as jax_sqlite
from seaweedfs_tpu.pb import filer_pb2 as jax_pb
from seaweedfs_tpu.stats import metrics as jax_metrics
from seaweedfs_tpu.util import chunk_cache as jax_cc
from seaweedfs_tpu.util import cipher as jax_cipher
from seaweedfs_tpu.util import compression as jax_comp
from seaweedfs_tpu.util import log_buffer as jax_lb
from seaweedfs_tpu_torch.filer import filechunk_manifest as port_manifest
from seaweedfs_tpu_torch.filer import filechunks as port_chunks
from seaweedfs_tpu_torch.filer import filer as port_filer
from seaweedfs_tpu_torch.filer import filer_conf as port_conf
from seaweedfs_tpu_torch.filer import filer_notify as port_notify
from seaweedfs_tpu_torch.filer import listing_cache as port_listing
from seaweedfs_tpu_torch.filer import filerstore as port_fstore
from seaweedfs_tpu_torch.filer.stores import abstract_sql as port_sql
from seaweedfs_tpu_torch.filer.stores import kv_store as port_kv
from seaweedfs_tpu_torch.filer.stores import memory_store as port_mem
from seaweedfs_tpu_torch.filer.stores import sqlite_store as port_sqlite
from seaweedfs_tpu_torch.pb import filer_pb2 as port_pb
from seaweedfs_tpu_torch.pb.wire import Message
from seaweedfs_tpu_torch.stats import metrics as port_metrics
from seaweedfs_tpu_torch.util import chunk_cache as port_cc
from seaweedfs_tpu_torch.util import cipher as port_cipher
from seaweedfs_tpu_torch.util import compression as port_comp
from seaweedfs_tpu_torch.util import grace as port_grace
from seaweedfs_tpu_torch.util import log_buffer as port_lb

PKGS = {
    "jax": types.SimpleNamespace(
        pb=jax_pb, chunks=jax_chunks, manifest=jax_manifest,
        filer=jax_filer, conf=jax_conf, notify=jax_notify,
        listing=jax_listing, fstore=jax_fstore, sql=jax_sql, kv=jax_kv,
        mem=jax_mem, sqlite=jax_sqlite, cc=jax_cc, cipher=jax_cipher,
        comp=jax_comp, lb=jax_lb),
    "port": types.SimpleNamespace(
        pb=port_pb, chunks=port_chunks, manifest=port_manifest,
        filer=port_filer, conf=port_conf, notify=port_notify,
        listing=port_listing, fstore=port_fstore, sql=port_sql, kv=port_kv,
        mem=port_mem, sqlite=port_sqlite, cc=port_cc, cipher=port_cipher,
        comp=port_comp, lb=port_lb),
}


@pytest.fixture(autouse=True)
def _frozen_entry_clock(monkeypatch):
    """Entry times (a parent directory made on the fly takes the clock)
    equal in both packages, whatever second each run falls in."""
    for mod in (jax_filer, port_filer):
        monkeypatch.setattr(mod, "_now", lambda: 1_760_000_000)


def both(fn):
    """fn(pkg) for the JAX package and the port; the results must be
    equal. Returns the port's."""
    want = fn(PKGS["jax"])
    got = fn(PKGS["port"])
    assert got == want
    return got


# -- filer_pb: field tables, methods, wire bytes -------------------------------

_KIND = {FieldDescriptor.TYPE_STRING: "string",
         FieldDescriptor.TYPE_BYTES: "bytes",
         FieldDescriptor.TYPE_BOOL: "bool",
         FieldDescriptor.TYPE_UINT32: "uint32",
         FieldDescriptor.TYPE_UINT64: "uint64",
         FieldDescriptor.TYPE_INT32: "int32",
         FieldDescriptor.TYPE_INT64: "int64",
         FieldDescriptor.TYPE_FIXED32: "fixed32",
         FieldDescriptor.TYPE_MESSAGE: "message"}


def _port_classes():
    out = []

    def walk(cls):
        out.append(cls)
        for sub in vars(cls).values():
            if isinstance(sub, type) and issubclass(sub, Message):
                walk(sub)

    for v in vars(port_pb).values():
        if isinstance(v, type) and issubclass(v, Message) and \
                v.__module__ == port_pb.__name__:
            walk(v)
    return out


def _jax_class(full_name: str):
    cls = jax_pb
    for part in full_name.split(".")[1:]:
        cls = getattr(cls, part)
    return cls


CLASSES = _port_classes()
IDS = [c.FULL_NAME for c in CLASSES]


def _is_map(f) -> bool:
    return f.message_type is not None and \
        f.message_type.GetOptions().map_entry


def test_every_filer_message_is_ported():
    jax_names = set()

    def walk(desc):
        if desc.GetOptions().map_entry:
            return
        jax_names.add(desc.full_name)
        for n in desc.nested_types:
            walk(n)

    for d in jax_pb.DESCRIPTOR.message_types_by_name.values():
        walk(d)
    assert {c.FULL_NAME for c in CLASSES} == jax_names
    assert len(jax_names) == 47


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_field_table_equals_jax_descriptor(cls):
    desc = _jax_class(cls.FULL_NAME).DESCRIPTOR
    want = []
    for f in desc.fields:
        if _is_map(f):
            kf = f.message_type.fields_by_name["key"]
            vf = f.message_type.fields_by_name["value"]
            want.append((f.name, f.number, "map", _KIND[kf.type],
                         vf.message_type.full_name if vf.message_type
                         else _KIND[vf.type]))
        else:
            want.append((f.name, f.number, _KIND[f.type],
                         f.label == FieldDescriptor.LABEL_REPEATED,
                         f.message_type.full_name if f.message_type
                         else None))
    got = []
    for f in cls._FIELDS:
        if f.kind == "map":
            got.append((f.name, f.number, "map", f.map_key,
                        f.cls.FULL_NAME if f.cls else f.map_value))
        else:
            got.append((f.name, f.number, f.kind, f.repeated,
                        f.cls.FULL_NAME if f.cls else None))
    assert sorted(got) == sorted(want)


def test_service_methods_equal_jax_descriptor():
    svc = jax_pb.DESCRIPTOR.services_by_name["SeaweedFiler"]
    assert svc.full_name == f"{port_pb.PACKAGE}.SeaweedFiler"
    got = {(name, req.FULL_NAME, resp.FULL_NAME, cs, ss)
           for name, req, resp, cs, ss in port_pb.SERVICES["SeaweedFiler"]}
    want = {(m.name, m.input_type.full_name, m.output_type.full_name,
             m.client_streaming, m.server_streaming) for m in svc.methods}
    assert got == want
    streams = {m[0]: (m[3], m[4]) for m in port_pb.SERVICES["SeaweedFiler"]}
    assert streams["ListEntries"] == (False, True)
    assert streams["SubscribeMetadata"] == (False, True)
    assert streams["SubscribeLocalMetadata"] == (False, True)
    assert streams["KeepConnected"] == (True, True)


_TEXT = ["", "a", "dir/name.txt", "ünïcødé", "日本語", "x" * 300]


def _value(kind, rng):
    if kind == "string":
        return _TEXT[int(rng.integers(len(_TEXT)))]
    if kind == "bytes":
        return rng.integers(0, 256, int(rng.integers(0, 80)),
                            dtype=np.uint8).tobytes()
    if kind == "bool":
        return bool(rng.integers(2))
    if kind in ("uint32", "fixed32"):
        return [0, 1, 127, 128, 2**31, 2**32 - 1,
                int(rng.integers(0, 2**32))][int(rng.integers(7))]
    if kind == "uint64":
        return [0, 1, 2**32, 2**63, 2**64 - 1,
                int(rng.integers(0, 2**63))][int(rng.integers(6))]
    if kind == "int32":
        return [0, -1, 1, -2**31, 2**31 - 1,
                int(rng.integers(-2**31, 2**31))][int(rng.integers(6))]
    return [0, -1, -2**63, 2**63 - 1,
            int(rng.integers(-2**62, 2**62))][int(rng.integers(5))]


def _random_pair(cls, rng, depth=0, map_pairs=5):
    """The same random field values as a port message and a protobuf
    message; each field is left unset about a third of the time."""
    jcls = _jax_class(cls.FULL_NAME)
    p, j = cls(), jcls()
    for f in cls._FIELDS:
        if rng.random() < 0.3:
            continue
        if f.kind == "map":
            for _ in range(int(rng.integers(0, map_pairs))):
                key = _value(f.map_key, rng)
                if f.cls is not None:
                    if depth >= 2:
                        continue
                    sp, sj = _random_pair(f.cls, rng, depth + 1, map_pairs)
                    getattr(p, f.name)[key].CopyFrom(sp)
                    getattr(j, f.name)[key].CopyFrom(sj)
                else:
                    v = _value(f.map_value, rng)
                    getattr(p, f.name)[key] = v
                    getattr(j, f.name)[key] = v
        elif f.kind == "message":
            if depth >= 3:
                continue
            n = int(rng.integers(0, 4)) if f.repeated else 1
            for _ in range(n):
                sp, sj = _random_pair(f.cls, rng, depth + 1, map_pairs)
                if f.repeated:
                    getattr(p, f.name).append(sp)
                    getattr(j, f.name).append(sj)
                else:
                    getattr(p, f.name).CopyFrom(sp)
                    getattr(j, f.name).CopyFrom(sj)
        elif f.repeated:
            vals = [_value(f.kind, rng)
                    for _ in range(int(rng.integers(0, 5)))]
            getattr(p, f.name).extend(vals)
            getattr(j, f.name).extend(vals)
        else:
            v = _value(f.kind, rng)
            setattr(p, f.name, v)
            setattr(j, f.name, v)
    return p, j


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_encoding_is_byte_equal_to_protobuf(cls):
    """Both directions: the port's bytes are protobuf's (its
    deterministic map order), and protobuf's bytes parse to the port's
    message; a message with at most one pair per map is equal to
    protobuf's plain SerializeToString too."""
    rng = np.random.default_rng(zlib.crc32(cls.FULL_NAME.encode()))
    for _ in range(10):
        port_msg, jax_msg = _random_pair(cls, rng)
        want = jax_msg.SerializeToString(deterministic=True)
        assert port_msg.SerializeToString() == want
        assert cls.FromString(want) == port_msg
        assert cls.FromString(jax_msg.SerializeToString()) == port_msg
        assert _jax_class(cls.FULL_NAME).FromString(
            port_msg.SerializeToString()) == jax_msg
    assert cls().SerializeToString() == b""


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_text_format_equals_protobuf(cls):
    """str() of a message is protobuf's text format (what fs.meta.cat
    prints); maps hold at most one pair here, since protobuf prints the
    pairs of a larger map in its hash order."""
    rng = np.random.default_rng(zlib.crc32(cls.FULL_NAME.encode()) + 1)
    for _ in range(6):
        port_msg, jax_msg = _random_pair(cls, rng, map_pairs=2)
        assert str(port_msg) == str(jax_msg)


def test_entry_extended_chunks_and_locations_map():
    """The map fields and repeated chunks, spelled out: one pair per map
    equals protobuf's plain bytes; many pairs its deterministic order,
    which keys a longer key before its own prefix."""
    for pb in (jax_pb, port_pb):
        e = pb.Entry(name="f.bin", is_directory=False)
        e.extended["x-amz-meta"] = b"\x00\xffv"
        e.chunks.add(file_id="3,01637037d6", offset=0, size=10,
                     fid=pb.FileId(volume_id=3, file_key=0x1637,
                                   cookie=0xdeadbeef))
        e.chunks.add(file_id="4,02", offset=10, size=5, is_compressed=True)
        e.attributes.group_name.extend(["g1", "g2"])
        r = pb.LookupVolumeResponse()
        r.locations_map["7"].locations.add(url="a:1", public_url="a:1")
        if pb is jax_pb:
            want_e, want_r = e.SerializeToString(), r.SerializeToString()
    assert e.SerializeToString() == want_e
    assert r.SerializeToString() == want_r
    for pb in (jax_pb, port_pb):
        m = pb.Entry()
        for k in ("ab", "a", "abc", "", "b", "aa"):
            m.extended[k] = k.encode()
        if pb is jax_pb:
            want = m.SerializeToString(deterministic=True)
    assert m.SerializeToString() == want
    assert port_pb.LookupVolumeResponse().locations_map.get("7") is None


# -- chunk intervals and manifests ---------------------------------------------


def _seeded_chunks(pkg, seed, n=None, manifests=False):
    """Overlapping chunks: random offsets/sizes/mtimes, some shadowed."""
    rng = np.random.default_rng(seed)
    n = n if n is not None else int(rng.integers(1, 24))
    out = []
    for i in range(n):
        off = int(rng.integers(0, 1 << 16))
        out.append(pkg.pb.FileChunk(
            file_id=f"{int(rng.integers(1, 9))},{i:x}{seed:02x}",
            offset=off, size=int(rng.integers(1, 1 << 14)),
            mtime=int(rng.integers(1, 1 << 40)),
            e_tag=f"{int(rng.integers(0, 1 << 60)):x}",
            cipher_key=b"k" * int(rng.integers(0, 2)) * 32,
            is_compressed=bool(rng.integers(2)),
            is_chunk_manifest=manifests and bool(rng.integers(4) == 0)))
    return out


def _views(views):
    return [(v.file_id, v.offset, v.size, v.logic_offset, v.chunk_size,
             bytes(v.cipher_key), v.is_compressed) for v in views]


@pytest.mark.parametrize("seed", range(8))
def test_visible_intervals_and_views_equal_jax(seed):
    def run(pkg):
        chunks = _seeded_chunks(pkg, seed)
        vis = pkg.chunks.non_overlapping_visible_intervals(chunks)
        rng = np.random.default_rng(seed + 100)
        windows = [(0, None)] + [
            (int(rng.integers(0, 1 << 16)), int(rng.integers(0, 1 << 15)))
            for _ in range(6)]
        return ([(v.start, v.stop, v.file_id, v.mtime, v.chunk_offset,
                  v.chunk_size, bytes(v.cipher_key), v.is_compressed)
                 for v in vis],
                [_views(pkg.chunks.view_from_chunks(chunks, o, s))
                 for o, s in windows],
                pkg.chunks.total_size(chunks),
                [c.SerializeToString() for c in
                 pkg.chunks.truncate_chunks(chunks, 1 << 15)])
    both(run)


@pytest.mark.parametrize("seed", range(8))
def test_etag_compact_unused_equal_jax(seed):
    def run(pkg):
        chunks = _seeded_chunks(pkg, seed)
        newer = _seeded_chunks(pkg, seed + 50)
        compacted, garbage = pkg.chunks.compact_file_chunks(chunks)
        unused = pkg.chunks.find_unused_file_chunks(
            chunks, newer + chunks[: len(chunks) // 2])
        return (pkg.chunks.etag_of_chunks(chunks),
                pkg.chunks.etag_of_chunks(chunks[:1]),
                [c.file_id for c in compacted], [c.file_id for c in garbage],
                [c.file_id for c in unused])
    both(run)


@pytest.mark.parametrize("n,batch", [(5, 4), (9, 4), (1001, 1000),
                                     (30, 7), (3, 10)])
def test_maybe_manifestize_and_resolve_equal_jax(n, batch):
    def run(pkg):
        chunks = _seeded_chunks(pkg, n, n=n)
        blobs = {}

        def save(blob):
            fid = f"99,{len(blobs):x}"
            blobs[fid] = blob
            return pkg.pb.FileChunk(file_id=fid, size=len(blob), mtime=7,
                                    e_tag=f"m{len(blobs)}")

        out = pkg.manifest.maybe_manifestize(save, chunks, batch=batch)
        resolved = pkg.manifest.resolve_chunk_manifest(
            lambda c: blobs[c.file_id], list(out))
        return ([c.SerializeToString() for c in out], sorted(blobs.items()),
                pkg.manifest.has_chunk_manifest(out),
                [c.SerializeToString() for c in resolved])
    both(run)


# -- stores --------------------------------------------------------------------


def _make_store(pkg, kind, tmp_path):
    if kind == "memory":
        return pkg.mem.MemoryStore()
    if kind == "sqlite":
        return pkg.sqlite.SqliteStore(str(tmp_path / "filer.db"))
    return pkg.kv.KvFilerStore(str(tmp_path / "weedkv"))


def _store_script(pkg, store, seed, log=None):
    """One seeded sequence of store calls through FilerStoreWrapper; the
    transcript of every result (appended to ``log`` when one is given,
    so that a caller keeps it if a call raises)."""
    rng = np.random.default_rng(seed)
    w = pkg.fstore.FilerStoreWrapper(store)
    dirs = ["/", "/a", "/a/b", "/a_b", "/c/d%e", "/日本"]
    names = ["x", "y", "x1", "x_2", "z%", "ü", "a.txt", "b.txt"]
    log = [] if log is None else log

    def entry(name):
        e = pkg.filer.new_entry(name, mime="t/x")
        e.attributes.crtime = e.attributes.mtime = int(
            rng.integers(1, 1 << 31))
        e.attributes.file_size = int(rng.integers(0, 1 << 20))
        if rng.random() < 0.5:
            e.chunks.add(file_id=f"{int(rng.integers(1, 9))},ab",
                         size=int(rng.integers(1, 99)))
        if rng.random() < 0.2:
            e.extended["k"] = bytes(rng.integers(0, 256, 3, dtype=np.uint8))
        return e

    for step in range(160):
        op = int(rng.integers(0, 8))
        d = dirs[int(rng.integers(len(dirs)))]
        n = names[int(rng.integers(len(names)))]
        if op <= 1:
            w.insert_entry(d, entry(n))
            log.append(("insert", d, n))
        elif op == 2:
            w.update_entry(d, entry(n))
            log.append(("update", d, n))
        elif op == 3:
            try:
                log.append(("find", w.find_entry(d, n).SerializeToString()))
            except pkg.fstore.NotFound:
                log.append(("find", None))
        elif op == 4:
            w.delete_entry(d, n)
            log.append(("delete", d, n))
        elif op == 5:
            prefix = ["", "x", "a", "ü"][int(rng.integers(4))]
            start = ["", "x", "x1", "b.txt"][int(rng.integers(4))]
            got = w.list_directory_entries(
                d, start_name=start, inclusive=bool(rng.integers(2)),
                limit=int(rng.integers(1, 6)), prefix=prefix)
            log.append(("list", [e.SerializeToString() for e in got]))
        elif op == 6:
            link = bytes([1, int(rng.integers(0, 3))])
            e = entry(n)
            e.hard_link_id = link
            w.insert_entry(d, e)
            log.append(("link", w.hardlink_counter(link)))
        else:
            k = bytes([int(rng.integers(0, 4))])
            if rng.random() < 0.5:
                w.kv_put(k, bytes(rng.integers(0, 256, 5, dtype=np.uint8)))
            log.append(("kv", w.kv_get(k)))
        if step == 120:
            w.delete_folder_children("/a")
            log.append(("rmdir",))
    log.append(("final", {d: [e.SerializeToString() for e in
                              w.list_directory_entries(d, limit=100)]
                          for d in dirs}))
    return log


@pytest.mark.parametrize("kind", ["memory", "sqlite", "weedkv"])
@pytest.mark.parametrize("seed", range(3))
def test_store_contract_equals_jax(kind, seed, tmp_path):
    def run(pkg):
        d = tmp_path / pkg.pb.__name__.split(".")[0]
        d.mkdir(exist_ok=True)
        store = _make_store(pkg, kind, d)
        try:
            return _store_script(pkg, store, seed)
        finally:
            store.close()
    both(run)


def _dump(pkg, store):
    w = pkg.fstore.FilerStoreWrapper(store)
    out = {}
    stack = ["/"]
    while stack:
        d = stack.pop()
        for e in w.list_directory_entries(d, limit=10000):
            out[(d, e.name)] = e.SerializeToString()
            if e.is_directory:
                stack.append(pkg.fstore.join_path(d, e.name))
    return out, w.kv_get(b"\x01"), w.kv_get(b"\x02")


@pytest.mark.parametrize("kind", ["sqlite", "weedkv"])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_store_files_open_in_the_other_package(kind, writer, reader,
                                               tmp_path):
    """A filer.db / weedkv directory one package writes, the other opens
    with every entry and kv value equal."""
    w_pkg, r_pkg = PKGS[writer], PKGS[reader]
    f = w_pkg.filer.Filer(_make_store(w_pkg, kind, tmp_path))
    f.meta_log.buffer._stopping = True
    for i in range(40):
        d = f"/t{i % 4}/s{i % 3}"
        e = w_pkg.filer.new_entry(f"f{i}", mime="a/b")
        e.chunks.add(file_id=f"{i % 5 + 1},{i:x}", size=i + 1, offset=0)
        f.create_entry(d, e)
    f.store.kv_put(b"\x01", b"one")
    f.store.kv_put(b"\x02", b"two" * 50)
    written = _dump(w_pkg, f.store.store)
    f.close()
    store = _make_store(r_pkg, kind, tmp_path)
    try:
        got = _dump(r_pkg, store)
    finally:
        store.close()
    assert got == written and len(written[0]) > 40


class _RecordingConn:
    """DB-API connection that records every (sql, args) and runs the
    statement on sqlite after a flavour-to-sqlite translation."""

    def __init__(self, flavor: str):
        self.flavor = flavor
        self.executed = []
        self._db = sqlite3.connect(":memory:", check_same_thread=False)

    def _translate(self, sql: str) -> str:
        sql = sql.replace("%s", "?")
        if self.flavor == "mysql":
            sql = re.sub(
                r"INSERT INTO (\w+) VALUES \(([?,]+)\) "
                r"ON DUPLICATE KEY UPDATE .*",
                r"INSERT OR REPLACE INTO \1 VALUES (\2)", sql)
            if " LIKE ?" in sql and "ESCAPE" not in sql:
                sql = sql.replace(" LIKE ?", " LIKE ? ESCAPE '\\'")
        return sql

    def cursor(self):
        outer = self

        class _Cur:
            def execute(self, sql, args=()):
                outer.executed.append((sql, tuple(args)))
                self._c = outer._db.execute(outer._translate(sql), args)
                return self

            def fetchone(self):
                return self._c.fetchone()

            def fetchall(self):
                return self._c.fetchall()

        return _Cur()

    def commit(self):
        self._db.commit()

    def rollback(self):
        self._db.rollback()

    def close(self):
        self._db.close()


@pytest.mark.parametrize("flavor", ["mysql", "postgres"])
def test_sql_flavours_emit_the_jax_statements(flavor):
    """The mysql/postgres stores over a fake driver: the same SQL and
    arguments as JAX's for one seeded store sequence, and the same
    results."""
    def run(pkg):
        cls = pkg.sql.MysqlStore if flavor == "mysql" \
            else pkg.sql.PostgresStore
        conn = _RecordingConn(flavor)

        class _Store(cls):
            def __init__(self):
                pkg.sql.AbstractSqlStore.__init__(self)

            def _connect(self):
                return conn

        store = _Store()
        try:
            log = _store_script(pkg, store, 11)
        finally:
            store.close()
        return log, [(sql, tuple(bytes(a) if isinstance(a, memoryview)
                                 else a for a in args))
                     for sql, args in conn.executed]
    both(run)


@pytest.mark.parametrize("flavor", ["mysql", "postgres"])
def test_sql_flavours_import_their_driver_lazily(flavor, monkeypatch):
    """Without the driver package the store raises at construction, in
    both packages alike (JAX abstract_sql.py:246, :289)."""
    real_import = builtins.__import__

    def deny(name, *a, **kw):
        if name.split(".")[0] in ("pymysql", "psycopg2", "MySQLdb"):
            raise ImportError(f"no {name}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", deny)

    def run(pkg):
        cls = pkg.sql.MysqlStore if flavor == "mysql" \
            else pkg.sql.PostgresStore
        try:
            cls()
        except Exception as e:
            return type(e).__name__, str(e)
        return None
    assert both(run) is not None


# -- the metadata event log, listing cache, filer_conf -------------------------


class _Clock:
    def __init__(self):
        self.ns = 1_760_000_000 * 10**9

    def time_ns(self):
        self.ns += 1_234_567_891
        return self.ns


def _mutations(pkg, f, seed):
    rng = np.random.default_rng(seed)
    for i in range(60):
        d = f"/m{int(rng.integers(3))}/s{int(rng.integers(2))}"
        n = f"f{int(rng.integers(12))}"
        op = int(rng.integers(4))
        e = pkg.filer.new_entry(n)
        e.attributes.crtime = e.attributes.mtime = 1000 + i
        if op <= 1:
            e.chunks.add(file_id=f"1,{i:x}", size=i + 1)
            f.create_entry(d, e)
        elif op == 2:
            try:
                f.delete_entry(f"{d}/{n}")
            except Exception:
                pass
        else:
            try:
                f.atomic_rename(d, n, d + "x", n + "r")
            except Exception:
                pass


@pytest.mark.parametrize("seed", range(3))
def test_meta_log_segments_are_byte_equal(seed, tmp_path, monkeypatch):
    """The same mutations under a fake clock: the dated segment files
    are byte-equal, and both read the same events back."""
    def run(pkg):
        clock = _Clock()
        monkeypatch.setattr(pkg.lb.time, "time_ns", clock.time_ns)
        log_dir = tmp_path / pkg.pb.__name__.split(".")[0]
        f = pkg.filer.Filer(pkg.mem.MemoryStore(), log_dir=str(log_dir))
        f.meta_log.buffer._stopping = True
        _mutations(pkg, f, seed)
        f.meta_log.buffer.flush()
        events = [e.SerializeToString()
                  for e in f.meta_log.read_events_since(0)]
        f.close()
        files = {}
        for root, _, names in os.walk(log_dir):
            for name in names:
                p = os.path.join(root, name)
                files[os.path.relpath(p, log_dir)] = open(p, "rb").read()
        return files, events
    files, events = both(run)
    assert files and len(events) >= 30


@pytest.mark.parametrize("seed", range(3))
def test_listing_through_the_cache_equals_without(seed):
    """Seeded mutations; every listing window through the cache equals
    the uncached listing, and both equal JAX's."""
    def run(pkg):
        cached = pkg.filer.Filer(pkg.mem.MemoryStore())
        cached.attach_listing_cache(pkg.listing.ListingCache(1 << 20))
        plain = pkg.filer.Filer(pkg.mem.MemoryStore())
        out = []
        for f in (cached, plain):
            f.meta_log.buffer._stopping = True
        rng = np.random.default_rng(seed)
        for round_ in range(4):
            for f in (cached, plain):
                _mutations(pkg, f, seed * 10 + round_)
            for d in ("/m0/s0", "/m1/s1", "/m2/s0x", "/"):
                start = f"f{int(rng.integers(12))}"
                limit = int(rng.integers(1, 8))
                pages = [[e.SerializeToString() for e in f.list_entries(
                    d, start_name=start, inclusive=True, limit=limit)]
                    for f in (cached, plain, cached)]
                assert pages[0] == pages[1] == pages[2]
                out.append(pages[0])
        stats = cached.listing_cache.stats()
        assert stats["hits"] > 0
        for f in (cached, plain):
            f.close()
        return out
    both(run)


def test_filer_conf_rules_equal_jax():
    blob = (b'{"locations": [{"locationPrefix": "/buckets/a/", '
            b'"collection": "ca", "replication": "001", "ttl": "3d", '
            b'"fsync": true}, {"locationPrefix": "/buckets/", '
            b'"collection": "cb"}, {"locationPrefix": "/x", '
            b'"unknown": 1}]}')

    def run(pkg):
        conf = pkg.conf.FilerConf.from_bytes(blob)
        got = []
        for p in ("/buckets/a/f", "/buckets/b", "/x/y", "/xy", "/other",
                  "/buckets/a"):
            r = conf.match(p)
            got.append(r.to_dict() if r is not None else None)
        return got, conf.to_bytes(), pkg.conf.FILER_CONF_PATH
    both(run)


# -- utilities -----------------------------------------------------------------


def test_log_buffer_framing_equals_jax():
    rng = np.random.default_rng(3)
    entries = [(int(rng.integers(0, 1 << 62)), int(rng.integers(0, 1 << 31)),
                rng.integers(0, 256, int(rng.integers(0, 300)),
                             dtype=np.uint8).tobytes()) for _ in range(40)]

    def run(pkg):
        blob = b"".join(pkg.lb.LogEntry(*e).pack() for e in entries)
        back = pkg.lb.LogEntry.unpack_stream(blob + b"\x00\x00\x01")
        return blob, [(e.ts_ns, e.partition_key_hash, e.data) for e in back]
    blob, back = both(run)
    assert len(back) == len(entries)


@pytest.mark.parametrize("ext,mime,n", [
    (".txt", "", 4000), (".jpg", "image/jpeg", 4000), ("", "text/html", 90),
    ("", "application/json", 5000), (".bin", "", 5000),
    ("", "application/octet-stream", 5000)])
def test_compression_equals_jax(ext, mime, n):
    data = (b"seaweed filer " * 1000)[:n]

    def run(pkg):
        stored, compressed = pkg.comp.maybe_compress(data, ext, mime)
        return (stored, compressed, pkg.comp.can_be_compressed(ext, mime),
                pkg.comp.decompress(stored) == data,
                pkg.comp.is_compressed(stored))
    both(run)


def test_chunk_cache_tiers_equal_jax(tmp_path):
    sizes = [10, 1 << 20, (1 << 20) + 1, 3 << 20, 5 << 20, 100]

    def run(pkg):
        cache = pkg.cc.TieredChunkCache(
            mem_limit_bytes=2 << 20,
            disk_dir=str(tmp_path / pkg.pb.__name__.split(".")[0]),
            disk_limit_bytes=12 << 20)
        for i, n in enumerate(sizes):
            cache.set(f"{i},ab", bytes([i]) * n)
        got = [len(cache.get(f"{i},ab") or b"") for i in range(len(sizes))]
        tiers = [sorted(os.listdir(t.dir)) for t in cache.tiers]
        return got, tiers
    both(run)


def test_cipher_round_trip_in_both(monkeypatch):
    data = os.urandom(5000)
    sealed, key = port_cipher.encrypt(data)
    assert jax_cipher.decrypt(sealed, key) == data
    sealed, key = jax_cipher.encrypt(data)
    assert port_cipher.decrypt(sealed, key) == data
    with pytest.raises(port_cipher.CipherError):
        port_cipher.decrypt(sealed[:5], key)


def test_cipher_without_cryptography_raises_in_both(monkeypatch):
    """With the import made to fail, an encrypted write or read raises
    CipherError (a RuntimeError, so the filer answers 500) in both."""
    real_import = builtins.__import__

    def deny(name, *a, **kw):
        if name.startswith("cryptography"):
            raise ImportError("no cryptography")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", deny)

    def run(pkg):
        out = []
        for call in (lambda: pkg.cipher.encrypt(b"x" * 100),
                     lambda: pkg.cipher.decrypt(b"y" * 40, b"k" * 32)):
            with pytest.raises(pkg.cipher.CipherError) as ei:
                call()
            assert isinstance(ei.value, RuntimeError)
            out.append(str(ei.value))
        return out
    both(run)


FILER_FAMILIES = ["IngestPipelineChunksHistogram",
                  "IngestPipelineOccupancyGauge", "MetaListingCounter",
                  "MetaListingInvalidationsCounter"]


@pytest.mark.parametrize("name", FILER_FAMILIES)
def test_filer_metric_families_match_jax(name):
    p, j = getattr(port_metrics, name), getattr(jax_metrics, name)
    assert (p.name, p.help, p.label_names, p.kind, type(p).__name__) == \
        (j.name, j.help, j.label_names, j.kind, type(j).__name__)
    assert getattr(p, "buckets", None) == getattr(j, "buckets", None)


def test_filer_role_is_qos_enforced():
    assert "filer" in port_metrics._QOS_ROLES


def test_cpuprofile_writes_a_pstats_file(tmp_path):
    import pstats
    path = str(tmp_path / "cpu.prof")
    port_grace.setup_profiling(path)
    sum(i * i for i in range(20000))
    port_grace.stop_profiling()
    assert pstats.Stats(path).total_calls > 0
    port_grace.setup_profiling(None)       # no flag: nothing starts
    assert port_grace._profiler is None

