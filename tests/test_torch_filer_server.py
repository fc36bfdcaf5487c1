"""The port's FilerServer against the JAX package's FilerServer.

Each package runs its own cluster in the process (a master, two volume
servers on the CPU codec, a filer with 256 KiB chunks on its default
sqlite store). The same requests go to both filers and must get the same
status, the same headers (bar ``Date`` and ``Server``) and the same body:
POSTs of a small, an autochunked and a gzip-able file and a multipart
form, GET, HEAD, ``Range`` (suffix and across chunks), 304, 416, JSON and
HTML listings (with ``limit``/``lastFileName``), DELETE (recursive and
not); and every RPC of ``SeaweedFiler`` with the same requests, a
``SubscribeMetadata`` stream included. One case runs on each serving
core (``-serve.async``). Also: two filers with ``-peers`` converge on
the merged metadata view two JAX filers reach, and an encrypted POST
with ``cryptography`` made unimportable answers 500 and stores no chunk
in both packages.
"""

import builtins
import http.client
import json
import threading
import time

import pytest

from seaweedfs_tpu.filer import filer as jax_filer_mod
from seaweedfs_tpu.pb import filer_pb2 as jax_pb
from seaweedfs_tpu.pb import filer_stub as jax_filer_stub
from seaweedfs_tpu.server.filer import FilerServer as JaxFilerServer
from seaweedfs_tpu.util import http_server as jax_hs
from seaweedfs_tpu_torch.filer import filer as port_filer_mod
from seaweedfs_tpu_torch.pb import filer_pb2 as port_pb
from seaweedfs_tpu_torch.pb import filer_stub as port_filer_stub
from seaweedfs_tpu_torch.server.filer import FilerServer as PortFilerServer
from seaweedfs_tpu_torch.util import http_server as port_hs
from seaweedfs_tpu_torch.util.http_server import ServeConfig as PortServe
from tests import cluster_util
from tests.test_torch_cluster import Cluster as PortCluster
from tests.test_torch_cluster import free_port_pair

CHUNK = 256 << 10
NOW = 1_760_000_000
FROZEN_DATE = "Sat, 17 Oct 2026 12:00:00 GMT"


class Side:
    """One package's cluster and filer(s)."""

    def __init__(self, name, cluster, filer, pb, stub_fn, filer_cls):
        self.name = name
        self.cluster = cluster
        self.filer = filer
        self.pb = pb
        self.stub_fn = stub_fn
        self.filer_cls = filer_cls
        self.extra = []

    @property
    def stub(self):
        return self.stub_fn(self.filer.url)

    def start_filer(self, **kw):
        f = self.filer_cls(self.cluster.master.url, port=free_port_pair(),
                           **kw)
        f.start()
        self.extra.append(f)
        return f

    def needles(self) -> int:
        n = 0
        for vs in self.cluster.volume_servers:
            for loc in vs.store.locations:
                for v in list(loc.volumes.values()):
                    fc = v.file_count
                    n += fc() if callable(fc) else fc
        return n

    def stop(self):
        for f in self.extra:
            f.stop()
        self.filer.stop()
        self.cluster.stop()


def make_sides(tmp_path_factory, **filer_kwargs):
    """A JAX cluster with its filer and a port cluster with its filer
    (sqlite, 256 KiB chunks), entry times and Date lines frozen in both
    packages. Returns ({"jax": Side, "port": Side}, undo)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_filer_mod, "_now", lambda: NOW)
    mp.setattr(port_filer_mod, "_now", lambda: NOW)
    mp.setattr(jax_hs, "http_date", lambda: FROZEN_DATE)
    mp.setattr(port_hs, "http_date", lambda: FROZEN_DATE)
    kw = {"chunk_size": CHUNK, "store": "sqlite"}
    kw.update(filer_kwargs)
    tj = tmp_path_factory.mktemp("jax")
    tp = tmp_path_factory.mktemp("port")
    jc = cluster_util.Cluster(tj, n_volume_servers=2, with_filer=True,
                              filer_kwargs=kw)
    try:
        pc = PortCluster(tp, n_volume_servers=2)
    except BaseException:
        jc.stop()
        raise
    pf = PortFilerServer(pc.master.url, port=free_port_pair(),
                         meta_dir=str(tp / "filer"), **kw)
    pf.start()
    jax_side = Side("jax", jc, jc.filer, jax_pb, jax_filer_stub,
                    JaxFilerServer)
    # the JAX cluster owns its filer; Side.stop stops it once
    jc.filer = None
    return {"jax": jax_side,
            "port": Side("port", pc, pf, port_pb, port_filer_stub,
                         PortFilerServer)}, mp.undo


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    out, undo = make_sides(tmp_path_factory)
    yield out
    for s in out.values():
        s.stop()
    undo()


def _request(url, method="GET", path="/", body=None, headers=None):
    host, port = url.split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        data = r.read()
        hs = [(k, v) for k, v in r.getheaders()
              if k.lower() not in ("date", "server")]
        return r.status, hs, data
    finally:
        conn.close()


def _both(sides, method, path, body=None, headers=None, filers=None):
    """The same request to both filers; the answers must be equal (the
    filer's own address, printed by the HTML listing, masked)."""
    out = {}
    for name, s in sides.items():
        f = filers[name] if filers else s.filer
        status, hs, data = _request(f.url, method, path, body, headers)
        data = data.replace(f"{f.ip}:{f.port}".encode(), b"FILER")
        out[name] = (status, hs, data)
    assert out["port"] == out["jax"], (method, path)
    return out["port"]


def _payload(n, seed=0):
    return bytes((i * 31 + seed * 7 + (i >> 9)) % 256 for i in range(n))


@pytest.fixture(scope="module")
def tree(sides):
    """The namespace both filers get: small, autochunked, gzip-able and
    multipart uploads, all compared as they are made."""
    posts = [
        ("/docs/hello.txt", b"hello filer", {"Content-Type": "text/plain"}),
        ("/big/blob.bin", _payload(CHUNK * 4 + 3), {}),
        ("/big/exact.bin", _payload(CHUNK, 1), {}),
        ("/docs/data.json", json.dumps({"k": list(range(400))}).encode(),
         {"Content-Type": "application/json"}),
        ("/docs/page.html", b"<p>" + b"seaweed " * 500 + b"</p>",
         {"Content-Type": "text/html"}),
    ]
    for i in range(7):
        posts.append((f"/list/f{i:02d}.txt", _payload(100 + i, i), {}))
    answers = {}
    for path, data, hs in posts:
        answers[path] = _both(sides, "POST", path, data, hs)
    boundary = "----seaweedform"
    form = (f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="file"; filename="form.txt"\r\nContent-Type: '
            f"text/plain\r\n\r\nform body\r\n--{boundary}--\r\n").encode()
    answers["form"] = _both(
        sides, "POST", "/forms/", form,
        {"Content-Type": f"multipart/form-data; boundary={boundary}"})
    return {p: d for p, d, _ in posts}, answers


def test_posts_answer_alike(tree):
    _, answers = tree
    for path, (status, hs, body) in answers.items():
        assert status == 201, (path, body)
        assert json.loads(body)["size"] >= 0


@pytest.mark.parametrize("path,headers", [
    ("/docs/hello.txt", {}),
    ("/big/blob.bin", {}),
    ("/big/exact.bin", {}),
    ("/docs/data.json", {}),
    ("/docs/page.html", {}),
    ("/forms/form.txt", {}),
    ("/big/blob.bin", {"Range": "bytes=262100-262200"}),
    ("/big/blob.bin", {"Range": "bytes=-10"}),
    ("/big/blob.bin", {"Range": "bytes=1048570-"}),
    ("/docs/hello.txt", {"Range": "bytes=50-60"}),
    ("/docs/hello.txt", {"Range": "bytes=abc"}),
    ("/nope/missing.txt", {}),
])
@pytest.mark.parametrize("method", ["GET", "HEAD"])
def test_reads_answer_alike(sides, tree, method, path, headers):
    data, _ = tree
    status, _, body = _both(sides, method, path, headers=headers)
    if method == "GET" and status == 200:
        assert body == data.get(path, b"form body")


def test_etag_gives_304_in_both(sides, tree):
    _, hs, _ = _both(sides, "GET", "/big/blob.bin")
    etag = dict(hs)["ETag"]
    status, _, _ = _both(sides, "GET", "/big/blob.bin",
                         headers={"If-None-Match": etag})
    assert status == 304


@pytest.mark.parametrize("query,accept", [
    ("", ""), ("?limit=3", ""), ("?limit=3&lastFileName=f02.txt", ""),
    ("?limit=bad", ""), ("", "text/html"), ("?limit=2", "text/html")])
@pytest.mark.parametrize("directory", ["/list/", "/", "/big/"])
def test_listings_answer_alike(sides, tree, directory, query, accept):
    headers = {"Accept": accept} if accept else {}
    status, _, body = _both(sides, "GET", directory + query,
                            headers=headers)
    assert status in (200, 400)


def test_deletes_answer_alike(sides, tree):
    for path, body in (("/del/sub/f.txt", b"x"), ("/del/g.txt", b"y")):
        _both(sides, "POST", path, body)
    status, _, _ = _both(sides, "DELETE", "/del")
    assert status == 409
    status, _, _ = _both(sides, "DELETE", "/del/g.txt")
    assert status == 204
    status, _, _ = _both(sides, "DELETE",
                         "/del?recursive=true&ignoreRecursiveError=true")
    assert status == 204
    assert _both(sides, "GET", "/del/sub/f.txt")[0] == 404
    assert _both(sides, "DELETE", "/")[0] in (204, 409)


@pytest.fixture(scope="module")
def async_filers(sides):
    """A second filer on each cluster, serving on the async core."""
    from seaweedfs_tpu.util.http_server import ServeConfig as JaxServe
    out = {}
    for name, serve in (("jax", JaxServe(async_mode=True)),
                        ("port", PortServe(async_mode=True))):
        out[name] = sides[name].start_filer(store="memory",
                                            chunk_size=CHUNK, serve=serve)
    return out


@pytest.mark.parametrize("core", ["threaded", "async"])
def test_one_case_on_each_serving_core(sides, async_filers, core):
    filers = async_filers if core == "async" else None
    data = _payload(CHUNK * 2 + 17, 5)
    assert _both(sides, "POST", f"/core/{core}.bin", data,
                 filers=filers)[0] == 201
    status, _, body = _both(sides, "GET", f"/core/{core}.bin",
                            filers=filers)
    assert status == 200 and body == data
    assert _both(sides, "GET", f"/core/{core}.bin", filers=filers,
                 headers={"Range": "bytes=100-300000"})[0] == 206
    assert _both(sides, "GET", "/core/", filers=filers)[0] == 200


# -- the RPC plane -------------------------------------------------------------


def _rpc_both(sides, method, make_request, normalize=None):
    """One unary RPC against both filers: the answers' bytes (after
    ``normalize``) or status codes must be equal."""
    out = {}
    for name, s in sides.items():
        try:
            resp = getattr(s.stub, method)(make_request(s.pb))
        except Exception as e:      # grpc.RpcError / rpc.RpcError
            out[name] = ("error", e.code().name)
            continue
        if normalize is not None:
            resp = normalize(s, resp)
        out[name] = resp.SerializeToString(deterministic=True) \
            if name == "jax" else resp.SerializeToString()
    assert out["port"] == out["jax"], method
    return out["port"]


def _entry(pb, name, chunks=0):
    e = pb.Entry(name=name)
    e.attributes.mtime = e.attributes.crtime = 1234
    e.attributes.file_mode = 0o644
    e.attributes.mime = "a/b"
    e.extended["x-k"] = b"v"
    for i in range(chunks):
        e.chunks.add(file_id=f"9,{i:x}00", offset=i * 10, size=10,
                     mtime=5, e_tag=f"t{i}")
    return e


def test_entry_rpcs_answer_alike(sides, tree):
    _rpc_both(sides, "CreateEntry", lambda pb: pb.CreateEntryRequest(
        directory="/rpc", entry=_entry(pb, "a.txt", 2)))
    _rpc_both(sides, "CreateEntry", lambda pb: pb.CreateEntryRequest(
        directory="/rpc", entry=_entry(pb, "a.txt"), o_excl=True))
    _rpc_both(sides, "LookupDirectoryEntry",
              lambda pb: pb.LookupDirectoryEntryRequest(
                  directory="/rpc", name="a.txt"))
    _rpc_both(sides, "LookupDirectoryEntry",
              lambda pb: pb.LookupDirectoryEntryRequest(
                  directory="/rpc", name="missing"))
    _rpc_both(sides, "UpdateEntry", lambda pb: pb.UpdateEntryRequest(
        directory="/rpc", entry=_entry(pb, "a.txt", 3)))
    _rpc_both(sides, "AppendToEntry", lambda pb: pb.AppendToEntryRequest(
        directory="/rpc", entry_name="a.txt",
        chunks=[pb.FileChunk(file_id="9,ff00", offset=30, size=4,
                             mtime=6)]))
    _rpc_both(sides, "LookupDirectoryEntry",
              lambda pb: pb.LookupDirectoryEntryRequest(
                  directory="/rpc", name="a.txt"))
    _rpc_both(sides, "AtomicRenameEntry",
              lambda pb: pb.AtomicRenameEntryRequest(
                  old_directory="/rpc", old_name="a.txt",
                  new_directory="/rpc2", new_name="b.txt"))
    _rpc_both(sides, "AtomicRenameEntry",
              lambda pb: pb.AtomicRenameEntryRequest(
                  old_directory="/rpc", old_name="gone",
                  new_directory="/rpc2", new_name="c.txt"))
    _rpc_both(sides, "LookupDirectoryEntry",
              lambda pb: pb.LookupDirectoryEntryRequest(
                  directory="/rpc2", name="b.txt"))
    _rpc_both(sides, "DeleteEntry", lambda pb: pb.DeleteEntryRequest(
        directory="/", name="rpc2"))
    _rpc_both(sides, "DeleteEntry", lambda pb: pb.DeleteEntryRequest(
        directory="/", name="rpc2", is_recursive=True))
    _rpc_both(sides, "KvPut", lambda pb: pb.KvPutRequest(key=b"k1",
                                                         value=b"v1"))
    _rpc_both(sides, "KvGet", lambda pb: pb.KvGetRequest(key=b"k1"))
    _rpc_both(sides, "KvGet", lambda pb: pb.KvGetRequest(key=b"nope"))


def _fid_free(entry):
    """The entry with its chunks' file ids and write times cleared: each
    cluster assigns its own."""
    for c in entry.chunks:
        c.file_id = ""
        c.mtime = 0
    return entry.SerializeToString()


def test_list_entries_streams_alike(sides, tree):
    for req in ({"directory": "/list"},
                {"directory": "/list", "limit": 3,
                 "start_from_file_name": "f01.txt"},
                {"directory": "/list", "prefix": "f0",
                 "start_from_file_name": "f03.txt",
                 "inclusive_start_from": True},
                {"directory": "/"}):
        out = {}
        for name, s in sides.items():
            out[name] = [_fid_free(r.entry) for r in
                         s.stub.ListEntries(s.pb.ListEntriesRequest(**req))]
        assert out["port"] == out["jax"] and out["port"], req


def test_volume_rpcs_answer_alike(sides, tree):
    def assign_shape(s, resp):
        assert resp.file_id and resp.url and not resp.error
        return s.pb.AssignVolumeResponse(
            count=resp.count, collection=resp.collection,
            replication=resp.replication)
    _rpc_both(sides, "AssignVolume",
              lambda pb: pb.AssignVolumeRequest(count=1), assign_shape)

    def locs_shape(s, resp):
        return s.pb.LookupVolumeResponse(locations_map={
            k: s.pb.Locations(locations=[s.pb.Location()
                                         for _ in v.locations])
            for k, v in resp.locations_map.items()})
    _rpc_both(sides, "LookupVolume",
              lambda pb: pb.LookupVolumeRequest(volume_ids=["1", "x",
                                                            "999"]),
              locs_shape)
    _rpc_both(sides, "CollectionList",
              lambda pb: pb.CollectionListRequest(
                  include_normal_volumes=True))

    def stats_shape(s, resp):
        assert resp.used_size > 0 and resp.file_count > 0
        return s.pb.StatisticsResponse()
    _rpc_both(sides, "Statistics", lambda pb: pb.StatisticsRequest(),
              stats_shape)

    def conf_shape(s, resp):
        assert list(resp.masters) == [s.cluster.master.url]
        resp.masters[:] = []
        return resp
    _rpc_both(sides, "GetFilerConfiguration",
              lambda pb: pb.GetFilerConfigurationRequest(), conf_shape)
    _rpc_both(sides, "DeleteCollection",
              lambda pb: pb.DeleteCollectionRequest(collection="nothere"))


def test_brokers_keep_connected_and_locate_alike(sides):
    out = {}
    for name, s in sides.items():
        reqs = iter([s.pb.KeepConnectedRequest(
            name="broker", grpc_port=17777, resources=["t1", "t2"])])
        gate = threading.Event()

        def requests():
            yield next(reqs)
            gate.wait(10)

        call = s.stub.KeepConnected(requests())
        next(iter(call))
        found = s.stub.LocateBroker(s.pb.LocateBrokerRequest(resource="t2"))
        missing = s.stub.LocateBroker(
            s.pb.LocateBrokerRequest(resource="t9"))
        gate.set()
        call.cancel()
        out[name] = (found.found, [(r.grpc_addresses, r.resource_count)
                                   for r in found.resources],
                     missing.found, len(missing.resources))
    assert out["port"] == out["jax"]
    assert out["port"][0] and out["port"][1][0][0].endswith(":17777")


def _stream(call, want, keep):
    """Up to ``want`` kept items of a server stream; the call is
    cancelled after 20 s whatever came."""
    got = []
    timer = threading.Timer(20.0, call.cancel)
    timer.start()
    try:
        for rec in call:
            item = keep(rec)
            if item is not None:
                got.append(item)
            if len(got) >= want:
                break
    except Exception:           # the cancel ends the stream with an error
        pass
    finally:
        timer.cancel()
        call.cancel()
    return got


def _events(s, prefix, since, want, local=False):
    method = "SubscribeLocalMetadata" if local else "SubscribeMetadata"
    call = getattr(s.stub, method)(s.pb.SubscribeMetadataRequest(
        client_name="t", path_prefix=prefix, since_ns=since))

    def keep(rec):
        ev = rec.event_notification
        return (rec.directory, ev.old_entry.name, ev.new_entry.name,
                ev.new_parent_path, ev.delete_chunks)
    return _stream(call, want, keep)


@pytest.mark.parametrize("local", [False, True])
def test_subscribe_metadata_streams_alike(sides, local):
    since = time.time_ns()
    top = f"/sub{int(local)}"
    for path in (f"{top}/a.txt", f"{top}/b.txt", "/other/c.txt"):
        _both(sides, "POST", path, b"event")
    _both(sides, "DELETE", f"{top}/a.txt")
    out = {name: _events(s, top, since, 4, local)
           for name, s in sides.items()}
    assert out["port"] == out["jax"]
    assert [e[:3] for e in out["port"]] == [
        ("/", "", top[1:]), (top, "", "a.txt"), (top, "", "b.txt"),
        (top, "a.txt", "")]


def test_peers_converge_on_the_same_merged_view(sides):
    """Two filers with -peers on each cluster: every write through one
    shows in the other's merged SubscribeMetadata stream."""
    views = {}
    for name, s in sides.items():
        ports = [free_port_pair(), free_port_pair()]
        urls = [f"127.0.0.1:{p}" for p in ports]
        filers = []
        for p in ports:
            f = s.filer_cls(s.cluster.master.url, port=p, store="memory",
                            peers=urls, chunk_size=CHUNK)
            f.start()
            s.extra.append(f)
            filers.append(f)
        since = time.time_ns()
        for i, f in enumerate(filers):
            for j in range(3):
                st, _, _ = _request(f.url, "POST", f"/peer/f{i}{j}.txt",
                                    b"p")
                assert st == 201
        merged = []
        for f in filers:
            call = s.stub_fn(f.url).SubscribeMetadata(
                s.pb.SubscribeMetadataRequest(
                    client_name="t", path_prefix="/peer", since_ns=since))
            merged.append(sorted(_stream(
                call, 6, lambda rec: rec.event_notification.new_entry.name
                if rec.event_notification.new_entry.name.endswith(".txt")
                else None)))
        views[name] = merged
    assert views["port"] == views["jax"]
    assert views["port"][0] == views["port"][1] == sorted(
        f"f{i}{j}.txt" for i in range(2) for j in range(3))


def test_encrypted_post_without_cryptography_is_500_in_both(
        sides, monkeypatch):
    real_import = builtins.__import__

    def deny(name, *a, **kw):
        if name.startswith("cryptography"):
            raise ImportError("no cryptography")
        return real_import(name, *a, **kw)

    filers = {name: s.start_filer(store="memory", chunk_size=CHUNK,
                                  cipher=True)
              for name, s in sides.items()}
    before = {name: s.needles() for name, s in sides.items()}
    monkeypatch.setattr(builtins, "__import__", deny)
    status, _, body = _both(sides, "POST", "/secret/s.bin",
                            _payload(CHUNK + 5), filers=filers)
    assert status == 500 and b"cryptography" in body
    monkeypatch.undo()
    assert _both(sides, "GET", "/secret/s.bin", filers=filers)[0] == 404
    assert {name: s.needles() for name, s in sides.items()} == before


def test_encrypted_post_round_trips_with_cryptography(sides):
    pytest.importorskip("cryptography")
    data = _payload(CHUNK * 2 + 9, 3)
    for name, s in sides.items():
        f = s.start_filer(store="memory", chunk_size=CHUNK, cipher=True)
        st, _, _ = _request(f.url, "POST", "/enc/e.bin", data)
        assert st == 201
        st, _, body = _request(f.url, "GET", "/enc/e.bin")
        assert (st, body) == (200, data)
        e = f.filer.find_entry("/enc/e.bin")
        assert all(len(c.cipher_key) == 32 for c in e.chunks)


def test_filer_store_names(sides, tmp_path):
    """-store keeps the JAX names: memory, sqlite and weedkv run, and so
    does a networked store: a filer on ``redis`` (a fake server) keeps
    its entries there."""
    from seaweedfs_tpu_torch.server.filer import make_filer_store
    from tests.fake_backends import FakeRedisServer
    for store in ("memory", "sqlite", "weedkv", "kv", "leveldb"):
        make_filer_store(store, str(tmp_path / store)).close()
    fake = FakeRedisServer()
    f = PortFilerServer(sides["port"].cluster.master.url,
                        port=free_port_pair(), store="redis",
                        store_options={"host": "127.0.0.1",
                                       "port": fake.port},
                        meta_dir=str(tmp_path / "redis"))
    f.start()
    try:
        assert _request(f.url, "POST", "/r/a.txt", b"on redis")[0] == 201
        assert _request(f.url, "GET", "/r/a.txt")[2] == b"on redis"
        assert b"/r/a.txt" in fake.data
    finally:
        f.stop()
        fake.stop()
    with pytest.raises(ValueError, match="unknown filer store"):
        make_filer_store("bogus", str(tmp_path))
