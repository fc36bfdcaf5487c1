"""The port's filer replication against the JAX package's.

``Replicator`` replays the same seeded event streams (creates, updates,
renames into and out of the path filter, deletes of files and of
directories) into a ``LocalSink`` in each package: the two trees must be
equal byte for byte. ``FilerSink`` replicates a filer's metadata log into
a second filer on the redis store (each against its own fake): the two
packages' destination trees are equal, and every entry they hold was
written ``is_from_other_cluster``. ``ObjectStoreSink`` writes into the
port's own S3 gateway, ``AzureSink`` into ``FakeAzureServer`` (which
checks every SharedKey signature) in both packages, ``make_sink`` builds
the registry's sinks from replication.toml's keys, and ``FilerSync``
keeps two port filers in step both ways with no ping-pong. As
subprocesses of the CLI: ``filer.replicate`` with a local sink replays a
port filer's tree and stops on SIGINT with exit 0 (without
replication.toml it exits 1 with the JAX message); ``filer.sync -a -b``
starts, carries a file and stops the same way; ``filer -store redis``
reads its ``[redis]`` section from filer.toml and serves a POST and a
GET.
"""

import base64
import os
import posixpath
import signal
import subprocess
import sys
import time
import types
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.filer import filer as jax_filer
from seaweedfs_tpu.filer import filer_notify as jax_notify
from seaweedfs_tpu.pb import filer_pb2 as jax_pb
from seaweedfs_tpu.replication import replicator as jax_replicator
from seaweedfs_tpu.replication import sinks as jax_sinks
from seaweedfs_tpu.replication import source as jax_source
from seaweedfs_tpu.server.filer import FilerServer as JaxFilerServer
from seaweedfs_tpu_torch.filer import filer as port_filer
from seaweedfs_tpu_torch.filer import filer_notify as port_notify
from seaweedfs_tpu_torch.pb import filer_pb2 as port_pb
from seaweedfs_tpu_torch.replication import filer_sync as port_sync
from seaweedfs_tpu_torch.replication import replicator as port_replicator
from seaweedfs_tpu_torch.replication import sinks as port_sinks
from seaweedfs_tpu_torch.replication import source as port_source
from seaweedfs_tpu_torch.server.filer import FilerServer as PortFilerServer
from tests import cluster_util
from tests.fake_backends import FakeAzureServer, FakeRedisServer
from tests.test_torch_cluster import REPO, free_port_pair, wait_for
from tests.test_torch_cluster import Cluster as PortCluster

PKGS = {
    "jax": types.SimpleNamespace(
        name="jax", pb=jax_pb, filer=jax_filer, notify=jax_notify,
        replicator=jax_replicator, sinks=jax_sinks, source=jax_source),
    "port": types.SimpleNamespace(
        name="port", pb=port_pb, filer=port_filer, notify=port_notify,
        replicator=port_replicator, sinks=port_sinks, source=port_source),
}
NOW = 1_760_000_000


@pytest.fixture(autouse=True)
def _frozen_entry_clock(monkeypatch):
    for mod in (jax_filer, port_filer):
        monkeypatch.setattr(mod, "_now", lambda: NOW)


def both(fn):
    want = fn(PKGS["jax"])
    got = fn(PKGS["port"])
    assert got == want
    return got


def _tree(root) -> dict:
    """{relative path: bytes, or None for a directory} under root."""
    out = {}
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        for n in dirs:
            out[os.path.normpath(os.path.join(rel, n))] = None
        for n in files:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.normpath(os.path.join(rel, n))] = f.read()
    return out


# -- Replicator on seeded event streams -----------------------------------------


class _DictSource:
    """A source whose files are a dict: {full path: bytes}."""

    def __init__(self, files):
        self.files = files
        self.reads = []

    def read_entry_data(self, directory, name):
        path = posixpath.join(directory, name)
        self.reads.append(path)
        return self.files[path]


def _events(seed):
    """A seeded stream of (parent directory, event kind, old name, new
    name, new parent, is_directory, file bytes): creates, updates,
    renames inside, into and out of /in, deletes of files and of
    directories."""
    rng = np.random.default_rng(seed)
    dirs = ["/in", "/in/a", "/in/a/b", "/out", "/in2"]
    live = {}                      # path -> is_directory
    out = []
    for step in range(120):
        op = int(rng.integers(0, 8))
        d = dirs[int(rng.integers(len(dirs)))]
        name = f"n{int(rng.integers(0, 8))}"
        path = posixpath.join(d, name)
        if op <= 3 or not live:
            is_dir = live.get(path, rng.random() < 0.2)
            data = None if is_dir else bytes(rng.integers(
                0, 256, int(rng.integers(0, 3000)), dtype=np.uint8))
            kind = "update" if path in live else "create"
            out.append((d, kind, name if kind == "update" else "", name,
                        "", is_dir, data))
            live[path] = is_dir
            continue
        # a rename or a delete of something that exists
        victim = sorted(live)[int(rng.integers(len(live)))]
        vd, vn = posixpath.split(victim)
        if op <= 5:
            nd = dirs[int(rng.integers(len(dirs)))]
            nn = f"r{step}"
            is_dir = live.pop(victim)
            data = None if is_dir else bytes(rng.integers(
                0, 256, int(rng.integers(1, 500)), dtype=np.uint8))
            out.append((vd, "rename", vn, nn, nd, is_dir, data))
            live[posixpath.join(nd, nn)] = is_dir
        else:
            is_dir = live.pop(victim)
            for p in [p for p in live if p.startswith(victim + "/")]:
                live.pop(p)
            out.append((vd, "delete", vn, "", "", is_dir, None))
    return out


def _replay(pkg, stream, root):
    files = {}
    source = _DictSource(files)
    sink = pkg.sinks.LocalSink(str(root))
    repl = pkg.replicator.Replicator(source, sink, path_filter="/in")
    for i, (d, kind, old, new, new_parent, is_dir, data) in \
            enumerate(stream):
        ev = pkg.pb.EventNotification()
        if old:
            ev.old_entry.name = old
            ev.old_entry.is_directory = is_dir
        if new:
            e = pkg.filer.new_entry(new, is_directory=is_dir)
            if data:
                e.chunks.add(file_id=f"1,{i:x}", size=len(data))
                files[posixpath.join(new_parent or d, new)] = data
            ev.new_entry.CopyFrom(e)
        if new_parent:
            ev.new_parent_path = new_parent
        repl.replicate(pkg.notify.event_key(d, ev), ev)
    return _tree(root), source.reads


@pytest.mark.parametrize("seed", range(4))
def test_replicator_local_sink_trees_equal_jax(seed, tmp_path):
    stream = _events(seed)
    tree, reads = both(lambda pkg: _replay(pkg, stream,
                                           tmp_path / pkg.name))
    # the filter is a path prefix, as in the reference: /in2 is inside
    assert reads and any(v is not None for v in tree.values())
    assert not any(p.startswith("out") for p in tree)


# -- a cluster per package: filer A (sqlite) and filer B (redis) ----------------


class Side:
    def __init__(self, name, cluster, a, b, redis):
        self.name, self.cluster, self.a, self.b = name, cluster, a, b
        self.redis = redis

    def stop(self):
        for f in (self.b, self.a):
            f.stop()
        self.cluster.stop()
        self.redis.stop()


def _redis_opts(fake):
    return {"host": "127.0.0.1", "port": fake.port}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for mod in (jax_filer, port_filer):
        mp.setattr(mod, "_now", lambda: NOW)
    out = {}
    try:
        tj = tmp_path_factory.mktemp("jax")
        jc = cluster_util.Cluster(tj, n_volume_servers=1)
        rj = FakeRedisServer()
        ja = JaxFilerServer(jc.master.url, port=free_port_pair(),
                            store="sqlite", meta_dir=str(tj / "fa"))
        jb = JaxFilerServer(jc.master.url, port=free_port_pair(),
                            store="redis", store_options=_redis_opts(rj),
                            meta_dir=str(tj / "fb"))
        for f in (ja, jb):
            f.start()
        out["jax"] = Side("jax", jc, ja, jb, rj)
        tp = tmp_path_factory.mktemp("port")
        pc = PortCluster(tp, n_volume_servers=1)
        rp = FakeRedisServer()
        pa = PortFilerServer(pc.master.url, port=free_port_pair(),
                             store="sqlite", meta_dir=str(tp / "fa"))
        pb = PortFilerServer(pc.master.url, port=free_port_pair(),
                             store="redis", store_options=_redis_opts(rp),
                             meta_dir=str(tp / "fb"))
        for f in (pa, pb):
            f.start()
        out["port"] = Side("port", pc, pa, pb, rp)
        yield out
    finally:
        for s in out.values():
            s.stop()
        mp.undo()


def _post(url, path, data):
    req = urllib.request.Request(f"http://{url}{path}", data=data,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 201


def _get(url, path):
    try:
        with urllib.request.urlopen(f"http://{url}{path}", timeout=30) as r:
            return r.read()
    except urllib.error.HTTPError:
        return None


def _files(seed, n=12):
    rng = np.random.default_rng(seed)
    return {f"/xr/d{i % 3}/f{i}.bin": bytes(rng.integers(
        0, 256, int(rng.integers(1, 200_000)), dtype=np.uint8))
        for i in range(n)}


def _walk(filer, top):
    """{path: (is_directory, bytes)} of a filer's tree under top."""
    out = {}
    stack = [top]
    while stack:
        d = stack.pop()
        for e in filer.filer.list_entries(d, limit=10000):
            path = posixpath.join(d, e.name)
            out[path] = (e.is_directory, None if e.is_directory
                         else _get(filer.url, path))
            if e.is_directory:
                stack.append(path)
    return out


def test_filer_sink_replicates_into_a_redis_filer(sides):
    """A's metadata log replayed through Replicator(FilerSource(A),
    FilerSink(B)): B (on redis) holds the same tree in both packages,
    every entry written as from the other cluster."""
    files = _files(1)

    def run(pkg):
        side = sides[pkg.name]
        t0 = time.time_ns()
        for path, data in sorted(files.items()):
            _post(side.a.url, path, data)
        repl = pkg.replicator.Replicator(
            pkg.source.FilerSource(side.a.url),
            pkg.sinks.FilerSink(side.b.url, path_prefix="/copy"))
        for rec in side.a.filer.meta_log.read_events_since(t0):
            repl.replicate(pkg.notify.event_key(
                rec.directory, rec.event_notification),
                rec.event_notification)
        tree = _walk(side.b, "/copy")
        marks = [(rec.directory, rec.event_notification.new_entry.name,
                  rec.event_notification.is_from_other_cluster)
                 for rec in side.b.filer.meta_log.read_events_since(t0)]
        return tree, marks

    tree, marks = both(run)
    for path, data in files.items():
        assert tree["/copy" + path] == (False, data)
    assert marks and all(flag for d, n, flag in marks
                         if d.startswith("/copy/"))


def test_filer_sync_active_active_no_ping_pong(sides):
    side = sides["port"]
    a, b = side.a, side.b
    sync = port_sync.FilerSync(a.url, b.url, path_prefix="/sync")
    sync.start()
    try:
        _post(a.url, "/sync/from-a.txt", b"written on A")
        wait_for(lambda: _get(b.url, "/sync/from-a.txt") == b"written on A",
                 timeout=30, what="A->B sync")
        _post(b.url, "/sync/from-b.txt", b"written on B")
        wait_for(lambda: _get(a.url, "/sync/from-b.txt") == b"written on B",
                 timeout=30, what="B->A sync")
        time.sleep(1.0)
        n_a = len(a.filer.meta_log.read_events_since(0))
        n_b = len(b.filer.meta_log.read_events_since(0))
        time.sleep(1.0)
        assert len(a.filer.meta_log.read_events_since(0)) == n_a
        assert len(b.filer.meta_log.read_events_since(0)) == n_b
        # each side holds exactly one replayed create: the other's file
        for f, other in ((a, "from-b.txt"), (b, "from-a.txt")):
            marked = [r.event_notification.new_entry.name
                      for r in f.filer.meta_log.read_events_since(0)
                      if r.directory == "/sync" and
                      r.event_notification.is_from_other_cluster]
            assert marked == [other]
    finally:
        sync.stop()


# -- object-store, Azure and the registry ---------------------------------------


def test_object_store_sink_replicates_to_the_port_s3_gateway(sides):
    from seaweedfs_tpu_torch.s3api import S3ApiServer
    from seaweedfs_tpu_torch.s3api.auth import Credential, Iam, Identity
    from seaweedfs_tpu_torch.util.s3_client import S3Client
    access, secret = "SINKKEY", "SINKSECRET"
    s3 = S3ApiServer(sides["port"].a.url, port=free_port_pair(),
                     iam=Iam([Identity("admin", [Credential(access, secret)],
                                       ["Admin"])]))
    s3.start()
    try:
        client = S3Client(s3.url, access, secret)
        client.create_bucket("repl")
        sink = port_sinks.make_sink("s3", endpoint=s3.url, bucket="repl",
                                    access_key=access, secret_key=secret,
                                    directory="mirror")
        e = port_pb.Entry(name="doc.txt")
        sink.create_entry("/data/doc.txt", e, b"replicated-bytes")
        assert client.get_object("repl", "mirror/data/doc.txt") == \
            b"replicated-bytes"
        sink.create_entry("/data/doc.txt", e, b"updated-bytes")
        assert client.get_object("repl", "mirror/data/doc.txt") == \
            b"updated-bytes"
        sink.create_entry("/data", port_pb.Entry(name="data",
                                                 is_directory=True), None)
        sink.delete_entry("/data/doc.txt", is_directory=False)
        assert client.head_object("repl", "mirror/data/doc.txt") is None
        sink.create_entry("/data/a", port_pb.Entry(name="a"), b"1")
        sink.create_entry("/data/b", port_pb.Entry(name="b"), b"2")
        sink.delete_entry("/data", is_directory=True)
        assert client.head_object("repl", "mirror/data/a") is None
        assert client.head_object("repl", "mirror/data/b") is None
    finally:
        s3.stop()


ACCOUNT = "testaccount"
KEY = base64.b64encode(b"0123456789abcdef0123456789abcdef").decode()


def test_azure_sink_against_the_signature_checking_fake():
    def run(pkg):
        srv = FakeAzureServer(ACCOUNT, KEY)
        try:
            sink = pkg.sinks.make_sink(
                "azure", account_name=ACCOUNT, account_key=KEY,
                container="backup", directory="/pre",
                endpoint=f"http://127.0.0.1:{srv.port}")
            entry = pkg.pb.Entry(name="f.txt")
            sink.create_entry("/docs/f.txt", entry, b"contents")
            sink.create_entry("/docs", pkg.pb.Entry(name="docs",
                                                    is_directory=True), None)
            sink.create_entry("/docs/g.txt", entry, b"more")
            sink.create_entry("/other/h.txt", entry, b"kept")
            first = dict(srv.blobs)
            sink.delete_entry("/docs", is_directory=True)
            sink.delete_entry("/docs/absent.txt", is_directory=False)
            bad = pkg.sinks.AzureSink(
                ACCOUNT, base64.b64encode(b"x" * 32).decode(), "backup",
                endpoint=f"http://127.0.0.1:{srv.port}")
            with pytest.raises(Exception) as ei:
                bad.create_entry("/nope", entry, b"x")
            return first, dict(srv.blobs), ei.value.status
        finally:
            srv.stop()

    first, after, status = both(run)
    assert first == {"backup/pre/docs/f.txt": b"contents",
                     "backup/pre/docs/g.txt": b"more",
                     "backup/pre/other/h.txt": b"kept"}
    assert after == {"backup/pre/other/h.txt": b"kept"} and status == 403


def test_make_sink_registry_aliases_and_bogus_kind(tmp_path):
    assert sorted(port_sinks.SINK_FACTORIES) == \
        sorted(jax_sinks.SINK_FACTORIES)
    assert {k: v.__name__ for k, v in port_sinks.SINK_FACTORIES.items()} \
        == {k: v.__name__ for k, v in jax_sinks.SINK_FACTORIES.items()}
    assert port_sinks._PROP_ALIASES == jax_sinks._PROP_ALIASES
    assert port_sinks._PROP_DROP == jax_sinks._PROP_DROP

    def run(pkg):
        with pytest.raises(ValueError) as ei:
            pkg.sinks.make_sink("bogus")
        local = pkg.sinks.make_sink("local",
                                    directory=str(tmp_path / "mirror"))
        filer = pkg.sinks.make_sink("filer", grpcAddress="127.0.0.1:1",
                                    directory="/backup", replication="")
        azure = pkg.sinks.make_sink("azure", account_name="a",
                                    account_key="a2V5", container="c")
        s3 = pkg.sinks.make_sink("gcs", endpoint="127.0.0.1:1",
                                 bucket="b", directory="/x/")
        return (str(ei.value), os.path.relpath(local.root, tmp_path),
                filer.filer_url, filer.prefix, azure.container,
                azure.client.base, s3.bucket, s3.prefix)

    got = both(run)
    assert got[0].startswith("unknown replication sink 'bogus'")


# -- the CLI --------------------------------------------------------------------


def _spawn(args, cwd):
    return subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch",
                             *args], cwd=str(cwd), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE,
                            env={**os.environ, "PYTHONPATH": REPO})


def _sigint(proc, timeout=30):
    proc.send_signal(signal.SIGINT)
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
        raise AssertionError(f"did not stop on SIGINT: {err.decode()}")
    return proc.returncode, err.decode()


def test_filer_replicate_cli_replays_a_tree_and_stops(sides, tmp_path):
    a = sides["port"].a
    files = {f"/rep/d{i % 2}/f{i}.bin": os.urandom(1000 + 997 * i)
             for i in range(6)}
    for path, data in files.items():
        _post(a.url, path, data)
    mirror = tmp_path / "mirror"
    (tmp_path / "replication.toml").write_text(
        f'[source.filer]\nenabled = true\ngrpcAddress = "{a.url}"\n'
        f'directory = "/rep"\n\n[sink.local]\nenabled = true\n'
        f'directory = "{mirror}"\n')
    proc = _spawn(["filer.replicate"], tmp_path)
    try:
        wait_for(lambda: all(
            (mirror / p.lstrip("/")).is_file() and
            (mirror / p.lstrip("/")).read_bytes() == d
            for p, d in files.items()), timeout=60,
            what="the tree in the local sink")
        _post(a.url, "/rep/late.bin", b"after the replay")
        wait_for(lambda: (mirror / "rep" / "late.bin").is_file(),
                 timeout=30, what="a new file followed")
    finally:
        rc, err = _sigint(proc)
    assert rc == 0 and "Traceback" not in err, err[-2000:]


def test_filer_replicate_cli_without_config_exits_1(tmp_path):
    r = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch",
                        "filer.replicate"], cwd=str(tmp_path),
                       capture_output=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": REPO,
                            "HOME": str(tmp_path)})
    assert r.returncode == 1
    assert r.stderr.decode().strip() == (
        "no replication.toml found; run `scaffold -config replication`")


def test_filer_sync_cli_starts_carries_and_stops(sides, tmp_path):
    a, b = sides["port"].a, sides["port"].b
    proc = _spawn(["filer.sync", "-a", a.url, "-b", b.url,
                   "-a.path", "/clisync"], tmp_path)
    try:
        def carried():
            _post(a.url, "/clisync/one.txt", b"via the CLI")
            return _get(b.url, "/clisync/one.txt") == b"via the CLI"
        # the tails start at the command's start: post until one lands
        wait_for(carried, timeout=60, what="filer.sync to carry a file")
    finally:
        rc, err = _sigint(proc)
    assert rc == 0 and "Traceback" not in err, err[-2000:]


def test_filer_on_redis_from_filer_toml(sides, tmp_path):
    fake = FakeRedisServer()
    port = free_port_pair()
    (tmp_path / "filer.toml").write_text(
        f'[redis]\nenabled = true\nhost = "127.0.0.1"\nport = {fake.port}\n')
    proc = _spawn(["filer", "-master", sides["port"].cluster.master.url,
                   "-port", str(port), "-store", "redis",
                   "-dir", str(tmp_path / "f")], tmp_path)
    try:
        url = f"127.0.0.1:{port}"
        data = os.urandom(70_000)

        def posted():
            try:
                _post(url, "/viaredis/f.bin", data)
                return True
            except OSError:
                return False
        wait_for(posted, timeout=60, what="the redis filer to take a POST")
        assert _get(url, "/viaredis/f.bin") == data
        assert b"/viaredis/f.bin" in fake.data
        assert fake.sets[b"/viaredis\x00:children"] == {b"f.bin"}
    finally:
        rc, err = _sigint(proc)
        fake.stop()
    assert rc == 0 and "Traceback" not in err, err[-2000:]
