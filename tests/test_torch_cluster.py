"""The port's cluster service path, in process on the CPU.

A port master and port volume servers (``ec_encoder="cpu"``, the codec's
plain version) on loopback, driven as ``tests/test_cluster.py`` drives the
JAX package's: heartbeat registration, upload/Range/404/delete,
``ec.encode`` of one and of several volumes (one fused RPC per server),
reads through four lost shards and through a stopped server (the decode
fleet), ``ec.rebuild`` and ``ec.decode``. Held against the JAX package:
the cluster's ``.dat`` snapshot encoded by the JAX encoder gives the same
shard and ``.ecx`` bytes, the decoded ``.dat`` is the snapshot, a copy of
a port volume directory serves the same needles from the JAX Store, and
the shell prints the JAX shell's lines. Also: the default encoder
(``cuda``) answers with an error status where there is no card, JAX
encoder names are refused, 010 on one rack is refused as the JAX master
refuses it and 001 on two servers is granted, the
master's ids survive a restart, and the CLI runs as subprocesses. The
read cache: repeat degraded reads through a stopped server are cache
hits with no new decode dispatch, and a rebuild invalidates. Against a
JAX volume server: a JAX-written chunk manifest answers GET, HEAD,
``cm=false``, BatchDelete (refused, 406) and DELETE as the JAX server
answers them, and a corrupt read counts in
``ScrubCorruptionsFoundCounter{kind="read"}`` on both.
"""

import hashlib
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.ec import encoder as jax_encoder
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.store import Store as JaxStore
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.ec import store_ec
from seaweedfs_tpu_torch.ec.encoder import shard_file_name
from seaweedfs_tpu_torch.operation import operations
from seaweedfs_tpu_torch.operation.file_id import parse_fid
from seaweedfs_tpu_torch.pb import (master_pb2, master_stub,
                                    volume_server_pb2, volume_stub)
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell import CommandError, Shell

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PULSE = 0.2


def free_port_pair() -> int:
    """A port p where both p and p+10000 (the RPC sibling) are free."""
    for _ in range(200):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        if p + rpc.GRPC_PORT_OFFSET > 65535:
            continue
        try:
            with socket.socket() as s2:
                s2.bind(("127.0.0.1", p + rpc.GRPC_PORT_OFFSET))
            return p
        except OSError:
            continue
    raise RuntimeError("no free port pair")


def wait_for(predicate, timeout: float = 10.0, what: str = ""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = predicate()
        if v:
            return v
        time.sleep(0.02)
    raise TimeoutError(f"timed out waiting for {what or predicate}")


def holder(master, vid: int, collection: str = "") -> str:
    """The url of a server holding vid. A heartbeat collected before the
    volume was allocated can reach the master after it and drop the vid
    from the layout until the next pulse, so this waits for it."""
    return wait_for(lambda: master.lookup_locations(vid, collection),
                    what=f"a location of volume {vid}")[0][0]


class Cluster:
    def __init__(self, tmp_path, n_volume_servers: int = 2,
                 volumes_per_server: int = 30, ec_encoder: str = "cpu",
                 volume_size_limit_mb: int = 64, ec_mesh: bool = False,
                 volume_kwargs=(), master_kwargs=None):
        self.tmp_path = tmp_path
        self.volumes_per_server = volumes_per_server
        self.ec_encoder = ec_encoder
        self.ec_mesh = ec_mesh
        # more VolumeServer options: server i gets volume_kwargs[i % n]
        self.volume_kwargs = list(volume_kwargs) or [{}]
        self.master = MasterServer(
            port=free_port_pair(), meta_dir=str(tmp_path / "master"),
            volume_size_limit_mb=volume_size_limit_mb,
            pulse_seconds=PULSE, **(master_kwargs or {}))
        self.master.start()
        self.volume_servers = []
        try:
            self.add_servers(n_volume_servers)
        except BaseException:
            self.stop()
            raise

    def add_servers(self, n: int) -> None:
        """Start n more volume servers and wait until the master has them."""
        want = len(self.master.topo.nodes()) + n
        for _ in range(n):
            d = self.tmp_path / f"vol{len(self.volume_servers)}"
            d.mkdir(parents=True, exist_ok=True)
            vs = VolumeServer(
                self.master.url, [str(d)], port=free_port_pair(),
                max_volume_counts=[self.volumes_per_server],
                pulse_seconds=PULSE, ec_encoder=self.ec_encoder,
                ec_mesh=self.ec_mesh,
                **self.volume_kwargs[len(self.volume_servers) %
                                     len(self.volume_kwargs)])
            vs.start()
            self.volume_servers.append(vs)
        wait_for(lambda: len(self.master.topo.nodes()) >= want,
                 what="volume servers registered")

    def http(self, url, data=None, method="GET", headers=None):
        return urllib.request.urlopen(urllib.request.Request(
            f"http://{url}", data=data, method=method,
            headers=headers or {}), timeout=30)

    def assign(self, **params) -> dict:
        q = "&".join(f"{k}={v}" for k, v in params.items())
        with self.http(f"{self.master.url}/dir/assign?{q}") as r:
            return json.load(r)

    def upload(self, data: bytes, mime: str = "", **assign_params) -> str:
        a = self.assign(**assign_params)
        assert "fid" in a, a
        headers = {"Content-Type": mime} if mime else {}
        with self.http(f"{a['url']}/{a['fid']}", data=data, method="POST",
                       headers=headers) as r:
            assert "error" not in json.load(r)
        return a["fid"]

    def fetch(self, fid: str, headers=None):
        def locations():
            with self.http(f"{self.master.url}/dir/lookup?volumeId={fid}") \
                    as r:
                return json.load(r).get("locations")
        url = wait_for(locations, what=f"a location of {fid}")[0]["url"]
        return self.http(f"{url}/{fid}", headers=headers)

    def server(self, url: str) -> VolumeServer:
        return next(vs for vs in self.volume_servers if vs.url == url)

    def stop(self) -> None:
        for vs in self.volume_servers:
            vs.stop()
        self.master.stop()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = Cluster(tmp_path_factory.mktemp("cluster"))
    yield c
    c.stop()


# -- the blob path (tests/test_cluster.py:28-135) ------------------------------


def test_nodes_register_via_heartbeat(cluster):
    assert {n.url for n in cluster.master.topo.nodes()} == \
        {vs.url for vs in cluster.volume_servers}


def test_upload_and_read_roundtrip(cluster):
    data = b"hello seaweedfs-tpu" * 100
    fid = cluster.upload(data, mime="text/x-test")
    with cluster.fetch(fid) as r:
        assert r.status == 200
        assert r.read() == data
        assert r.headers["Content-Type"] == "text/x-test"
        etag = r.headers["ETag"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        cluster.fetch(fid, headers={"If-None-Match": etag})
    assert ei.value.code == 304


@pytest.mark.parametrize("rng,start,end", [("bytes=10-19", 10, 19),
                                           ("bytes=-16", 1008, 1023),
                                           ("bytes=1000-", 1000, 1023)])
def test_range_reads(cluster, rng, start, end):
    data = bytes(range(256)) * 4
    fid = cluster.upload(data)
    with cluster.fetch(fid, headers={"Range": rng}) as r:
        assert r.status == 206
        assert r.read() == data[start:end + 1]
        assert r.headers["Content-Range"] == f"bytes {start}-{end}/1024"
    with pytest.raises(urllib.error.HTTPError) as ei:
        cluster.fetch(fid, headers={"Range": "bytes=5000-"})
    assert ei.value.code == 416


def test_multipart_upload_preserves_trailing_newline(cluster):
    payload = b"line one\nline two\n"
    a = cluster.assign()
    boundary = "testboundary123"
    body = (f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="file"; '
            f'filename="notes.txt"\r\n'
            f"Content-Type: text/plain\r\n\r\n").encode() + payload + \
        f"\r\n--{boundary}--\r\n".encode()
    with cluster.http(f"{a['url']}/{a['fid']}", data=body, method="POST",
                      headers={"Content-Type": "multipart/form-data; "
                               f"boundary={boundary}"}) as r:
        assert r.status == 201
    with cluster.fetch(a["fid"]) as r:
        assert r.read() == payload
        assert "notes.txt" in r.headers.get("Content-Disposition", "")
        assert r.headers["Content-Type"] == "text/plain"


def test_gzip_upload_round_trips(cluster):
    data = b"compress me " * 500
    a = operations.assign(cluster.master.url)
    operations.upload_data(f"{a.url}/{a.fid}", data, filename="x.txt",
                           mime="text/plain", gzip=True)
    with cluster.fetch(a.fid) as r:
        assert r.read() == data
    r = operations.http_request("GET", f"{a.url}/{a.fid}",
                                headers={"Accept-Encoding": "gzip"})
    assert r.headers.get("content-encoding") == "gzip"
    import gzip
    assert gzip.decompress(r.body) == data


def test_missing_needle_404_and_delete(cluster):
    fid = cluster.upload(b"to be deleted")
    f = parse_fid(fid)
    url = holder(cluster.master, f.volume_id)
    with pytest.raises(urllib.error.HTTPError) as ei:
        cluster.fetch(f"{f.volume_id},deadbeef00000000")
    assert ei.value.code == 404
    wrong = f"{f.volume_id},{f.key:x}{(f.cookie ^ 1):08x}"
    with pytest.raises(urllib.error.HTTPError) as ei:
        cluster.http(f"{url}/{wrong}", method="DELETE")
    assert ei.value.code == 403
    with cluster.http(f"{url}/{fid}", method="DELETE") as r:
        assert r.status == 202
    with pytest.raises(urllib.error.HTTPError) as ei:
        cluster.fetch(fid)
    assert ei.value.code == 404


def test_read_redirects_from_non_owner(cluster):
    data = b"redirect me"
    fid = cluster.upload(data)
    owner = {u for u, _ in cluster.master.lookup_locations(
        parse_fid(fid).volume_id)}
    other = next(vs for vs in cluster.volume_servers if vs.url not in owner)
    with cluster.http(f"{other.url}/{fid}") as r:
        assert r.read() == data


def test_replication_010_on_one_rack_answers_as_jax(cluster):
    """Two servers in one rack cannot hold 010 (a copy in another rack):
    the assign, the RPC assign, /vol/grow and a client upload get the
    JAX master's NoFreeSlots text, and no volume is grown."""
    from seaweedfs_tpu.storage.superblock import \
        ReplicaPlacement as JaxPlacement
    from seaweedfs_tpu.topology.topology import Topology as JaxTopology
    from seaweedfs_tpu.topology.volume_growth import (
        NoFreeSlots as JaxNoFreeSlots, VolumeGrowth as JaxGrowth)
    jax_topo = JaxTopology()
    for vs in cluster.volume_servers:
        jax_topo.sync_heartbeat(vs.store.collect_heartbeat())
    with pytest.raises(JaxNoFreeSlots) as want:
        JaxGrowth(jax_topo).find_empty_slots(JaxPlacement.parse("010"))
    before = cluster.master.topo.next_volume_id
    assert cluster.assign(replication="010") == {"error": str(want.value)}
    resp = master_stub(cluster.master.url).Assign(
        master_pb2.AssignRequest(replication="010"))
    assert not resp.fid and resp.error == str(want.value)
    with cluster.http(f"{cluster.master.url}/vol/grow?replication=010") as r:
        assert json.load(r) == {"error": str(want.value)}
    with pytest.raises(RuntimeError, match="no placement for 010"):
        operations.upload(cluster.master.url, b"x", replication="010")
    assert cluster.master.topo.next_volume_id == before


def test_replication_001_with_two_nodes_succeeds(tmp_path):
    """001 (a second copy in the same rack) on two servers: the master
    grows growth_count(2) = 6 volumes on both, and an upload reads back
    from each of them."""
    c = Cluster(tmp_path, n_volume_servers=2, volumes_per_server=8)
    try:
        fid = c.upload(b"two copies", replication="001", collection="r1")
        vid = parse_fid(fid).volume_id
        wait_for(lambda: len(c.master.lookup_locations(vid, "r1")) == 2,
                 what="both replicas in the layout")
        for vs in c.volume_servers:
            assert len(vs.store.locations[0].volumes) == 6
            with c.http(f"{vs.url}/{fid}") as r:
                assert r.read() == b"two copies"
    finally:
        c.stop()


def test_keepconnected_streams_topology(cluster):
    cluster.upload(b"kc-seed")
    stream = master_stub(cluster.master.url).KeepConnected(
        iter([master_pb2.KeepConnectedRequest(name="test-client")]))
    assert next(stream).leader == cluster.master.url
    got = next(stream)
    assert got.url and got.new_vids
    stream.cancel()


def test_port_volume_directory_opens_in_the_jax_store(cluster, tmp_path):
    blobs = [os.urandom(int(n)) for n in
             np.random.default_rng(3).integers(1, 5000, 20)]
    fids = [cluster.upload(b, collection="copy") for b in blobs]
    vs = cluster.server(holder(cluster.master, parse_fid(fids[0]).volume_id,
                               "copy"))
    for v in vs.store.locations[0].volumes.values():
        v.sync()
    copy = tmp_path / "copy"
    shutil.copytree(vs.store.locations[0].directory, copy)
    js = JaxStore([str(copy)], [100])
    try:
        served = 0
        for fid, data in zip(fids, blobs):
            f = parse_fid(fid)
            if js.find_volume(f.volume_id) is None:
                continue
            got = js.read_needle(f.volume_id,
                                 JaxNeedle(id=f.key, cookie=f.cookie))
            assert got.data == data
            served += 1
        assert served >= 1
    finally:
        js.close()


# -- EC over RPC (tests/test_cluster.py:182-264) --------------------------------


def _fill_volume(cluster, collection: str, n: int = 6, size: int = 1024):
    datas = [os.urandom(size) for _ in range(n)]
    fids = [cluster.upload(d, collection=collection) for d in datas]
    vid = parse_fid(fids[0]).volume_id
    keep = [(f, d) for f, d in zip(fids, datas)
            if parse_fid(f).volume_id == vid]
    owner = holder(cluster.master, vid, collection)
    return vid, keep, owner


def test_ec_encode_mount_read_with_shard_loss(cluster):
    vid, keep, owner = _fill_volume(cluster, "ecc")
    stub = volume_stub(owner)
    stub.VolumeMarkReadonly(
        volume_server_pb2.VolumeMarkReadonlyRequest(volume_id=vid))
    stub.VolumeEcShardsGenerate(volume_server_pb2.VolumeEcShardsGenerateRequest(
        volume_id=vid, collection="ecc", encoder="cpu"))
    stub.VolumeEcShardsMount(volume_server_pb2.VolumeEcShardsMountRequest(
        volume_id=vid, collection="ecc", shard_ids=list(range(14))))
    stub.VolumeDelete(volume_server_pb2.VolumeDeleteRequest(volume_id=vid))
    wait_for(lambda: cluster.master.topo.lookup_ec(vid),
             what="ec shards in topology")
    for fid, d in keep:
        with cluster.fetch(fid) as r:
            assert r.read() == d
    lost = [0, 3, 11, 13]
    stub.VolumeEcShardsUnmount(volume_server_pb2.VolumeEcShardsUnmountRequest(
        volume_id=vid, shard_ids=lost))
    stub.VolumeEcShardsDelete(volume_server_pb2.VolumeEcShardsDeleteRequest(
        volume_id=vid, collection="ecc", shard_ids=lost))
    vs = cluster.server(owner)
    d0 = vs.degraded.dispatches
    for fid, d in keep:
        with cluster.fetch(fid) as r:
            assert r.read() == d, "EC read must survive 4 lost shards"
    assert vs.degraded.dispatches > d0
    resp = stub.VolumeEcShardsRebuild(
        volume_server_pb2.VolumeEcShardsRebuildRequest(
            volume_id=vid, collection="ecc", encoder="cpu"))
    assert sorted(resp.rebuilt_shard_ids) == lost
    stub.VolumeEcShardsMount(volume_server_pb2.VolumeEcShardsMountRequest(
        volume_id=vid, collection="ecc", shard_ids=lost))
    for fid, d in keep:
        with cluster.fetch(fid) as r:
            assert r.read() == d


def test_ec_decode_back_to_volume(cluster):
    vid, keep, owner = _fill_volume(cluster, "dec", n=4, size=700)
    stub = volume_stub(owner)
    stub.VolumeMarkReadonly(
        volume_server_pb2.VolumeMarkReadonlyRequest(volume_id=vid))
    stub.VolumeEcShardsGenerate(volume_server_pb2.VolumeEcShardsGenerateRequest(
        volume_id=vid, collection="dec", encoder="cpu"))
    stub.VolumeDelete(volume_server_pb2.VolumeDeleteRequest(volume_id=vid))
    stub.VolumeEcShardsToVolume(
        volume_server_pb2.VolumeEcShardsToVolumeRequest(
            volume_id=vid, collection="dec", ))
    wait_for(lambda: cluster.master.topo.lookup(vid, "dec"),
             what="decoded volume back in topology")
    for fid, d in keep:
        with cluster.fetch(fid) as r:
            assert r.read() == d


def test_ec_rpcs_refuse_jax_encoder_names(cluster):
    vid, _, owner = _fill_volume(cluster, "names", n=2)
    stub = volume_stub(owner)
    for name in ("tpu", "jax", "native", "numpy", "auto", "pallas"):
        with pytest.raises(rpc.RpcError) as ei:
            stub.VolumeEcShardsGenerate(
                volume_server_pb2.VolumeEcShardsGenerateRequest(
                    volume_id=vid, collection="names", encoder=name))
        assert ei.value.code() == rpc.StatusCode.INVALID_ARGUMENT
    # nothing was encoded on the way
    assert store_ec._find_ec_base(cluster.server(owner).store, vid) is None
    sh = Shell(cluster.master.url)
    for name in ("jax", "auto"):
        with pytest.raises(CommandError, match="INVALID_ARGUMENT"):
            sh.run_command(f"ec.encode -volumeId={vid} -encoder={name}")
    with pytest.raises(ValueError):
        VolumeServer(cluster.master.url, [], ec_encoder="auto")


def test_default_encoder_without_a_card_is_an_error_status(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this case is about a host without a card")
    c = Cluster(tmp_path, n_volume_servers=1, ec_encoder="cuda")
    try:
        vs = c.volume_servers[0]
        assert vs.ec_encoder == "cuda"
        # constructing the server made no codec
        assert vs.degraded._rs is None
        vid, _, owner = _fill_volume(c, "card", n=2)
        with pytest.raises(rpc.RpcError) as ei:
            volume_stub(owner).VolumeEcShardsGenerate(
                volume_server_pb2.VolumeEcShardsGenerateRequest(
                    volume_id=vid, collection="card"))
        assert ei.value.code() == rpc.StatusCode.FAILED_PRECONDITION
        assert store_ec._find_ec_base(vs.store, vid) is None
        with pytest.raises(CommandError, match="FAILED_PRECONDITION"):
            Shell(c.master.url).run_command(f"ec.encode -volumeId={vid}")
        # the failed encode unfroze the volume: it takes writes again
        c.upload(b"still writable", collection="card")
        assert not vs.store.find_volume(vid).read_only
    finally:
        c.stop()


# -- the shell (tests/test_cluster.py:358-432, 483) -----------------------------


def test_shell_ec_encode_fuses_one_rpc_per_server(tmp_path, monkeypatch):
    calls = []
    orig = store_ec.generate_ec_shards_batch

    def spy(store, vids, backend="cuda", **kw):
        calls.append(sorted(vids))
        return orig(store, vids, backend=backend, **kw)

    monkeypatch.setattr(store_ec, "generate_ec_shards_batch", spy)
    c = Cluster(tmp_path, n_volume_servers=1)
    try:
        blobs = []
        for _ in range(14):
            d = os.urandom(1024)
            blobs.append((c.upload(d, collection="fuse"), d))
        vids = sorted({parse_fid(fid).volume_id for fid, _ in blobs})
        assert len(vids) >= 2, vids
        va, vb = vids[:2]
        out = Shell(c.master.url).run_command(
            f"ec.encode -volumeId={va},{vb}")
        assert f"volume {va}: ec.encode done" in out
        assert f"volume {vb}: ec.encode done" in out
        assert calls == [[va, vb]]
        wait_for(lambda: not c.master.topo.lookup(va) and
                 not c.master.topo.lookup(vb), what="originals retired")
        for fid, d in blobs:
            with c.fetch(fid) as r:
                assert r.read() == d
    finally:
        c.stop()


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _jax_encoded_snapshot(c, collection: str, vids, snap) -> dict:
    """Copy each volume's .dat/.idx into snap and encode the copies with
    the JAX package's numpy encoder; returns {vid: sha256 of the .dat}."""
    snap.mkdir()
    dat_hash = {}
    for vid in vids:
        owner = c.server(holder(c.master, vid))
        v = owner.store.find_volume(vid)
        v.sync()
        for ext in (".dat", ".idx"):
            shutil.copy(v.file_name() + ext, snap / f"{collection}_{vid}{ext}")
        dat_hash[vid] = _sha(v.file_name() + ".dat")
        base = str(snap / f"{collection}_{vid}")
        jax_encoder.write_ec_files(base, backend="numpy")
        jax_encoder.write_sorted_file_from_idx(base)
    return dat_hash


def _assert_shards_are_the_snapshots(c, collection: str, vids, snap) -> None:
    """Each of the 14 shards of every volume lies on exactly one server
    and equals the JAX encoder's shard of the snapshot, as does the .ecx."""
    for vid in vids:
        found = {}
        for vs in c.volume_servers:
            base = os.path.join(vs.store.locations[0].directory,
                                f"{collection}_{vid}")
            for sid in range(14):
                p = shard_file_name(base, sid)
                if os.path.exists(p):
                    found.setdefault(sid, []).append(p)
        assert sorted(found) == list(range(14))
        assert all(len(p) == 1 for p in found.values())
        ref = str(snap / f"{collection}_{vid}")
        for sid, (p,) in found.items():
            assert _sha(p) == _sha(shard_file_name(ref, sid)), (vid, sid)
        holder = os.path.dirname(found[0][0])
        assert _sha(os.path.join(holder, f"{collection}_{vid}.ecx")) == \
            _sha(ref + ".ecx")


def test_shell_lifecycle_matches_the_jax_encoder(tmp_path):
    """ec.encode of every volume over four servers, reads through a
    stopped server, ec.rebuild and ec.decode; the shard bytes are the
    JAX encoder's on the same .dat, and the decoded .dat is that .dat."""
    c = Cluster(tmp_path, n_volume_servers=4, volumes_per_server=10)
    try:
        # two volumes, so the spread leaves no server more than four shards
        # of either (their free slots differ by at most two)
        with c.http(f"{c.master.url}/vol/grow?collection=life&count=2") as r:
            assert json.load(r)["count"] == 2
        rng = np.random.default_rng(11)
        blobs = {}
        for _ in range(40):
            d = rng.integers(0, 256, int(rng.integers(1, 64 << 10)),
                             dtype=np.uint8).tobytes()
            blobs[c.upload(d, collection="life")] = d
        vids = sorted({parse_fid(f).volume_id for f in blobs})
        snap = tmp_path / "snap"
        dat_hash = _jax_encoded_snapshot(c, "life", vids, snap)

        out = Shell(c.master.url).run_command(
            f"ec.encode -collection=life "
            f"-volumeId={','.join(map(str, vids))}")
        for vid in vids:
            assert f"volume {vid}: ec.encode done (14 shards on 4 nodes)" \
                in out
        wait_for(lambda: all(c.master.topo.lookup_ec(v) and
                             not c.master.topo.lookup(v) for v in vids),
                 what="every volume as spread EC shards")

        _assert_shards_are_the_snapshots(c, "life", vids, snap)
        for fid, d in blobs.items():
            with c.fetch(fid) as r:
                assert r.read() == d

        # stop the server holding shard 0 of the first volume (a volume
        # under 10 MiB keeps all its data there: 1 MiB blocks, ten to a
        # row) and read through the others: the decode fleet rebuilds it
        victim = next(vs for vs in c.volume_servers
                      if vs.store.find_ec_volume(vids[0]).shard_bits.has(0))
        assert all(victim.store.find_ec_volume(v).shard_bits.count <= 4
                   for v in vids)
        victim.stop()
        c.volume_servers.remove(victim)
        wait_for(lambda: victim.url not in
                 {n.url for n in c.master.topo.nodes()},
                 what="the master dropping the stopped server")
        d0 = sum(vs.degraded.dispatches for vs in c.volume_servers)
        for i, (fid, d) in enumerate(blobs.items()):
            vs = c.volume_servers[i % len(c.volume_servers)]
            with c.http(f"{vs.url}/{fid}") as r:
                assert r.read() == d
        assert sum(vs.degraded.dispatches for vs in c.volume_servers) > d0

        sh = Shell(c.master.url)
        out = sh.run_command("ec.rebuild -collection=life")
        assert all(f"volume {v}: rebuilt shards" in out for v in vids)
        wait_for(lambda: all(
            sum(b.count for b in c.master.topo.lookup_ec(v).values()) == 14
            for v in vids), what="14 shards per volume on live servers")
        for fid, d in blobs.items():
            with c.fetch(fid) as r:
                assert r.read() == d

        out = sh.run_command("ec.decode -collection=life")
        assert all(f"volume {v}: decoded back to a normal volume" in out
                   for v in vids)
        wait_for(lambda: all(c.master.topo.lookup(v) and
                             not c.master.topo.lookup_ec(v) for v in vids),
                 what="decoded volumes back in topology")
        for vid in vids:
            owner = c.server(holder(c.master, vid))
            assert _sha(owner.store.find_volume(vid).file_name() + ".dat") \
                == dat_hash[vid]
        for fid, d in blobs.items():
            with c.fetch(fid) as r:
                assert r.read() == d
    finally:
        c.stop()


def test_ec_mesh_encode_and_degraded_reads(tmp_path, monkeypatch):
    """-ec.mesh on the mesh tests' 8 CPU devices (dp=4, sp=2): the
    shell's fused generate of four volumes rides the mesh scheduler, and
    reads through a stopped server decode on it. The shards are the JAX
    encoder's, and no mesh attempt falls back to the fleet."""
    import torch
    from concurrent.futures import ThreadPoolExecutor

    from seaweedfs_tpu_torch.parallel import make_mesh, mesh_fleet
    from seaweedfs_tpu_torch.stats.metrics import FleetMeshFallbacksCounter

    mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    assert mesh.shape == {"dp": 4, "sp": 2}
    monkeypatch.setattr(mesh_fleet, "_default_mesh", lambda: mesh)
    calls = {"encode": 0, "decode": 0}
    for name, kind in (("mesh_write_ec_files", "encode"),
                       ("sharded_reconstruct", "decode")):
        def spy(*a, _real=getattr(mesh_fleet, name), _kind=kind, **kw):
            calls[_kind] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mesh_fleet, name, spy)

    def fallbacks():
        return sum(FleetMeshFallbacksCounter.labels(r).value
                   for r in ("unavailable", "timeout", "error"))

    before = fallbacks()
    # every volume on one server, so its one fused generate fills dp
    c = Cluster(tmp_path, n_volume_servers=1, volumes_per_server=10,
                ec_mesh=True)
    try:
        with c.http(f"{c.master.url}/vol/grow?collection=mesh&count=4") as r:
            vids = sorted(json.load(r)["volumeIds"])
        assert len(vids) == 4
        rng = np.random.default_rng(12)
        blobs = {}
        for _ in range(48):
            d = rng.integers(0, 256, int(rng.integers(1, 32 << 10)),
                             dtype=np.uint8).tobytes()
            blobs[c.upload(d, collection="mesh")] = d
        snap = tmp_path / "snap"
        _jax_encoded_snapshot(c, "mesh", vids, snap)
        c.add_servers(3)

        out = Shell(c.master.url).run_command(
            f"ec.encode -collection=mesh "
            f"-volumeId={','.join(map(str, vids))}")
        for vid in vids:
            assert f"volume {vid}: ec.encode done (14 shards on 4 nodes)" \
                in out
        assert calls["encode"] >= 1
        wait_for(lambda: all(c.master.topo.lookup_ec(v) and
                             not c.master.topo.lookup(v) for v in vids),
                 what="every volume as spread EC shards")
        _assert_shards_are_the_snapshots(c, "mesh", vids, snap)

        # stop the server that holds shard 0 (all the data of a volume
        # under 10 MiB) of the most volumes it leaves readable (at most
        # four of their shards on it); read those volumes' blobs
        def degraded_by(vs):
            out = []
            for v in vids:
                ecv = vs.store.find_ec_volume(v)
                if ecv is not None and ecv.shard_bits.has(0) and \
                        ecv.shard_bits.count <= 4:
                    out.append(v)
            return out

        victim = max(c.volume_servers, key=lambda vs: len(degraded_by(vs)))
        hit = degraded_by(victim)
        assert hit
        sample = {f: d for f, d in blobs.items()
                  if parse_fid(f).volume_id in hit}
        assert len(sample) >= 2
        victim.stop()
        c.volume_servers.remove(victim)
        wait_for(lambda: victim.url not in
                 {n.url for n in c.master.topo.nodes()},
                 what="the master dropping the stopped server")
        for vs in c.volume_servers:
            # a wider batch window, so concurrent reads share a decode
            vs.degraded.batch_window_s = 0.05
        d0 = sum(vs.degraded.dispatches for vs in c.volume_servers)

        def read(item):
            i, (fid, d) = item
            vs = c.volume_servers[i % len(c.volume_servers)]
            with c.http(f"{vs.url}/{fid}") as r:
                return r.read() == d

        def shared_decode() -> bool:
            # a decode rides the mesh only when two reads meet in one
            # batch, which a loaded host can keep apart in a round: read
            # the sample again until two did
            with ThreadPoolExecutor(8) as ex:
                assert all(ex.map(read, enumerate(sample.items())))
            return calls["decode"] >= 1

        wait_for(shared_decode, timeout=60,
                 what="two concurrent reads sharing one mesh decode")
        assert sum(vs.degraded.dispatches for vs in c.volume_servers) > d0
        assert calls["decode"] >= 1
        assert fallbacks() == before
    finally:
        c.stop()


def test_ec_mesh_without_a_mesh_says_so_at_start(tmp_path):
    """-ec.mesh where no mesh exists (no card here; one card on a chip
    host) warns at start that the per-card fleet takes the work."""
    import logging

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    logger = logging.getLogger("seaweedfs_tpu_torch.volume")
    h = Keep(level=logging.WARNING)
    logger.addHandler(h)
    try:
        c = Cluster(tmp_path, n_volume_servers=1, ec_mesh=True)
        c.stop()
    finally:
        logger.removeHandler(h)
    assert any("-ec.mesh: no mesh" in r.getMessage() and
               "per-card fleet" in r.getMessage() for r in records)


def _normalize(out: str, urls, vids) -> list:
    for i, u in enumerate(urls):
        out = out.replace(u, f"<node{i}>")
    for i, v in enumerate(vids):
        out = re.sub(rf"\bvolume {v}\b", f"volume <v{i}>", out)
    return out.splitlines()


def test_shell_output_has_the_jax_shell_form(tmp_path):
    from seaweedfs_tpu.shell import Shell as JaxShell
    from tests.cluster_util import Cluster as JaxCluster

    script = ["ec.encode -collection=form -volumeId={va},{vb}",
              "ec.rebuild -collection=form",
              "ec.balance",
              "ec.decode -collection=form"]
    outputs = []
    for kind in ("jax", "port"):
        if kind == "jax":
            c = JaxCluster(tmp_path / kind, n_volume_servers=1,
                           ec_encoder="numpy")
            sh = JaxShell(c.master.url)
        else:
            c = Cluster(tmp_path / kind, n_volume_servers=1)
            sh = Shell(c.master.url)
        try:
            vids = []
            while len(vids) < 2:
                a = c.assign(collection="form")
                vid = parse_fid(a["fid"]).volume_id
                with c.http(f"{a['url']}/{a['fid']}", data=os.urandom(500),
                            method="POST"):
                    pass
                if vid not in vids:
                    vids.append(vid)
            vids.sort()   # ec.decode walks volumes in id order
            lines = []
            for cmd in script:
                lines += _normalize(
                    sh.run_command(cmd.format(va=vids[0], vb=vids[1])),
                    [vs.url for vs in c.volume_servers], vids)
            outputs.append(lines)
        finally:
            c.stop()
    assert outputs[0] == outputs[1]
    assert "volume <v0>: ec.encode done (14 shards on 1 nodes)" in outputs[1]


# -- the master ----------------------------------------------------------------


def test_master_ids_survive_a_restart(tmp_path):
    c = Cluster(tmp_path, n_volume_servers=1)
    try:
        fids = [c.upload(b"x") for _ in range(5)]
        max_vid = c.master.topo.next_volume_id - 1
        max_key = max(parse_fid(f).key for f in fids)
    finally:
        c.stop()
    m = MasterServer(port=free_port_pair(), meta_dir=str(tmp_path / "master"))
    assert m.topo.next_volume_id == max_vid + 1
    assert m.topo.sequence.peek > max_key


# -- the CLI -------------------------------------------------------------------


def _spawn(args, log_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", *args],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=open(log_path, "wb"))


def test_cli_master_volume_and_shell(tmp_path):
    mport, vport = free_port_pair(), free_port_pair()
    murl = f"127.0.0.1:{mport}"
    procs = [
        _spawn(["master", "-port", str(mport), "-mdir",
                str(tmp_path / "m"), "-pulseSeconds", "0.2"],
               tmp_path / "master.log"),
        _spawn(["volume", "-port", str(vport), "-dir", str(tmp_path / "v"),
                "-mserver", murl, "-max", "10", "-pulseSeconds", "0.2",
                "-ec.encoder", "cpu"], tmp_path / "volume.log")]
    try:
        def registered():
            try:
                with urllib.request.urlopen(f"http://{murl}/dir/status",
                                            timeout=2) as r:
                    topo = json.load(r)["Topology"]
            except OSError:
                return False
            return any(n["url"] == f"127.0.0.1:{vport}"
                       for dc in topo["data_centers"]
                       for rack in dc["racks"] for n in rack["nodes"])

        wait_for(registered, timeout=60, what="the CLI volume server")
        blobs = {operations.upload(murl, os.urandom(700 + i)): None
                 for i in range(8)}
        for fid in blobs:
            blobs[fid] = operations.http_request(
                "GET", f"127.0.0.1:{vport}/{fid}").body
        vid = parse_fid(next(iter(blobs))).volume_id
        out = subprocess.run(
            [sys.executable, "-m", "seaweedfs_tpu_torch", "shell",
             "-master", murl, f"ec.encode -volumeId={vid}"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert f"volume {vid}: ec.encode done" in out.stdout
        wait_for(lambda: operations.lookup(murl, vid), what="ec lookup")
        for fid, data in blobs.items():
            assert operations.http_request(
                "GET", f"127.0.0.1:{vport}/{fid}").body == data
    finally:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=30) for p in procs]
    assert codes == [0, 0]
    for name in ("master.log", "volume.log"):
        assert "Traceback" not in (tmp_path / name).read_text()


# -- the read cache on the service path (tests/test_cluster.py:483) ------------


def test_degraded_reads_through_the_cache_end_to_end(tmp_path):
    """Four servers with the read cache and hedging on (one on the kv
    needle map): reads through a stopped server are byte-identical and
    decode on the fleet; the same reads repeated, each to the same
    server, are cache hits with zero new decode dispatches; /status has
    the Cache block; ec.rebuild invalidates and the reads after it are
    byte-identical; a scrub repair and an EC delete invalidate."""
    cached = {"cache_size_mb": 16, "hedge_reads": True}
    c = Cluster(tmp_path, n_volume_servers=4, volumes_per_server=10,
                volume_kwargs=[cached, cached, cached,
                               dict(cached, needle_map_kind="kv")])
    try:
        assert [vs.store.locations[0].needle_map_kind
                for vs in c.volume_servers] == ["memory"] * 3 + ["kv"]
        with c.http(f"{c.master.url}/vol/grow?collection=deg&count=2") as r:
            assert json.load(r)["count"] == 2
        rng = np.random.default_rng(17)
        blobs = {}
        for _ in range(40):
            d = rng.integers(0, 256, int(rng.integers(1, 64 << 10)),
                             dtype=np.uint8).tobytes()
            blobs[c.upload(d, collection="deg")] = d
        vids = sorted({parse_fid(f).volume_id for f in blobs})
        out = Shell(c.master.url).run_command(
            f"ec.encode -collection=deg "
            f"-volumeId={','.join(map(str, vids))}")
        assert all(f"volume {v}: ec.encode done" in out for v in vids)
        wait_for(lambda: all(c.master.topo.lookup_ec(v) and
                             not c.master.topo.lookup(v) for v in vids),
                 what="every volume as spread EC shards")
        victim = next(vs for vs in c.volume_servers
                      if vs.store.find_ec_volume(vids[0]).shard_bits.has(0))
        victim.stop()
        c.volume_servers.remove(victim)
        wait_for(lambda: victim.url not in
                 {n.url for n in c.master.topo.nodes()},
                 what="the master dropping the stopped server")
        servers = c.volume_servers

        def read_all():
            for i, (fid, d) in enumerate(sorted(blobs.items())):
                with c.http(f"{servers[i % len(servers)].url}/{fid}") as r:
                    assert r.read() == d

        def total(attr):
            return sum(getattr(vs.read_cache, attr) for vs in servers)

        d0 = sum(vs.degraded.dispatches for vs in servers)
        read_all()
        d1 = sum(vs.degraded.dispatches for vs in servers)
        assert d1 > d0, "degraded reads never reached the decode fleet"
        h0 = total("hits")
        read_all()
        assert sum(vs.degraded.dispatches for vs in servers) == d1, \
            "repeat reads made new decode dispatches past the cache"
        assert total("hits") - h0 == len(blobs)
        with c.http(f"{servers[0].url}/status") as r:
            st = json.load(r)
        assert st["Cache"]["enabled"] and st["Cache"]["hits"] > 0
        assert st["Cache"]["mem_entries"] > 0

        inv0 = total("invalidations")
        out = Shell(c.master.url).run_command("ec.rebuild -collection=deg")
        assert all(f"volume {v}: rebuilt shards" in out for v in vids)
        assert total("invalidations") > inv0, \
            "a shard rebuild must invalidate cached entries"
        wait_for(lambda: all(
            sum(b.count for b in c.master.topo.lookup_ec(v).values()) == 14
            for v in vids), what="14 shards per volume on live servers")
        read_all()

        vs = servers[0]
        assert vs.scrub.on_repair == vs._invalidate_volume_cache
        before = vs.read_cache.stats()["mem_entries"]
        vs.scrub.on_repair(vids[0])
        assert vs.read_cache.stats()["mem_entries"] < before
        fid = next(f for i, f in enumerate(sorted(blobs))
                   if i % len(servers) == 0)
        key = vs.read_cache.needle_key(parse_fid(fid).volume_id,
                                       parse_fid(fid).key)
        with c.http(f"{vs.url}/{fid}") as r:
            r.read()
        assert vs.read_cache.get(key) is not None
        with c.http(f"{vs.url}/{fid}", method="DELETE") as r:
            assert r.status == 202
        assert vs.read_cache.get(key) is None
        with pytest.raises(urllib.error.HTTPError) as ei:
            c.http(f"{vs.url}/{fid}")
        assert ei.value.code == 404
    finally:
        c.stop()


# -- faults found against the JAX server (ROADMAP Queue 3) ---------------------


def _jax_volume_server(d, port):
    from seaweedfs_tpu.server.volume import VolumeServer as JaxVolumeServer
    vs = JaxVolumeServer("127.0.0.1:1", [str(d)], port=port,
                         pulse_seconds=60.0, ec_encoder="numpy")
    vs.start()
    vs.store.add_volume(1)
    return vs


def _request(method, url, data=None, headers=None):
    """(status, body) of one HTTP request, errors included."""
    try:
        with urllib.request.urlopen(urllib.request.Request(
                f"http://{url}", data=data, method=method,
                headers=headers or {}), timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


MANIFEST = b'{"name": "x", "mime": "", "size": 0, "chunks": []}'


def test_chunk_manifest_is_refused(tmp_path):
    """The 50-byte manifest the JAX server stores flagged 0x84 (at record
    offset 70), in a directory a JAX server and a port server each open:
    GET, HEAD, GET ?cm=false and DELETE answer alike (status, headers,
    body), and both refuse it in BatchDelete (406), the one refusal left
    since the port serves chunk manifests. A port upload with cm=true is
    flagged 0x84 too."""
    from seaweedfs_tpu.pb import volume_server_pb2 as jax_vs_pb2
    from seaweedfs_tpu.pb import volume_stub as jax_volume_stub
    assert len(MANIFEST) == 50
    d = tmp_path / "v"
    d.mkdir()
    jvs = _jax_volume_server(d, free_port_pair())
    try:
        status, _ = _request("POST", f"{jvs.url}/1,01000000aa?cm=true",
                             MANIFEST, {"Content-Type": "application/json"})
        assert status == 201
        jvs.store.find_volume(1).sync()
    finally:
        jvs.stop()
    with open(d / "1.dat", "rb") as f:
        record = f.read()[8:]
    assert record[70] == 0x84
    shutil.copytree(d, tmp_path / "j")
    jvs = _jax_volume_server(tmp_path / "j", free_port_pair())
    vs = VolumeServer("127.0.0.1:1", [str(d)], port=free_port_pair(),
                      pulse_seconds=60.0, ec_encoder="cpu")
    vs.start()
    compared = ("Content-Type", "Content-Length", "Content-Disposition",
                "X-File-Store", "Accept-Ranges")

    def answer(url, method="GET"):
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    f"http://{url}", method=method), timeout=30) as r:
                return r.status, [r.headers.get(k) for k in compared], \
                    r.read()
        except urllib.error.HTTPError as e:
            return e.code, [e.headers.get(k) for k in compared], e.read()

    try:
        for method, suffix in (("GET", ""), ("HEAD", ""),
                               ("GET", "?cm=false")):
            got = [answer(f"{srv.url}/1,01000000aa{suffix}", method)
                   for srv in (jvs, vs)]
            assert got[1] == got[0], (method, suffix)
        assert got[1][2] == MANIFEST
        assert answer(f"{vs.url}/1,01000000aa")[1][3] == "chunked"
        refusals = [
            stub(srv.url).BatchDelete(pb2.BatchDeleteRequest(
                file_ids=["1,01000000aa"])).results[0]
            for stub, pb2, srv in ((jax_volume_stub, jax_vs_pb2, jvs),
                                   (volume_stub, volume_server_pb2, vs))]
        assert [(r.status, r.error) for r in refusals] == \
            [(406, "ChunkManifest: not allowed in batch delete mode.")] * 2
        deleted = [(answer(f"{srv.url}/1,01000000aa", "DELETE"),
                    answer(f"{srv.url}/1,01000000aa")[0])
                   for srv in (jvs, vs)]
        assert deleted[1] == deleted[0]
        assert deleted[1][0][0] == 202 and deleted[1][1] == 404
        status, _ = _request("POST", f"{vs.url}/1,02000000bb?cm=true",
                             MANIFEST, {"Content-Type": "application/json"})
        assert status == 201
        v = vs.store.find_volume(1)
        v.sync()
        with open(v.dat_path, "rb") as f:
            dat = f.read()
        assert dat[dat.rindex(MANIFEST) + len(MANIFEST)] == 0x84
        # without cm the same bytes are a plain needle, as in the JAX
        # package: the flags byte is 0x04 (a mime type)
        status, _ = _request("POST", f"{vs.url}/1,03000000cc", MANIFEST,
                             {"Content-Type": "application/json"})
        assert status == 201
        status, body = _request("GET", f"{vs.url}/1,03000000cc")
        assert (status, body) == (200, MANIFEST)
    finally:
        vs.stop()
        jvs.stop()


def test_corrupt_read_is_counted_on_both_servers(tmp_path):
    """One needle whose payload has one byte flipped, read with
    SEAWEED_VERIFY_READS on: 500 from both servers, and
    ScrubCorruptionsFoundCounter{kind="read"} rises by one on both."""
    from seaweedfs_tpu.stats.metrics import \
        ScrubCorruptionsFoundCounter as JaxCounter
    from seaweedfs_tpu.storage import volume as jax_volume
    from seaweedfs_tpu_torch.stats.metrics import \
        ScrubCorruptionsFoundCounter as PortCounter
    from seaweedfs_tpu_torch.storage import volume as port_volume
    payload = np.random.default_rng(23).bytes(3000)
    fid = "1,05000000ee"
    rises = {}
    for name, mod, counter, make in (
            ("jax", jax_volume, JaxCounter,
             lambda d: _jax_volume_server(d, free_port_pair())),
            ("port", port_volume, PortCounter, None)):
        d = tmp_path / name
        d.mkdir()
        if make is None:
            vs = VolumeServer("127.0.0.1:1", [str(d)], port=free_port_pair(),
                              pulse_seconds=60.0, ec_encoder="cpu")
            vs.start()
            vs.store.add_volume(1)
        else:
            vs = make(d)
        was = mod.verify_reads_enabled()
        mod.set_verify_reads(True)
        try:
            assert _request("POST", f"{vs.url}/{fid}", payload)[0] == 201
            assert _request("GET", f"{vs.url}/{fid}") == (200, payload)
            v = vs.store.find_volume(1)
            v.sync()
            with open(v.dat_path, "r+b") as f:  # record at 8, data at +20
                f.seek(8 + 20 + 1234)
                b = f.read(1)
                f.seek(8 + 20 + 1234)
                f.write(bytes([b[0] ^ 0x40]))
            before = counter.labels("read").value
            status, body = _request("GET", f"{vs.url}/{fid}")
            rises[name] = (status, counter.labels("read").value - before)
        finally:
            mod.set_verify_reads(was)
            vs.stop()
    assert rises == {"jax": (500, 1), "port": (500, 1)}
