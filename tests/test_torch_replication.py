"""The port's replication against the JAX package's.

Pure functions on the same seeded inputs: xyz placement
(``VolumeGrowth.find_empty_slots`` with ``random.Random(s)`` against the
JAX package's after ``random.seed(s)``, ``NoFreeSlots`` in the same
cases, ``growth_count``), ``plan_fix_replication``, the circuit breaker's
transitions under one scripted sequence of outcomes and clock,
``sort_candidates``, ``retry``'s attempts and sleeps, and
``http_client.classify``. Then in-process clusters (one master, three
volume servers over two racks, ``ec_encoder="cpu"``) driven beside a JAX
cluster of the same shape: writes of 001 and 010 read back from every
replica, HTTP DELETE and BatchDelete remove a needle from all of them, a
write with a replica down is not acknowledged, scrub repairs a needle
from a replica (and cannot without one). The port alone:
``volume.fix.replication``, ``volume.configure.replication`` then a fix,
``volume.copy``, a replica directory that opens in the JAX Store,
``ec.encode`` of a 001 volume (both replicas retired, shards equal to
the JAX ``ReedSolomon("jax")`` encode), and the ``-dataCenter``,
``-rack``, ``-publicUrl``, ``-defaultReplication``,
``-replicate.parallel`` and ``-resilience.breaker*`` flags.
"""

import hashlib
import http.server
import os
import random
import shutil
import threading
import types

import numpy as np
import pytest

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.operation.file_id import parse_fid
from seaweedfs_tpu_torch.pb import volume_server_pb2, volume_stub
from seaweedfs_tpu_torch.resilience import breaker
from seaweedfs_tpu_torch.shell import Shell
from seaweedfs_tpu_torch.storage.superblock import ReplicaPlacement
from seaweedfs_tpu_torch.topology import volume_growth
from seaweedfs_tpu_torch.topology.topology import Topology
from seaweedfs_tpu_torch.util import http_client, retry
from tests.test_torch_cluster import Cluster, free_port_pair, wait_for

PLACEMENTS = ["000", "001", "010", "100", "011", "110", "200"]
RACKS = ("r1", "r1", "r2")


# -- placement -----------------------------------------------------------------


def _heartbeats(seed: int) -> list:
    """(heartbeat, dc, rack) of a seeded topology: 1-3 data centers of
    1-3 racks of 1-3 servers, some of them full."""
    rng = np.random.default_rng(seed)
    out, port, vid = [], 8000, 1
    for d in range(int(rng.integers(1, 4))):
        for r in range(int(rng.integers(1, 4))):
            for _ in range(int(rng.integers(1, 4))):
                max_count = int(rng.integers(1, 4))
                used = int(rng.integers(0, max_count + 1))
                vols = [{"id": vid + i, "collection": "", "size": 0,
                         "replica_placement": 0, "version": 3}
                        for i in range(used)]
                vid += used
                out.append(({"ip": "127.0.0.1", "port": port,
                             "max_volume_count": max_count,
                             "volumes": vols}, f"dc{d}", f"rack{r}"))
                port += 1
    return out


def _topologies(seed: int):
    from seaweedfs_tpu.topology.topology import Topology as JaxTopology
    port, jax = Topology(), JaxTopology()
    for hb, dc, rack in _heartbeats(seed):
        port.sync_heartbeat(dict(hb), dc=dc, rack=rack)
        jax.sync_heartbeat(dict(hb), dc=dc, rack=rack)
    return port, jax


def test_growth_count_equals_jax():
    from seaweedfs_tpu.topology.volume_growth import \
        growth_count as jax_growth_count
    for copies in range(6):
        assert volume_growth.growth_count(copies) == \
            jax_growth_count(copies)
    assert [volume_growth.growth_count(c) for c in (1, 2, 3)] == [7, 6, 3]


@pytest.mark.parametrize("topo_seed", [3, 11, 29])
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_find_empty_slots_equals_jax(topo_seed, placement):
    from seaweedfs_tpu.storage.superblock import \
        ReplicaPlacement as JaxPlacement
    from seaweedfs_tpu.topology import volume_growth as jax_growth
    port_topo, jax_topo = _topologies(topo_seed)
    rp, jrp = ReplicaPlacement.parse(placement), JaxPlacement.parse(placement)
    for s in range(12):
        for dc in ("", "dc0"):
            want = got = None
            random.seed(s)
            try:
                want = [n.url for n in jax_growth.VolumeGrowth(jax_topo)
                        .find_empty_slots(jrp, dc)]
            except jax_growth.NoFreeSlots as e:
                want = str(e)
            grower = volume_growth.VolumeGrowth(port_topo,
                                                rng=random.Random(s))
            try:
                got = [n.url for n in grower.find_empty_slots(rp, dc)]
            except volume_growth.NoFreeSlots as e:
                got = str(e)
            assert got == want, (s, dc)
            if not isinstance(got, str):
                nodes = [port_topo.find_node(u) for u in got]
                assert len(set(got)) == rp.copy_count
                main = nodes[0]
                assert sum(n.rack is main.rack for n in nodes) == \
                    1 + rp.same_rack
                assert sum(n.rack.data_center is not
                           main.rack.data_center for n in nodes) == \
                    rp.diff_dc


# -- fix.replication planning --------------------------------------------------


def _plan_both(replicas, candidates):
    from seaweedfs_tpu.shell import command_volume as jcv
    from seaweedfs_tpu_torch.shell import command_volume as pcv
    port = pcv.plan_fix_replication(
        {v: [(pcv.NodeLoc(*loc), b) for loc, b in r]
         for v, r in replicas.items()},
        [pcv.NodeLoc(*c) for c in candidates])
    jax = jcv.plan_fix_replication(
        {v: [(jcv.NodeLoc(*loc), b) for loc, b in r]
         for v, r in replicas.items()},
        [jcv.NodeLoc(*c) for c in candidates])
    assert [tuple(m) for m in port] == [tuple(m) for m in jax]
    return [tuple(m) for m in port]


def test_plan_fix_replication_cases_equal_jax():
    a, b = ("a:1", "dc1", "r1"), ("b:1", "dc1", "r1")
    c, d = ("c:1", "dc1", "r2"), ("d:1", "dc2", "r1")
    assert _plan_both({5: [(a, 1)], 6: [(a, 0)]}, [a, b]) == \
        [(5, "a:1", "b:1")]
    assert {m[2] for m in _plan_both({9: [(a, 110)]}, [a, b, c, d])} == \
        {"c:1", "d:1"}
    assert _plan_both({9: [(a, 1)]}, [a, c]) == []
    assert _plan_both({9: [(a, 10), (b, 10)]}, [a, b, c]) == []


@pytest.mark.parametrize("seed", range(4))
def test_plan_fix_replication_random_layouts_equal_jax(seed):
    rng = np.random.default_rng(seed)
    nodes = [(f"n{i}:1", f"dc{rng.integers(2)}", f"r{rng.integers(3)}")
             for i in range(int(rng.integers(3, 9)))]
    replicas = {}
    for vid in range(1, 25):
        placement = int(rng.choice([0, 1, 10, 100, 11, 110, 200]))
        held = rng.choice(len(nodes), size=int(rng.integers(1, 3)),
                          replace=False)
        replicas[vid] = [(nodes[i], placement) for i in held]
    _plan_both(replicas, nodes)


# -- EC balance across racks --------------------------------------------------


def _ec_nodes(pkg_env, pkg_bits, layout):
    return [pkg_env.EcNode(url, free, {vid: pkg_bits.ShardBits.of(*sids)
                                       for vid, sids in shards.items()},
                           rack=rack)
            for url, free, shards, rack in layout]


@pytest.mark.parametrize("seed", [None, 1, 2, 3])
def test_plan_balance_across_racks_equals_jax(seed):
    """The rack rule of ec.balance once nodes carry racks: the port plans
    the JAX package's moves, and no rack ends with more than its share of
    any volume's shards."""
    from seaweedfs_tpu.ec import shard_bits as jbits
    from seaweedfs_tpu.shell import command_env as jenv
    from seaweedfs_tpu.shell import ec_common as jec
    from seaweedfs_tpu_torch.ec import shard_bits as pbits
    from seaweedfs_tpu_torch.shell import command_env as penv
    from seaweedfs_tpu_torch.shell import ec_common as pec
    if seed is None:   # tests/test_shell.py::test_plan_balance_across_racks
        layout = [("a:1", 20, {1: range(10)}, "dc/r1"),
                  ("b:1", 20, {1: (10, 11, 12, 13)}, "dc/r1"),
                  ("c:1", 20, {}, "dc/r2"), ("d:1", 20, {}, "dc/r3")]
    else:
        rng = np.random.default_rng(seed)
        urls = [f"n{i}:1" for i in range(int(rng.integers(3, 7)))]
        racks = {u: f"dc/r{rng.integers(1, 4)}" for u in urls}
        shards = {u: {} for u in urls}
        for vid in (1, 2, 3):
            for sid in range(14):
                u = urls[int(rng.integers(min(2, len(urls))))]
                shards[u].setdefault(vid, []).append(sid)
        layout = [(u, 20, shards[u], racks[u]) for u in urls]
    port_nodes = _ec_nodes(penv, pbits, layout)
    moves = pec.plan_balance_across_racks(port_nodes)
    want = jec.plan_balance_across_racks(_ec_nodes(jenv, jbits, layout))
    assert [tuple(m) for m in moves] == [tuple(m) for m in want]
    after = pec.apply_moves_to_nodes(port_nodes, moves)
    n_racks = len({n.rack for n in after})
    for vid in (1, 2, 3):
        per_rack, held = {}, []
        for n in after:
            bits = n.shards.get(vid, pbits.ShardBits(0))
            per_rack[n.rack] = per_rack.get(n.rack, 0) + bits.count
            held += bits.shard_ids
        if held:
            assert sorted(held) == list(range(14))
            assert max(per_rack.values()) <= -(-14 // n_racks)


# -- the breaker, retry and the HTTP client ------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t


def _script(module, clock):
    """One scripted run: states after each step of outcomes and time."""
    b = module.CircuitBreaker("peer:1", threshold=3, cooldown_s=2.0)
    trace = []
    steps = ["fail", "fail", "ok", "fail", "fail", "fail", "allow",
             ("tick", 1.0), "allow", ("tick", 1.5), "state", "allow",
             "allow", "fail", "allow", ("tick", 2.5), "allow", "ok",
             "allow", ("tick", 0.1), "fail", "fail", "fail", "state"]
    for step in steps:
        if isinstance(step, tuple):
            clock.t += step[1]
        elif step == "allow":
            trace.append(("allow", b.allow()))
        elif step == "state":
            trace.append(("state", b.state))
        else:
            b.record(step == "ok")
        trace.append(b._state)
    return trace


def test_breaker_transitions_equal_jax(monkeypatch):
    from seaweedfs_tpu.resilience import breaker as jax_breaker
    traces = []
    for module in (jax_breaker, breaker):
        clock = _Clock()
        monkeypatch.setattr(module, "time", types.SimpleNamespace(
            monotonic=clock.monotonic))
        traces.append(_script(module, clock))
    assert traces[0] == traces[1]
    assert breaker.OPEN in traces[1] and breaker.HALF_OPEN in traces[1]


def test_sort_candidates_and_is_open_equal_jax():
    from seaweedfs_tpu.resilience import breaker as jax_breaker
    urls = ["a:1", "b:1", "c:1", "d:1"]
    got = []
    try:
        for module in (jax_breaker, breaker):
            module.reset()
            assert module.sort_candidates(urls[::-1]) == urls[::-1]
            module.configure(enable=True, threshold=1, cooldown_s=60)
            module.record("b:1", False)
            module.record("d:1", False)
            module.record("c:1", True)
            got.append((module.sort_candidates(urls),
                        [module.is_open(u) for u in urls + ["z:1"]],
                        "z:1" in module._registry))
            with pytest.raises(module.BreakerOpen):
                module.check("b:1")
    finally:
        for module in (jax_breaker, breaker):
            module.reset()
            module.configure(threshold=5, cooldown_s=5.0)
    assert got[0] == got[1] == (["a:1", "c:1", "b:1", "d:1"],
                                [False, True, False, True, False], False)


def _retry_run(module, outcomes, **kw):
    sleeps = []
    calls = iter(outcomes)

    def fn():
        out = next(calls)
        if isinstance(out, BaseException):
            raise out
        return out

    try:
        result = module.retry("t", fn, _sleep=sleeps.append,
                              _rand=lambda: 0.5, **kw)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        result = f"raised {type(e).__name__}: {e}"
    return result, sleeps


@pytest.mark.parametrize("case", ["ok_after_two", "exhausted", "no_jitter",
                                  "retry_after", "nonretryable"])
def test_retry_attempts_and_sleeps_equal_jax(case):
    from seaweedfs_tpu.util import retry as jax_retry
    from seaweedfs_tpu.util import http_client as jax_http
    pkgs = [(jax_retry, jax_http), (retry, http_client)]
    got = []
    for r_mod, h_mod in pkgs:
        conn = h_mod.ConnectError("refused")
        outcomes, kw = {
            "ok_after_two": ([conn, conn, "done"], {}),
            "exhausted": ([conn] * 4, {"times": 4, "wait_seconds": 0.1}),
            "no_jitter": ([conn] * 3 + ["x"], {"jitter": False,
                                               "backoff": 3.0}),
            "retry_after": ([h_mod.ServerBusy("busy", retry_after=1.25),
                             "y"], {}),
            "nonretryable": ([h_mod.RequestTimeout("slow"), "z"], {}),
        }[case]
        got.append(_retry_run(r_mod, outcomes, **kw))
    assert got[0] == got[1]


def _exception_pairs():
    from seaweedfs_tpu.resilience import breaker as jb
    from seaweedfs_tpu.resilience import deadline as jd
    from seaweedfs_tpu.util import http_client as jh
    from seaweedfs_tpu_torch.resilience import deadline as pd
    return [
        (jd.DeadlineExceeded("x"), pd.DeadlineExceeded("x")),
        (jb.BreakerOpen("p:1"), breaker.BreakerOpen("p:1")),
        (jh.ServerBusy("b"), http_client.ServerBusy("b")),
        (jh.RequestTimeout("t"), http_client.RequestTimeout("t")),
        (TimeoutError("t"), TimeoutError("t")),
        (jh.ConnectError("c"), http_client.ConnectError("c")),
        (jh._StaleConnection("s", retryable=True),
         http_client._StaleConnection("s", retryable=True)),
        (jh._StaleConnection("s"), http_client._StaleConnection("s")),
        (jh.ResponseError("r"), http_client.ResponseError("r")),
        (ConnectionResetError("r"), ConnectionResetError("r")),
        (ValueError("v"), ValueError("v")),
    ]


def test_classify_equals_jax():
    from seaweedfs_tpu.util import http_client as jh
    kinds = [(jh.classify(j), http_client.classify(p))
             for j, p in _exception_pairs()]
    assert all(a == b for a, b in kinds), kinds
    assert {a for a, _ in kinds} == {"deadline", "breaker", "busy",
                                     "timeout", "connect", "response",
                                     "other"}


def test_http_client_pools_and_feeds_the_breaker():
    """Keep-alive reuse, chunked and sized bodies, a refused peer as
    ConnectError, and the breaker it feeds opening and failing fast."""
    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path == "/chunked":
                self.send_response(200)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for part in (b"hello ", b"chunked"):
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(part), part))
                self.wfile.write(b"0\r\n\r\n")
                return
            body = self.path.encode()
            self.send_response(404 if "missing" in self.path else 200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    peer = f"127.0.0.1:{srv.server_address[1]}"
    try:
        http_client.close_all()
        r = http_client.request("GET", f"http://{peer}/a?b=1")
        assert (r.status, r.body) == (200, b"/a?b=1")
        assert http_client._idle_count() == 1
        r = http_client.request("GET", f"{peer}/missing")
        assert (r.status, r.body) == (404, b"/missing")
        assert http_client._idle_count() == 1      # the same connection
        assert http_client.request("GET", f"{peer}/chunked").body == \
            b"hello chunked"
    finally:
        srv.shutdown()
        srv.server_close()
        http_client.close_all()
    try:
        breaker.configure(enable=True, threshold=2, cooldown_s=60)
        for _ in range(2):
            with pytest.raises(http_client.ConnectError):
                http_client.request("GET", f"{peer}/x", timeout=2)
        assert breaker.is_open(peer)
        with pytest.raises(breaker.BreakerOpen):
            http_client.request("GET", f"{peer}/x", timeout=2)
    finally:
        breaker.reset()
        breaker.configure(threshold=5, cooldown_s=5.0)


# -- the clusters --------------------------------------------------------------


def _port_cluster(path, racks=RACKS, **kw):
    return Cluster(path, n_volume_servers=len(racks), volumes_per_server=40,
                   volume_kwargs=[{"rack": r, "data_center": "dc1"}
                                  for r in racks], **kw)


def _jax_cluster(path, racks=RACKS):
    from tests.cluster_util import Cluster as JaxCluster
    return JaxCluster(path, n_volume_servers=len(racks),
                      volumes_per_server=40, racks=list(racks))


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    port = _port_cluster(tmp_path_factory.mktemp("port"))
    try:
        jax = _jax_cluster(tmp_path_factory.mktemp("jax"))
    except BaseException:
        port.stop()
        raise
    yield {"port": port, "jax": jax}
    jax.stop()
    port.stop()


def _status(c, url: str, method: str = "GET", data=None):
    import urllib.error
    try:
        with c.http(url, data=data, method=method) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _replica_urls(c, vid: int, collection: str, copies: int):
    return wait_for(
        lambda: (lambda locs: sorted(u for u, _ in locs)
                 if len(locs) == copies else None)(
            c.master.lookup_locations(vid, collection)),
        what=f"{copies} replicas of volume {vid}")


def _write_read_delete(c, kind: str, placement: str) -> list:
    """The operations both packages run: statuses and read-back checks,
    in order."""
    from seaweedfs_tpu.pb import volume_server_pb2 as jax_vpb
    from seaweedfs_tpu.pb import volume_stub as jax_volume_stub
    rng = np.random.default_rng(int(placement))
    datas = [rng.bytes(int(n)) for n in rng.integers(1, 9000, 6)]
    collection = f"c{placement}"
    fids = [c.upload(d, replication=placement, collection=collection)
            for d in datas]
    log = []
    rack = {vs.url: vs.rack for vs in c.volume_servers}
    for fid, data in zip(fids, datas):
        urls = _replica_urls(c, parse_fid(fid).volume_id, collection, 2)
        same_rack = rack[urls[0]] == rack[urls[1]]
        log.append(("racks", same_rack))
        for url in urls:
            status, body = _status(c, f"{url}/{fid}")
            log.append(("read", status, body == data))
    # HTTP DELETE through one replica removes it from both
    urls = _replica_urls(c, parse_fid(fids[0]).volume_id, collection, 2)
    log.append(("delete", _status(c, f"{urls[0]}/{fids[0]}",
                                  method="DELETE")[0]))
    log += [("gone", _status(c, f"{u}/{fids[0]}")[0]) for u in urls]
    # BatchDelete through the other replica too
    urls = _replica_urls(c, parse_fid(fids[1]).volume_id, collection, 2)
    if kind == "port":
        res = volume_stub(urls[1]).BatchDelete(
            volume_server_pb2.BatchDeleteRequest(file_ids=[fids[1]]))
    else:
        res = jax_volume_stub(urls[1]).BatchDelete(
            jax_vpb.BatchDeleteRequest(file_ids=[fids[1]]))
    log.append(("batch", [r.status for r in res.results]))
    log += [("gone", _status(c, f"{u}/{fids[1]}")[0]) for u in urls]
    return log


@pytest.mark.parametrize("placement", ["001", "010"])
def test_replicated_writes_and_deletes_equal_jax(clusters, placement):
    logs = {k: _write_read_delete(c, k, placement)
            for k, c in clusters.items()}
    assert logs["port"] == logs["jax"]
    assert ("racks", placement == "001") in logs["port"]
    assert all(e[1] == 200 and e[2] for e in logs["port"]
               if e[0] == "read")
    assert [e[1] for e in logs["port"] if e[0] in ("delete", "gone",
                                                    "batch")] == \
        [202, 404, 404, [202], 404, 404]


def test_write_with_a_replica_down_is_not_acknowledged(tmp_path):
    """A write whose replica POST fails is a 500 in both packages. Once
    the master has dropped the stopped server the port still refuses (the
    placement names two copies and one is known); the JAX server then
    acknowledges with one copy (ROADMAP Queue 3)."""
    got = {}
    for kind, make in (("port", _port_cluster), ("jax", _jax_cluster)):
        c = make(tmp_path / kind, racks=("r1", "r2"))
        try:
            fid = c.upload(b"first", replication="010", collection="down")
            vid = parse_fid(fid).volume_id
            urls = _replica_urls(c, vid, "down", 2)
            primary, victim = urls
            # a write through the primary caches its replica locations,
            # as a busy volume's writes do
            warm = f"{vid},{0x76:x}{0x12345678:08x}"
            assert _status(c, f"{primary}/{warm}", "POST", b"warm")[0] == 201
            next(vs for vs in c.volume_servers if vs.url == victim).stop()
            new_fid = f"{vid},{0x77:x}{0x12345678:08x}"
            statuses = [_status(c, f"{primary}/{new_fid}", "POST",
                                b"second")[0]]
            wait_for(lambda: len(c.master.lookup_locations(vid, "down"))
                     == 1, what="the master dropping the server")
            statuses.append(_status(c, f"{primary}/{new_fid}", "POST",
                                    b"third")[0])
            statuses.append(_status(c, f"{primary}/{fid}")[0])
            got[kind] = statuses
        finally:
            c.volume_servers = [vs for vs in c.volume_servers
                                if not vs._stopping]
            c.stop()
    assert got["port"] == [500, 500, 200]
    assert got["jax"] == [500, 201, 200]


def _corrupt_needle(vs, vid: int, key: int) -> None:
    v = vs.store.find_volume(vid)
    v.sync()
    nv = v.nm.get(key)
    with open(v.file_name() + ".dat", "r+b") as f:
        f.seek(nv.offset + 16 + 4 + 3)   # the first data bytes
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x5A]))


@pytest.mark.parametrize("placement", ["010", "000"])
def test_scrub_repairs_from_a_replica_equal_jax(clusters, placement):
    """A CRC-bad needle on one replica: scrub fetches it from the other
    and rewrites it; on a volume of one copy it stays unrecoverable."""
    got = {}
    data = np.random.default_rng(int(placement) + 7).bytes(3000)
    for kind, c in clusters.items():
        col = f"scrub{placement}"
        fid = c.upload(data, replication=placement, collection=col)
        f = parse_fid(fid)
        urls = _replica_urls(c, f.volume_id, col,
                             ReplicaPlacement.parse(placement).copy_count)
        vs = next(v for v in c.volume_servers if v.url == urls[0])
        _corrupt_needle(vs, f.volume_id, f.key)
        res = vs.scrub.run_pass(volume_ids=[f.volume_id])
        got[kind] = (res.corruptions_found, res.corruptions_repaired,
                     res.unrecoverable, _status(c, f"{vs.url}/{fid}"))
    assert got["port"] == got["jax"]
    if placement == "010":
        assert got["port"] == (1, 1, 0, (200, data))
    else:
        assert got["port"][:3] == (1, 0, 1)
        assert got["port"][3][0] == 500


def test_port_replica_opens_in_the_jax_store(clusters, tmp_path):
    from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
    from seaweedfs_tpu.storage.store import Store as JaxStore
    c = clusters["port"]
    blobs = [os.urandom(n) for n in (1, 700, 5000, 12000)]
    fids = [c.upload(b, replication="010", collection="jaxopen")
            for b in blobs]
    vid = parse_fid(fids[0]).volume_id
    for url in _replica_urls(c, vid, "jaxopen", 2):
        v = c.server(url).store.find_volume(vid)
        v.sync()
        d = tmp_path / url.replace(":", "_")
        d.mkdir()
        for ext in (".dat", ".idx"):
            shutil.copy(v.file_name() + ext, d)
        s = JaxStore([str(d)])
        try:
            jv = s.find_volume(vid)
            assert str(jv.replica_placement) == "010"
            for fid, blob in zip(fids, blobs):
                f = parse_fid(fid)
                if f.volume_id == vid:
                    assert s.read_needle(vid, JaxNeedle(
                        id=f.key, cookie=f.cookie)).data == blob
        finally:
            s.close()


# -- the shell -----------------------------------------------------------------


def test_fix_replication_configure_and_copy(tmp_path):
    c = _port_cluster(tmp_path)
    try:
        sh = Shell(c.master.url)
        # a lost replica comes back where the placement wants it, and the
        # surviving replica's next write reaches the new copy
        fid = c.upload(b"fix me", replication="010", collection="fix")
        vid = parse_fid(fid).volume_id
        urls = _replica_urls(c, vid, "fix", 2)
        lost = next(u for u in urls if c.server(u).rack == "r1")
        keep = next(u for u in urls if u != lost)
        # a write caches the replica locations on the survivor
        warm = f"{vid},{0x44:x}{0x0badf00d:08x}"
        assert _status(c, f"{keep}/{warm}", "POST", b"warm")[0] == 201
        assert vid in c.server(keep)._replica_urls
        volume_stub(lost).VolumeDelete(
            volume_server_pb2.VolumeDeleteRequest(volume_id=vid))
        wait_for(lambda: len(c.master.lookup_locations(vid, "fix")) == 1,
                 what="the replica loss")
        out = sh.run_command("volume.fix.replication")
        new = next(vs.url for vs in c.volume_servers
                   if vs.store.has_volume(vid) and vs.url != keep)
        assert f"volume {vid}: replicated {keep} -> {new}" in out
        assert c.server(new).rack == "r1"
        # the copy's source forgot its cached locations
        assert vid not in c.server(keep)._replica_urls
        _replica_urls(c, vid, "fix", 2)
        assert _status(c, f"{new}/{fid}") == (200, b"fix me")
        after = f"{vid},{0x55:x}{0x0badf00d:08x}"
        assert _status(c, f"{keep}/{after}", "POST", b"late")[0] == 201
        assert _status(c, f"{new}/{after}") == (200, b"late")
        assert "all volumes sufficiently replicated" in \
            sh.run_command("volume.fix.replication")

        # configure 000 -> 010, then the fix makes the second copy
        fid = c.upload(b"one copy", collection="cfg")
        vid = parse_fid(fid).volume_id
        (only,) = _replica_urls(c, vid, "cfg", 1)
        out = sh.run_command(
            f"volume.configure.replication -volumeId={vid} -replication=010")
        assert out == f"volume {vid}: replication -> 010 on {only}\n"
        wait_for(lambda: getattr(c.master.topo.find_node(only).volumes.get(
            vid), "replica_placement", None) == 10,
            what="the new placement in the heartbeat")
        out = sh.run_command("volume.fix.replication")
        assert f"volume {vid}: replicated {only} ->" in out
        a, b = _replica_urls(c, vid, "cfg", 2)
        assert c.server(a).rack != c.server(b).rack
        for url in (a, b):
            assert _status(c, f"{url}/{fid}") == (200, b"one copy")

        # volume.copy makes a replica on a server that holds none
        fid = c.upload(b"copy me", collection="cp")
        vid = parse_fid(fid).volume_id
        (src,) = _replica_urls(c, vid, "cp", 1)
        dst = next(vs.url for vs in c.volume_servers if vs.url != src)
        sh.run_command(f"volume.copy -volumeId={vid} -source={src} "
                       f"-target={dst}")
        assert c.server(dst).store.has_volume(vid)
        assert _status(c, f"{dst}/{fid}") == (200, b"copy me")
    finally:
        c.stop()


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_ec_encode_of_a_replicated_volume(tmp_path):
    """ec.encode of a 001 volume: one generate, every replica frozen and
    retired, shards equal to the JAX codec's encode of the .dat."""
    from seaweedfs_tpu.ec import encoder as jax_encoder
    from seaweedfs_tpu_torch.ec.encoder import shard_file_name
    c = _port_cluster(tmp_path, racks=("r1", "r1", "r2"))
    try:
        rng = np.random.default_rng(5)
        datas = [rng.bytes(int(n)) for n in rng.integers(1, 40000, 40)]
        fids = [c.upload(d, replication="001", collection="ec")
                for d in datas]
        vid = parse_fid(fids[0]).volume_id
        _replica_urls(c, vid, "ec", 2)
        snap = tmp_path / "snap"
        snap.mkdir()
        # the replica ec.encode generates from: the master's first
        # location (the replicas differ in their needles' append times)
        source = c.master.lookup_locations(vid, "ec")[0][0]
        v = c.server(source).store.find_volume(vid)
        v.sync()
        for ext in (".dat", ".idx"):
            shutil.copy(v.file_name() + ext, snap / f"ec_{vid}{ext}")
        ref = str(snap / f"ec_{vid}")
        jax_encoder.write_ec_files(ref, backend="jax")
        jax_encoder.write_sorted_file_from_idx(ref)
        out = Shell(c.master.url).run_command(
            f"ec.encode -collection=ec -volumeId={vid}")
        assert out.count(f"volume {vid}: generated 14 shards") == 1
        assert f"volume {vid}: ec.encode done" in out
        wait_for(lambda: c.master.topo.lookup_ec(vid) and
                 not c.master.topo.lookup(vid, "ec"),
                 what="the EC volume in the topology")
        found = {}
        for vs in c.volume_servers:
            assert not vs.store.has_volume(vid)
            base = os.path.join(vs.store.locations[0].directory,
                                f"ec_{vid}")
            assert not os.path.exists(base + ".dat")
            for sid in range(14):
                if os.path.exists(shard_file_name(base, sid)):
                    found.setdefault(sid, []).append(
                        shard_file_name(base, sid))
        assert sorted(found) == list(range(14))
        for sid, paths in found.items():
            assert len(paths) == 1
            assert _sha(paths[0]) == _sha(shard_file_name(ref, sid))
        for fid, data in zip(fids, datas):
            if parse_fid(fid).volume_id == vid:
                with c.fetch(fid) as r:
                    assert r.read() == data
    finally:
        c.stop()


# -- flags ---------------------------------------------------------------------


def test_volume_flags_reach_the_heartbeat_and_the_master(tmp_path):
    from seaweedfs_tpu_torch.command import servers
    opts = servers._volume_parser().parse_args(
        ["-dir", str(tmp_path / "v"), "-ec.encoder", "cpu",
         "-dataCenter", "dc7", "-rack", "rk3", "-publicUrl", "pub:8080",
         "-replicate.parallel", "3", "-resilience.breaker",
         "-resilience.breakerThreshold", "4",
         "-resilience.breakerCooldownS", "1.5"])
    vs = servers._build_volume(opts)
    try:
        assert (vs.data_center, vs.rack, vs.store.public_url,
                vs._replicate_pool.size) == ("dc7", "rk3", "pub:8080", 3)
        assert breaker.enabled and (breaker._threshold,
                                    breaker._cooldown_s) == (4, 1.5)
        from seaweedfs_tpu_torch.server import convert
        hb = convert.heartbeat_to_pb(vs.store.collect_heartbeat(),
                                     vs.data_center, vs.rack)
        assert (hb.data_center, hb.rack, hb.public_url) == \
            ("dc7", "rk3", "pub:8080")
    finally:
        vs.store.close()
        breaker.reset()
        breaker.configure(threshold=5, cooldown_s=5.0)
    (tmp_path / "c").mkdir()
    c = Cluster(tmp_path / "c", n_volume_servers=2, volume_kwargs=[{
        "data_center": "dc7", "rack": "rk3", "public_url": "pub.example:80",
        "replicate_parallel": 2}],
        master_kwargs={"default_replication": "001"})
    try:
        for node in c.master.topo.nodes():
            assert (node.rack.data_center.id, node.rack.id,
                    node.public_url) == ("dc7", "rk3", "pub.example:80")
        # an assign that names no placement gets -defaultReplication's
        a = c.assign()
        assert a["publicUrl"] == "pub.example:80"
        vid = parse_fid(a["fid"]).volume_id
        assert len(_replica_urls(c, vid, "", 2)) == 2
        assert all(str(vs.store.find_volume(vid).replica_placement) == "001"
                   for vs in c.volume_servers)
    finally:
        c.stop()


def test_replicate_parallel_pool_makes_no_thread_before_a_fan_out(tmp_path):
    c = _port_cluster(tmp_path, racks=("r1", "r2"))
    try:
        pools = [vs._replicate_pool for vs in c.volume_servers]
        c.upload(b"one copy")                      # 000: no fan-out
        assert all(p.thread_count() == 0 for p in pools)
        fid = c.upload(b"two", replication="010", collection="p")
        urls = _replica_urls(c, parse_fid(fid).volume_id, "p", 2)
        assert all(_status(c, f"{u}/{fid}") == (200, b"two") for u in urls)
        # one other replica runs inline on the caller: still no thread
        assert all(p.thread_count() == 0 for p in pools)
    finally:
        c.stop()
