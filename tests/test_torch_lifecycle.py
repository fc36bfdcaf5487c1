"""The port's heat-driven lifecycle engine against the JAX package's.

The pure planner first: ``plan_transitions`` and ``reconcile_states`` of
``seaweedfs_tpu_torch.lifecycle`` give the JAX package's decisions and
state records, field for field, on 600 seeded random view/state sets,
and ``LifecycleConfig.validate`` refuses the same configurations with
the same messages. Then the engine on port clusters in process on the
CPU (``ec_encoder="cpu"``, the kernels' plain versions): a dry run that
decides and acts zero times, an idle volume ``ec.encode``d by the
policy loop alone and read back byte-identical, a re-heated EC volume
``ec.decode``d back to a normal volume; a three-master raft set whose
new leader's engine reconciles from its topology and encodes after the
old leader stops; a WARM volume frozen to the ``memory`` tier and
downloaded again on re-heat; and the shard files a port lifecycle
encode leaves, gathered into one directory, serving the same needles
from the JAX ``Store``. The off contract: a master without ``-lifecycle``
holds no engine and starts no lifecycle thread.
"""

import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu.ec import store_ec as jax_store_ec
from seaweedfs_tpu.lifecycle import policy as jax_policy
from seaweedfs_tpu.ops import ReedSolomon as JaxReedSolomon
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.store import Store as JaxStore
from seaweedfs_tpu_torch.lifecycle import policy as port_policy
from seaweedfs_tpu_torch.lifecycle import LifecycleConfig
from seaweedfs_tpu_torch.operation.file_id import parse_fid
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell import Shell
from seaweedfs_tpu_torch.stats.metrics import LifecycleTransitionsCounter
from seaweedfs_tpu_torch.storage import backend as bk
from tests.test_torch_cluster import Cluster, free_port_pair, wait_for

WAIT_S = 30.0
STATES = ("hot", "warm", "cold")


# -- the pure planner, seeded against the JAX package --------------------------


def _random_case(rng):
    cool = float(rng.choice([0.0, 0.5, 1.0, rng.uniform(0, 5)]))
    cfg = dict(
        dry_run=bool(rng.integers(2)),
        interval_s=float(rng.uniform(0.1, 60)),
        cool_threshold=cool,
        warm_threshold=cool + float(rng.choice([0.5, 3.0,
                                                rng.uniform(0.01, 20)])),
        hot_dwell_s=float(rng.choice([0.0, 2.0, rng.uniform(0, 600)])),
        warm_dwell_s=float(rng.choice([0.0, 2.0, rng.uniform(0, 600)])),
        cold_dwell_s=float(rng.choice([0.0, rng.uniform(0, 600)])),
        freeze_s=float(rng.choice([0.0, rng.uniform(0, 900)])),
        cold_backend=str(rng.choice(["", "memory.cold"])),
        max_inflight=int(rng.integers(1, 6)),
        throttle_mbps=0.0)
    now = float(rng.uniform(1_000, 100_000))
    views_raw, states_raw = {}, {}
    for _ in range(int(rng.integers(0, 14))):
        vid = int(rng.integers(1, 40))
        reads = float(rng.choice([0.0, 1.0, 3.0,
                                  rng.integers(0, 30),
                                  rng.uniform(0, 30)]))
        views_raw[vid] = dict(
            vid=vid, tier=str(rng.choice(["hot", "warm"])),
            size=int(rng.choice([0, rng.integers(1, 1 << 30)])),
            file_count=int(rng.choice([0, rng.integers(1, 5000)])),
            reads_window=reads,
            ewma=float(rng.choice([0.0, reads, rng.uniform(0, 10)])),
            modified_age_s=float(rng.choice([1e18, rng.uniform(0, 2000)])),
            collection=str(rng.choice(["", "hot", "cold"])))
    for _ in range(int(rng.integers(0, 14))):
        vid = int(rng.integers(1, 40))
        states_raw[vid] = (str(rng.choice(STATES + ("bogus",))),
                           now - float(rng.uniform(0, 2000)))
    return cfg, now, views_raw, states_raw, int(rng.integers(0, 4))


def _plan(pkg, case):
    cfg_raw, now, views_raw, states_raw, in_flight = case
    cfg = pkg.LifecycleConfig(**cfg_raw).validate()
    views = {vid: pkg.VolumeView(**v) for vid, v in views_raw.items()}
    states = {vid: pkg.VolState(*s) for vid, s in states_raw.items()}
    reconciled = pkg.reconcile_states(views, states, now)
    plan = pkg.plan_transitions(views, reconciled, cfg, now,
                                in_flight=in_flight)
    # plan against the raw records too: a state the engine carried over
    # from an earlier pass (COLD above all) need not match the view
    plan_raw = pkg.plan_transitions(
        views, {vid: st for vid, st in states.items()
                if st.state in STATES}, cfg, now, in_flight=in_flight)
    as_tuples = lambda d: {k: tuple(v) for k, v in d.items()}  # noqa: E731
    return (as_tuples(reconciled), [tuple(t) for t in plan],
            [tuple(t) for t in plan_raw])


def test_planner_equals_jax_on_seeded_cases():
    rng = np.random.default_rng(20261017)
    kinds = set()
    for i in range(600):
        case = _random_case(rng)
        got, want = _plan(port_policy, case), _plan(jax_policy, case)
        assert got == want, f"case {i}: {case}"
        kinds.update(t[1] for t in got[1] + got[2])
    # the seeded cases reach every transition kind
    assert kinds == {"encode", "decode", "offload", "download"}


@pytest.mark.parametrize("bad", [
    dict(cool_threshold=3.0, warm_threshold=3.0),
    dict(cool_threshold=5.0, warm_threshold=1.0),
    dict(interval_s=0.0),
    dict(interval_s=-1.0),
    dict(max_inflight=0),
    dict(),
])
def test_config_validate_errors_equal_jax(bad):
    def outcome(pkg):
        try:
            return ("ok", tuple(pkg.LifecycleConfig(**bad).validate()))
        except ValueError as e:
            return ("error", str(e))
    got, want = outcome(port_policy), outcome(jax_policy)
    assert got == want
    assert (got[0] == "ok") == (not bad)


# -- the engine on a port cluster ------------------------------------------------


def _cfg(**kw):
    base = dict(dry_run=True, interval_s=0.25, cool_threshold=0.5,
                warm_threshold=3.0, hot_dwell_s=1.2, warm_dwell_s=0.4,
                cold_dwell_s=0.4, max_inflight=16)
    base.update(kw)
    return LifecycleConfig(**base)


def _read(url: str, fid: str, timeout: float = 30):
    with urllib.request.urlopen(f"http://{url}/{fid}",
                                timeout=timeout) as r:
        return r.read()


def _fetch_any(master, fid: str):
    """The body of fid read through the master's lookup, or None while
    the vid is mid-transition (a decode unmounts the shards before its
    .dat exists)."""
    vid = parse_fid(fid).volume_id
    urls = [u for u, _ in master.lookup_locations(vid)]
    if not urls:
        urls = sorted(master.topo.lookup_ec(vid))
    for url in urls:
        try:
            return _read(url, fid)
        except (urllib.error.URLError, OSError):
            continue
    return None


@pytest.fixture(scope="module")
def lifecycle_cluster(tmp_path_factory):
    c = Cluster(tmp_path_factory.mktemp("lifecycle"), n_volume_servers=3,
                volume_kwargs=[{"heat_track": True, "heat_window_s": 1.0}],
                master_kwargs={"lifecycle": _cfg()})
    yield c
    c.stop()


def test_engine_dry_runs_encodes_reheats_and_decodes(lifecycle_cluster,
                                                     tmp_path):
    c = lifecycle_cluster
    engine = c.master.lifecycle
    assert engine is not None
    body = b"lifecycle-blob " * 200
    blobs = {}
    for i in range(6):
        data = body + str(i).encode()
        blobs[c.upload(data, collection="lc")] = data
    fid0 = next(iter(blobs))
    vid = parse_fid(fid0).volume_id
    blobs = {f: d for f, d in blobs.items() if parse_fid(f).volume_id == vid}
    for f, d in blobs.items():
        assert _fetch_any(c.master, f) == d

    # dry run: the engine decides to encode and acts zero times
    wait_for(lambda: [d for d in engine.status()["decisions"]
                      if d["vid"] == vid and d["kind"] == "encode"
                      and d["outcome"] == "dry_run"], WAIT_S,
             "a dry-run encode decision")
    assert c.master.topo.lookup(vid, "lc")
    assert engine.transitions_ok == 0
    enc0 = LifecycleTransitionsCounter.labels("encode", "ok").value

    # live: the idle volume is encoded by the policy loop alone
    engine.cfg = engine.cfg._replace(dry_run=False)
    wait_for(lambda: vid in c.master.topo.ec_locations, WAIT_S,
             "a policy-driven ec.encode")
    wait_for(lambda: not c.master.topo.lookup(vid, "lc"), WAIT_S,
             "the original volume retired")
    wait_for(lambda: LifecycleTransitionsCounter.labels(
        "encode", "ok").value > enc0, WAIT_S, "the encode on the ledger")
    for f, d in blobs.items():
        assert _fetch_any(c.master, f) == d
    assert engine.status()["states"]["warm"] >= 1
    out = Shell(c.master.url).run_command("cluster.heat")
    assert f"volume {vid}:" in out and "state:warm" in out

    # the encoded shards, gathered into one directory, serve the same
    # needles from the JAX Store
    gather = tmp_path / "gathered"
    gather.mkdir()
    for vs in c.volume_servers:
        d = vs.store.locations[0].directory
        for name in os.listdir(d):
            if name.startswith(f"lc_{vid}.ec") or \
                    name == f"lc_{vid}.vif":
                shutil.copy(os.path.join(d, name), gather / name)
    js = JaxStore([str(gather)], [10])
    try:
        jax_store_ec.mount_ec_shards(js, vid, "lc", list(range(14)))
        for f, d in blobs.items():
            p = parse_fid(f)
            got = jax_store_ec.read_ec_needle(
                js, vid, JaxNeedle(id=p.key, cookie=p.cookie),
                rs=JaxReedSolomon(backend="numpy"))
            assert got.data == d
    finally:
        js.close()

    # sustained reads re-heat the EC volume: the engine decodes it back
    dec0 = LifecycleTransitionsCounter.labels("decode", "ok").value
    deadline = time.monotonic() + WAIT_S
    while time.monotonic() < deadline and \
            not c.master.topo.lookup(vid, "lc"):
        for f, d in blobs.items():
            got = _fetch_any(c.master, f)
            assert got is None or got == d
        time.sleep(0.05)
    assert c.master.topo.lookup(vid, "lc"), \
        "the re-heated volume was never decoded"
    wait_for(lambda: vid not in c.master.topo.ec_locations, WAIT_S,
             "the EC shards retired after the decode")
    wait_for(lambda: LifecycleTransitionsCounter.labels(
        "decode", "ok").value > dec0, WAIT_S, "the decode on the ledger")
    for f, d in blobs.items():
        assert _fetch_any(c.master, f) == d


def test_engine_control_plane_and_shell(lifecycle_cluster):
    c = lifecycle_cluster
    engine = c.master.lifecycle
    sh = Shell(c.master.url)
    assert "lifecycle:" in sh.run_command("volume.lifecycle -status")
    sh.run_command("volume.lifecycle -pause")
    assert engine.paused
    assert "PAUSED" in sh.run_command("volume.lifecycle")
    sh.run_command("volume.lifecycle -resume")
    assert not engine.paused
    with pytest.raises(Exception, match="not tracked"):
        sh.run_command("volume.lifecycle -force -volumeId=999 -target=warm")


def test_engine_survives_a_leader_failover(tmp_path):
    """The new leader's engine rebuilds its states from its own topology
    (what was EC reads as WARM, nothing encodes twice) and encodes the
    volume that goes idle after the old leader stopped."""
    ports = [free_port_pair() for _ in range(3)]
    urls = [f"127.0.0.1:{p}" for p in ports]
    masters = []
    servers = []
    try:
        for i, p in enumerate(ports):
            m = MasterServer(port=p, meta_dir=str(tmp_path / f"m{i}"),
                             peers=urls, pulse_seconds=0.2,
                             raft_election_timeout=0.25,
                             volume_size_limit_mb=64,
                             lifecycle=_cfg(dry_run=False))
            m.start()
            masters.append(m)
        leader = wait_for(lambda: next((m for m in masters
                                        if m.raft.is_leader), None),
                          WAIT_S, "a leader")
        for i in range(3):
            d = tmp_path / f"v{i}"
            d.mkdir()
            vs = VolumeServer(",".join(urls), [str(d)],
                              port=free_port_pair(),
                              max_volume_counts=[20], pulse_seconds=0.2,
                              ec_encoder="cpu", heat_track=True,
                              heat_window_s=1.0)
            vs.start()
            servers.append(vs)
        wait_for(lambda: len(leader.topo.nodes()) == 3, WAIT_S,
                 "volume servers registered")
        leader.lifecycle.pause()
        helper = Cluster.__new__(Cluster)
        helper.master = leader
        first = helper.upload(b"first " * 500, collection="fo")
        v1 = parse_fid(first).volume_id
        leader.lifecycle.resume()
        wait_for(lambda: v1 in leader.topo.ec_locations, WAIT_S,
                 "the first volume encoded by the first leader")
        wait_for(lambda: not leader.topo.lookup(v1, "fo"), WAIT_S,
                 "the first volume's original retired")
        # a second volume, kept hot by reads until the failover
        survivors = [m for m in masters if m is not leader]
        stop_reads = threading.Event()
        second = helper.upload(b"second " * 500, collection="fo2")
        v2 = parse_fid(second).volume_id

        def keep_hot():
            while not stop_reads.is_set():
                _fetch_any(leader if leader.raft.is_leader else
                           next((m for m in survivors
                                 if m.raft.is_leader), leader), second)
                time.sleep(0.02)
        reader = threading.Thread(target=keep_hot, daemon=True)
        reader.start()
        time.sleep(0.5)
        leader.stop()
        new = wait_for(lambda: next((m for m in survivors
                                     if m.raft.is_leader), None),
                       WAIT_S, "a new leader")
        wait_for(lambda: v1 in new.topo.ec_locations and
                 new.lifecycle.states.get(v1) is not None, WAIT_S,
                 "the new leader's engine reconciled")
        assert new.lifecycle.states[v1].state == "warm"
        assert new.lifecycle.transitions_ok == 0
        stop_reads.set()
        reader.join(timeout=5)
        wait_for(lambda: v2 in new.topo.ec_locations, WAIT_S,
                 "the new leader encodes the now idle volume")
        assert _fetch_any(new, first) == b"first " * 500
        wait_for(lambda: _fetch_any(new, second) == b"second " * 500,
                 WAIT_S, "the second volume readable after its encode")
        def encoded():
            return [d["vid"] for d in new.lifecycle.status()["decisions"]
                    if d["kind"] == "encode" and d["outcome"] == "ok"]
        wait_for(lambda: v2 in encoded(), WAIT_S, "the encode recorded")
        assert v1 not in encoded() and encoded().count(v2) == 1
    finally:
        for vs in servers:
            vs.stop()
        for m in masters:
            m.stop()


def test_engine_freezes_to_the_memory_tier_and_downloads(tmp_path):
    bk.register_backend(bk.MemoryBackendStorage("memory.cold"))
    cfg = _cfg(dry_run=False, freeze_s=0.5, cold_backend="memory.cold",
               warm_threshold=2.0)
    c = Cluster(tmp_path, n_volume_servers=2,
                volume_kwargs=[{"heat_track": True, "heat_window_s": 1.0}],
                master_kwargs={"lifecycle": cfg})
    try:
        engine = c.master.lifecycle
        data = b"frozen " * 300
        fid = c.upload(data, collection="fz")
        vid = parse_fid(fid).volume_id
        wait_for(lambda: (engine.states.get(vid) or (None,))[0] == "cold",
                 WAIT_S, "the WARM volume frozen to the memory tier")
        tiered = [name for vs in c.volume_servers
                  for name in os.listdir(vs.store.locations[0].directory)
                  if name == f"fz_{vid}.ectier"]
        assert tiered, "no .ectier sidecar after the freeze"
        assert _fetch_any(c.master, fid) == data
        # sustained reads: COLD -> WARM (download), then WARM -> HOT
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline and \
                not c.master.topo.lookup(vid, "fz"):
            got = _fetch_any(c.master, fid)
            assert got is None or got == data
            time.sleep(0.05)
        kinds = [d["kind"] for d in engine.status()["decisions"]
                 if d["vid"] == vid and d["outcome"] == "ok"]
        assert kinds[:3] == ["encode", "offload", "download"], kinds
        assert c.master.topo.lookup(vid, "fz")
        assert _fetch_any(c.master, fid) == data
    finally:
        c.stop()


def test_no_engine_and_no_thread_without_the_flag(tmp_path):
    before = {t.name for t in threading.enumerate()}
    m = MasterServer(port=free_port_pair(), meta_dir=str(tmp_path / "m"),
                     pulse_seconds=0.2)
    m.start()
    try:
        assert m.lifecycle is None
        names = {t.name for t in threading.enumerate()} - before
        assert "master-lifecycle" not in names
        body = urllib.request.urlopen(
            f"http://{m.url}/cluster/lifecycle", timeout=10).read()
        assert b"start the master with -lifecycle" in body
    finally:
        m.stop()
