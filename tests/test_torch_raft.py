"""The port's raft master set against the JAX package's.

The port's counterparts of the twelve tests of ``tests/test_raft.py``
(election, failover, the follower's HTTP proxy, assigns through a leader
kill, compaction and snapshot catch-up, and the WAL's durability rules:
no double vote, replay, torn and newline-less tails, compaction across a
restart, the legacy ``raft.json`` upgrade and its crash rerun), each on
the port's ``MasterServer`` and ``RaftNode``. Held against the JAX
package: meta directories written by one package's raft replay in the
other to the same applied master state, both directions; one command
sequence applies to the same state; snowflake ids equal for one node id
and clock; the etcd sequencer against ``FakeEtcdServer``. Also: a volume
server given a follower first follows ``HeartbeatResponse.leader``, the
cron and the scrub scheduler act only on the leader, no file id or
volume id is issued twice across a failover, and ``-peers`` with an even
count is warned about. Timeouts are the JAX tests' (election 0.25 s,
pulse 0.2 s); every wait is for a condition.
"""

import json
import logging
import shutil
import urllib.request

import pytest

from seaweedfs_tpu_torch.pb import raft_pb2
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.raft import NotLeader, RaftNode
from seaweedfs_tpu_torch.server.volume import VolumeServer
from tests.test_torch_cluster import free_port_pair, wait_for

WAIT_S = 20.0


def _start_masters(tmp_path, n=3, cls=MasterServer, **kwargs):
    ports = [free_port_pair() for _ in range(n)]
    urls = [f"127.0.0.1:{p}" for p in ports]
    masters = []
    for i, p in enumerate(ports):
        m = cls(port=p, meta_dir=str(tmp_path / f"m{i}"), peers=urls,
                pulse_seconds=0.2, raft_election_timeout=0.25, **kwargs)
        m.start()
        masters.append(m)
    return masters, urls


def _leader_of(masters):
    leaders = [m for m in masters if m.raft.is_leader]
    return leaders[0] if len(leaders) == 1 else None


def _get_json(url: str) -> dict:
    with urllib.request.urlopen(f"http://{url}", timeout=10) as r:
        return json.load(r)


def _volume_server(tmp_path, urls, name="vol"):
    d = tmp_path / name
    d.mkdir()
    vs = VolumeServer(master_url=",".join(urls), directories=[str(d)],
                      port=free_port_pair(), max_volume_counts=[10],
                      pulse_seconds=0.2, ec_encoder="cpu")
    vs.start()
    return vs


# -- the twelve tests of tests/test_raft.py ------------------------------------


def test_election_and_replicated_state(tmp_path):
    masters, urls = _start_masters(tmp_path)
    try:
        leader = wait_for(lambda: _leader_of(masters), WAIT_S, "a leader")
        followers = [m for m in masters if m is not leader]
        wait_for(lambda: all(m.raft.leader() == leader.url
                             for m in masters), WAIT_S, "leader agreement")
        with pytest.raises(NotLeader):
            followers[0].assign()
        leader.raft.propose({"op": "max_volume_id", "value": 41})
        wait_for(lambda: all(m.topo.next_volume_id >= 42 for m in masters),
                 WAIT_S, "max volume id replication")
    finally:
        for m in masters:
            m.stop()


def test_leader_failover_new_leader_emerges(tmp_path):
    masters, urls = _start_masters(tmp_path)
    try:
        leader = wait_for(lambda: _leader_of(masters), WAIT_S, "a leader")
        leader.raft.propose({"op": "max_volume_id", "value": 7})
        survivors = [m for m in masters if m is not leader]
        leader.stop()
        new_leader = wait_for(lambda: _leader_of(survivors), WAIT_S,
                              "failover leader")
        assert new_leader is not leader
        # the committed entry applies on the new leader once an entry of
        # its own term has replicated
        wait_for(lambda: new_leader.topo.next_volume_id >= 8, WAIT_S,
                 "replicated state applied on the new leader")
        new_leader.raft.propose({"op": "max_volume_id", "value": 99})
        wait_for(lambda: all(m.topo.next_volume_id >= 100
                             for m in survivors), WAIT_S,
                 "post-failover replication")
    finally:
        for m in masters:
            m.stop()


def test_follower_http_proxies_to_leader(tmp_path):
    masters, urls = _start_masters(tmp_path)
    vs = None
    try:
        leader = wait_for(lambda: _leader_of(masters), WAIT_S, "a leader")
        vs = _volume_server(tmp_path, urls)
        wait_for(lambda: len(leader.topo.nodes()) == 1, WAIT_S,
                 "volume server registration")
        follower = next(m for m in masters if m is not leader)
        resp = _get_json(f"{follower.url}/dir/assign")
        assert "fid" in resp, resp
        # /cluster/status is answered locally and names the leader
        st = _get_json(f"{follower.url}/cluster/status")
        assert st["IsLeader"] is False and st["Leader"] == leader.url
        assert sorted(st["Peers"]) == sorted(u for u in urls
                                             if u != follower.url)
        assert _get_json(f"{leader.url}/cluster/status")["IsLeader"] is True
    finally:
        if vs is not None:
            vs.stop()
        for m in masters:
            m.stop()


def test_kill_leader_assigns_keep_working(tmp_path):
    """Three masters, the leader killed: assigns go on after the
    failover (the volume server re-heartbeats to the new leader on its
    own), and no file id or volume id is issued twice."""
    masters, urls = _start_masters(tmp_path)
    vs = None
    try:
        leader = wait_for(lambda: _leader_of(masters), WAIT_S, "a leader")
        vs = _volume_server(tmp_path, urls)
        wait_for(lambda: len(leader.topo.nodes()) == 1, WAIT_S,
                 "volume server registration")
        first = [_get_json(f"{leader.url}/dir/assign") for _ in range(5)]
        assert all("fid" in a for a in first), first
        first_vid = max(int(a["fid"].split(",")[0]) for a in first)

        leader.stop()
        survivors = [m for m in masters if m is not leader]
        new_leader = wait_for(lambda: _leader_of(survivors), WAIT_S,
                              "failover leader")
        wait_for(lambda: len(new_leader.topo.nodes()) == 1, WAIT_S,
                 "re-heartbeat to the new leader")
        second = [_get_json(f"{new_leader.url}/dir/assign")
                  for _ in range(5)]
        assert all("fid" in a for a in second), second
        # the pre-failover max volume id was committed at grow time, the
        # file-id watermark at the first assign
        assert new_leader.topo.next_volume_id > first_vid
        fids = [a["fid"] for a in first + second]
        assert len(set(fids)) == len(fids)
        keys = [int(f.split(",")[1][:-8], 16) for f in fids]
        assert min(keys[5:]) > max(keys[:5])
    finally:
        if vs is not None:
            vs.stop()
        for m in masters:
            m.stop()


def test_log_compaction_and_snapshot_catchup(tmp_path):
    """The log compacts into a snapshot past LOG_CAP, and a wiped,
    restarted follower catches up from the piggybacked snapshot."""
    masters, urls = _start_masters(tmp_path)
    try:
        leader = wait_for(lambda: _leader_of(masters), WAIT_S, "a leader")
        for m in masters:
            m.raft.LOG_CAP = 8
        for i in range(1, 30):
            leader.raft.propose({"op": "max_volume_id", "value": i})
        assert len(leader.raft.log) <= 9
        assert leader.raft.snapshot_state.get("max_volume_id", 0) > 0
        wait_for(lambda: all(m.topo.next_volume_id >= 30 for m in masters),
                 WAIT_S, "replication through compaction")
        follower = next(m for m in masters if m is not leader)
        fidx = masters.index(follower)
        follower.stop()
        shutil.rmtree(tmp_path / f"m{fidx}")
        m2 = MasterServer(port=int(follower.url.split(":")[1]),
                          meta_dir=str(tmp_path / f"m{fidx}"),
                          peers=urls, pulse_seconds=0.2,
                          raft_election_timeout=0.25)
        m2.raft.LOG_CAP = 8
        m2.start()
        masters[fidx] = m2
        wait_for(lambda: m2.topo.next_volume_id >= 30, WAIT_S,
                 "snapshot catch-up on the wiped follower")
    finally:
        for m in masters:
            m.stop()


def _mk_node(tmp_path, peers=(), applied=None, node_cls=RaftNode, **kw):
    applied = applied if applied is not None else []
    state = {"sum": 0}

    def apply(cmd, term):
        applied.append(cmd)
        state["sum"] += cmd.get("v", 0)

    return node_cls(
        "127.0.0.1:1", list(peers), str(tmp_path / "meta"), apply,
        snapshot_fn=lambda: dict(state),
        restore_fn=lambda s: state.update(s or {"sum": 0}), **kw), state


def test_no_double_vote_after_crash_restart(tmp_path):
    peers = ["127.0.0.1:2", "127.0.0.1:3"]
    node, _ = _mk_node(tmp_path, peers)
    resp = node.RequestVote(raft_pb2.VoteRequest(
        term=5, candidate_id="127.0.0.1:2",
        last_log_index=0, last_log_term=0), None)
    assert resp.vote_granted
    node.stop()  # crash

    node2, _ = _mk_node(tmp_path, peers)
    assert node2.current_term == 5
    assert node2.voted_for == "127.0.0.1:2"
    resp = node2.RequestVote(raft_pb2.VoteRequest(
        term=5, candidate_id="127.0.0.1:3",
        last_log_index=0, last_log_term=0), None)
    assert not resp.vote_granted
    resp = node2.RequestVote(raft_pb2.VoteRequest(
        term=5, candidate_id="127.0.0.1:2",
        last_log_index=0, last_log_term=0), None)
    assert resp.vote_granted
    node2.stop()


def test_wal_replay_restores_state_machine(tmp_path):
    node, state = _mk_node(tmp_path)
    for i in range(1, 6):
        node.propose({"op": "add", "v": i})
    assert state["sum"] == 15
    node.stop()
    applied2 = []
    node2, state2 = _mk_node(tmp_path, applied=applied2)
    assert state2["sum"] == 15
    assert len(applied2) == 5
    assert node2.commit_index == 5
    node2.stop()


def test_wal_torn_tail_is_cut(tmp_path):
    node, _ = _mk_node(tmp_path)
    node.propose({"op": "add", "v": 7})
    node.propose({"op": "add", "v": 8})
    node.stop()
    with open(tmp_path / "meta" / "raft.wal.0", "ab") as f:
        f.write(b'{"op": "append", "entry": {"index":')  # torn record
    node2, state2 = _mk_node(tmp_path)
    assert state2["sum"] == 15
    node2.propose({"op": "add", "v": 1})
    node2.stop()
    node3, state3 = _mk_node(tmp_path)
    assert state3["sum"] == 16
    node3.stop()


def test_compaction_snapshot_survives_restart(tmp_path):
    node, state = _mk_node(tmp_path)
    node.LOG_CAP = 8
    for _ in range(30):
        node.propose({"op": "add", "v": 1})
    assert len(node.log) <= 9
    node.stop()
    applied2 = []
    node2, state2 = _mk_node(tmp_path, applied=applied2)
    assert state2["sum"] == 30
    assert len(applied2) < 30   # only the tail past the snapshot replays
    node2.stop()


def _legacy(meta, term, voted_for, log, commit):
    meta.mkdir()
    (meta / "raft.json").write_text(json.dumps({
        "term": term, "voted_for": voted_for, "log": log,
        "snapshot": {}, "commit_index": commit}))


def test_legacy_raft_json_upgrade(tmp_path):
    meta = tmp_path / "meta"
    _legacy(meta, 3, "127.0.0.1:2",
            [{"index": 0, "term": 0, "command": None},
             {"index": 1, "term": 2, "command": {"op": "add", "v": 9}},
             {"index": 2, "term": 3, "command": {"op": "add", "v": 4}}], 2)
    node, state = _mk_node(tmp_path)
    assert node.current_term == 3
    assert state["sum"] == 13
    assert not (meta / "raft.json").exists()
    assert (meta / "raft.meta.json").exists()
    assert any(p.name.startswith("raft.wal.") for p in meta.iterdir())
    node.stop()


def test_wal_newline_less_tail_is_cut(tmp_path):
    node, _ = _mk_node(tmp_path)
    node.propose({"op": "add", "v": 5})
    node.stop()
    with open(tmp_path / "meta" / "raft.wal.0", "ab") as f:
        f.write(b'{"op": "append", "entry": {"index": 2, "term": 0, '
                b'"command": {"op": "add", "v": 99}}}')  # no newline
    node2, state2 = _mk_node(tmp_path)
    assert state2["sum"] == 5
    node2.propose({"op": "add", "v": 2})
    node2.stop()
    node3, state3 = _mk_node(tmp_path)
    assert state3["sum"] == 7
    node3.stop()


def test_legacy_migration_crash_rerun(tmp_path):
    """A crash between the migrated meta write and the snapshot write
    leaves raft.json, so the migration runs again and keeps its state."""
    meta = tmp_path / "meta"
    _legacy(meta, 4, None,
            [{"index": 0, "term": 0, "command": None},
             {"index": 1, "term": 4, "command": {"op": "add", "v": 6}}], 1)
    (meta / "raft.meta.json").write_text('{"term": 4, "voted_for": null}')
    node, state = _mk_node(tmp_path)
    assert state["sum"] == 6
    assert node.current_term == 4
    assert not (meta / "raft.json").exists()
    node.stop()


# -- against the JAX package ---------------------------------------------------


def _fill_meta(master_cls, meta_dir):
    """A single master's raft log and sequence file: grown volume ids,
    watermarks, and a compaction in the middle."""
    m = master_cls(port=0, meta_dir=str(meta_dir))
    m.raft.LOG_CAP = 4
    for i in range(1, 8):
        m.raft.propose({"op": "max_volume_id", "value": 3 * i})
        m.raft.propose({"op": "sequence", "value": 1000 * i})
    m.topo.sequence.set_max(4321)
    m.raft.stop()
    m._save_sequence()
    return m


def _master_state(m) -> tuple:
    return (dict(m._applied_state), m.topo.next_volume_id,
            m.topo.sequence.peek, m.raft.commit_index, m.raft.current_term)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_meta_dirs_move_between_packages(tmp_path, writer):
    """A meta directory written by one package's master replays in the
    other's to the same applied state, and the files are the same."""
    from seaweedfs_tpu.server.master import MasterServer as JaxMaster
    w_cls, r_cls = (JaxMaster, MasterServer) if writer == "jax" \
        else (MasterServer, JaxMaster)
    src = _fill_meta(w_cls, tmp_path / "meta")
    names = sorted(p.name for p in (tmp_path / "meta").iterdir())
    assert "raft.snap.json" in names and "sequence.json" in names
    shutil.copytree(tmp_path / "meta", tmp_path / "copy")
    got = []
    for cls in (w_cls, r_cls):
        m = cls(port=0, meta_dir=str(tmp_path / "copy"))
        try:
            got.append(_master_state(m))
        finally:
            m.raft.stop()
    assert got[0] == got[1]
    assert got[1][:2] == (src._applied_state, src.topo.next_volume_id)
    assert sorted(p.name for p in (tmp_path / "copy").iterdir()) == names


def test_raft_apply_gives_the_jax_state(tmp_path):
    from seaweedfs_tpu.server.master import MasterServer as JaxMaster
    cmds = [({"op": "max_volume_id", "value": 5}, 1),
            ({"op": "sequence", "value": 10000}, 1),
            ({"op": "max_volume_id", "value": 3}, 2),
            ({"op": "sequence", "value": 7000}, 2),
            ({"op": "sequence", "value": 20500}, 3),
            ({"op": "noop"}, 3),
            ({"op": "max_volume_id", "value": 12}, 3)]
    got = []
    for cls in (JaxMaster, MasterServer):
        m = cls(port=0, meta_dir=None)
        for cmd, term in cmds:
            m._raft_apply(cmd, term)
        got.append((dict(m._applied_state), m.topo.next_volume_id,
                    m.topo.sequence.peek))
        m._raft_restore({"max_volume_id": 40, "sequence": 30000})
        got.append((dict(m._applied_state), m.topo.next_volume_id,
                    m.topo.sequence.peek))
    assert got[:2] == got[2:]
    assert got[0] == ({"max_volume_id": 12, "sequence": 20500}, 13, 20501)


def test_snowflake_ids_equal_jax(monkeypatch):
    import time
    from seaweedfs_tpu.topology.sequence import \
        SnowflakeSequencer as JaxSnowflake
    from seaweedfs_tpu_torch.topology.sequence import SnowflakeSequencer
    ticks = iter([1_700_000_000.000, 1_700_000_000.000, 1_700_000_000.001,
                  1_700_000_000.001, 1_700_000_005.5, 1_700_000_005.5] * 2)
    clock = {"t": 0.0}

    def fake_time():
        return clock["t"]

    monkeypatch.setattr(time, "time", fake_time)
    seqs = [JaxSnowflake(node_id=717), SnowflakeSequencer(node_id=717)]
    out = [[], []]
    for count in (1, 5, 4096, 3, 1, 100):
        clock["t"] = next(ticks)
        for i, s in enumerate(seqs):
            out[i].append((s.next_batch(count), s.peek))
    assert out[0] == out[1]
    with pytest.raises(ValueError):
        seqs[1].next_batch(4097)
    ids = [first for first, _ in out[1]]
    assert len(set(ids)) == len(ids) and all(
        (first >> 12) & 0x3FF == 717 for first in ids)


def test_etcd_sequencer_against_fake_etcd(tmp_path):
    from tests.fake_backends import FakeEtcdServer
    from seaweedfs_tpu_torch.topology.sequence import EtcdSequencer
    etcd = FakeEtcdServer()
    try:
        endpoint = f"127.0.0.1:{etcd.port}"
        a, b = EtcdSequencer(endpoint), EtcdSequencer(endpoint)
        seen = set()
        for seq in (a, b, a, b, a):
            first = seq.next_batch(10)
            ids = set(range(first, first + 10))
            assert not ids & seen
            seen |= ids
        first = a.next_batch(350)   # across several claimed steps
        assert not set(range(first, first + 350)) & seen
        b.set_max(10_000)
        assert EtcdSequencer(endpoint).next_batch(1) > 10_000
        m = MasterServer(port=0, meta_dir=str(tmp_path),
                         sequencer_type="etcd",
                         sequencer_etcd_urls=endpoint)
        first = m.topo.sequence.next_batch(5)
        assert m.topo.sequence.next_batch(1) == first + 5
        m.raft.stop()
    finally:
        etcd.stop()


def test_unknown_sequencer_is_refused():
    with pytest.raises(ValueError, match="unknown sequencer"):
        MasterServer(port=0, sequencer_type="zookeeper")


# -- the volume server and the master's loops ----------------------------------


def test_volume_server_follows_heartbeat_leader(tmp_path):
    """Given a follower first, the volume server dials the leader that
    the follower names and registers there only."""
    masters, urls = _start_masters(tmp_path)
    vs = None
    try:
        leader = wait_for(lambda: _leader_of(masters), WAIT_S, "a leader")
        wait_for(lambda: all(m.raft.leader() == leader.url
                             for m in masters), WAIT_S, "leader agreement")
        follower = next(m for m in masters if m is not leader)
        order = [follower.url] + [u for u in urls if u != follower.url]
        vs = _volume_server(tmp_path, order)
        wait_for(lambda: vs.current_master == leader.url, WAIT_S,
                 "the heartbeat on the leader")
        wait_for(lambda: len(leader.topo.nodes()) == 1, WAIT_S,
                 "registration at the leader")
        assert all(not m.topo.nodes() for m in masters if m is not leader)
    finally:
        if vs is not None:
            vs.stop()
        for m in masters:
            m.stop()


def test_cron_and_scrub_scheduler_run_only_on_the_leader(tmp_path):
    ran, scrubbed = [], []

    class Probe(MasterServer):
        def _run_maintenance_pass(self):
            ran.append(self.url)

        def _start_scrub_on(self, url):
            scrubbed.append(self.url)
            return True

    masters, urls = _start_masters(
        tmp_path, cls=Probe, maintenance_scripts=["lock", "unlock"],
        maintenance_interval_s=0.3, scrub_interval_s=0.3)
    try:
        leader = wait_for(lambda: _leader_of(masters), WAIT_S, "a leader")
        # the same node in every master's topology, so a follower's
        # scheduler would have a server to start a scrub on
        for m in masters:
            m.topo.sync_heartbeat({"ip": "127.0.0.1", "port": 1,
                                   "max_volume_count": 1})
        wait_for(lambda: len(ran) >= 2 and len(scrubbed) >= 2 and
                 all(m.maintenance_passes for m in masters), WAIT_S,
                 "cron passes and scrub windows")
        assert set(ran) == set(scrubbed) == {leader.url}
    finally:
        for m in masters:
            m.stop()


def test_even_peer_count_is_warned_about(caplog):
    from seaweedfs_tpu_torch.command import servers
    opts = servers._master_parser().parse_args(
        ["-port", "0", "-peers", "127.0.0.1:1,127.0.0.1:2",
         "-defaultReplication", "010"])
    with caplog.at_level(logging.WARNING):
        m = servers._build_master(opts)
    try:
        assert "even" in caplog.text
        assert m.raft.peers == ["127.0.0.1:1", "127.0.0.1:2"]
        assert m.default_replication == "010"
    finally:
        m.raft.stop()
