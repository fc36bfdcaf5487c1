"""Master server: the cluster's control plane.

Owns the Topology, assigns file ids, grows volumes under any xyz replica
placement (``topology/volume_growth.py``), drives vacuum and feeds
clients a live vid -> location view over the KeepConnected stream. The
port of ``seaweedfs_tpu.server.master``.

With ``peers`` (``-peers``) an odd set of masters elects one leader by
raft (``server/raft.py``). Only the leader assigns, grows, vacuums,
leases the admin lock, takes heartbeats and runs the loops below; a
follower answers an RPC with NotLeader and proxies HTTP to the leader
(``/cluster/status`` is answered locally). The raft log carries the max
volume id, raised before a grown id is used, and a file-id watermark
``SEQ_WATERMARK_GAP`` ahead of every id handed out, so a new leader never
issues an id twice. Without peers the node leads alone and the same log
keeps the max volume id across a restart; ``sequence.json`` keeps the
memory sequencer's next id at stop. These files are the JAX package's.

Two optional loops do the cluster's upkeep with no operator: the
maintenance cron runs master.toml's ``master.maintenance.scripts``
through the shell every ``sleep_minutes`` (reference
master_server.go:187-263), and the scrub scheduler opens one scrub pass
on every volume server per ``-scrub.intervalSeconds``, staggered over
the window. Neither thread exists unless its scripts or interval are
set, and both act only on the leader. A third, the heat-driven lifecycle
engine (``lifecycle/``, ``-lifecycle``), exists only when configured and
acts only while this master leads: it joins the topology with the heat
map the volume servers' heartbeats carry (``Topology.cluster_heat``)
and ``ec.encode``s idle volumes in fused groups, ``ec.decode``s re-heated
ones and moves frozen ones to a tier backend, through the shell.

``/cluster/heat``, ``/cluster/qos`` and ``/cluster/lifecycle`` go to the
leader like every other path; ``/status`` (this master's Lifecycle and
Heat blocks), ``/qos/status``, ``/debug/trace`` and ``/debug/requests``
answer for this process and are never proxied. ``/`` and ``/ui`` are a
plain page of the topology. With ``serve=ServeConfig(async_mode=True)``
(``-serve.async``) the HTTP plane runs on the selector loop of
``util/async_server.py``.

Reference: weed/server/master_server.go, master_grpc_server.go
(SendHeartbeat :20-176, KeepConnected :178-233),
master_server_handlers*.go, raft_server.go, topology/topology_vacuum.go.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import zlib
from typing import Dict, List, Optional, Set
from urllib.parse import parse_qs

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import (master_pb2, raft_pb2, volume_server_pb2,
                                    volume_stub)
from seaweedfs_tpu_torch.server import convert
from seaweedfs_tpu_torch.server.raft import NotLeader, RaftNode
from seaweedfs_tpu_torch.storage.superblock import ReplicaPlacement
from seaweedfs_tpu_torch.topology.node import VolumeInfo
from seaweedfs_tpu_torch.topology.sequence import (EtcdSequencer,
                                                   MemorySequencer,
                                                   SnowflakeSequencer)
from seaweedfs_tpu_torch.topology.topology import Topology
from seaweedfs_tpu_torch.topology.volume_growth import (NoFreeSlots,
                                                       VolumeGrowth,
                                                       growth_count)
from seaweedfs_tpu_torch.util import http_client, wlog
from seaweedfs_tpu_torch.util.http_server import (FastHandler, ServeConfig,
                                                  make_http_server)

log = wlog.logger("master")

SEQUENCE_FILE = "sequence.json"
# what an assign or grow answers with an error message instead of a fid
ASSIGN_ERRORS = (NoFreeSlots, RuntimeError, NotLeader, TimeoutError,
                 ValueError)


class AdminLock:
    """Cluster-wide exclusive admin lease (reference
    wdclient/exclusive_locks + master_grpc_server_admin.go)."""

    RENEW_WINDOW_NS = 10 * 1_000_000_000

    def __init__(self):
        self._lock = threading.Lock()
        self._token = 0  # guarded_by(self._lock)
        self._ts_ns = 0  # guarded_by(self._lock)

    def lease(self, previous_token: int) -> tuple:
        now = time.monotonic_ns()
        with self._lock:
            held = self._token and now - self._ts_ns < self.RENEW_WINDOW_NS
            if held and previous_token != self._token:
                raise PermissionError("admin lock held by another client")
            self._token = now
            self._ts_ns = now
            return self._token, self._ts_ns

    def release(self, previous_token: int) -> None:
        with self._lock:
            if previous_token == self._token:
                self._token = 0
                self._ts_ns = 0


def plan_scrub_stagger(urls: List[str],
                       interval_s: float) -> List[tuple]:
    """Spread one scrub window over the servers: [(url, wait_before_s)].

    Server i starts interval_s / n after server i - 1, so every server
    is covered once per interval and at most one starts its scan at any
    moment."""
    if not urls:
        return []
    gap = interval_s / len(urls)
    return [(url, 0.0 if i == 0 else gap) for i, url in enumerate(urls)]


class MasterServer:
    SEQ_WATERMARK_GAP = 10000  # ids raft-committed ahead of allocation

    def __init__(self, ip: str = "127.0.0.1", port: int = 9333,
                 meta_dir: Optional[str] = None,
                 volume_size_limit_mb: int = 30 * 1024,
                 default_replication: str = "000",
                 pulse_seconds: float = 5.0,
                 garbage_threshold: float = 0.3,
                 peers: Optional[List[str]] = None,
                 raft_election_timeout: float = 0.5,
                 maintenance_scripts: Optional[List[str]] = None,
                 maintenance_interval_s: float = 17 * 60,
                 scrub_interval_s: float = 0.0,
                 scrub_throttle_mbps: float = 0.0,
                 sequencer_type: str = "memory",
                 sequencer_node_id: Optional[int] = None,
                 sequencer_etcd_urls: str = "127.0.0.1:2379",
                 lifecycle=None,
                 serve: Optional[ServeConfig] = None):
        self.ip = ip
        self.port = port
        self.meta_dir = meta_dir
        # an assign or grow that names no placement gets this one
        self.default_replication = str(
            ReplicaPlacement.parse(default_replication or "000"))
        self.garbage_threshold = garbage_threshold
        if sequencer_type == "snowflake":
            # coordination-free ids; the node id must differ per master:
            # configured, or derived from ip:port (masters often share a
            # port across hosts)
            node_id = sequencer_node_id if sequencer_node_id is not None \
                else zlib.crc32(f"{ip}:{port}".encode()) & 0x3FF
            seq = SnowflakeSequencer(node_id=node_id)
        elif sequencer_type == "etcd":
            seq = EtcdSequencer(
                endpoint=sequencer_etcd_urls.split(",")[0].strip())
        elif sequencer_type in ("memory", ""):
            seq = MemorySequencer(start=self._load_sequence())
        else:
            raise ValueError(f"unknown sequencer type {sequencer_type!r} "
                             "(memory | snowflake | etcd)")
        self.topo = Topology(
            volume_size_limit=volume_size_limit_mb << 20,
            sequencer=seq, pulse_seconds=pulse_seconds)
        self.growth = VolumeGrowth(self.topo)
        self.admin_lock = AdminLock()
        # RaftNode.__init__ replays the committed log through _raft_apply
        # before self.raft exists: the callbacks use _applied_state, never
        # self.raft
        self._applied_state = {"max_volume_id": 0, "sequence": 0}
        self._seq_watermark = 0  # guarded_by(self._seq_lock)
        self._seq_lock = threading.Lock()
        self.raft = RaftNode(
            f"{ip}:{port}", peers or [], meta_dir,
            apply=self._raft_apply,
            snapshot_fn=lambda: dict(self._applied_state),
            restore_fn=self._raft_restore,
            election_timeout=raft_election_timeout)
        self._grow_lock = threading.Lock()
        # layouts being grown -> the event their waiters block on
        self._growing: Dict[tuple, threading.Event] = {}  # guarded_by(self._grow_lock)
        # -serve.*: the async selector core; a default master never
        # imports util/async_server
        self.serve = serve or ServeConfig()
        self._grpc_server = None
        self._http_server = None
        self._http_thread = None
        # heartbeat stream identity per node url (reconnect-safe cleanup)
        self._node_streams: Dict[str, object] = {}
        # KeepConnected subscribers: key -> queue of VolumeLocation
        self._subscribers: Dict[int, queue.Queue] = {}  # guarded_by(self._sub_lock)
        self._sub_seq = 0  # guarded_by(self._sub_lock)
        self._sub_lock = threading.Lock()
        self._stopping = False
        # the maintenance cron (master.toml master.maintenance.scripts,
        # every sleep_minutes): no thread unless scripts are set
        self.maintenance_scripts = list(maintenance_scripts or [])
        self.maintenance_interval_s = maintenance_interval_s
        self._maint_thread: Optional[threading.Thread] = None
        self._maint_wake = threading.Event()
        # passes finished, and scripts that failed; read by tests and ops
        self.maintenance_passes = 0
        self.maintenance_failures = 0
        # the scrub scheduler (0 = no thread)
        self.scrub_interval_s = scrub_interval_s
        self.scrub_throttle_mbps = scrub_throttle_mbps
        self._scrub_thread: Optional[threading.Thread] = None
        self._scrub_wake = threading.Event()
        # the heat-driven lifecycle engine (-lifecycle, a LifecycleConfig):
        # absent, not merely idle, unless configured, so a default master
        # makes no engine object and no thread
        self.lifecycle = None
        if lifecycle is not None:
            from seaweedfs_tpu_torch.lifecycle import LifecycleEngine
            self.lifecycle = LifecycleEngine(self, lifecycle)

    # -- lifecycle -----------------------------------------------------------

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> None:
        if self.port == 0:
            raise ValueError("master port must be fixed (rpc = port+10000)")
        handler = rpc.generic_handler(master_pb2, "Seaweed", self,
                                      stats_role="master")
        raft_handler = rpc.generic_handler(raft_pb2, "Raft", self.raft,
                                           stats_role="raft")
        self._grpc_server = rpc.make_server(
            f"{self.ip}:{self.port + rpc.GRPC_PORT_OFFSET}",
            [handler, raft_handler])
        self.raft.start()
        self._http_server = make_http_server(
            (self.ip, self.port), _make_http_handler(self),
            role="master", serve=self.serve)
        # lint: thread-ok(listener thread; each request mints its own context)
        self._http_thread = threading.Thread(
            target=self._http_server.serve_forever, name="master-http",
            daemon=True)
        self._http_thread.start()
        if self.maintenance_scripts:
            # lint: thread-ok(maintenance cron daemon; no request context)
            self._maint_thread = threading.Thread(
                target=self._maintenance_loop, name="master-maintenance",
                daemon=True)
            self._maint_thread.start()
        if self.scrub_interval_s > 0:
            # lint: thread-ok(scrub scheduler daemon; no request context)
            self._scrub_thread = threading.Thread(
                target=self._scrub_loop, name="master-scrub", daemon=True)
            self._scrub_thread.start()
        if self.lifecycle is not None:
            self.lifecycle.start()
        log.info("master %s started (rpc :%d)", self.url,
                 self.port + rpc.GRPC_PORT_OFFSET)

    def stop(self) -> None:
        log.info("master %s stopping", self.url)
        self._stopping = True
        self._maint_wake.set()
        self._scrub_wake.set()
        if self.lifecycle is not None:
            self.lifecycle.stop()
        for th in (self._maint_thread, self._scrub_thread):
            if th is not None:
                th.join(timeout=30)
        self.raft.stop()
        self._save_sequence()
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        if self._grpc_server:
            self._grpc_server.stop()

    @property
    def is_leader(self) -> bool:
        return self.raft.is_leader

    def _require_leader(self) -> None:
        if not self.raft.is_leader:
            raise NotLeader(self.raft.leader())

    # -- maintenance cron ----------------------------------------------------

    def _maintenance_loop(self) -> None:
        """Leader only: run the configured shell scripts every interval,
        so EC encode and rebuild (and vacuum, when scripted) happen with
        no operator (reference master_server.go:187-263). A script that
        fails is logged and counted; the pass goes on with the next."""
        while not self._stopping:
            self._maint_wake.wait(timeout=self.maintenance_interval_s)
            self._maint_wake.clear()
            if self._stopping:
                return
            if self.is_leader:
                self._run_maintenance_pass()
            self.maintenance_passes += 1

    def _run_maintenance_pass(self) -> None:
        from seaweedfs_tpu_torch.shell import CommandError, Shell
        sh = Shell(self.url)
        for script in self.maintenance_scripts:
            if self._stopping:
                return
            if not self.is_leader:
                log.info("maintenance: lost leadership mid-pass; "
                         "leaving the remaining scripts")
                return
            try:
                out = sh.run_command(script)
                if out.strip():
                    log.info("maintenance %r:\n%s", script, out.strip())
            except CommandError as e:
                self.maintenance_failures += 1
                log.warning("maintenance %r failed: %s", script, e)
            except Exception:  # noqa: BLE001 - the cron outlives a script
                self.maintenance_failures += 1
                log.exception("maintenance %r crashed", script)

    def run_maintenance_now(self) -> None:
        """Start one cron pass now (maintenance_passes counts it when it
        ends)."""
        self._maint_wake.set()

    # -- scrub scheduler -----------------------------------------------------

    def _scrub_loop(self) -> None:
        """Leader only: once per scrub_interval_s, start a scrub pass on
        every volume server, staggered across the window. The stagger
        waits are spent inside the window, so each server's period is the
        interval, not the interval plus the stagger."""
        while not self._stopping:
            cycle_start = time.monotonic()
            if self.is_leader:
                urls = sorted(n.url for n in self.topo.nodes())
                for url, wait in plan_scrub_stagger(urls,
                                                    self.scrub_interval_s):
                    if wait > 0:
                        self._scrub_wake.wait(timeout=wait)
                        self._scrub_wake.clear()
                    if self._stopping or not self.is_leader:
                        break
                    self._start_scrub_on(url)
            if self._stopping:
                return
            remainder = self.scrub_interval_s - \
                (time.monotonic() - cycle_start)
            if remainder > 0:
                self._scrub_wake.wait(timeout=remainder)
                self._scrub_wake.clear()

    def _start_scrub_on(self, url: str) -> bool:
        try:
            resp = volume_stub(url).VolumeScrubStart(
                volume_server_pb2.VolumeScrubStartRequest(
                    throttle_mbps=self.scrub_throttle_mbps))
        except rpc.RpcError as e:
            log.warning("scrub start on %s failed: %s", url, e.code().name)
            return False
        if resp.started:
            log.info("scrub window opened on %s", url)
        return resp.started

    def scrub_all_now(self) -> List[str]:
        """Start a scrub pass on every volume server now, without the
        stagger. Returns the urls that accepted."""
        return [n.url for n in self.topo.nodes()
                if self._start_scrub_on(n.url)]

    # -- vacuum across the cluster -----------------------------------------

    def vacuum(self, garbage_threshold: Optional[float] = None) -> List[int]:
        """Compact every writable volume whose garbage ratio is at least
        the threshold, on all its replicas (reference
        topology/topology_vacuum.go:17-201). Returns the compacted ids."""
        threshold = garbage_threshold or self.garbage_threshold
        compacted = []
        seen: Set[int] = set()
        for node in self.topo.nodes():
            for vid, info in list(node.volumes.items()):
                if vid in seen or info.read_only:
                    continue
                seen.add(vid)
                replicas = self.topo.lookup(vid, info.collection) or [node]
                try:
                    if self._vacuum_one(vid, replicas, threshold):
                        compacted.append(vid)
                except rpc.RpcError as e:
                    # failed mid-compaction: clean up on every replica
                    log.warning("vacuum of volume %d failed: %s", vid, e)
                    for r in replicas:
                        try:
                            volume_stub(r.url).VacuumVolumeCleanup(
                                volume_server_pb2.VacuumVolumeCleanupRequest(
                                    volume_id=vid))
                        except rpc.RpcError as ce:
                            log.warning("vacuum cleanup of volume %d on "
                                        "%s failed: %s", vid, r.url, ce)
        return compacted

    def _vacuum_one(self, vid: int, replicas, threshold: float) -> bool:
        stubs = [volume_stub(r.url) for r in replicas]
        checks = [s.VacuumVolumeCheck(
            volume_server_pb2.VacuumVolumeCheckRequest(volume_id=vid))
            for s in stubs]
        if not checks or min(c.garbage_ratio for c in checks) < threshold:
            return False
        for s in stubs:
            s.VacuumVolumeCompact(volume_server_pb2.VacuumVolumeCompactRequest(
                volume_id=vid))
        for s in stubs:
            s.VacuumVolumeCommit(volume_server_pb2.VacuumVolumeCommitRequest(
                volume_id=vid))
        return True

    # -- persistent state ----------------------------------------------------

    def _sequence_path(self) -> Optional[str]:
        return os.path.join(self.meta_dir, SEQUENCE_FILE) \
            if self.meta_dir else None

    def _load_sequence(self) -> int:
        p = self._sequence_path()
        if p and os.path.exists(p):
            with open(p) as f:
                return json.load(f).get("next", 1)
        return 1

    def _save_sequence(self) -> None:
        if not getattr(self.topo.sequence, "persistable", True):
            return  # snowflake ids must not seed a later memory run
        p = self._sequence_path()
        if p:
            os.makedirs(self.meta_dir, exist_ok=True)
            tmp = p + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"next": self.topo.sequence.peek}, f)
            os.replace(tmp, p)

    # -- raft state machine ----------------------------------------------------

    def _raft_apply(self, cmd: dict, term: int = 0) -> None:
        """The committed log's state machine: the max volume id and the
        file-id watermark (the state the reference snapshots,
        raft_server.go:21-60). Runs during RaftNode.__init__'s replay,
        before self.raft is set."""
        op = cmd.get("op")
        raft = getattr(self, "raft", None)
        if op == "max_volume_id":
            value = int(cmd["value"])
            self.topo.adjust_max_volume_id(value)
            self._applied_state["max_volume_id"] = max(
                self._applied_state["max_volume_id"], value)
        elif op == "sequence":
            value = int(cmd["value"])
            self._applied_state["sequence"] = max(
                self._applied_state["sequence"], value)
            # every watermark raises the floor but the sitting leader's
            # own proposals of its term (its sequencer is the truth
            # there); a prior term's, applied after winning, must raise
            # it, or this leader re-issues the dead leader's ids
            own_proposal = raft is not None and raft.is_leader and \
                term == raft.current_term
            if not own_proposal:
                self.topo.sequence.set_max(value)

    def _raft_restore(self, state: dict) -> None:
        """Reinstall a raft snapshot (log compaction, catch-up)."""
        if not state:
            return
        self._applied_state.update({
            "max_volume_id": int(state.get("max_volume_id", 0)),
            "sequence": int(state.get("sequence", 0))})
        if self._applied_state["max_volume_id"]:
            self.topo.adjust_max_volume_id(
                self._applied_state["max_volume_id"])
        if self._applied_state["sequence"]:
            self.topo.sequence.set_max(self._applied_state["sequence"])

    def _ensure_sequence_watermark(self, count: int) -> None:  # requires(self._seq_lock)
        """Keep the committed watermark ahead of every id this assign can
        hand out; the caller holds _seq_lock, so no id at or above the
        committed watermark ever goes out and a new leader resuming at
        it cannot repeat one."""
        if not self.raft.peers or \
                not getattr(self.topo.sequence, "needs_watermark", True):
            # time-based ids collide with nothing; watermarking them would
            # propose on almost every assign
            return
        peek = self.topo.sequence.peek
        if peek + count >= self._seq_watermark:
            new_wm = peek + count + self.SEQ_WATERMARK_GAP
            self.raft.propose({"op": "sequence", "value": new_wm})
            self._seq_watermark = new_wm

    # -- KeepConnected fan-out -----------------------------------------------

    def _broadcast(self, loc) -> None:
        with self._sub_lock:
            for q in self._subscribers.values():
                # lint: block-ok(unbounded Queue.put never blocks)
                q.put(loc)

    def _full_locations(self) -> list:
        locs = []
        for node in self.topo.nodes():
            vids = sorted(set(node.volumes) | set(node.ec_shards))
            if vids:
                locs.append(master_pb2.VolumeLocation(
                    url=node.url, public_url=node.public_url,
                    new_vids=vids))
        return locs

    # -- rpc: Seaweed service ------------------------------------------------

    def SendHeartbeat(self, request_iterator, context):
        if not self.raft.is_leader:
            # name the leader and end the stream; the volume server
            # redials it (reference master_grpc_server.go:20-28)
            next(request_iterator, None)
            yield master_pb2.HeartbeatResponse(
                leader=self.raft.leader() or "")
            return
        node_url = None
        stream_id = object()  # identity of THIS connection
        try:
            for hb in request_iterator:
                d = convert.heartbeat_from_pb(hb)
                node_url = f"{d['ip']}:{d['port']}"
                self._node_streams[node_url] = stream_id
                prev = self.topo.find_node(node_url)
                before = (set(prev.volumes) | set(prev.ec_shards)) \
                    if prev else set()
                if prev is None:
                    log.info("volume server %s connected (dc=%s rack=%s)",
                             node_url, hb.data_center or "DefaultDataCenter",
                             hb.rack or "DefaultRack")
                node = self.topo.sync_heartbeat(
                    d, dc=hb.data_center or "DefaultDataCenter",
                    rack=hb.rack or "DefaultRack")
                after = set(node.volumes) | set(node.ec_shards)
                new, deleted = sorted(after - before), sorted(before - after)
                if new or deleted:
                    self._broadcast(master_pb2.VolumeLocation(
                        url=node.url, public_url=node.public_url,
                        new_vids=new, deleted_vids=deleted))
                if not self.raft.is_leader:
                    # deposed mid-stream: send the node to the new leader
                    yield master_pb2.HeartbeatResponse(
                        leader=self.raft.leader() or "")
                    return
                yield master_pb2.HeartbeatResponse(
                    volume_size_limit=self.topo.volume_size_limit,
                    leader=self.url)
        finally:
            # stream break == node death (reference
            # master_grpc_server.go:22-50), unless the node already
            # reconnected on a fresh stream
            if node_url is not None and not self._stopping and \
                    self._node_streams.get(node_url) is stream_id:
                self._node_streams.pop(node_url, None)
                node = self.topo.find_node(node_url)
                if node is not None:
                    gone = sorted(set(node.volumes) | set(node.ec_shards))
                    log.warning("volume server %s disconnected; "
                                "unregistering %d volumes/shards",
                                node_url, len(gone))
                    self.topo.unregister_node(node_url)
                    if gone:
                        self._broadcast(master_pb2.VolumeLocation(
                            url=node_url, public_url=node.public_url,
                            deleted_vids=gone))

    def KeepConnected(self, request_iterator, context):
        if next(request_iterator, None) is None:  # the client's intro
            return
        if not self.raft.is_leader:
            yield master_pb2.VolumeLocation(leader=self.raft.leader() or "")
            return
        q: queue.Queue = queue.Queue()
        with self._sub_lock:
            self._sub_seq += 1
            key = self._sub_seq
            self._subscribers[key] = q
        try:
            yield master_pb2.VolumeLocation(leader=self.url)
            for loc in self._full_locations():
                yield loc
            while context.is_active():
                try:
                    yield q.get(timeout=1.0)
                except queue.Empty:
                    continue
        finally:
            with self._sub_lock:
                self._subscribers.pop(key, None)

    def LookupVolume(self, request, context):
        out = []
        VolumeIdLocation = master_pb2.LookupVolumeResponse.VolumeIdLocation
        for vid_str in request.volume_ids:
            try:
                vid = int(vid_str.split(",")[0])
            except ValueError:
                out.append(VolumeIdLocation(volume_id=vid_str,
                                            error="unknown volume id"))
                continue
            locs = self.lookup_locations(vid, request.collection)
            if locs:
                out.append(VolumeIdLocation(
                    volume_id=vid_str,
                    locations=[master_pb2.Location(url=u, public_url=p)
                               for u, p in locs]))
            else:
                out.append(VolumeIdLocation(
                    volume_id=vid_str, error=f"volume {vid} not found"))
        return master_pb2.LookupVolumeResponse(volume_id_locations=out)

    def lookup_locations(self, vid: int, collection: str = "") -> List[tuple]:
        """[(url, public_url)] over normal replicas, else EC shard holders."""
        nodes = self.topo.lookup(vid, collection)
        if nodes:
            return [(n.url, n.public_url) for n in nodes]
        out = []
        for u in self.topo.lookup_ec(vid):
            n = self.topo.find_node(u)
            out.append((u, n.public_url if n else u))
        return out

    def Assign(self, request, context):
        try:
            fid, count, locs = self.assign(
                count=max(1, request.count or 1),
                replication=request.replication,
                collection=request.collection,
                ttl=request.ttl,
                data_center=request.data_center,
                writable_volume_count=request.writable_volume_count)
        except ASSIGN_ERRORS as e:
            return master_pb2.AssignResponse(error=str(e))
        return master_pb2.AssignResponse(
            fid=fid, url=locs[0].url, public_url=locs[0].public_url,
            count=count)

    def assign(self, count: int = 1, replication: str = "",
               collection: str = "", ttl: str = "", data_center: str = "",
               writable_volume_count: int = 0):
        self._require_leader()
        rp = ReplicaPlacement.parse(replication or self.default_replication)
        rb = rp.to_byte()
        key = (collection, rb, ttl)
        for _ in range(2):
            if self.topo.has_writable(collection, rb, ttl):
                break
            # one grow per layout at a time; the others wait for it, and
            # no lock is held across the AllocateVolume RPCs
            with self._grow_lock:
                ev = self._growing.get(key)
                leader = ev is None
                if leader:
                    ev = self._growing[key] = threading.Event()
            if not leader:
                ev.wait(timeout=60.0)
                continue
            try:
                self.grow_volumes(
                    writable_volume_count or growth_count(rp.copy_count),
                    str(rp), collection, ttl, data_center)
            finally:
                with self._grow_lock:
                    self._growing.pop(key, None)
                ev.set()
        with self._seq_lock:
            self._ensure_sequence_watermark(count)
            picked = self.topo.pick_for_write(
                count=count, collection=collection, replica_byte=rb,
                ttl=ttl)
        if picked is None:
            raise RuntimeError("no writable volumes")
        return picked

    def grow_volumes(self, target_count: int, replication: str,
                     collection: str = "", ttl: str = "",
                     data_center: str = "") -> List[int]:
        """Allocate ``target_count`` new volumes, each on the nodes its
        placement picks (reference volume_growth.go:70-240). A volume
        whose replicas are not all created is left for
        volume.fix.replication and hands out no write location."""
        self._require_leader()
        rp = ReplicaPlacement.parse(replication or self.default_replication)
        grown = []
        for _ in range(max(1, target_count)):
            try:
                nodes = self.growth.find_empty_slots(rp, data_center)
            except NoFreeSlots:
                if grown:
                    break  # partial growth still unblocks the assign
                raise
            vid = self.topo.reserve_volume_ids(1)[0]
            # the new max volume id is committed before it is used, so no
            # later leader issues it again
            self.raft.propose({"op": "max_volume_id", "value": vid})
            ok_nodes = []
            for n in nodes:
                try:
                    volume_stub(n.url).AllocateVolume(
                        volume_server_pb2.AllocateVolumeRequest(
                            volume_id=vid, collection=collection,
                            replication=str(rp), ttl=ttl))
                    ok_nodes.append(n)
                except rpc.RpcError as e:
                    # a dead node: the heartbeat stream's end reaps it
                    log.warning("allocate volume %d on %s failed: %s",
                                vid, n.url, e)
            if len(ok_nodes) < rp.copy_count:
                if grown:
                    break
                raise RuntimeError(
                    f"volume allocation failed: {len(ok_nodes)}/"
                    f"{rp.copy_count} replicas created for vid {vid}")
            for n in ok_nodes:
                info = VolumeInfo(id=vid, collection=collection,
                                  replica_placement=rp.to_byte(), ttl=ttl)
                n.volumes[vid] = info
                self.topo.register_volume(info, n)
                self._broadcast(master_pb2.VolumeLocation(
                    url=n.url, public_url=n.public_url, new_vids=[vid]))
            grown.append(vid)
        return grown

    def Statistics(self, request, context):
        used = file_count = 0
        for node in self.topo.nodes():
            for v in node.volumes.values():
                if request.collection and v.collection != request.collection:
                    continue
                used += v.size
                file_count += v.file_count
        total = sum(n.max_volumes for n in self.topo.nodes()) \
            * self.topo.volume_size_limit
        return master_pb2.StatisticsResponse(
            total_size=total, used_size=used, file_count=file_count)

    def CollectionList(self, request, context):
        names: Set[str] = set()
        if request.include_normal_volumes or not request.include_ec_volumes:
            for (col, _, _), vl in self.topo.layouts.items():
                # a layout whose volumes are all gone names no collection
                # (the JAX master tests the bound method, always true)
                if vl.volume_ids():
                    names.add(col)
        if request.include_ec_volumes:
            names.update(self.topo.ec_collections.values())
        names.discard("")
        return master_pb2.CollectionListResponse(
            collections=[master_pb2.Collection(name=n) for n in sorted(names)])

    def CollectionDelete(self, request, context):
        for node in self.topo.nodes():
            try:
                volume_stub(node.url).DeleteCollection(
                    volume_server_pb2.DeleteCollectionRequest(
                        collection=request.name))
            except rpc.RpcError as e:
                # a server that is down converges at its next heartbeat
                log.warning("collection delete on %s failed: %s",
                            node.url, e)
        return master_pb2.CollectionDeleteResponse()

    def VacuumVolume(self, request, context):
        try:
            self.vacuum(request.garbage_threshold or self.garbage_threshold)
        except NotLeader as e:
            context.abort(rpc.StatusCode.FAILED_PRECONDITION, str(e))
        return master_pb2.VacuumVolumeResponse()

    def VolumeList(self, request, context):
        return master_pb2.VolumeListResponse(
            topology_info=convert.topology_to_pb(self.topo.to_map()),
            volume_size_limit_mb=self.topo.volume_size_limit >> 20)

    def LookupEcVolume(self, request, context):
        by_url = self.topo.lookup_ec(request.volume_id)
        if not by_url:
            context.abort(rpc.StatusCode.NOT_FOUND,
                          f"ec volume {request.volume_id} not found")
        shard_locs: Dict[int, List[str]] = {}
        for url, bits in by_url.items():
            for sid in bits.shard_ids:
                shard_locs.setdefault(sid, []).append(url)
        EcShardIdLocation = master_pb2.LookupEcVolumeResponse.EcShardIdLocation
        return master_pb2.LookupEcVolumeResponse(
            volume_id=request.volume_id,
            shard_id_locations=[
                EcShardIdLocation(
                    shard_id=sid,
                    locations=[master_pb2.Location(
                        url=u,
                        public_url=getattr(self.topo.find_node(u),
                                           "public_url", u))
                        for u in urls])
                for sid, urls in sorted(shard_locs.items())])

    def GetMasterConfiguration(self, request, context):
        return master_pb2.GetMasterConfigurationResponse()

    def LeaseAdminToken(self, request, context):
        if not self.raft.is_leader:
            # the cluster-wide lock lives on the leader only: a lease
            # from a follower would make two holders
            context.abort(rpc.StatusCode.FAILED_PRECONDITION,
                          f"not the raft leader; leader is "
                          f"{self.raft.leader() or '?'}")
        try:
            token, ts = self.admin_lock.lease(request.previous_token)
        except PermissionError as e:
            context.abort(rpc.StatusCode.PERMISSION_DENIED, str(e))
        return master_pb2.LeaseAdminTokenResponse(token=token, lock_ts_ns=ts)

    def ReleaseAdminToken(self, request, context):
        self.admin_lock.release(request.previous_token)
        return master_pb2.ReleaseAdminTokenResponse()

    # -- HTTP view -----------------------------------------------------------

    def http_assign(self, params: dict) -> dict:
        try:
            fid, count, locs = self.assign(
                count=int(params.get("count", ["1"])[0]),
                replication=params.get("replication", [""])[0],
                collection=params.get("collection", [""])[0],
                ttl=params.get("ttl", [""])[0],
                data_center=params.get("dataCenter", [""])[0])
        except ASSIGN_ERRORS as e:
            return {"error": str(e)}
        return {"fid": fid, "url": locs[0].url,
                "publicUrl": locs[0].public_url, "count": count}

    def http_lookup(self, params: dict) -> dict:
        """GET /dir/lookup: ``volumeId``/``fileId`` answers one vid;
        ``volumeIds=a,b,c`` answers each vid as its own entry."""
        collection = params.get("collection", [""])[0]
        if "volumeIds" in params:
            out = []
            for part in params.get("volumeIds", [""])[0].split(","):
                try:
                    vid = int(part)
                except ValueError:
                    out.append({"volumeId": part,
                                "error": f"bad volume id {part!r}"})
                    continue
                locs = self.lookup_locations(vid, collection)
                if locs:
                    out.append({"volumeId": str(vid),
                                "locations": [{"url": u, "publicUrl": p}
                                              for u, p in locs]})
                else:
                    out.append({"volumeId": str(vid),
                                "error": "volume not found"})
            return {"volumeIdLocations": out}
        raw = params.get("volumeId", params.get("fileId", [""]))[0]
        try:
            vid = int(raw.split(",")[0])
        except ValueError:
            return {"error": f"bad volume id {raw!r}"}
        locs = self.lookup_locations(vid, collection)
        if not locs:
            return {"volumeId": str(vid), "error": "volume not found"}
        return {"volumeId": str(vid),
                "locations": [{"url": u, "publicUrl": p} for u, p in locs]}

    def http_grow(self, params: dict) -> dict:
        try:
            grown = self.grow_volumes(
                int(params.get("count", ["1"])[0]),
                params.get("replication", [self.default_replication])[0],
                params.get("collection", [""])[0],
                params.get("ttl", [""])[0],
                params.get("dataCenter", [""])[0])
        except ASSIGN_ERRORS as e:
            return {"error": str(e)}
        return {"count": len(grown), "volumeIds": grown}

    def http_cluster_status(self) -> dict:
        return {"IsLeader": self.raft.is_leader,
                "Leader": self.raft.leader() or "",
                "Peers": self.raft.peers}

    def http_status(self) -> dict:
        """GET /status: this master's role block (the volume server's
        /status twin): the lifecycle engine's state and the live cluster
        heat."""
        return {
            "Version": "seaweedfs-tpu-torch",
            "IsLeader": self.raft.is_leader,
            "Lifecycle": self.lifecycle.status()
            if self.lifecycle is not None else {"enabled": False},
            "Heat": {str(vid): rec for vid, rec in
                     sorted(self.topo.cluster_heat().items())},
        }

    def http_cluster_heat(self) -> dict:
        """GET /cluster/heat: the heartbeat-fed cluster heat map, with
        each vid's observed tier — what `cluster.heat` renders."""
        heat = self.topo.cluster_heat()
        ec_vids = set(self.topo.ec_locations)
        vol_vids = {vid for n in self.topo.nodes() for vid in n.volumes}
        out = {}
        for vid in sorted(vol_vids | ec_vids | set(heat)):
            rec = dict(heat.get(vid, {"reads_window": 0.0, "ewma": 0.0,
                                      "servers": []}))
            rec["tier"] = "warm" if vid in ec_vids and vid not in vol_vids \
                else "hot"
            if self.lifecycle is not None:
                st = self.lifecycle.states.get(vid)
                if st is not None:
                    rec["state"] = st.state
            out[str(vid)] = rec
        return {"volumes": out}

    def http_cluster_qos(self) -> dict:
        """GET /cluster/qos: this master's own QoS block plus every data
        node's /qos/status, fanned out with short per-node timeouts —
        what `cluster.qos` renders. A node that does not answer reports
        an error entry instead of failing the whole view."""
        from seaweedfs_tpu_torch import qos
        mgr = qos.manager()
        out = {"master": mgr.status() if mgr is not None
               else {"enabled": False}, "nodes": {}}
        for n in self.topo.nodes():
            try:
                resp = http_client.request(
                    "GET", f"{n.url}/qos/status", timeout=2.0)
                out["nodes"][n.url] = json.loads(resp.body)
            except (OSError, ValueError) as e:
                out["nodes"][n.url] = {"error": str(e)}
        return out

    def http_lifecycle(self, params: dict, method: str = "GET") -> dict:
        """GET/POST /cluster/lifecycle: status (default), and the
        volume.lifecycle verbs — pause / resume / run / force."""
        if self.lifecycle is None:
            return {"enabled": False,
                    "error": "lifecycle disabled (start the master "
                             "with -lifecycle)"}
        action = params.get("action", [""])[0]
        if not action or action == "status":
            return self.lifecycle.status()
        if method != "POST":
            return {"error": f"action {action!r} requires POST"}
        if action == "pause":
            self.lifecycle.pause()
            return {"paused": True}
        if action == "resume":
            self.lifecycle.resume()
            return {"paused": False}
        if action == "run":
            self.lifecycle.run_pass_now()
            return {"triggered": True}
        if action == "force":
            try:
                vid = int(params.get("volumeId", ["0"])[0])
                kind = self.lifecycle.force(
                    vid, params.get("target", [""])[0])
            except ValueError as e:
                return {"error": str(e)}
            self.lifecycle.run_pass_now()
            return {"queued": kind, "volumeId": vid}
        return {"error": f"unknown action {action!r} (status | pause | "
                         "resume | run | force)"}


def _make_http_handler(ms: MasterServer):
    class Handler(FastHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, payload: dict, code: int = 200) -> None:
            self.fast_reply(code, json.dumps(payload).encode(),
                            ctype="application/json")

        def _html(self, body: str, code: int = 200) -> None:
            blob = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def _proxy_to_leader(self) -> bool:
            """Forward this request to the raft leader (reference
            master_server.go:155-185 proxyToLeader). True when the
            request was answered here (proxied, or an error)."""
            if ms.raft.is_leader:
                return False
            leader = ms.raft.leader()
            if not leader:
                self._json({"error": "no raft leader elected yet"},
                           code=503)
                return True
            try:
                r = http_client.request(self.command,
                                        f"{leader}{self.path}", timeout=30)
            except OSError as e:
                self._json({"error": f"leader {leader} unreachable: {e}"},
                           code=502)
                return True
            self.fast_reply(r.status, r.body, ctype=r.header(
                "content-type", "application/json"))
            return True

        def do_GET(self):
            upath, sep, query = self.path.partition("?")
            params = parse_qs(query) if sep else {}
            if upath in ("/debug/trace", "/debug/requests"):
                # local collector and flight-recorder state, never
                # proxied to the leader (each process answers for itself)
                from seaweedfs_tpu_torch.stats import cluster_trace
                self._json(cluster_trace.debug_payload(
                    self.path, "master", ms.url))
                return
            if upath == "/status":
                # this master's own role block, never proxied
                self._json(ms.http_status())
                return
            if upath == "/qos/status":
                # this process's own QoS admission state, never proxied
                # (the gathered cluster view is /cluster/qos)
                from seaweedfs_tpu_torch import qos
                mgr = qos.manager()
                self._json(mgr.status() if mgr is not None
                           else {"enabled": False})
                return
            if upath != "/cluster/status" and self._proxy_to_leader():
                return
            if upath == "/dir/assign":
                self._json(ms.http_assign(params))
            elif upath == "/dir/lookup":
                self._json(ms.http_lookup(params))
            elif upath == "/dir/status":
                self._json({"Topology": ms.topo.to_map(),
                            "Version": "seaweedfs-tpu-torch"})
            elif upath == "/vol/grow":
                self._json(ms.http_grow(params))
            elif upath == "/vol/vacuum":
                t = params.get("garbageThreshold", [""])[0]
                self._json({"compacted": ms.vacuum(float(t) if t
                                                   else None)})
            elif upath == "/cluster/status":
                self._json(ms.http_cluster_status())
            elif upath == "/cluster/heat":
                self._json(ms.http_cluster_heat())
            elif upath == "/cluster/qos":
                self._json(ms.http_cluster_qos())
            elif upath == "/cluster/lifecycle":
                self._json(ms.http_lifecycle(params, self.command))
            elif upath in ("/", "/ui"):
                self._html(_master_ui(ms))
            else:
                self._json({"error": f"unknown path {upath}"}, code=404)

        do_POST = do_GET

    from seaweedfs_tpu_torch.stats.metrics import instrument_http_handler
    return instrument_http_handler(Handler, "master")


def _master_ui(ms: MasterServer) -> str:
    """A plain status page (reference master UI, server/master_ui/). Every
    interpolated string is escaped: node urls and rack names come from
    heartbeats, which is remote input."""
    import html as _html
    esc = _html.escape
    rows = []
    for node in ms.topo.nodes():
        rows.append(
            f"<tr><td>{esc(node.url)}</td><td>{len(node.volumes)}"
            f"/{node.max_volumes}</td><td>{len(node.ec_shards)}</td>"
            f"<td>{esc(node.rack.id if node.rack else '')}</td></tr>")
    raft = ms.raft
    return (
        "<html><head><title>seaweedfs-tpu master</title></head><body>"
        f"<h1>Master {esc(ms.url)}</h1>"
        f"<p>leader: {esc(raft.leader() or '?')} | "
        f"is_leader: {raft.is_leader}"
        f" | peers: {esc(', '.join(raft.peers)) or '(single)'}"
        f" | volume size limit: {ms.topo.volume_size_limit >> 20} MB</p>"
        "<h2>Topology</h2><table border=1 cellpadding=4>"
        "<tr><th>volume server</th><th>volumes</th><th>ec shards</th>"
        "<th>rack</th></tr>" + "".join(rows) + "</table>"
        "<p><a href=/dir/status>dir status (json)</a> | "
        "<a href=/cluster/status>cluster status (json)</a></p>"
        "</body></html>")
