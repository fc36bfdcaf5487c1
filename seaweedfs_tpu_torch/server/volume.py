"""Volume server: the data-plane node, with its codec on the card.

HTTP serves the blob path (GET/POST/DELETE /<vid>,<fid>); the RPC port
serves the admin plane the shell drives (allocate, mount, copy, the EC
lifecycle, scrub control); a background thread streams heartbeats to the
master. The port of ``seaweedfs_tpu.server.volume``: every EC RPC and
every degraded read runs the CUDA codec (``-ec.encoder cuda``, the
default) or, when asked, its plain version on the host (``cpu``). An
encoder name the port does not run is refused with INVALID_ARGUMENT, and
a missing card with FAILED_PRECONDITION; nothing falls back to the host
quietly.

With ``cache_size_mb`` a tiered read cache sits in front of every EC
read (``cache/``): a repeat read is one hit instead of a reconstruction
on the card, and every write, delete, rebuild, decode and scrub repair
invalidates what it changes. With ``hedge_reads`` a remote shard read
with more than one holder hedges to the next after the tracked p95
(``resilience/hedge.py``). Both are None unless asked for.

The maintenance surface: vacuum (check, compact, commit, cleanup, paced
by ``compaction_mbps``), whole-volume copy, sync status, incremental
copy and tail streams, tiers (a sealed volume's .dat, or this server's
EC shards, to a configured backend and back), collection delete, batch
delete, needle status, configure, leave, and the JSON Query scan.

Replication: a write or delete of a volume whose placement asks for more
than one copy is applied here, then POSTed to every other replica at
once (``/admin/replicate``, ``/admin/replicate_delete``, on a pool of
``replicate_parallel`` lanes), and acknowledged only when every replica
answered. A failed replica fails the request, and so does a volume with
fewer known replicas than its placement names. Remote readers and the
scrub's replica source sort their candidates by circuit-breaker state
(``resilience/breaker.py``). ``master_url`` may list several masters:
the heartbeat follows the raft leader that a follower names.

Chunk manifests: ``POST``/``PUT ?cm=true`` stores a needle flagged as
one; ``GET``/``HEAD`` resolve it into the file it lists (unless
``cm=false``), reading the chunks through ``ChunkedFileReader`` against
the master the heartbeat follows, whole or by range; ``DELETE`` deletes
every chunk before the manifest; ``BatchDelete`` refuses a manifest.

Observability and policy: with ``heat_track`` (``-heat.track``) every
served read, normal or EC, is counted per volume in a sliding window
(``stats/heat.py``) whose summary rides the heartbeat to the master's
lifecycle engine; an unmount, delete or EC change forgets the vid. The
HTTP and RPC planes go through the shared request instrumentation
(``stats.metrics.instrument_http_handler``, ``rpc.generic_handler``), so
``-qos`` admission, cluster tracing and the request counters reach them;
``/qos/status``, ``/debug/trace`` and ``/debug/requests`` answer on the
data port.

An image GET with ``width`` or ``height`` is EXIF-fixed and resized
(``images/``; the stored bytes when PIL is missing, as in the JAX
package). ``/status`` carries the Heat block and ``/ui`` is a plain page
of this server's volumes.

With ``serve=ServeConfig(async_mode=True)`` (``-serve.async``) the HTTP
plane runs on the selector loop of ``util/async_server.py``; a plain GET
of a local normal volume then leaves through ``os.sendfile``
(``_try_send_needle_span``), and every reply is byte-identical to the
threaded model's.

Reference: weed/server/volume_server.go, volume_server_handlers_*.go,
volume_grpc_*.go, volume_grpc_client_to_master.go.
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs

import torch

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.ec import store_ec
from seaweedfs_tpu_torch.ec.ec_volume import EcShardNotFound
from seaweedfs_tpu_torch.ec.encoder import shard_file_name
from seaweedfs_tpu_torch.ec.shard_bits import DATA_SHARDS, TOTAL_SHARDS
from seaweedfs_tpu_torch.native.builder import BuildError, KernelLaunchError
from seaweedfs_tpu_torch.operation.file_id import parse_fid
from seaweedfs_tpu_torch.ops.rs_code import BACKENDS
from seaweedfs_tpu_torch.pb import (master_pb2, master_stub,
                                    volume_server_pb2, volume_stub)
from seaweedfs_tpu_torch.reads import DegradedReadFleet
from seaweedfs_tpu_torch.resilience import breaker as _breaker
from seaweedfs_tpu_torch.resilience import deadline as _deadline
from seaweedfs_tpu_torch.resilience import failpoint as _failpoint
from seaweedfs_tpu_torch.scrub import ScrubDaemon
from seaweedfs_tpu_torch.server import convert
from seaweedfs_tpu_torch.stats.metrics import ScrubCorruptionsFoundCounter
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage import vacuum as vacuum_mod
from seaweedfs_tpu_torch.storage import volume_backup, volume_tier
from seaweedfs_tpu_torch.storage.backend import BackendError
from seaweedfs_tpu_torch.storage.needle import (FLAG_IS_CHUNK_MANIFEST,
                                                FLAG_IS_COMPRESSED,
                                                CookieMismatch,
                                                DataCorruptionError, Needle,
                                                NeedleError)
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.superblock import TTL
from seaweedfs_tpu_torch.storage.volume import VolumeError
from seaweedfs_tpu_torch.util.fanout import FanOutPool
from seaweedfs_tpu_torch.util.throttler import Throttler
from seaweedfs_tpu_torch.util import http_client, wlog
from seaweedfs_tpu_torch.util.http_server import (FastHandler, ServeConfig,
                                                  make_http_server)
from seaweedfs_tpu_torch.util.multipart import iter_parts

log = wlog.logger("volume")

COPY_CHUNK = 1 << 20
# EC shard-location freshness is tiered by how complete the cached view
# is (reference storage/store_ec.go:221-231)
EC_REFRESH_SPARSE_S = 11.0
EC_REFRESH_PARTIAL_S = 7 * 60.0
EC_REFRESH_FULL_S = 37 * 60.0
# Replica locations are cached this long: replica sets move on
# volume.fix.replication and volume.move, so the window stays short, and
# a failed replica POST forgets the vid at once
REPLICA_REFRESH_S = 30.0
# the deadline on one remote shard interval read
REMOTE_READ_TIMEOUT_S = 15.0
# how often a tail stream looks for new needles
TAIL_POLL_S = 1.0
# a chunked file's GET up to this many bytes is read whole before its
# head is sent, so a chunk that fails is an error status; a longer one is
# sent with chunked framing, which a failed chunk cuts off without its
# last chunk, so the client still sees an error, never a short body
CHUNKED_BUFFER_BYTES = 64 << 20


def check_encoder(name: str) -> str:
    """The codec backend an EC request runs on: ``cuda`` or ``cpu``.
    Raises ValueError for any other name (the JAX package's
    ``tpu|jax|native|numpy|auto|pallas`` included)."""
    if name not in BACKENDS:
        raise ValueError(f"unknown EC encoder {name!r}; this server runs "
                         f"{' or '.join(repr(b) for b in BACKENDS)}")
    return name


class VolumeServer:
    def __init__(self, master_url: str, directories: List[str],
                 ip: str = "127.0.0.1", port: int = 8080,
                 public_url: str = "", data_center: str = "",
                 rack: str = "",
                 max_volume_counts: Optional[List[int]] = None,
                 pulse_seconds: float = 5.0, ec_encoder: str = "cuda",
                 ec_mesh: bool = False, needle_map_kind: str = "memory",
                 cache_size_mb: int = 0, cache_dir: Optional[str] = None,
                 hedge_reads: bool = False, hedge_delay_ms: float = 10.0,
                 compaction_mbps: float = 0.0,
                 storage_backends: Optional[dict] = None,
                 replicate_parallel: int = 8,
                 heat_track: bool = False,
                 heat_window_s: float = 60.0,
                 serve: Optional[ServeConfig] = None):
        self.ec_encoder = check_encoder(ec_encoder)
        if storage_backends:
            # tier targets (master.toml [storage.backend.<scheme>.<id>]);
            # an unknown scheme, or s3, fails the start
            from seaweedfs_tpu_torch.storage import backend as _bk
            _bk.load_configuration(storage_backends)
        # -compactionMBps: the pace of vacuum scans and file copies
        self.compaction_mbps = compaction_mbps
        # vid -> the compaction VacuumVolumeCommit finishes
        self.compact_states: Dict[int, vacuum_mod.CompactState] = {}
        self.master_url = master_url
        # the master this server last heartbeated successfully (the
        # leader); master_url may list several, so lookups dial this
        self.current_master = master_url.split(",")[0].strip()
        self.ip = ip
        self.port = port
        # where the master places this server (-dataCenter, -rack); empty
        # is the master's DefaultDataCenter/DefaultRack
        self.data_center = data_center
        self.rack = rack
        self.pulse_seconds = pulse_seconds
        # -ec.mesh: batched encode, verify and degraded decode on the
        # unified mesh scheduler (parallel/mesh_fleet, its default mesh);
        # None, not empty, when off
        self.ec_mesh_cfg = {} if ec_mesh else None
        self.store = Store(directories, max_volume_counts, ip=ip, port=port,
                           public_url=public_url,
                           needle_map_kind=needle_map_kind)
        # tiered read cache (-cache.sizeMB, -cache.dir): None, not empty,
        # unless sized, so the read path without it pays one None check
        self.read_cache = None
        if cache_size_mb > 0:
            from seaweedfs_tpu_torch.cache import TieredReadCache
            self.read_cache = TieredReadCache(
                cache_size_mb << 20,
                disk_dir=os.path.join(cache_dir, f"rc{port}")
                if cache_dir else None)
        # degraded reads go through the decode fleet; it and the scrub
        # daemon make no codec, thread or CUDA context until first use
        self.degraded = DegradedReadFleet(backend=self.ec_encoder,
                                          use_mesh=ec_mesh)
        self.scrub = ScrubDaemon(self.store, backend=self.ec_encoder,
                                 mesh_cfg=self.ec_mesh_cfg,
                                 replica_fetch=self._fetch_needle_from_replica,
                                 on_repair=self._invalidate_volume_cache)
        # the replica fan-out (-replicate.parallel): every replica POST of
        # one write goes out at once on this pool, which makes no thread
        # before the first fan-out to two or more replicas
        self._replicate_pool = FanOutPool(max(1, replicate_parallel),
                                          f"replicate-{port}")
        # vid -> (monotonic time, the other replicas' urls)
        self._replica_urls: Dict[int, Tuple[float, List[str]]] = {}
        # hedged remote shard reads (-resilience.hedge): None unless
        # asked for; a Hedger makes no thread until its first fetch with
        # more than one candidate
        self.hedger = None
        if hedge_reads:
            from seaweedfs_tpu_torch.resilience.hedge import Hedger
            self.hedger = Hedger(
                delay_floor_s=max(hedge_delay_ms, 0.1) / 1000.0,
                name=f"hedge-volume-{port}")
        # read-path heat telemetry (-heat.track): absent, not merely idle,
        # unless enabled, so the read path without it pays one None check
        from seaweedfs_tpu_torch.stats.heat import make_tracker
        self.heat = make_tracker(heat_track, window_s=heat_window_s)
        self.volume_size_limit = 30 << 30
        # -serve.*: the async selector core and its zero-copy GET; a
        # default server never imports util/async_server
        self.serve = serve or ServeConfig()
        self._ec_locations: Dict[int, Tuple[float, Dict[int, List[str]]]] = {}
        self._grpc_server = None
        self._http_server = None
        self._http_thread = None
        self._hb_thread = None
        self._hb_call = None
        self._hb_wake = threading.Event()
        self._stopping = False

    # -- lifecycle -----------------------------------------------------------

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> None:
        handler = rpc.generic_handler(
            volume_server_pb2, "VolumeServer", self)
        self._grpc_server = rpc.make_server(
            f"{self.ip}:{self.port + rpc.GRPC_PORT_OFFSET}", [handler])
        self._http_server = make_http_server(
            (self.ip, self.port), _make_http_handler(self),
            role="volume", serve=self.serve)
        # lint: thread-ok(listener thread; each request mints its own context)
        self._http_thread = threading.Thread(
            target=self._http_server.serve_forever,
            name=f"volume-http-{self.port}", daemon=True)
        self._http_thread.start()
        # lint: thread-ok(heartbeat daemon; no request context)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name=f"heartbeat-{self.port}",
            daemon=True)
        self._hb_thread.start()
        log.info("volume server %s:%d started (rpc :%d, dirs %s, "
                 "encoder %s)", self.ip, self.port,
                 self.port + rpc.GRPC_PORT_OFFSET,
                 [loc.directory for loc in self.store.locations],
                 self.ec_encoder)
        if self.ec_mesh_cfg is not None:
            self._report_mesh()

    def _report_mesh(self) -> None:
        """Say at start which mesh -ec.mesh rides, or that there is none
        (fewer than two cards) and the per-card fleet takes its work."""
        from seaweedfs_tpu_torch.parallel import mesh_fleet
        try:
            log.info("-ec.mesh: %r", mesh_fleet._resolve_mesh(None))
        except mesh_fleet.MeshError as e:
            log.warning("-ec.mesh: no mesh (%s); EC batches, scrub passes "
                        "and degraded decodes run on the per-card fleet", e)

    def stop(self) -> None:
        log.info("volume server %s:%d stopping", self.ip, self.port)
        self._stopping = True
        if self.heat is not None:
            self.heat.close()
        self.degraded.stop()
        self.scrub.stop()
        self._replicate_pool.stop()
        if self.hedger is not None:
            self.hedger.stop()
        self._hb_wake.set()
        if self._hb_call is not None:
            self._hb_call.cancel()
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        if self._grpc_server:
            self._grpc_server.stop()
        self.store.close()

    # -- heartbeat -----------------------------------------------------------

    def _heartbeat_gen(self):
        while not self._stopping:
            hb = self.store.collect_heartbeat()
            if self.heat is not None:
                # the heat summary rides the heartbeat: the master's
                # topology sums every server's window reads and decayed
                # EWMA into the cluster heat map the lifecycle engine
                # decides from. Absent (not empty) when -heat.track is
                # off, so the heartbeat's bytes are unchanged.
                hb["volume_heats"] = self.heat.summary()
            yield convert.heartbeat_to_pb(hb, self.data_center, self.rack)
            self._hb_wake.wait(timeout=self.pulse_seconds)
            self._hb_wake.clear()

    def _heartbeat_loop(self) -> None:
        """Keep one bidi heartbeat stream to the master leader; redial on
        a break (reference volume_grpc_client_to_master.go:50-95).
        master_url may list several masters: a follower answers with the
        leader's address and the loop dials it, and a plain break moves on
        to the next master of the list after a pause, so an election
        without a leader is no tight redial loop."""
        candidates = [m.strip() for m in self.master_url.split(",")
                      if m.strip()]
        target = candidates[0]
        rotate = 0
        while not self._stopping:
            redirect = None
            try:
                self._hb_call = master_stub(target).SendHeartbeat(
                    self._heartbeat_gen())
                connected = False
                for resp in self._hb_call:
                    if resp.leader != target:
                        # a follower: it names the leader, or "" while
                        # an election runs (then the next candidate)
                        redirect = resp.leader or None
                        log.info("master %s redirects the heartbeat to "
                                 "leader %s", target, redirect or "?")
                        self._hb_call.cancel()
                        break
                    if not connected:
                        connected = True
                        self.current_master = target
                        log.info("heartbeat stream to master %s "
                                 "established", target)
                    if resp.volume_size_limit:
                        self.volume_size_limit = resp.volume_size_limit
                    if self._stopping:
                        return
            except rpc.RpcError as e:
                if self._stopping:
                    return
                log.warning("heartbeat stream to master %s broken (%s); "
                            "reconnecting", target, e.code().name)
            if self._stopping:
                return
            if redirect:
                target = redirect
                continue
            rotate += 1
            target = candidates[rotate % len(candidates)]
            self._hb_wake.wait(timeout=min(self.pulse_seconds, 1.0))
            self._hb_wake.clear()

    def trigger_heartbeat(self) -> None:
        """Push a heartbeat now instead of waiting out the pulse."""
        self._hb_wake.set()

    # -- rpc: volume lifecycle -----------------------------------------------

    def AllocateVolume(self, request, context):
        self.store.add_volume(request.volume_id, request.collection,
                              replica_placement=request.replication or "000",
                              ttl=request.ttl)
        self.trigger_heartbeat()
        return volume_server_pb2.AllocateVolumeResponse()

    def VolumeDelete(self, request, context):
        self.store.delete_volume(request.volume_id)
        self._invalidate_volume_cache(request.volume_id, "rebuild")
        self._forget_heat(request.volume_id)
        self.trigger_heartbeat()
        return volume_server_pb2.VolumeDeleteResponse()

    def VolumeMarkReadonly(self, request, context):
        if not self.store.mark_volume_readonly(request.volume_id):
            context.abort(rpc.StatusCode.NOT_FOUND,
                          f"volume {request.volume_id} not found")
        self.trigger_heartbeat()
        return volume_server_pb2.VolumeMarkReadonlyResponse()

    def VolumeMarkWritable(self, request, context):
        if not self.store.mark_volume_writable(request.volume_id):
            context.abort(rpc.StatusCode.NOT_FOUND,
                          f"volume {request.volume_id} not found")
        self.trigger_heartbeat()
        return volume_server_pb2.VolumeMarkWritableResponse()

    def VolumeMount(self, request, context):
        vid = request.volume_id
        if self.store.find_volume(vid) is None:
            found = False
            for loc in self.store.locations:
                for name in os.listdir(loc.directory):
                    if not name.endswith(".dat"):
                        continue
                    stem = name[:-len(".dat")]
                    col, _, tail = stem.rpartition("_")
                    if tail == str(vid) or (not col and stem == str(vid)):
                        loc.add_volume(vid, col)
                        found = True
                        break
                if found:
                    break
            if not found:
                context.abort(rpc.StatusCode.NOT_FOUND,
                              f"no .dat for volume {vid} on any disk")
        self.trigger_heartbeat()
        return volume_server_pb2.VolumeMountResponse()

    def VolumeUnmount(self, request, context):
        for loc in self.store.locations:
            loc.unload_volume(request.volume_id)
        self._forget_heat(request.volume_id)
        self.trigger_heartbeat()
        return volume_server_pb2.VolumeUnmountResponse()

    def DeleteCollection(self, request, context):
        for vid in self.store.delete_collection(request.collection):
            self.compact_states.pop(vid, None)
            self._invalidate_volume_cache(vid, "rebuild")
            self._forget_heat(vid)
        self.trigger_heartbeat()
        return volume_server_pb2.DeleteCollectionResponse()

    def _forget_heat(self, vid: int) -> None:
        """Heat hygiene on a volume's departure or conversion: without
        it a dead vid's SeaweedFS_volume_heat{vid} child and counters
        linger forever (unbounded label growth)."""
        if self.heat is not None:
            self.heat.forget(vid)

    def _volume_or_abort(self, context, vid: int):
        v = self.store.find_volume(vid)
        if v is None:
            context.abort(rpc.StatusCode.NOT_FOUND,
                          f"volume {vid} not found")
        return v

    def ReadVolumeFileStatus(self, request, context):
        v = self._volume_or_abort(context, request.volume_id)
        # the first call of a VolumeCopy from here: the vid is about to
        # gain a replica this server's cached locations do not name
        self._forget_replicas(v.id)
        base = v.file_name()
        return volume_server_pb2.ReadVolumeFileStatusResponse(
            volume_id=v.id,
            idx_file_size=os.path.getsize(base + ".idx"),
            dat_file_size=os.path.getsize(base + ".dat"),
            idx_file_timestamp_seconds=int(os.path.getmtime(base + ".idx")),
            dat_file_timestamp_seconds=int(os.path.getmtime(base + ".dat")),
            file_count=v.file_count,
            compaction_revision=v.super_block.compaction_revision,
            collection=v.collection)

    # -- rpc: vacuum ---------------------------------------------------------

    def VacuumVolumeCheck(self, request, context):
        v = self._volume_or_abort(context, request.volume_id)
        return volume_server_pb2.VacuumVolumeCheckResponse(
            garbage_ratio=v.garbage_ratio())

    def VacuumVolumeCompact(self, request, context):
        v = self._volume_or_abort(context, request.volume_id)
        try:
            self.compact_states[v.id] = vacuum_mod.compact(
                v, preallocate=request.preallocate,
                compaction_mbps=self.compaction_mbps)
        except VolumeError as e:   # a tiered volume has no local .dat
            context.abort(rpc.StatusCode.FAILED_PRECONDITION, str(e))
        return volume_server_pb2.VacuumVolumeCompactResponse()

    def VacuumVolumeCommit(self, request, context):
        v = self.store.find_volume(request.volume_id)
        state = self.compact_states.pop(request.volume_id, None)
        if v is None or state is None:
            context.abort(rpc.StatusCode.FAILED_PRECONDITION,
                          f"volume {request.volume_id}: no pending "
                          "compaction")
        vacuum_mod.commit_compact(v, state)
        # every needle moved: no entry of the volume may outlive it
        self._invalidate_volume_cache(v.id, "rebuild")
        self.trigger_heartbeat()
        return volume_server_pb2.VacuumVolumeCommitResponse(
            is_read_only=v.read_only)

    def VacuumVolumeCleanup(self, request, context):
        v = self.store.find_volume(request.volume_id)
        self.compact_states.pop(request.volume_id, None)
        if v is not None:
            for ext in (".cpd", ".cpx"):
                p = v.file_name() + ext
                if os.path.exists(p):
                    os.remove(p)
        return volume_server_pb2.VacuumVolumeCleanupResponse()

    # -- rpc: needle and volume admin ----------------------------------------

    def BatchDelete(self, request, context):
        results = []
        for fid in request.file_ids:
            try:
                f = parse_fid(fid)
            except ValueError as e:
                results.append(volume_server_pb2.DeleteResult(
                    file_id=fid, status=400, error=str(e)))
                continue
            n = Needle(id=f.key, cookie=f.cookie)
            try:
                if not request.skip_cookie_check:
                    got = self.read_needle(f.volume_id, n)
                    if got.cookie != f.cookie:
                        raise CookieMismatch(f"cookie mismatch on {fid}")
                    if got.is_chunk_manifest:
                        # its chunks would go first; refused like the
                        # reference (volume_grpc_batch_delete.go:62-69)
                        results.append(volume_server_pb2.DeleteResult(
                            file_id=fid, status=406,
                            error="ChunkManifest: not allowed in batch "
                                  "delete mode."))
                        continue
                # replicated like the HTTP DELETE: the needle goes from
                # every replica, not only this one
                size = self.replicated_delete(f.volume_id, n)
                results.append(volume_server_pb2.DeleteResult(
                    file_id=fid, status=202, size=size))
            except CookieMismatch as e:
                results.append(volume_server_pb2.DeleteResult(
                    file_id=fid, status=403, error=str(e)))
            except (NeedleError, EcShardNotFound, VolumeError) as e:
                results.append(volume_server_pb2.DeleteResult(
                    file_id=fid, status=404, error=str(e)))
        return volume_server_pb2.BatchDeleteResponse(results=results)

    def VolumeServerLeave(self, request, context):
        """Stop heartbeating, so the master forgets this server; the
        process serves on until it is stopped."""
        self._stopping = True
        self._hb_wake.set()
        if self._hb_call is not None:
            self._hb_call.cancel()
        return volume_server_pb2.VolumeServerLeaveResponse()

    def VolumeNeedleStatus(self, request, context):
        """One needle's metadata without its data (reference
        volume_grpc_query.go VolumeNeedleStatus)."""
        v = self._volume_or_abort(context, request.volume_id)
        nv = v.nm.get(request.needle_id)
        if nv is None or not t.size_is_valid(nv.size):
            context.abort(rpc.StatusCode.NOT_FOUND,
                          f"needle {request.needle_id} not found")
        try:
            # cookie 0 skips the cookie check: an admin probe
            got = v.read_needle(Needle(id=request.needle_id, cookie=0))
        except NeedleError as e:   # expired, torn or CRC-bad
            context.abort(rpc.StatusCode.NOT_FOUND, str(e))
        return volume_server_pb2.VolumeNeedleStatusResponse(
            needle_id=request.needle_id, cookie=got.cookie, size=nv.size,
            last_modified=got.append_at_ns // 1_000_000_000,
            crc=got.checksum, ttl=str(v.ttl))

    def VolumeConfigure(self, request, context):
        """Rewrite a volume's replica placement in its superblock
        (reference volume_grpc_admin.go:104); volume.fix.replication then
        makes the copies it asks for."""
        try:
            found = self.store.configure_volume(request.volume_id,
                                                request.replication)
        except (ValueError, VolumeError) as e:
            return volume_server_pb2.VolumeConfigureResponse(error=str(e))
        if not found:
            context.abort(rpc.StatusCode.NOT_FOUND,
                          f"volume {request.volume_id} not found")
        self._invalidate_volume_cache(request.volume_id, "rebuild")
        self.trigger_heartbeat()
        return volume_server_pb2.VolumeConfigureResponse()

    def Query(self, request, context):
        """Scan stored JSON documents: filter and project, one stripe per
        file id (reference volume_grpc_query.go:12-76)."""
        from seaweedfs_tpu_torch.query import Query as JQuery
        from seaweedfs_tpu_torch.query import query_json_lines
        q = JQuery(field=request.filter.field, op=request.filter.operand,
                   value=request.filter.value)
        for fid in request.from_file_ids:
            try:
                f = parse_fid(fid)
            except ValueError as e:
                context.abort(rpc.StatusCode.INVALID_ARGUMENT, str(e))
            try:
                got = self.read_needle(f.volume_id,
                                       Needle(id=f.key, cookie=f.cookie))
            except (NeedleError, EcShardNotFound) as e:
                context.abort(rpc.StatusCode.NOT_FOUND, f"{fid}: {e}")
            data = gzip.decompress(got.data) if got.is_compressed \
                else got.data
            yield volume_server_pb2.QueriedStripe(records=b"".join(
                json.dumps(rec).encode() + b"\n"
                for rec in query_json_lines(
                    data, list(request.selections), q)))

    # -- rpc: file copy ------------------------------------------------------

    def CopyFile(self, request, context):
        path = self._file_path_for_copy(request)
        if path is None or not os.path.exists(path):
            if request.ignore_source_file_not_found:
                return
            context.abort(rpc.StatusCode.NOT_FOUND,
                          f"no file for vid={request.volume_id} "
                          f"ext={request.ext}")
        stop = request.stop_offset or os.path.getsize(path)
        throttler = Throttler(self.compaction_mbps)
        with open(path, "rb") as f:
            sent = 0
            while sent < stop:
                chunk = f.read(min(COPY_CHUNK, stop - sent))
                if not chunk:
                    break
                sent += len(chunk)
                throttler.maybe_slowdown(len(chunk))
                yield volume_server_pb2.CopyFileResponse(file_content=chunk)

    def _file_path_for_copy(self, request) -> Optional[str]:
        vid, ext = request.volume_id, request.ext
        if request.is_ec_volume:
            base = store_ec._find_ec_base(self.store, vid,
                                          request.collection or None)
            return base + ext if base else None
        v = self.store.find_volume(vid)
        return v.file_name() + ext if v else None

    def _pull_file(self, src_stub, vid: int, ext: str, dest_path: str,
                   collection: str = "", is_ec: bool = False,
                   ignore_missing: bool = False) -> None:
        tmp = dest_path + ".copying"
        with open(tmp, "wb") as f:
            for resp in src_stub.CopyFile(volume_server_pb2.CopyFileRequest(
                    volume_id=vid, ext=ext, collection=collection,
                    is_ec_volume=is_ec,
                    ignore_source_file_not_found=ignore_missing)):
                f.write(resp.file_content)
        os.replace(tmp, dest_path)

    def VolumeCopy(self, request, context):
        """Pull a whole volume (.idx, then .dat) from source_data_node and
        mount it (reference volume_grpc_copy.go)."""
        vid = request.volume_id
        if self.store.find_volume(vid) is not None:
            context.abort(rpc.StatusCode.ALREADY_EXISTS,
                          f"volume {vid} already exists")
        src = volume_stub(request.source_data_node)
        status = src.ReadVolumeFileStatus(
            volume_server_pb2.ReadVolumeFileStatusRequest(volume_id=vid))
        loc = next((l for l in self.store.locations if l.has_free_slot()),
                   None)
        if loc is None:
            context.abort(rpc.StatusCode.RESOURCE_EXHAUSTED, "no free slot")
        base = store_ec._base_name(loc.directory, status.collection, vid)
        try:
            for ext in (".idx", ".dat"):
                self._pull_file(src, vid, ext, base + ext,
                                collection=status.collection)
        except rpc.RpcError:
            for ext in (".idx", ".dat"):
                if os.path.exists(base + ext):
                    os.remove(base + ext)
            raise
        v = loc.add_volume(vid, status.collection)
        self._invalidate_volume_cache(vid, "rebuild")
        self.trigger_heartbeat()
        return volume_server_pb2.VolumeCopyResponse(
            last_append_at_ns=v.last_append_at_ns)

    # -- rpc: sync status, incremental copy, tail ----------------------------

    def VolumeSyncStatus(self, request, context):
        """The follower's handshake (reference volume_backup.go:19-33)."""
        v = self._volume_or_abort(context, request.volume_id)
        return volume_server_pb2.VolumeSyncStatusResponse(
            **volume_backup.sync_status(v))

    def VolumeIncrementalCopy(self, request, context):
        """Stream the raw .dat bytes appended after since_ns (reference
        volume_grpc_copy_incremental.go)."""
        v = self._volume_or_abort(context, request.volume_id)
        offset, is_last = volume_backup.binary_search_by_append_at_ns(
            v, request.since_ns)
        if is_last:
            return
        for chunk in volume_backup.read_dat_range(v, offset):
            yield volume_server_pb2.VolumeIncrementalCopyResponse(
                file_content=chunk)

    def VolumeTailSender(self, request, context):
        """Stream the needles appended after since_ns, and keep following
        until the tail stays quiet for idle_timeout_seconds (0 follows
        until the client hangs up; reference volume_grpc_tail.go:17-64)."""
        v = self._volume_or_abort(context, request.volume_id)
        last_ns = request.since_ns
        draining = request.idle_timeout_seconds
        while True:
            if not context.is_active():
                return
            progressed = False
            offset, is_last = volume_backup.binary_search_by_append_at_ns(
                v, last_ns)
            if not is_last:
                for _, n in volume_backup.scan_dat_from(v, offset):
                    blob = n.to_bytes(v.version)
                    yield volume_server_pb2.VolumeTailSenderResponse(
                        needle_header=blob[:t.NEEDLE_HEADER_SIZE],
                        needle_body=blob[t.NEEDLE_HEADER_SIZE:])
                    if n.append_at_ns > last_ns:
                        last_ns = n.append_at_ns
                        progressed = True
            if request.idle_timeout_seconds == 0:
                time.sleep(TAIL_POLL_S)
                continue
            if progressed:
                draining = request.idle_timeout_seconds
            else:
                draining -= 1
                if draining <= 0:
                    yield volume_server_pb2.VolumeTailSenderResponse(
                        is_last_chunk=True)
                    return
            time.sleep(TAIL_POLL_S)

    def VolumeTailReceiver(self, request, context):
        """Pull a tail stream from source_volume_server and replay it into
        the local volume (reference volume_grpc_tail.go:80-94)."""
        v = self._volume_or_abort(context, request.volume_id)
        src = volume_stub(request.source_volume_server)
        for resp in src.VolumeTailSender(
                volume_server_pb2.VolumeTailSenderRequest(
                    volume_id=request.volume_id, since_ns=request.since_ns,
                    idle_timeout_seconds=request.idle_timeout_seconds)):
            if resp.is_last_chunk:
                break
            blob = bytes(resp.needle_header) + bytes(resp.needle_body)
            n = Needle.from_bytes(blob, v.version, check_crc=False)
            if len(n.data) == 0:
                v.delete_needle(n)
            else:
                v.write_needle(n)
            self._invalidate_needle_cache(v.id, n.id, "overwrite")
        return volume_server_pb2.VolumeTailReceiverResponse()

    # -- rpc: tiers ----------------------------------------------------------

    def VolumeTierMoveDatToRemote(self, request, context):
        """Move a sealed volume's .dat to the named backend (reference
        volume_grpc_tier_upload.go); for an EC vid, this server's .ecNN
        files. The .idx/.ecx stay local."""
        v = self.store.find_volume(request.volume_id)
        try:
            if v is None:
                ecv = self.store.find_ec_volume(request.volume_id)
                if ecv is None:
                    context.abort(rpc.StatusCode.NOT_FOUND,
                                  f"volume {request.volume_id} not found")
                total = volume_tier.move_ec_shards_to_remote(
                    ecv, request.destination_backend_name,
                    keep_local=request.keep_local_dat_file, owner=self.url)
                pct = 100.0
                # reads go to the backend from now on, also the cached
                self._invalidate_volume_cache(ecv.volume_id, "rebuild")
            else:
                size = max(v.content_size, 1)
                total = volume_tier.move_dat_to_remote(
                    v, request.destination_backend_name,
                    keep_local=request.keep_local_dat_file, owner=self.url)
                pct = 100.0 * total / size
        except (VolumeError, BackendError) as e:
            context.abort(rpc.StatusCode.FAILED_PRECONDITION, str(e))
        self.trigger_heartbeat()
        yield volume_server_pb2.VolumeTierMoveDatToRemoteResponse(
            processed=total, processed_percentage=pct)

    def VolumeTierMoveDatFromRemote(self, request, context):
        """Bring a tiered volume's .dat, or this server's tiered EC
        shards, back to local disk (reference
        volume_grpc_tier_download.go)."""
        v = self.store.find_volume(request.volume_id)
        try:
            if v is None:
                ecv = self.store.find_ec_volume(request.volume_id)
                if ecv is None:
                    context.abort(rpc.StatusCode.NOT_FOUND,
                                  f"volume {request.volume_id} not found")
                total = volume_tier.move_ec_shards_from_remote(
                    ecv, keep_remote=request.keep_remote_dat_file)
            else:
                total = volume_tier.move_dat_from_remote(
                    v, keep_remote=request.keep_remote_dat_file)
        except (VolumeError, BackendError) as e:
            context.abort(rpc.StatusCode.FAILED_PRECONDITION, str(e))
        yield volume_server_pb2.VolumeTierMoveDatFromRemoteResponse(
            processed=total, processed_percentage=100.0)

    # -- rpc: erasure coding -------------------------------------------------

    def _ec_backend(self, context, requested: str = "") -> str:
        """The backend an EC request runs on; refuses a name the port
        does not run and a card that is not there, before any work."""
        try:
            name = check_encoder(requested or self.ec_encoder)
        except ValueError as e:
            context.abort(rpc.StatusCode.INVALID_ARGUMENT, str(e))
        if name == "cuda" and not torch.cuda.is_available():
            context.abort(rpc.StatusCode.FAILED_PRECONDITION,
                          "EC encoder 'cuda' needs a CUDA device and none "
                          "is available on this server")
        return name

    def _codec_call(self, context, fn, *args, **kwargs):
        """Run one codec step; a kernel that does not build or launch is
        an INTERNAL status, never a retry on another path."""
        try:
            return fn(*args, **kwargs)
        except (BuildError, KernelLaunchError) as e:
            context.abort(rpc.StatusCode.INTERNAL, f"EC kernel: {e}")

    def VolumeEcShardsGenerate(self, request, context):
        backend = self._ec_backend(context, request.encoder)
        vids = list(request.volume_ids) or [request.volume_id]
        try:
            # one scheduler packs all the volumes' chunks into shared
            # dispatches (the mesh scheduler under -ec.mesh for two or
            # more volumes, the fleet otherwise)
            self._codec_call(context, store_ec.generate_ec_shards_batch,
                             self.store, vids, backend=backend,
                             mesh_cfg=self.ec_mesh_cfg)
        except NeedleError as e:
            context.abort(rpc.StatusCode.NOT_FOUND, str(e))
        for vid in vids:
            # a new EC incarnation: nothing cached of an earlier one (a
            # decode, vacuum and re-encode moves every needle) may serve;
            # and the EC era's heat ledger starts from zero
            self._invalidate_volume_cache(vid, "rebuild")
            self._forget_heat(vid)
        return volume_server_pb2.VolumeEcShardsGenerateResponse()

    def VolumeEcShardsRebuild(self, request, context):
        backend = self._ec_backend(context, request.encoder)
        try:
            rebuilt = self._codec_call(
                context, store_ec.rebuild_ec_shards, self.store,
                request.volume_id, collection=request.collection or None,
                backend=backend)
        except EcShardNotFound as e:
            context.abort(rpc.StatusCode.NOT_FOUND, str(e))
        if rebuilt:
            # rebuilt shard bytes supersede any reconstructed spans
            self._invalidate_volume_cache(request.volume_id, "rebuild")
        return volume_server_pb2.VolumeEcShardsRebuildResponse(
            rebuilt_shard_ids=rebuilt)

    def VolumeEcShardsCopy(self, request, context):
        vid = request.volume_id
        src = volume_stub(request.source_data_node)
        loc = next((l for l in self.store.locations if l.has_free_slot()),
                   self.store.locations[0])
        base = store_ec._base_name(loc.directory, request.collection, vid)
        for sid in request.shard_ids:
            self._pull_file(src, vid, f".ec{sid:02d}",
                            shard_file_name(base, sid),
                            collection=request.collection, is_ec=True)
        if request.copy_ecx_file:
            self._pull_file(src, vid, ".ecx", base + ".ecx",
                            collection=request.collection, is_ec=True)
        if request.copy_ecj_file:
            self._pull_file(src, vid, ".ecj", base + ".ecj",
                            collection=request.collection, is_ec=True,
                            ignore_missing=True)
        return volume_server_pb2.VolumeEcShardsCopyResponse()

    def VolumeEcShardsDelete(self, request, context):
        store_ec.delete_ec_shards(self.store, request.volume_id,
                                  collection=request.collection or None,
                                  shard_ids=list(request.shard_ids))
        # the shard set changed under any cached reconstructed spans
        self._invalidate_volume_cache(request.volume_id, "rebuild")
        self.trigger_heartbeat()
        return volume_server_pb2.VolumeEcShardsDeleteResponse()

    def VolumeEcShardsMount(self, request, context):
        try:
            store_ec.mount_ec_shards(self.store, request.volume_id,
                                     request.collection,
                                     list(request.shard_ids))
        except EcShardNotFound as e:
            context.abort(rpc.StatusCode.NOT_FOUND, str(e))
        # the shard set changed under any cached reconstructed spans
        self._invalidate_volume_cache(request.volume_id, "rebuild")
        self.trigger_heartbeat()
        return volume_server_pb2.VolumeEcShardsMountResponse()

    def VolumeEcShardsUnmount(self, request, context):
        store_ec.unmount_ec_shards(self.store, request.volume_id,
                                   list(request.shard_ids))
        self.trigger_heartbeat()
        return volume_server_pb2.VolumeEcShardsUnmountResponse()

    def VolumeEcShardRead(self, request, context):
        try:
            data = store_ec.read_ec_shard(
                self.store, request.volume_id, request.shard_id,
                request.offset, request.size)
        except EcShardNotFound as e:
            context.abort(rpc.StatusCode.NOT_FOUND, str(e))
        for i in range(0, len(data), COPY_CHUNK):
            yield volume_server_pb2.VolumeEcShardReadResponse(
                data=data[i:i + COPY_CHUNK])

    def VolumeEcBlobDelete(self, request, context):
        try:
            store_ec.delete_ec_needle(self.store, request.volume_id,
                                      Needle(id=request.file_key),
                                      cache=self.read_cache)
        except EcShardNotFound as e:
            context.abort(rpc.StatusCode.NOT_FOUND, str(e))
        return volume_server_pb2.VolumeEcBlobDeleteResponse()

    def VolumeEcShardsToVolume(self, request, context):
        backend = self._ec_backend(context)
        try:
            self._codec_call(context, store_ec.ec_shards_to_volume,
                             self.store, request.volume_id,
                             request.collection, backend=backend)
        except EcShardNotFound as e:
            context.abort(rpc.StatusCode.FAILED_PRECONDITION, str(e))
        # the vid serves from a normal volume now: no EC-era entry may
        # outlive the change (writes can land again), and the EC era's
        # heat ledger resets with the tier
        self._invalidate_volume_cache(request.volume_id, "rebuild")
        self._forget_heat(request.volume_id)
        self.trigger_heartbeat()
        return volume_server_pb2.VolumeEcShardsToVolumeResponse()

    # -- rpc: scrub control plane --------------------------------------------

    def VolumeScrubStart(self, request, context):
        started = self.scrub.start(
            volume_ids=list(request.volume_ids) or None,
            throttle_mbps=request.throttle_mbps or None,
            full=request.full)
        return volume_server_pb2.VolumeScrubStartResponse(started=started)

    def VolumeScrubPause(self, request, context):
        return volume_server_pb2.VolumeScrubPauseResponse(
            paused=self.scrub.pause())

    def VolumeScrubStatus(self, request, context):
        return volume_server_pb2.VolumeScrubStatusResponse(
            **self.scrub.status())

    # -- rpc: status ---------------------------------------------------------

    def VolumeServerStatus(self, request, context):
        disks = []
        for loc in self.store.locations:
            st = os.statvfs(loc.directory)
            disks.append(volume_server_pb2.DiskStatus(
                dir=loc.directory, all=st.f_blocks * st.f_frsize,
                free=st.f_bavail * st.f_frsize,
                used=(st.f_blocks - st.f_bfree) * st.f_frsize))
        return volume_server_pb2.VolumeServerStatusResponse(
            disk_statuses=disks)

    def VolumeStatus(self, request, context):
        v = self.store.find_volume(request.volume_id)
        if v is None:
            context.abort(rpc.StatusCode.NOT_FOUND,
                          f"volume {request.volume_id} not found")
        return volume_server_pb2.VolumeStatusResponse(
            is_read_only=v.read_only)

    # -- needle data ops (shared by the HTTP handlers) -----------------------

    def read_needle(self, vid: int, n: Needle,
                    record_heat: bool = True) -> Needle:
        if self.heat is not None and record_heat:
            # counted at admission, not success: a read of a dead needle
            # still heats the volume (the lifecycle policy cares about
            # demand, not hit rate). record_heat=False when the async
            # span path already counted this request and fell back here
            # for the payload.
            self.heat.record(vid, n.id)
        if self.store.has_volume(vid):
            got = self.store.read_needle(vid, n)
        elif self.store.find_ec_volume(vid) is not None:
            got = store_ec.read_ec_needle(
                self.store, vid, n,
                remote_reader=self._make_remote_reader(vid),
                decoder=self.degraded, cache=self.read_cache)
        else:
            raise NeedleError(f"volume {vid} not found")
        if _failpoint._armed:
            got.data = _failpoint.mangle(
                "volume.read", got.data, vid=str(vid), server=self.url)
        return got

    def delete_needle(self, vid: int, n: Needle) -> int:
        """Delete on this server only (a replica's side of a fan-out)."""
        if self.store.has_volume(vid):
            size = self.store.delete_needle(vid, n)
            self._invalidate_needle_cache(vid, n.id, "delete")
            return size
        if self.store.find_ec_volume(vid) is not None:
            store_ec.delete_ec_needle(self.store, vid, n,
                                      cache=self.read_cache)
            return 0
        raise NeedleError(f"volume {vid} not found")

    def write_local(self, vid: int, n: Needle) -> int:
        """Write on this server only (a replica's side of a fan-out)."""
        _, size = self.store.write_needle(vid, n)
        self._invalidate_needle_cache(vid, n.id, "overwrite")
        return size

    # -- replication ---------------------------------------------------------

    def _other_replicas(self, vid: int) -> List[str]:
        """The other replicas' urls, cached for REPLICA_REFRESH_S."""
        now = time.monotonic()
        cached = self._replica_urls.get(vid)
        if cached is not None and now - cached[0] < REPLICA_REFRESH_S:
            return cached[1]
        try:
            resp = master_stub(self.current_master).LookupVolume(
                master_pb2.LookupVolumeRequest(volume_ids=[str(vid)]))
        except rpc.RpcError:
            # master unreachable: the stale view, if any; a POST to a
            # moved replica fails and forgets it
            return cached[1] if cached is not None else []
        urls = [loc.url for vl in resp.volume_id_locations
                for loc in vl.locations if loc.url != self.url]
        if not urls:
            # never cache an empty view: a replica mid-restart is missing
            # from the master for a pulse
            self._replica_urls.pop(vid, None)
            return urls
        self._replica_urls[vid] = (now, urls)
        return urls

    def _forget_replicas(self, vid: int) -> None:
        self._replica_urls.pop(vid, None)

    def _replica_targets(self, v, vid: int) -> List[str]:
        """The replicas a write or delete of ``vid`` must reach. Raises
        when the master knows fewer than the placement names (reference
        topology/store_replicate.go GetWritableRemoteReplications): a
        write is never acknowledged with fewer copies than asked for."""
        if v.replica_placement.copy_count <= 1:
            return []
        urls = self._other_replicas(vid)
        want = v.replica_placement.copy_count - 1
        if len(urls) < want:
            self._forget_replicas(vid)
            raise NeedleError(
                f"volume {vid} (replication {v.replica_placement}): "
                f"{len(urls)} other replicas known, {want} needed")
        return urls

    def _fan_out_replicas(self, vid: int, urls: List[str], op: str,
                          post_one) -> None:
        """``post_one(url)`` for every replica at once on the shared pool
        (reference topology/store_replicate.go). Every POST runs to its
        end, then the first error fails the request and forgets the vid's
        cached locations. An open breaker makes its POST fail at once: the
        request still fails, in microseconds instead of a connect
        timeout."""
        from seaweedfs_tpu_torch.stats.metrics import \
            IngestReplicaFanoutSecondsHistogram
        urls = _breaker.sort_candidates(urls)
        t0 = time.perf_counter()
        outcomes = self._replicate_pool.run(
            [lambda u=u: post_one(u) for u in urls])
        IngestReplicaFanoutSecondsHistogram.labels(op).observe(
            time.perf_counter() - t0)
        first_err = None
        for url, (resp, exc) in zip(urls, outcomes):
            if exc is not None:
                err = f"{op} to {url} failed: {exc}"
            elif resp.status >= 300:
                err = f"{op} to {url} failed: {resp.status}"
            else:
                continue
            if first_err is None:
                first_err = err
        if first_err is not None:
            self._forget_replicas(vid)
            raise NeedleError(first_err)

    def replicated_write(self, vid: int, n: Needle,
                         fsync: bool = False) -> int:
        """Write here, then to every other replica at once (reference
        topology/store_replicate.go:21-94). Returns after every replica
        answered; a volume of one copy never asks the master."""
        v = self.store.find_volume(vid)
        if v is not None and v.read_only:
            raise NeedleError(f"volume {vid} is read only")
        urls = self._replica_targets(v, vid) if v is not None else []
        _, size = self.store.write_needle(vid, n, fsync=fsync)
        self._invalidate_needle_cache(vid, n.id, "overwrite")
        if not urls:
            return size
        blob = n.to_bytes()

        def post_one(url):
            return http_client.request(
                "POST", f"{url}/admin/replicate?volume={vid}", body=blob,
                headers={"Content-Type": "application/octet-stream"},
                timeout=30)

        self._fan_out_replicas(vid, urls, "replicate", post_one)
        return size

    def replicated_delete(self, vid: int, n: Needle) -> int:
        v = self.store.find_volume(vid)
        urls = self._replica_targets(v, vid) if v is not None else None
        size = self.delete_needle(vid, n)
        if urls is None:
            # an EC volume: every other shard holder tombstones the
            # needle in its .ecx too
            urls = self._other_replicas(vid)
        if not urls:
            return size

        def post_one(url):
            return http_client.request(
                "POST", f"{url}/admin/replicate_delete"
                f"?volume={vid}&key={n.id:x}&cookie={n.cookie:08x}",
                timeout=30)

        self._fan_out_replicas(vid, urls, "replicate_delete", post_one)
        return size

    def _fetch_needle_from_replica(self, vid: int, corrupt: Needle):
        """Scrub's repair source: one needle's stored payload from any
        OTHER replica. Accept-Encoding gzip keeps a compressed needle's
        bytes as stored. The planner checks what comes back against the
        local record's stored CRC, so a stale or corrupt copy is refused,
        never written."""
        fid = f"{vid},{corrupt.id:x}{corrupt.cookie:08x}"
        for url in _breaker.sort_candidates(self._other_replicas(vid)):
            try:
                resp = http_client.request(
                    "GET", f"{url}/{fid}?cm=false",
                    headers={"Accept-Encoding": "gzip"}, timeout=30)
            except OSError:
                continue
            if resp.status == 200:
                return resp.body
        return None

    # -- read-cache invalidation ---------------------------------------------

    def _invalidate_needle_cache(self, vid: int, needle_id: int,
                                 reason: str) -> None:
        if self.read_cache is not None:
            self.read_cache.invalidate(vid, needle_id, reason)

    def _invalidate_volume_cache(self, vid: int,
                                 reason: str = "scrub_repair") -> None:
        """The vid's bytes or EC layout changed here: drop its cached
        entries and its cached shard locations. A location map kept from
        an earlier EC incarnation (decode, vacuum, encode again) names
        holders that no longer have those shards, and with 14 entries it
        would be trusted for 37 minutes. The vid's cached replica
        locations go too: a move, copy or placement change makes them
        stale."""
        self._ec_locations.pop(vid, None)
        self._replica_urls.pop(vid, None)
        if self.read_cache is not None:
            self.read_cache.invalidate_volume(vid, reason)

    def _make_remote_reader(self, vid: int):
        def fetch_shard(url: str, shard_id: int, offset: int,
                        length: int) -> bytes:
            # deadline: a hung peer must fail this row, not pin the
            # caller (the decode fleet's workers ride this reader)
            chunks = [r.data for r in volume_stub(url).VolumeEcShardRead(
                volume_server_pb2.VolumeEcShardReadRequest(
                    volume_id=vid, shard_id=shard_id, offset=offset,
                    size=length), timeout=REMOTE_READ_TIMEOUT_S)]
            data = b"".join(chunks)
            if len(data) != length:
                raise EcShardNotFound(
                    f"vid {vid} shard {shard_id}: short remote read")
            return data

        def remote_reader(shard_id: int, offset: int, length: int):
            # open-breaker holders last (reference store_ec.go)
            urls = _breaker.sort_candidates(
                [u for u in self._ec_shard_locations(vid).get(shard_id, [])
                 if u != self.url])
            if self.hedger is not None and len(urls) > 1:
                # a stalled holder hedges to the next one after the
                # tracked p95; the first response wins
                try:
                    return self.hedger.fetch(
                        [lambda u=u: fetch_shard(u, shard_id, offset,
                                                 length) for u in urls])
                except _deadline.DeadlineExceeded:
                    # a spent budget is the client's state, not evidence
                    # against these holders: never forget them for it
                    raise
                except (rpc.RpcError, OSError, EcShardNotFound):
                    pass
            else:
                for url in urls:
                    try:
                        return fetch_shard(url, shard_id, offset, length)
                    except (rpc.RpcError, EcShardNotFound):
                        continue
            if urls:
                # every known holder failed: forget this shard's
                # locations so reads stop redialing a dead node
                # (reference forgetShardId, store_ec.go:214-219)
                self._forget_ec_shard(vid, shard_id)
            return None
        return remote_reader

    def _ec_shard_locations(self, vid: int) -> Dict[int, List[str]]:
        now = time.monotonic()
        cached = self._ec_locations.get(vid)
        if cached is not None:
            ts, locs = cached
            if len(locs) >= TOTAL_SHARDS:
                window = EC_REFRESH_FULL_S
            elif len(locs) >= DATA_SHARDS:
                window = EC_REFRESH_PARTIAL_S
            else:
                window = EC_REFRESH_SPARSE_S
            if now - ts < window:
                return locs
        locs = dict(cached[1]) if cached is not None else {}
        try:
            resp = master_stub(self.current_master).LookupEcVolume(
                master_pb2.LookupEcVolumeRequest(volume_id=vid))
            # merge per shard (store_ec.go:249-257): shards absent from
            # the answer keep their last-known urls
            for sl in resp.shard_id_locations:
                locs[sl.shard_id] = [l.url for l in sl.locations]
        except rpc.RpcError:
            # master unreachable: serve the stale view, and don't poison
            # the cache with an empty map
            return cached[1] if cached is not None else {}
        self._ec_locations[vid] = (now, locs)
        return locs

    def _forget_ec_shard(self, vid: int, shard_id: int) -> None:
        cached = self._ec_locations.get(vid)
        if cached is not None:
            cached[1].pop(shard_id, None)


# -- HTTP layer ----------------------------------------------------------------


def parse_byte_range(rng: str, total: int) -> Tuple[int, int]:
    """Parse a single "bytes=a-b" / "bytes=a-" / "bytes=-n" header against
    a payload of `total` bytes. Returns (start, end) inclusive; raises
    ValueError on anything unsatisfiable (HTTP 416)."""
    start_s, _, end_s = rng[len("bytes="):].partition("-")
    if not start_s:  # suffix range: last N bytes
        start = max(0, total - int(end_s))
        end = total - 1
    else:
        start = int(start_s)
        end = int(end_s) if end_s else total - 1
    end = min(end, total - 1)
    if start > end or start < 0:
        raise ValueError(f"unsatisfiable range {rng!r} for {total}")
    return start, end


def content_disposition(name: str) -> str:
    """inline; filename=... with CR/LF/quotes stripped, so a name cannot
    split the response into injected headers."""
    safe = name.replace("\r", "").replace("\n", "").replace('"', "")
    return f'inline; filename="{safe}"'


def parse_multipart(content_type: str, body: bytes):
    """(filename, mime, data, encoding) of the first file part, where
    encoding is the part's Content-Encoding (reference
    needle_parse_upload.go)."""
    fallback = None
    for _name, filename, headers, data in iter_parts(content_type, body):
        mime = headers.get("content-type", "")
        encoding = headers.get("content-encoding", "")
        if filename:
            return filename, mime, data, encoding
        if fallback is None:
            fallback = ("", mime, data, encoding)
    if fallback is None:
        raise ValueError("empty multipart body")
    return fallback


def _make_http_handler(vs: VolumeServer):
    class Handler(FastHandler):
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):
            pass

        def _json(self, payload: dict, code: int = 200) -> None:
            self.fast_reply(code, json.dumps(payload).encode(),
                            ctype="application/json")

        def _parse_path(self):
            """/<vid>,<key_hex><cookie_hex> and the query parameters."""
            path, sep, query = self.path.partition("?")
            return parse_fid(path.lstrip("/")), \
                (parse_qs(query) if sep else {})

        # -- read ------------------------------------------------------------

        def do_GET(self):
            upath = self.path.partition("?")[0]
            if upath == "/status":
                self._json(self.server_status())
                return
            if upath == "/qos/status":
                # the data plane's own QoS admission state (the master
                # gathers these under /cluster/qos)
                from seaweedfs_tpu_torch import qos
                mgr = qos.manager()
                self._json(mgr.status() if mgr is not None
                           else {"enabled": False})
                return
            if upath in ("/debug/trace", "/debug/requests"):
                # the cluster-trace collector and flight recorder on the
                # data port: cluster.trace fans out over topology node
                # urls, which are HTTP ports, not metrics ports
                from seaweedfs_tpu_torch.stats import cluster_trace
                self._json(cluster_trace.debug_payload(
                    self.path, "volumeServer", vs.url))
                return
            if upath in ("/ui", "/ui/"):
                self._ui()
                return
            try:
                f, params = self._parse_path()
            except ValueError as e:
                self._json({"error": str(e)}, code=404)
                return
            if not vs.store.has_volume(f.volume_id) and \
                    vs.store.find_ec_volume(f.volume_id) is None:
                self._redirect(f)
                return
            record_heat = True
            if self.async_conn is not None and vs.serve.sendfile and \
                    not _failpoint._armed and \
                    vs.store.has_volume(f.volume_id):
                # the zero-copy path: the payload rides os.sendfile from
                # the volume fd to the socket. It hands back to the byte
                # path whenever the payload itself is needed (compressed,
                # chunk manifest, image resize, armed failpoints, strict
                # read verification)
                if self._try_send_needle_span(f, params):
                    return
                record_heat = False   # the span path counted this read
            try:
                got = vs.read_needle(f.volume_id,
                                     Needle(id=f.key, cookie=f.cookie),
                                     record_heat=record_heat)
                _deadline.check(f"volume {f.volume_id} read")
            except CookieMismatch:
                self.fast_reply(404)
                return
            except _deadline.DeadlineExceeded as e:
                self._json({"error": str(e)}, code=504)
                return
            except _failpoint.FailpointError as e:
                self._json({"error": str(e)}, code=500)
                return
            except DataCorruptionError as e:
                # corrupt is not missing: 500, and the scrub counter
                # flags it for repair
                ScrubCorruptionsFoundCounter.labels("read").inc()
                self._json({"error": str(e)}, code=500)
                return
            except (NeedleError, EcShardNotFound) as e:
                self._json({"error": str(e)}, code=404)
                return
            except Exception as e:  # noqa: BLE001 - a failed read is a 500
                log.exception("read %s failed", self.path)
                self._json({"error": f"{type(e).__name__}: {e}"}, code=500)
                return
            if got.is_chunk_manifest and \
                    params.get("cm", [""])[0] != "false" and \
                    self._send_chunked(got):
                return
            self._send_needle(got, params)

        do_HEAD = do_GET

        def server_status(self) -> dict:
            return {
                "Version": "seaweedfs-tpu-torch",
                "Volumes": [Store.volume_info(v)
                            for loc in vs.store.locations
                            for v in list(loc.volumes.values())],
                "Scrub": vs.scrub.status(),
                "Cache": vs.read_cache.stats()
                if vs.read_cache is not None else {"enabled": False},
                "Heat": vs.heat.snapshot()
                if vs.heat is not None else {"enabled": False},
            }

        def _ui(self) -> None:
            """A plain page of this server's volumes (reference
            volume_server_ui/); the collection names are escaped."""
            import html as _html
            st = self.server_status()
            rows = "".join(
                f"<tr><td>{v['id']}</td>"
                f"<td>{_html.escape(v.get('collection') or '')}"
                f"</td><td>{v['size']}</td><td>{v['file_count']}</td>"
                f"<td>{'ro' if v.get('read_only') else 'rw'}</td></tr>"
                for v in st["Volumes"])
            body = ("<html><head><title>seaweedfs-tpu volume</title>"
                    f"</head><body><h1>Volume server {vs.url}</h1>"
                    f"<p>master: {vs.current_master}</p>"
                    "<table border=1 cellpadding=4><tr><th>vid</th>"
                    "<th>collection</th><th>size</th><th>files</th>"
                    "<th>mode</th></tr>" + rows + "</table>"
                    "</body></html>").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_chunked(self, got: Needle) -> bool:
            """Serve the file a chunk-manifest needle lists (reference
            volume_server_handlers_read.go:180-216 tryHandleChunkedFile).
            False for a manifest that does not parse: it is then served
            as the raw needle."""
            from seaweedfs_tpu_torch.operation.chunked_file import (
                ChunkedFileReader, load_chunk_manifest)
            try:
                cm = load_chunk_manifest(got.data, got.is_compressed)
            except (ValueError, KeyError, TypeError):
                log.warning("volume %s: unparseable chunk manifest",
                            self.path)
                return False
            reader = ChunkedFileReader(cm.chunks, vs.current_master)
            total = reader.total_size
            headers = {"X-File-Store": "chunked", "Accept-Ranges": "bytes"}
            name = cm.name or (got.name.decode("utf-8", "replace")
                               if got.name else "")
            if name:
                headers["Content-Disposition"] = content_disposition(name)
            if cm.mime and not cm.mime.startswith(
                    "application/octet-stream"):
                headers["Content-Type"] = cm.mime
            status, start, length = 200, 0, total
            rng = self.headers.get("range")
            if rng and rng.startswith("bytes="):
                try:
                    start, end = parse_byte_range(rng, total)
                except ValueError:
                    # RFC 7233 4.4: a 416 carries the representation size
                    self.fast_reply(416, headers={
                        "Content-Range": f"bytes */{total}"})
                    return True
                status = 206
                length = end - start + 1
                headers["Content-Range"] = f"bytes {start}-{end}/{total}"
            if self.command == "HEAD":
                self.wfile.write(self._head_bytes(status, length, headers))
                return True
            chunk_errors = (RuntimeError, OSError, rpc.RpcError)
            if length <= CHUNKED_BUFFER_BYTES:
                try:
                    body = b"".join(reader.stream(start, length))
                except chunk_errors as e:
                    self._json({"error": f"read chunks: {e}"}, code=500)
                    return True
                self.fast_reply(status, body, headers)
                return True
            self.wfile.write(self._head_bytes(status, None, headers))
            try:
                for block in reader.stream(start, length):
                    self.wfile.write(b"%x\r\n%b\r\n" % (len(block), block))
            except chunk_errors as e:
                # no last chunk: the client sees the body cut off
                log.warning("chunked read %s failed: %s", self.path, e)
                self.close_connection = True
                return True
            self.wfile.write(b"0\r\n\r\n")
            return True

        def _redirect(self, f) -> None:
            try:
                resp = master_stub(vs.current_master).LookupVolume(
                    master_pb2.LookupVolumeRequest(
                        volume_ids=[str(f.volume_id)]))
            except rpc.RpcError:
                self._json({"error": "master unreachable"}, code=500)
                return
            candidates = [loc for vl in resp.volume_id_locations
                          for loc in vl.locations if loc.url != vs.url]
            if candidates:
                # never send a reader to a peer known dead while a
                # healthier replica exists
                loc = min(candidates,
                          key=lambda l: 1 if _breaker.is_open(l.url) else 0)
                self.fast_reply(302, headers={
                    "Location": f"http://{loc.public_url or loc.url}/{f}"})
                return
            self._json({"error": f"volume {f.volume_id} not found"},
                       code=404)

        def _try_send_needle_span(self, f, params: dict) -> bool:
            """The async zero-copy GET: resolve the needle's payload span
            and reply through send_span (os.sendfile on the async
            connection). True when a reply went out; False hands the
            request to the byte path, which must not count its heat
            again. Every reply here is byte-identical to _send_needle's
            and do_GET's."""
            if vs.heat is not None:
                # counted at admission, where read_needle counts it
                vs.heat.record(f.volume_id, f.key)
            n = Needle(id=f.key, cookie=f.cookie)
            try:
                got_span = vs.store.read_needle_span(f.volume_id, n)
            except CookieMismatch:
                self.fast_reply(404)
                return True
            except NeedleError as e:
                self._json({"error": str(e)}, code=404)
                return True
            if got_span is None:
                return False
            got, span = got_span
            try:
                _deadline.check(f"volume {f.volume_id} read")
            except _deadline.DeadlineExceeded as e:
                span.close()
                self._json({"error": str(e)}, code=504)
                return True
            mime = got.mime.decode("utf-8", "replace") if got.mime else ""
            if got.is_compressed or \
                    (got.is_chunk_manifest and
                     params.get("cm", [""])[0] != "false") or \
                    (mime.startswith("image/") and
                     ("width" in params or "height" in params)):
                # the payload itself is needed: the byte path serves it
                span.close()
                return False
            etag = f'"{got.etag}"'
            if self.headers.get("if-none-match") == etag:
                span.close()
                self.fast_reply(304)
                return True
            headers = {"ETag": etag, "Accept-Ranges": "bytes"}
            if got.name:
                headers["Content-Disposition"] = content_disposition(
                    got.name.decode("utf-8", "replace"))
            if mime:
                headers["Content-Type"] = mime
            rng = self.headers.get("range")
            if rng and rng.startswith("bytes="):
                try:
                    start, end = parse_byte_range(rng, span.length)
                except ValueError:
                    span.close()
                    # RFC 7233 4.4: a 416 carries the representation size
                    self.fast_reply(416, headers={
                        "Content-Range": f"bytes */{span.length}"})
                    return True
                headers["Content-Range"] = \
                    f"bytes {start}-{end}/{span.length}"
                span.offset += start
                span.length = end - start + 1
                self.send_span(206, span, headers)
                return True
            self.send_span(200, span, headers)
            return True

        def _send_needle(self, got: Needle, params: dict) -> None:
            etag = f'"{got.etag}"'
            if self.headers.get("if-none-match") == etag:
                self.fast_reply(304)
                return
            data = got.data
            headers = {"ETag": etag, "Accept-Ranges": "bytes"}
            if got.name:
                headers["Content-Disposition"] = content_disposition(
                    got.name.decode("utf-8", "replace"))
            mime = got.mime.decode("utf-8", "replace") if got.mime else ""
            if mime:
                headers["Content-Type"] = mime
            want_resize = mime.startswith("image/") and \
                ("width" in params or "height" in params)
            if got.is_compressed:
                if not want_resize and "gzip" in (
                        self.headers.get("accept-encoding") or ""):
                    headers["Content-Encoding"] = "gzip"
                else:
                    data = gzip.decompress(data)
            if want_resize:
                # EXIF-upright, then resize, as the reference read
                # handler does (volume_server_handlers_read.go:219-243)
                from seaweedfs_tpu_torch.images import (fix_orientation,
                                                        resized)
                data = fix_orientation(data, mime)
                try:
                    width = int(params.get("width", ["0"])[0] or 0)
                    height = int(params.get("height", ["0"])[0] or 0)
                except ValueError:
                    width = height = 0
                data, _, _ = resized(data, mime, width=width, height=height,
                                     mode=params.get("mode", [""])[0])
            rng = self.headers.get("range")
            if rng and rng.startswith("bytes=") and not got.is_compressed:
                try:
                    start, end = parse_byte_range(rng, len(data))
                except ValueError:
                    self.fast_reply(416, headers={
                        "Content-Range": f"bytes */{len(data)}"})
                    return
                headers["Content-Range"] = f"bytes {start}-{end}/{len(data)}"
                self.fast_reply(206, data[start:end + 1], headers)
                return
            self.fast_reply(200, data, headers)

        # -- write -----------------------------------------------------------

        def do_POST(self):
            upath, sep, query = self.path.partition("?")
            if upath in ("/admin/replicate", "/admin/replicate_delete"):
                params = parse_qs(query) if sep else {}
                if upath == "/admin/replicate":
                    self._handle_replicate(params)
                else:
                    self._handle_replicate_delete(params)
                return
            try:
                f, params = self._parse_path()
            except ValueError as e:
                self._json({"error": str(e)}, code=400)
                return
            body = self.read_body()
            ctype = self.headers.get("content-type") or ""
            encoding = self.headers.get("content-encoding") or ""
            filename, mime, data = "", ctype, body
            if ctype.startswith("multipart/form-data"):
                try:
                    filename, mime, data, part_enc = \
                        parse_multipart(ctype, body)
                except ValueError as e:
                    self._json({"error": str(e)}, code=400)
                    return
                encoding = part_enc or encoding
            ttl_s = params.get("ttl", [""])[0]
            flags = FLAG_IS_COMPRESSED if encoding.lower() == "gzip" else 0
            if params.get("cm", [""])[0].lower() == "true":
                # a chunk manifest (reference needle_parse_upload.go:180)
                flags |= FLAG_IS_CHUNK_MANIFEST
            n = Needle(id=f.key, cookie=f.cookie, data=data, flags=flags,
                       name=filename.encode() if filename else b"",
                       mime=mime.encode() if mime and
                       mime != "application/octet-stream" else b"",
                       ttl=TTL.parse(ttl_s) if ttl_s else None)
            try:
                if params.get("type", [""])[0] == "replicate":
                    size = vs.write_local(f.volume_id, n)
                else:
                    size = vs.replicated_write(f.volume_id, n,
                                               fsync="fsync" in params)
            except (NeedleError, VolumeError) as e:
                self._json({"error": str(e)}, code=500)
                return
            self._json({"name": filename, "size": size, "eTag": n.etag},
                       code=201)

        do_PUT = do_POST

        def _handle_replicate(self, params: dict) -> None:
            """A replica's side of a write: the needle as its primary
            serialized it."""
            try:
                vid = int(params["volume"][0])
                n = Needle.from_bytes(self.read_body())
                vs.write_local(vid, n)
            except (KeyError, ValueError) as e:
                self._json({"error": f"bad replicate request: {e}"},
                           code=400)
                return
            except (NeedleError, VolumeError) as e:
                self._json({"error": str(e)}, code=500)
                return
            self._json({"size": n.size}, code=201)

        def _handle_replicate_delete(self, params: dict) -> None:
            try:
                vid = int(params["volume"][0])
                n = Needle(id=int(params["key"][0], 16),
                           cookie=int(params["cookie"][0], 16))
            except (KeyError, ValueError) as e:
                self._json({"error": f"bad replicate request: {e}"},
                           code=400)
                return
            try:
                vs.delete_needle(vid, n)
            except (NeedleError, EcShardNotFound) as e:
                self._json({"error": str(e)}, code=404)
                return
            self._json({}, code=202)

        # -- delete ----------------------------------------------------------

        def do_DELETE(self):
            try:
                f, params = self._parse_path()
            except ValueError as e:
                self._json({"error": str(e)}, code=400)
                return
            n = Needle(id=f.key, cookie=f.cookie)
            try:
                got = vs.read_needle(f.volume_id, n)
                if got.cookie != f.cookie:
                    self._json({"error": "cookie mismatch"}, code=403)
                    return
                chunked_size = None
                if got.is_chunk_manifest:
                    # every chunk goes before the manifest (reference
                    # volume_server_handlers_write.go:124-137); a chunk
                    # that fails keeps the manifest, so the delete can
                    # run again
                    from seaweedfs_tpu_torch.operation.chunked_file \
                        import load_chunk_manifest
                    try:
                        cm = load_chunk_manifest(got.data,
                                                 got.is_compressed)
                    except (ValueError, KeyError, TypeError) as e:
                        self._json({"error":
                                    f"load chunks manifest: {e}"},
                                   code=500)
                        return
                    try:
                        cm.delete_chunks(vs.current_master)
                    except (RuntimeError, OSError, rpc.RpcError) as e:
                        self._json({"error": f"delete chunks: {e}"},
                                   code=500)
                        return
                    chunked_size = cm.size
                if params.get("type", [""])[0] == "replicate":
                    size = vs.delete_needle(f.volume_id, n)
                else:
                    size = vs.replicated_delete(f.volume_id, n)
                if chunked_size is not None:
                    size = chunked_size
            except CookieMismatch:
                self._json({"error": "cookie mismatch"}, code=403)
                return
            except (NeedleError, EcShardNotFound, VolumeError) as e:
                self._json({"error": str(e)}, code=404)
                return
            self._json({"size": size}, code=202)

    # request counter + latency + trace span (+ QoS admission) per HTTP
    # verb, through the shared role wrapper
    from seaweedfs_tpu_torch.stats.metrics import instrument_http_handler
    return instrument_http_handler(Handler, "volumeServer")
