"""MasterClient: a live vid -> location map and the raft leader.

The port of ``seaweedfs_tpu.wdclient.masterclient``. It holds a
KeepConnected stream to the master (the port's RPC transport); the
stream's deltas keep the VidMap fresh, so data-path clients seldom ask
the master. A follower answers the stream with the leader's address, and
the client follows it there.

Reconnects: each full failed rotation over the configured masters backs
off exponentially with full jitter (U(0, wait), wait doubling to a 5 s
cap), resets on any established stream, and counts redials in
SeaweedFS_master_reconnects_total. With breakers enabled a master that
refuses streams repeatedly is skipped until its cooldown.

Reference: weed/wdclient/masterclient.go:16-160.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import master_pb2, master_stub
from seaweedfs_tpu_torch.resilience import breaker
from seaweedfs_tpu_torch.wdclient.vid_map import Location, VidMap

RECONNECT_WAIT_S = 0.2     # first backoff step after a failed rotation
RECONNECT_WAIT_CAP_S = 5.0


class MasterUnreachable(TimeoutError):
    """No configured master produced a KeepConnected stream in time.
    Subclasses TimeoutError so pre-existing callers keep catching it."""

    def __init__(self, masters: List[str], timeout: float):
        super().__init__(
            f"no master reachable within {timeout:.1f}s "
            f"(tried {', '.join(masters)})")
        self.masters = list(masters)


class MasterClient:
    def __init__(self, masters: List[str], client_name: str = "client",
                 grpc_port: int = 0):
        if not masters:
            raise ValueError("need at least one master address")
        self.masters = masters
        self.client_name = client_name
        self.grpc_port = grpc_port  # advertised via ListMasterClients
        self.current_master = masters[0]
        self.vid_map = VidMap()
        self.reconnects = 0   # redials after the initial dial (ledger)
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream = None
        self._dialed = False
        # the coalescing single-flight + TTL cache over the miss path:
        # absent, not merely empty, unless enabled, so the disabled miss
        # path is one None check. The KeepConnected-fed vid_map stays the
        # first stop either way.
        from seaweedfs_tpu_torch.wdclient import lookup_cache as _lc
        self._lookup_cache = _lc.make_cache(self._lookup_batch) \
            if _lc.enabled else None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MasterClient":
        # lint: thread-ok(keep-connected daemon; reconnects use their own jittered backoff)
        self._thread = threading.Thread(
            target=self._keep_connected_loop,
            name=f"masterclient-{self.client_name}", daemon=True)
        self._thread.start()
        return self

    def wait_until_connected(self, timeout: float = 10.0) -> None:
        if not self._ready.wait(timeout):
            raise MasterUnreachable(self.masters, timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._stream is not None:
            self._stream.cancel()

    # -- stream --------------------------------------------------------------

    def _keep_connected_loop(self) -> None:
        wait = RECONNECT_WAIT_S
        while not self._stop.is_set():
            progressed = False
            for target in [self.current_master] + \
                    [m for m in self.masters if m != self.current_master]:
                if self._stop.is_set():
                    return
                if breaker.enabled and target != self.current_master:
                    # skip a master whose breaker is open — EXCEPT the
                    # current one, which stays the half-open probe path
                    if breaker.is_open(target):
                        continue
                try:
                    breaker.check(target)
                except breaker.BreakerOpen:
                    continue   # a refusal is not evidence of failure
                if self._follow(target):
                    progressed = True
            if self._stop.is_set():
                return
            if progressed:
                wait = RECONNECT_WAIT_S
                continue
            # full rotation failed: full-jitter exponential backoff so
            # a fleet of clients does not synchronize on the masters
            self._stop.wait(timeout=random.random() * wait)
            wait = min(wait * 2, RECONNECT_WAIT_CAP_S)

    def _follow(self, target: str) -> bool:
        """One KeepConnected stream's lifetime. Returns True when the
        stream established (>= 1 message), i.e. the redial backoff
        should reset. Never raises — ANY failure here (RPC, an armed
        rpc.call failpoint's OSError, anything) must cost one rotation
        step, never the keep-connected thread itself."""
        if self._dialed:
            self.reconnects += 1
            from seaweedfs_tpu_torch.stats.metrics import MasterReconnectsCounter
            MasterReconnectsCounter.inc()
        self._dialed = True
        established = False
        try:
            stub = master_stub(target)
            self._stream = stub.KeepConnected(iter(
                [master_pb2.KeepConnectedRequest(name=self.client_name,
                                                 grpc_port=self.grpc_port)]))
            for loc in self._stream:
                if not established:
                    established = True
                    breaker.record(target, True)
                if self._stop.is_set():
                    return established
                self.current_master = target
                if loc.leader and loc.leader != target:
                    # not the leader: reconnect there next
                    self.current_master = loc.leader
                    self._stream.cancel()
                    return established
                self._apply(loc)
                self._ready.set()
        except Exception:  # noqa: BLE001 - see docstring
            from seaweedfs_tpu_torch.stats import metrics
            metrics.swallowed("masterclient.follow")
        # a stream that BROKE after establishing is not a dead master;
        # a dial that never produced a message — whether it raised or
        # closed cleanly empty — is, and MUST be recorded: breaker
        # half-open probes are reclaimed by record(), so an unrecorded
        # probe would wedge the peer's breaker
        if not established:
            breaker.record(target, False)
        return established

    def _apply(self, loc: master_pb2.VolumeLocation) -> None:
        if loc.url:
            l = Location(loc.url, loc.public_url or loc.url)
            for vid in loc.new_vids:
                self.vid_map.add_location(vid, l)
            for vid in loc.deleted_vids:
                self.vid_map.delete_location(vid, loc.url)

    # -- lookups -------------------------------------------------------------

    def lookup(self, vid: int) -> List[Location]:
        locs = self.vid_map.lookup(vid)
        if locs:
            return locs
        if self._lookup_cache is not None:
            # coalesced + single-flighted + TTL'd (incl. negative)
            return list(self._lookup_cache.lookup(vid).locations)
        # cache miss: ask the master directly and backfill
        try:
            resp = master_stub(self.current_master).LookupVolume(
                master_pb2.LookupVolumeRequest(volume_ids=[str(vid)]))
        except rpc.RpcError:
            return []
        for vl in resp.volume_id_locations:
            for l in vl.locations:
                self.vid_map.add_location(vid, Location(l.url, l.public_url))
        return self.vid_map.lookup(vid)

    @property
    def lookup_cache_enabled(self) -> bool:
        """True when the coalescing cache is armed — the one check
        callers pay before batch-prefetching (disabled: no prefetch,
        the lazy per-chunk path is byte-identical to the old one)."""
        return self._lookup_cache is not None

    def lookup_many(self, vids) -> Dict[int, List[Location]]:
        """Resolve many vids at once: stream-fed vid_map hits answer
        locally, every miss rides ONE batched LookupVolume through the
        coalescing cache — a 64-chunk read's locations in one master
        round trip. Without the cache (disabled) this is exactly a
        loop over lookup(), so behavior off is unchanged."""
        out: Dict[int, List[Location]] = {}
        misses: List[int] = []
        for vid in dict.fromkeys(vids):
            locs = self.vid_map.lookup(vid)
            if locs:
                out[vid] = locs
            else:
                misses.append(vid)
        if not misses:
            return out
        if self._lookup_cache is not None:
            for vid, res in self._lookup_cache.lookup_many(misses).items():
                out[vid] = list(res.locations)
        else:
            for vid in misses:
                out[vid] = self.lookup(vid)
        return out

    def invalidate_lookup(self, vid: int,
                          reason: str = "read_failure") -> None:
        """A caller failed to read from every location lookup()
        returned: drop the cached belief so the next lookup re-asks."""
        if self._lookup_cache is not None:
            self._lookup_cache.invalidate(vid, reason)

    def _lookup_batch(self, vids: List[int]):
        """Batched LookupVolume against the current master: the
        coalescing cache's RPC transport. Raises on transport failure
        (the cache answers waiters and caches nothing)."""
        from seaweedfs_tpu_torch.wdclient.lookup_cache import LookupResult
        resp = master_stub(self.current_master).LookupVolume(
            master_pb2.LookupVolumeRequest(
                volume_ids=[str(v) for v in vids]))
        out: Dict[int, LookupResult] = {}
        for vl in resp.volume_id_locations:
            try:
                vid = int(vl.volume_id.split(",")[0])
            except ValueError:
                continue
            if vl.error:
                out[vid] = LookupResult((), vl.error)
            else:
                out[vid] = LookupResult(tuple(
                    Location(l.url, l.public_url or l.url)
                    for l in vl.locations), "")
        return out

    def lookup_file_id(self, fid: str) -> str:
        from seaweedfs_tpu_torch.operation.file_id import parse_fid
        vid = parse_fid(fid).volume_id
        locs = self.lookup(vid)
        if not locs:
            raise KeyError(f"volume {vid} has no known locations")
        return f"{locs[0].url}/{fid}"
