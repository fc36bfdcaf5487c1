"""Scrub daemon: the volume server's background integrity thread.

The counterpart of ``seaweedfs_tpu.scrub.daemon``. One daemon per server.
Constructing it costs nothing (no thread, no IO, no CUDA context) until
start() or a pass. A pass walks every mounted volume and EC volume:

  1. needle sweep per normal volume (scanner.scan_volume), corrupt
     needles fetched again from replicas (planner.repair_needle);
  2. needle sweep per EC volume over local shards, localizing bad data
     shards by exclusion (the reconstruct runs on the card);
  3. ONE fused stripe verify across ALL the server's EC volumes: the
     fleet verify on the card, or with ``mesh_cfg`` the unified mesh
     scheduler (``parallel/mesh_fleet.pod_verify_ec_files``), which
     compares the recomputed parity on the card;
  4. per damaged EC volume: classify -> quarantine .corrupt -> fleet
     rebuild -> verify again (a data repair un-contaminates the parity
     evidence; round two condemns genuinely bad parity).

Pacing rides util.throttler.Throttler. pause() takes effect at volume
granularity; start() on a paused daemon resumes it. Counters feed
status() and the SeaweedFS_scrub_* families. Unlike the JAX package, a
pass does not run under the QoS internal tenant: QoS is not ported.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from seaweedfs_tpu_torch.ec import fleet
from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon
from seaweedfs_tpu_torch.scrub import planner, scanner
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.stats.metrics import (
    ScrubCorruptionsFoundCounter, ScrubCorruptionsRepairedCounter,
    ScrubNeedlesVerifiedCounter, ScrubPassSecondsHistogram,
    ScrubScanLagGauge, ScrubScannedBytesCounter,
    ScrubStripesVerifiedCounter, ScrubUnrecoverableCounter)
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.util.throttler import Throttler

log = logging.getLogger(__name__)


@dataclass
class PassResult:
    """What one scrub pass saw and did."""

    bytes_scanned: int = 0
    needles_verified: int = 0
    stripes_verified: int = 0
    corruptions_found: int = 0
    corruptions_repaired: int = 0
    unrecoverable: int = 0
    volumes: int = 0
    ec_volumes: int = 0
    details: List[str] = field(default_factory=list)


class ScrubPaused(Exception):
    """Raised inside a pass when stop() interrupts it."""


class ScrubDaemon:
    """start/pause/status control plane over the scanner + planner. The
    RS work runs on the card unless ``backend="cpu"``."""

    def __init__(self, store: Store, mbps: float = 0.0,
                 backend: str = "cuda", interval_s: float = 0.0,
                 replica_fetch: Optional[Callable] = None,
                 export_lag: bool = True,
                 on_repair: Optional[Callable[[int], None]] = None,
                 mesh_cfg: Optional[dict] = None):
        self.store = store
        self.mbps = mbps
        self.backend = backend
        self.interval_s = interval_s
        self.replica_fetch = replica_fetch
        # when set, the fused stripe verify rides the unified mesh
        # scheduler (pod_verify_ec_files with these keywords), which
        # falls back to the fleet verify on a scheduler failure
        self.mesh_cfg = mesh_cfg
        # on_repair(vid) fires after scrub rewrites any bytes of a volume
        # (needle rewrite or EC shard reconstruction)
        self.on_repair = on_repair
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None  # guarded_by(self._lock)
        self._resume = threading.Event()
        self._resume.set()            # not paused
        self._wake = threading.Event()  # interval sleep interrupt
        # the pass thread polls these lock-free; every WRITE takes the
        # lock so start/stop/pause serialize against each other
        self._stopping = False  # guarded_by(self._lock, writes)
        # overrides for the FIRST pass of a freshly started thread only,
        # written under the lock before the thread spawns
        self._pass_volume_ids: Optional[List[int]] = None  # guarded_by(self._lock, writes)
        self._pass_mbps: Optional[float] = None  # guarded_by(self._lock, writes)
        self._state = "idle"  # guarded_by(self._lock, writes)
        self.current_volume_id = 0
        self.passes_completed = 0
        self.last_pass_unix = 0.0
        self.totals = PassResult()
        if export_lag:
            # weakref: the gauge is process-global and must neither pin a
            # dead daemon's Store in memory nor keep reporting it
            ref = weakref.ref(self)
            ScrubScanLagGauge.set_function(
                lambda: d._scan_lag() if (d := ref()) is not None else 0.0)

    def _scan_lag(self) -> float:
        """Seconds since the last completed pass, evaluated at metric
        collection time, so a stalled scrubber's lag keeps growing."""
        return round(time.time() - self.last_pass_unix, 3) \
            if self.last_pass_unix else 0.0

    # -- control -------------------------------------------------------------

    def start(self, volume_ids: Optional[Sequence[int]] = None,
              throttle_mbps: Optional[float] = None,
              full: bool = False) -> bool:
        """Begin a pass (or resume a paused one). Returns False when a
        pass is already running un-paused, and then changes nothing."""
        with self._lock:
            if self._stopping:
                return False
            if self._thread is not None and self._thread.is_alive():
                if not self._resume.is_set():
                    self._state = "running"
                    self._resume.set()   # un-pause
                    return True
                self._wake.set()         # cut an interval sleep short
                return False
            if full:
                self.totals = PassResult()
                self.passes_completed = 0
            # overrides apply to the first pass only; the interval loop
            # reverts to whole-store scope and the server budget
            self._pass_volume_ids = list(volume_ids) if volume_ids else None
            self._pass_mbps = throttle_mbps \
                if throttle_mbps is not None and throttle_mbps > 0 else None
            self._state = "running"
            self._resume.set()
            # lint: thread-ok(scrub daemon paced by its own budget; no request context)
            self._thread = threading.Thread(
                target=self._run, name="scrub-daemon", daemon=True)
            self._thread.start()
            return True

    def pause(self) -> bool:
        """Hold the pass at the next volume boundary. Returns True if
        there was a live pass to pause."""
        with self._lock:
            alive = self._thread is not None and self._thread.is_alive()
            if alive:
                self._state = "paused"
            self._resume.clear()
            return alive

    def stop(self) -> None:
        # _stopping flips under the lock: an unlocked write could land
        # after a concurrent start() passed its check but before it
        # spawned, and stop() would join the old thread only
        with self._lock:
            self._stopping = True
            t = self._thread
        self._resume.set()
        self._wake.set()
        if t is not None:
            t.join(timeout=10)
        with self._lock:
            self._state = "idle"

    def status(self) -> Dict:
        lag = self._scan_lag()
        t = self.totals
        return {
            "state": self._state,
            "bytes_scanned": t.bytes_scanned,
            "needles_verified": t.needles_verified,
            "stripes_verified": t.stripes_verified,
            "corruptions_found": t.corruptions_found,
            "corruptions_repaired": t.corruptions_repaired,
            "unrecoverable": t.unrecoverable,
            "current_volume_id": self.current_volume_id,
            "passes_completed": self.passes_completed,
            "last_pass_unix": self.last_pass_unix,
            "scan_lag_seconds": lag,
        }

    # -- the pass ------------------------------------------------------------

    def _checkpoint(self, vid: int) -> None:
        """Between-volumes barrier: block while paused, abort on stop."""
        self.current_volume_id = vid
        while not self._resume.wait(timeout=0.5):
            if self._stopping:
                raise ScrubPaused()
        if self._stopping:
            raise ScrubPaused()

    def _run(self) -> None:
        # the whole daemon runs as the _internal QoS tenant: its replica
        # and shard fetches are weighted low on every fan-out pool and
        # exempt from admission shed (repair trades latency for
        # durability, never the other way). No-op context when QoS off.
        from seaweedfs_tpu_torch import qos
        vids, mbps = self._pass_volume_ids, self._pass_mbps
        while not self._stopping:
            try:
                with qos.internal_context():
                    self.run_pass(vids, mbps=mbps)
            except ScrubPaused:
                return
            except Exception:
                log.exception("scrub pass failed")
            vids, mbps = None, None  # later passes: whole store, budget
            if self.interval_s <= 0:
                break
            self._wake.wait(timeout=self.interval_s)
            self._wake.clear()
        with self._lock:
            if not self._stopping:   # stop() owns the final state
                self._state = "idle"

    def run_pass(self, volume_ids: Optional[Sequence[int]] = None,
                 mbps: Optional[float] = None) -> PassResult:
        """One synchronous sweep over everything mounted locally."""
        res = PassResult()
        mbps = self.mbps if mbps is None else mbps
        throttler = Throttler(mbps) if mbps > 0 else None
        t0 = time.perf_counter()
        only = set(volume_ids) if volume_ids else None
        with trace.span("scrub.pass"):
            self._scan_volumes(res, throttler, only)
            self._scan_ec_volumes(res, throttler, only)
        ScrubPassSecondsHistogram.observe(time.perf_counter() - t0)
        self.last_pass_unix = time.time()
        self.passes_completed += 1
        self.current_volume_id = 0
        self._accumulate(res)
        return res

    def _accumulate(self, res: PassResult) -> None:
        t = self.totals
        t.bytes_scanned += res.bytes_scanned
        t.needles_verified += res.needles_verified
        t.stripes_verified += res.stripes_verified
        t.corruptions_found += res.corruptions_found
        t.corruptions_repaired += res.corruptions_repaired
        t.unrecoverable += res.unrecoverable
        t.volumes += res.volumes
        t.ec_volumes += res.ec_volumes
        t.details.extend(res.details)
        del t.details[:-100]   # ring: keep the newest hundred findings

    def _scan_volumes(self, res: PassResult, throttler, only) -> None:
        for loc in self.store.locations:
            for vid, v in list(loc.volumes.items()):
                if only is not None and vid not in only:
                    continue
                if v.is_remote:
                    continue  # remote-tiered bytes are the backend's
                self._checkpoint(vid)
                scan = scanner.scan_volume(v, throttler)
                res.volumes += 1
                res.bytes_scanned += scan.bytes_scanned
                res.needles_verified += scan.needles_verified
                ScrubScannedBytesCounter.inc(scan.bytes_scanned)
                ScrubNeedlesVerifiedCounter.inc(scan.needles_verified)
                for offset, n in scan.corrupt:
                    res.corruptions_found += 1
                    ScrubCorruptionsFoundCounter.labels("needle").inc()
                    log.warning("volume %d: needle %x at %d fails CRC",
                                vid, n.id, offset)
                    if self.replica_fetch is not None and \
                            planner.repair_needle(v, n, self.replica_fetch):
                        res.corruptions_repaired += 1
                        ScrubCorruptionsRepairedCounter.labels(
                            "needle").inc()
                        if self.on_repair is not None:
                            self.on_repair(vid)
                        res.details.append(
                            f"volume {vid}: needle {n.id:x} rewritten "
                            f"from replica")
                    else:
                        res.unrecoverable += 1
                        ScrubUnrecoverableCounter.inc()
                        res.details.append(
                            f"volume {vid}: needle {n.id:x} corrupt, "
                            f"no healthy replica")

    def _scan_ec_volumes(self, res: PassResult, throttler, only) -> None:
        ecvs = [(vid, ecv)
                for loc in self.store.locations
                for vid, ecv in list(loc.ec_volumes.items())
                if only is None or vid in only]
        if not ecvs:
            return
        # the exclusion reconstructs: the process's card codec on "cuda"
        rs = None if self.backend == "cuda" else \
            ReedSolomon(backend=self.backend)
        damages: Dict[int, planner.EcDamage] = {}
        for vid, ecv in ecvs:
            self._checkpoint(vid)
            scan = scanner.scan_ec_volume_needles(ecv, throttler=throttler,
                                                  rs=rs)
            res.ec_volumes += 1
            res.bytes_scanned += scan.bytes_scanned
            res.needles_verified += scan.needles_verified
            ScrubScannedBytesCounter.inc(scan.bytes_scanned)
            ScrubNeedlesVerifiedCounter.inc(scan.needles_verified)
            if scan.corrupt:
                log.warning("ec volume %d: %d needle(s) fail CRC "
                            "(bad data shards: %s)", vid,
                            len(scan.corrupt),
                            sorted(scan.bad_data_shards) or "?")
            damages[vid] = planner.EcDamage(
                base=ecv.base_name, bad_data=scan.bad_data_shards)
        # ONE fused verify across every local EC volume: spans from all
        # of them share dispatches
        self._checkpoint(0)
        by_base = {ecv.base_name: (vid, ecv) for vid, ecv in ecvs}
        with trace.span("scrub.verify", volumes=len(by_base)):
            mesh_fleet = fleet.mesh_fleet_or_none() \
                if self.mesh_cfg is not None else None
            if mesh_fleet is not None:
                verified = mesh_fleet.pod_verify_ec_files(
                    list(by_base), backend=self.backend,
                    throttler=throttler, **self.mesh_cfg)
            else:
                verified = fleet.fleet_verify_ec_files(
                    list(by_base), backend=self.backend,
                    throttler=throttler)
        for base, vr in verified.items():
            vid, ecv = by_base[base]
            d = damages[vid]
            d.parity_mismatch = dict(vr.parity_mismatch)
            d.first_mismatch = dict(vr.first_mismatch)
            d.parity_checked = list(vr.parity_checked)
            # a shard file gone while this server still has it mounted is
            # local damage; shards on OTHER servers are theirs to scrub,
            # and a tiered shard's bytes are the backend's
            d.missing = [s for s in vr.missing if s in ecv.shards
                         and not ecv.shards[s].is_remote]
            res.stripes_verified += vr.spans
            res.bytes_scanned += vr.bytes_verified
            ScrubStripesVerifiedCounter.inc(vr.spans)
            ScrubScannedBytesCounter.inc(vr.bytes_verified)
        for vid, ecv in ecvs:
            self._repair_ec(vid, ecv, damages[vid], res)

    def _repair_ec(self, vid: int, ecv, damage: planner.EcDamage,
                   res: PassResult, rounds: int = 2) -> None:
        """Classify -> quarantine -> rebuild -> verify again, at most
        `rounds` times (round one clears data damage, whose recomputed
        parity contaminated the first evidence; round two then judges the
        parity shards on their own)."""
        for _ in range(rounds):
            checked = set(damage.parity_checked)
            if not damage.bad_data and len(checked) >= 2 and \
                    set(damage.parity_mismatch) == checked:
                # every locally checked parity stream disagrees but no
                # live needle is bad: dead-space damage in a data shard.
                # The syndrome probe names it, so the shard comes back
                # byte-identical instead of parity being re-encoded
                # around corrupt data
                damage.bad_data |= planner.localize_from_parity_deltas(
                    damage.base, sorted(set(damage.first_mismatch
                                            .values())),
                    parity_ids=sorted(checked))
            verdict, bad = planner.classify_ec_damage(damage)
            if verdict == "clean":
                return
            kinds = ["ec_data" if s < fleet.DATA_SHARDS else "ec_parity"
                     for s in bad]
            for k in kinds:
                res.corruptions_found += 1
                ScrubCorruptionsFoundCounter.labels(k).inc()
            if verdict == "unrecoverable":
                res.unrecoverable += len(bad)
                ScrubUnrecoverableCounter.inc(len(bad))
                res.details.append(
                    f"ec volume {vid}: shards {bad} unrecoverable "
                    f"(>{fleet.TOTAL_SHARDS - fleet.DATA_SHARDS} damaged)")
                log.error("ec volume %d: shards %s unrecoverable",
                          vid, bad)
                return
            self._checkpoint(vid)
            log.warning("ec volume %d: rebuilding %s shard(s) %s",
                        vid, verdict, bad)
            try:
                planner.repair_ec_volume(
                    damage.base, bad, backend=self.backend,
                    unmount=ecv.unmount_shard, remount=ecv.mount_shard)
            except (ValueError, OSError) as e:
                res.unrecoverable += len(bad)
                ScrubUnrecoverableCounter.inc(len(bad))
                res.details.append(
                    f"ec volume {vid}: rebuild of {bad} failed: {e}")
                log.error("ec volume %d: rebuild failed: %s", vid, e)
                return
            if self.on_repair is not None:
                self.on_repair(vid)
            vr = planner.verify_ec_repair(damage.base,
                                          backend=self.backend)
            res.stripes_verified += vr.spans
            ScrubStripesVerifiedCounter.inc(vr.spans)
            for k in kinds:
                res.corruptions_repaired += 1
                ScrubCorruptionsRepairedCounter.labels(k).inc()
            res.details.append(
                f"ec volume {vid}: shards {bad} reconstructed")
            # evidence for the next round: repaired shards are clean by
            # construction, only fresh parity mismatches remain
            damage = planner.EcDamage(
                base=damage.base,
                parity_mismatch=dict(vr.parity_mismatch),
                first_mismatch=dict(vr.first_mismatch),
                parity_checked=list(vr.parity_checked))
            if vr.clean:
                return
        log.error("ec volume %d: still inconsistent after %d repair "
                  "rounds", vid, rounds)
