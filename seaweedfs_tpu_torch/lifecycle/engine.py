"""LifecycleEngine: the master-side leader-only daemon around policy.py.

One pass, every `-lifecycle.intervalSeconds`:

  1. build VolumeViews from the topology (normal volumes = HOT tier,
     EC volumes = WARM tier) joined with the heartbeat heat map
     (Topology.cluster_heat);
  2. reconcile the engine's state records against what the cluster
     actually looks like (operators and failovers move volumes too);
  3. run the pure planner under the cluster-wide in-flight cap;
  4. execute — or, under `-lifecycle.dryRun`, log and ledger every
     decision without acting.

Execution rides the admin shell rather than re-implementing the
crash-safe orderings: encodes GROUP into one `ec.encode
-volumeId=a,b,c` per pass (the server fuses the whole group's chunks
into shared RS dispatches on the card — ec/fleet.py), decodes run `ec.decode`
(VolumeEcShardsToVolume + shard cleanup), and COLD moves ride
`volume.tier.upload` / `volume.tier.download`. Transitions execute
serially on the engine thread; `max_inflight` therefore bounds how
much of the cluster can be mid-transition (writes frozen, shards in
motion) per pass, and a byte-budget Throttler paces transition
admission by volume size (`-lifecycle.throttleMBps`), so a cold
cluster never converts itself at full disk speed.

Zero-cost-disabled contract: a master without `-lifecycle` constructs
no engine at all (MasterServer.lifecycle is None). A constructed
engine spawns nothing until start(), and its loop acts only while
this master is the raft leader.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from seaweedfs_tpu_torch.lifecycle.policy import (COLD, HOT, STATES, WARM,
                                            LifecycleConfig, Transition,
                                            VolState, VolumeView,
                                            plan_transitions,
                                            reconcile_states)
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.util import wlog
from seaweedfs_tpu_torch.util.throttler import Throttler

log = wlog.logger("lifecycle")

DECISION_RING = 64      # recent decisions kept for /status + dry-run
RETRY_BACKOFF_PASSES = 4   # passes a failed vid sits out before retry


class LifecycleEngine:
    def __init__(self, master, cfg: LifecycleConfig):
        self.master = master
        self.cfg = cfg.validate()
        self.states: Dict[int, VolState] = {}
        self.paused = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._stopping = False
        self._lock = threading.Lock()      # states/forced/decisions
        self._forced: List[Transition] = []  # guarded_by(self._lock)
        self._decisions: List[dict] = []  # guarded_by(self._lock)   ring, newest last
        self._failed_until: Dict[int, int] = {}  # vid -> pass number
        # last-known HOT size per vid: heartbeats carry no size for EC
        # shards, so WARM/COLD views (and therefore the byte budget and
        # bytes-moved ledger for decode/offload/download) remember the
        # volume's size from its HOT era
        self._sizes: Dict[int, int] = {}
        self._pass_no = 0
        self._throttler = Throttler(cfg.throttle_mbps,
                                    burst_s=cfg.interval_s)
        self.transitions_ok = 0
        self.transitions_err = 0

    # -- lifecycle of the lifecycle -----------------------------------------

    def start(self) -> None:
        # lint: thread-ok(leader-only policy cron daemon; no request context)
        self._thread = threading.Thread(
            target=self._loop, name="master-lifecycle", daemon=True)
        self._thread.start()
        log.info("lifecycle engine started (interval=%.0fs dry_run=%s "
                 "cool<=%g warm>=%g cap=%d)",
                 self.cfg.interval_s, self.cfg.dry_run,
                 self.cfg.cool_threshold, self.cfg.warm_threshold,
                 self.cfg.max_inflight)

    def stop(self) -> None:
        self._stopping = True
        self._wake.set()

    def run_pass_now(self) -> None:
        """Test/ops hook: trigger one policy pass immediately."""
        self._wake.set()

    # -- control plane --------------------------------------------------------

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    def force(self, vid: int, target: str) -> str:
        """Queue one operator-forced transition (volume.lifecycle
        -force): bypasses thresholds and dwell, still executes on the
        engine thread under the same serialized executor, and still
        honors dry-run (a dry-run engine reports what it WOULD do)."""
        target = target.lower()
        if target not in STATES:
            raise ValueError(f"unknown target state {target!r} "
                             f"(want one of {', '.join(STATES)})")
        with self._lock:
            st = self.states.get(vid)
        if st is None:
            raise ValueError(f"volume {vid} is not tracked (no "
                             "heartbeat holder yet?)")
        kind = {(HOT, WARM): "encode", (WARM, HOT): "decode",
                (WARM, COLD): "offload", (COLD, WARM): "download",
                (COLD, HOT): "download"}.get((st.state, target))
        if kind is None:
            raise ValueError(
                f"volume {vid}: no single transition {st.state} -> "
                f"{target}")
        if kind == "offload" and not self.cfg.cold_backend:
            raise ValueError(
                "COLD is disabled: no -lifecycle.coldBackend configured")
        t = Transition(vid, kind, WARM if kind == "download" else target,
                       self._sizes.get(vid, 0), "",
                       f"forced by operator ({st.state} -> {target})")
        with self._lock:
            self._forced.append(t)
        self._wake.set()
        return kind

    def status(self) -> dict:
        with self._lock:
            counts = {s: 0 for s in STATES}
            for st in self.states.values():
                counts[st.state] = counts.get(st.state, 0) + 1
            return {
                "enabled": True,
                "dry_run": self.cfg.dry_run,
                "paused": self.paused,
                "is_leader": self.master.raft.is_leader,
                "interval_s": self.cfg.interval_s,
                "passes": self._pass_no,
                "states": counts,
                "queued_forced": len(self._forced),
                "transitions_ok": self.transitions_ok,
                "transitions_err": self.transitions_err,
                "decisions": list(self._decisions),
            }

    # -- the pass -------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stopping:
            self._wake.wait(timeout=self.cfg.interval_s)
            self._wake.clear()
            if self._stopping:
                return
            if not self.master.raft.is_leader:
                continue
            try:
                # encode/offload passes run as the _internal QoS
                # tenant: low fair-share weight on the stores' pools,
                # exempt from admission shed (no-op context when off)
                from seaweedfs_tpu_torch import qos
                with qos.internal_context():
                    self._run_pass()
            except Exception:
                log.exception("lifecycle pass crashed")

    def _run_pass(self) -> None:
        from seaweedfs_tpu_torch.stats.metrics import (
            LifecyclePassSecondsHistogram, LifecycleQueueDepthGauge,
            LifecycleVolumeStatesGauge)
        t0 = time.perf_counter()
        self._pass_no += 1
        now = time.monotonic()
        sp = trace.span("lifecycle.pass", n=self._pass_no) \
            if trace.is_enabled() else trace.NOOP
        with sp:
            views = self._build_views()
            with self._lock:
                self.states = reconcile_states(views, self.states, now)
                forced, self._forced = self._forced, []
                # backoff hygiene: expired entries and vids that left
                # the cluster must not accumulate on a long-lived master
                self._failed_until = {
                    vid: until
                    for vid, until in self._failed_until.items()
                    if until > self._pass_no and vid in views}
                backoff = set(self._failed_until)
            eligible = {vid: v for vid, v in views.items()
                        if vid not in backoff}
            # pause stops the POLICY only: states keep reconciling (so
            # status stays live) and operator-forced transitions still
            # execute — an explicit force is never held hostage
            plan = [] if self.paused else plan_transitions(
                eligible, self.states, self.cfg, now,
                in_flight=len(forced))
            # a forced vid must not ALSO be planned by policy in the
            # same pass (a duplicate would fuse "ec.encode -volumeId=
            # 5,5" and double-record the outcome)
            forced_vids = {t.vid for t in forced}
            plan = [t for t in plan if t.vid not in forced_vids]
            for s in STATES:
                LifecycleVolumeStatesGauge.labels(s).set(float(
                    sum(1 for st in self.states.values()
                        if st.state == s)))
            todo = forced + plan
            LifecycleQueueDepthGauge.set(float(len(todo)))
            if todo:
                self._execute(todo, views)
            LifecycleQueueDepthGauge.set(0.0)
        LifecyclePassSecondsHistogram.observe(time.perf_counter() - t0)

    def _build_views(self) -> Dict[int, VolumeView]:
        """Observed cluster state -> planner views. EC vids report as
        WARM; everything with a normal replica reports HOT (a vid mid-
        conversion holding both counts as HOT until the originals are
        retired — exactly when ec.encode finishes)."""
        topo = self.master.topo
        heat = topo.cluster_heat()
        wall = time.time()
        views: Dict[int, VolumeView] = {}
        for node in topo.nodes():
            for vid, info in node.volumes.items():
                prev = views.get(vid)
                h = heat.get(vid, {})
                age = wall - info.modified_at_second \
                    if info.modified_at_second else 1e18
                if prev is not None and prev.tier == HOT:
                    views[vid] = prev._replace(
                        size=max(prev.size, info.size),
                        file_count=max(prev.file_count, info.file_count),
                        modified_age_s=min(prev.modified_age_s, age))
                else:
                    views[vid] = VolumeView(
                        vid=vid, tier=HOT, size=info.size,
                        file_count=info.file_count,
                        reads_window=h.get("reads_window", 0.0),
                        ewma=h.get("ewma", 0.0),
                        modified_age_s=age,
                        collection=info.collection)
        for vid, vw in views.items():
            if vw.size > 0:
                self._sizes[vid] = vw.size
        for vid in list(topo.ec_locations):
            if vid in views:
                continue       # normal replica wins (mid-conversion)
            h = heat.get(vid, {})
            views[vid] = VolumeView(
                vid=vid, tier=WARM, size=self._sizes.get(vid, 0),
                reads_window=h.get("reads_window", 0.0),
                ewma=h.get("ewma", 0.0),
                collection=self.master.topo.ec_collections.get(vid, ""))
        # size memory tracks the live view set (no unbounded growth)
        for vid in list(self._sizes):
            if vid not in views:
                self._sizes.pop(vid, None)
        return views

    def _typical_size(self) -> int:
        """Median known volume size: the pacing stand-in for volumes
        whose size the heartbeat can't tell us (EC shards carry no
        byte count on the wire)."""
        known = sorted(self._sizes.values())
        return known[len(known) // 2] if known else 0

    # -- execution ------------------------------------------------------------

    def _record(self, t: Transition, outcome: str, detail: str = "") -> None:
        from seaweedfs_tpu_torch.stats.metrics import (
            LifecycleBytesMovedCounter, LifecycleTransitionsCounter)
        LifecycleTransitionsCounter.labels(t.kind, outcome).inc()
        if outcome == "ok" and t.size:
            LifecycleBytesMovedCounter.labels(t.kind).inc(float(t.size))
        with self._lock:
            self._decisions.append({
                "ts": time.time(), "vid": t.vid, "kind": t.kind,
                "target": t.target, "reason": t.reason,
                "outcome": outcome,
                **({"detail": detail[:200]} if detail else {})})
            del self._decisions[:-DECISION_RING]

    def _execute(self, todo: List[Transition],
                 views: Dict[int, VolumeView]) -> None:
        from seaweedfs_tpu_torch.shell import Shell
        if self.cfg.dry_run:
            for t in todo:
                log.info("lifecycle DRY RUN: volume %d %s -> %s (%s)",
                         t.vid, t.kind, t.target, t.reason)
                self._record(t, "dry_run")
            return
        sh = Shell(self.master.url)
        # encodes group into ONE fused ec.encode per pass: the server
        # packs the whole group's chunks into shared RS dispatches
        encodes = [t for t in todo if t.kind == "encode"]
        rest = [t for t in todo if t.kind != "encode"]
        if encodes:
            self._run_group(
                sh, encodes,
                "ec.encode -volumeId=" +
                ",".join(str(t.vid) for t in encodes))
        for t in rest:
            cmd = {
                "decode": f"ec.decode -volumeId={t.vid}",
                "offload": f"volume.tier.upload -volumeId={t.vid} "
                           f"-dest={self.cfg.cold_backend}",
                "download": f"volume.tier.download -volumeId={t.vid}",
            }[t.kind]
            self._run_group(sh, [t], cmd)

    def _run_group(self, sh, group: List[Transition], cmd: str) -> None:
        from seaweedfs_tpu_torch.shell import CommandError
        now = time.monotonic()
        for t in group:
            # admission pacing: the byte budget is spent BEFORE the
            # move, so a burst of cold volumes converts at the
            # configured MB/s, not at disk speed. Heartbeats carry no
            # size for EC shards, so a WARM/COLD volume whose HOT era
            # predates this master (restart) paces at the median of
            # the sizes we DO know rather than slipping through free.
            self._throttler.maybe_slowdown(t.size or self._typical_size())
        sp = trace.span("lifecycle.transition", kind=group[0].kind,
                        volumes=len(group)) \
            if trace.is_enabled() else trace.NOOP
        with sp:
            try:
                out = sh.run_command(cmd)
            except CommandError as e:
                log.warning("lifecycle %s failed: %s", cmd, e)
                with self._lock:
                    for t in group:
                        self._failed_until[t.vid] = \
                            self._pass_no + RETRY_BACKOFF_PASSES
                    self.transitions_err += len(group)
                for t in group:
                    self._record(t, "error", str(e))
                return
        dt = time.monotonic() - now
        log.info("lifecycle: %s done in %.1fs (%d volume(s))",
                 cmd.split()[0], dt, len(group))
        if out.strip():
            log.info("lifecycle %s:\n%s", cmd.split()[0], out.strip())
        with self._lock:
            for t in group:
                self.states[t.vid] = VolState(t.target, time.monotonic())
                self._failed_until.pop(t.vid, None)
            self.transitions_ok += len(group)
        for t in group:
            self._record(t, "ok")
