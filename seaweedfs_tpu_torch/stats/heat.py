"""Read-path heat telemetry: who is hot, right now.

The counterpart of ``seaweedfs_tpu.stats.heat``. The heat-driven
lifecycle (``lifecycle/``: EC-encode cold volumes, un-cool ones that
heat back up, batch-offload frozen ones) decides from this measurement
plane: a per-volume sliding window of
read counts (a ring of time buckets, so the exported number is "reads
in the last window", not an ever-growing total) plus a sampled
per-needle counter that surfaces the hottest keys inside a hot volume
(the f4-style "is it one object or the whole volume" question).

Exported as `SeaweedFS_volume_heat{vid}` (collection-time callables —
scrapes see a moving window with zero writes between reads) and as the
Heat block on the volume server's /status.

Cost discipline (checked by tests/test_torch_observability.py): the
tracker is absent — not merely idle — unless -heat.track is set, so
the disabled read path pays one None check. Enabled, record() is a few
dict/list ops under the GIL; counts may race and lose the odd
increment, which is fine for telemetry (same trade the hedger's
latency window makes). No threads, ever.
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from typing import Dict, List, Optional

BUCKETS = 8
# EWMA time constant in units of the heat window: sized so a sustained
# rate change converges in ~3-4 windows while a single-pulse spike
# moves the average only fractionally (the lifecycle's hysteresis
# partner — thresholds compare against BOTH the instantaneous window
# and this decayed rate)
EWMA_TAU_WINDOWS = 2.0
# below this decayed rate (one read per ~17 minutes) the EWMA snaps to
# an exact 0.0: exponential decay otherwise never reaches zero, which
# would make the lifecycle's default coolThreshold=0 unreachable
EWMA_ZERO = 1e-3

# Live trackers + the vids with a registered gauge child. The gauge's
# per-vid callable sums over LIVE trackers via this weak set, so a
# stopped server's tracker is collectable (its gauge reading decays to
# the survivors' counts instead of freezing), and two heat-tracking
# volume servers in one process (in-process test clusters) SUM instead
# of last-registration-wins clobbering.
_TRACKERS: "weakref.WeakSet[HeatTracker]" = weakref.WeakSet()
_registered_vids: set = set()
_reg_lock = threading.Lock()


def _vid_reads(vid: int) -> float:
    return float(sum(t.window_reads(vid) for t in list(_TRACKERS)))


def _register_vid_gauge(vid: int) -> None:
    with _reg_lock:
        if vid in _registered_vids:
            return
        _registered_vids.add(vid)
    from seaweedfs_tpu_torch.stats.metrics import VolumeHeatGauge
    VolumeHeatGauge.labels(str(vid)).set_function(
        lambda vid=vid: _vid_reads(vid))


class _VolHeat:
    __slots__ = ("stamps", "counts", "total", "needles", "ewma",
                 "ewma_ts")

    def __init__(self):
        self.stamps = [0] * BUCKETS     # which time slot each bucket holds
        self.counts = [0] * BUCKETS
        self.total = 0
        self.needles: Dict[int, int] = {}
        # decayed average of the window-read rate, updated lazily at
        # summary() time (the heartbeat cadence): the policy engine's
        # anti-flap signal — a one-pulse burst barely moves it, a
        # sustained change converges within a few windows
        self.ewma = 0.0
        self.ewma_ts = 0.0


class HeatTracker:
    def __init__(self, window_s: float = 60.0, needle_sample: int = 16,
                 top_n: int = 8):
        self.window_s = window_s
        self.bucket_s = window_s / BUCKETS
        self.needle_sample = max(1, needle_sample)
        self.top_n = max(1, top_n)
        # lock-free reads are the documented trade (telemetry may lose
        # the odd increment); every INSERT/DROP takes the lock
        self._vols: Dict[int, _VolHeat] = {}  # guarded_by(self._lock, writes)
        self._lock = threading.Lock()   # vid insert + gauge child reg only
        _TRACKERS.add(self)

    # -- hot path -------------------------------------------------------------

    def record(self, vid: int, needle_id: int = 0) -> None:
        v = self._vols.get(vid)
        if v is None:
            v = self._add(vid)
        slot = int(time.monotonic() / self.bucket_s)
        i = slot % BUCKETS
        if v.stamps[i] != slot:
            v.stamps[i] = slot
            v.counts[i] = 0
        v.counts[i] += 1
        v.total += 1
        if needle_id and v.total % self.needle_sample == 0:
            n = v.needles
            n[needle_id] = n.get(needle_id, 0) + 1
            if len(n) > self.top_n * 8:
                # prune the cold tail; the hot keys keep their counts
                for nid, _c in sorted(n.items(),
                                      key=lambda kv: kv[1])[:len(n) // 2]:
                    del n[nid]

    def _add(self, vid: int) -> _VolHeat:
        with self._lock:
            v = self._vols.get(vid)
            if v is None:
                v = self._vols[vid] = _VolHeat()
                _register_vid_gauge(vid)
            return v

    def close(self) -> None:
        """Detach from the gauge registry (server stop): the per-vid
        gauge stops counting this tracker immediately instead of
        waiting for the GC."""
        _TRACKERS.discard(self)

    def forget(self, vid: int) -> None:
        """Drop everything tracked for a volume that left this server
        (delete, unmount, EC conversion). Without this a dead vid's
        `SeaweedFS_volume_heat{vid}` child and needle counters linger
        forever — unbounded label growth, the exact cardinality smell
        the `metric` lint polices. The gauge child is unregistered only
        once NO live tracker still holds the vid (two in-process
        servers may share one)."""
        with self._lock:
            self._vols.pop(vid, None)
        if any(vid in t._vols for t in list(_TRACKERS)):
            return
        with _reg_lock:
            if vid not in _registered_vids:
                return
            _registered_vids.discard(vid)
        from seaweedfs_tpu_torch.stats.metrics import VolumeHeatGauge
        VolumeHeatGauge.remove(str(vid))

    # -- read side ------------------------------------------------------------

    def window_reads(self, vid: int) -> int:
        """Reads of vid within the sliding window (stale buckets are
        excluded by their slot stamp, so an idle volume decays to 0
        without anyone writing)."""
        v = self._vols.get(vid)
        if v is None:
            return 0
        newest = int(time.monotonic() / self.bucket_s)
        return sum(c for s, c in zip(v.stamps, v.counts)
                   if newest - s < BUCKETS)

    def summary(self) -> List[dict]:
        """The heartbeat heat payload: per-vid window reads plus the
        decayed EWMA of the window-read rate (reads/s). Called once per
        pulse; the EWMA decays with time constant EWMA_TAU_WINDOWS heat
        windows, so it keeps falling while a volume sits idle (no reads
        means no record() calls, but the heartbeat still reports the
        cooling trajectory)."""
        now = time.monotonic()
        out = []
        for vid in list(self._vols):
            v = self._vols.get(vid)
            if v is None:
                continue
            rate = self.window_reads(vid) / self.window_s
            if v.ewma_ts == 0.0:
                v.ewma = rate
            else:
                tau = EWMA_TAU_WINDOWS * self.window_s
                alpha = 1.0 - math.exp(-(now - v.ewma_ts) / tau)
                v.ewma += alpha * (rate - v.ewma)
                if v.ewma < EWMA_ZERO:
                    # exponential decay never reaches 0.0 (a once-read
                    # volume would carry a denormal for ~a day) — snap
                    # to an honest zero so a coolThreshold of 0 can
                    # actually be met by an idle volume
                    v.ewma = 0.0
            v.ewma_ts = now
            out.append({"id": vid,
                        "reads_window": self.window_reads(vid),
                        "ewma": v.ewma})
        return out

    def hot_needles(self, vid: int) -> List[List]:
        v = self._vols.get(vid)
        if v is None:
            return []
        top = sorted(v.needles.items(), key=lambda kv: -kv[1])
        return [[f"{nid:x}", c] for nid, c in top[:self.top_n]]

    def snapshot(self) -> dict:
        """The /status Heat block."""
        out = {"enabled": True, "window_s": self.window_s,
               "needle_sample": self.needle_sample, "volumes": {}}
        for vid in list(self._vols):
            v = self._vols.get(vid)
            if v is None:
                continue
            out["volumes"][str(vid)] = {
                "reads_window": self.window_reads(vid),
                "reads_total": v.total,
                "hot_needles": self.hot_needles(vid),
            }
        return out


def make_tracker(enabled: bool, window_s: float = 60.0,
                 needle_sample: int = 16) -> Optional[HeatTracker]:
    """None unless enabled — the read path's heat branch must be a
    None check, never an idle object with live method calls."""
    if not enabled:
        return None
    return HeatTracker(window_s=window_s, needle_sample=needle_sample)
