"""The lifecycle state machine, pure over fabricated cluster views.

States
------
HOT   a replicated normal volume: full-speed reads, writable.
WARM  erasure-coded RS(10,4): 1.4x storage instead of Nx, reads a
      touch slower, reconstruction on shard loss (the f4 shape).
COLD  bulk bytes (sealed .dat or EC shards) offloaded to a cloud
      backend through storage/volume_tier; reads become ranged GETs.

Transitions (kind names are the metric labels)
----------------------------------------------
  HOT  -> WARM   "encode"    fused `ec.encode -volumeId=a,b,c`
  WARM -> HOT    "decode"    `ec.decode` (VolumeEcShardsToVolume)
  WARM -> COLD   "offload"   `volume.tier.upload` (EC shards)
  COLD -> WARM   "download"  `volume.tier.download`

Anti-flap contract
------------------
* Hysteresis: a volume cools only when BOTH its instantaneous window
  reads and its decayed EWMA rate sit at or below `cool_threshold`;
  it heats back up only when window reads reach `warm_threshold`
  (validated > cool_threshold). The band between the two thresholds
  is dead: no transition in either direction.
* Dwell: each state has a minimum residence time; a volume that just
  transitioned cannot transition again until its dwell elapses, no
  matter what the thresholds say. A fresh HOT volume's dwell also
  doubles as the write-quiet guard (its modified-age must clear the
  hot dwell before an encode — never EC a volume still being filled).
* Cap: at most `max_inflight` transitions may be planned/running
  cluster-wide at once. Heat-ups (download/decode) outrank cool-downs
  in the plan order — un-cooling is user-facing latency, cooling is
  housekeeping.

Everything here is pure: `reconcile_states` + `plan_transitions` take
plain views/state dicts and a timestamp, return decisions, and touch
no cluster — the house planning-function pattern (plan_scrub_stagger,
plan_volume_balance), so the whole lattice is unit-testable on
fabricated views.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

HOT = "hot"
WARM = "warm"
COLD = "cold"
STATES = (HOT, WARM, COLD)


class LifecycleConfig(NamedTuple):
    """The `-lifecycle.*` master knobs (defaults match the CLI)."""
    dry_run: bool = False
    interval_s: float = 60.0
    cool_threshold: float = 0.0     # window reads <= this => cool candidate
    warm_threshold: float = 50.0    # window reads >= this => heat back up
    hot_dwell_s: float = 600.0
    warm_dwell_s: float = 600.0
    cold_dwell_s: float = 3600.0
    freeze_s: float = 0.0           # WARM idle this long => COLD (0 = never)
    cold_backend: str = ""          # tier backend name ("" = COLD disabled)
    max_inflight: int = 2
    throttle_mbps: float = 0.0

    def validate(self) -> "LifecycleConfig":
        if self.warm_threshold <= self.cool_threshold:
            raise ValueError(
                f"-lifecycle.warmThreshold ({self.warm_threshold}) must "
                f"exceed -lifecycle.coolThreshold ({self.cool_threshold}) "
                "— without the hysteresis band a volume at the boundary "
                "would flap encode/decode every pass")
        if self.interval_s <= 0:
            raise ValueError("-lifecycle.intervalSeconds must be > 0")
        if self.max_inflight < 1:
            raise ValueError("-lifecycle.maxInflight must be >= 1")
        return self


class VolumeView(NamedTuple):
    """One volume as the planner sees it (fabricated in unit tests,
    built from topology + the heartbeat heat map by the engine)."""
    vid: int
    tier: str                   # observed tier: HOT (normal) or WARM (EC)
    size: int = 0
    file_count: int = 0
    reads_window: float = 0.0   # cluster-summed window reads
    ewma: float = 0.0           # cluster-summed decayed rate
    modified_age_s: float = 1e18   # seconds since last write
    collection: str = ""


class VolState(NamedTuple):
    state: str
    since: float                # monotonic timestamp of state entry


class Transition(NamedTuple):
    vid: int
    kind: str                   # encode | decode | offload | download
    target: str                 # the state the volume lands in
    size: int
    collection: str
    reason: str


# what each kind moves between
KIND_TO_TARGET = {"encode": WARM, "decode": HOT,
                  "offload": COLD, "download": WARM}


def reconcile_states(views: Dict[int, VolumeView],
                     states: Dict[int, VolState],
                     now: float) -> Dict[int, VolState]:
    """Fold the observed topology into the engine's state records.

    The heartbeat view is authoritative for HOT-vs-WARM (an operator's
    manual ec.encode, a master failover, a crashed transition — all
    converge here); COLD is engine memory layered on top, because a
    tier-offloaded volume is indistinguishable from WARM in the
    heartbeat. A COLD record therefore survives only while the
    observed tier still matches WARM's wire shape; after a master
    restart COLD volumes re-enter as WARM and the idle-freeze rule
    re-offloads them — which is why `volume.tier.upload` must be
    idempotent (already-tiered holders skip cleanly). Vids that left
    the cluster drop out; new vids enter in their observed tier with
    dwell starting now."""
    out: Dict[int, VolState] = {}
    for vid, view in views.items():
        prev = states.get(vid)
        if prev is None:
            out[vid] = VolState(view.tier, now)
        elif prev.state == COLD and view.tier == WARM:
            out[vid] = prev            # COLD rides on the WARM wire shape
        elif prev.state != view.tier:
            out[vid] = VolState(view.tier, now)   # external transition
        else:
            out[vid] = prev
        # sanity: a view tier the machine doesn't know resets to HOT
        if out[vid].state not in STATES:
            out[vid] = VolState(HOT, now)
    return out


def _dwell(cfg: LifecycleConfig, state: str) -> float:
    return {HOT: cfg.hot_dwell_s, WARM: cfg.warm_dwell_s,
            COLD: cfg.cold_dwell_s}[state]


def _classify(view: VolumeView, st: VolState, cfg: LifecycleConfig,
              now: float) -> Optional[Transition]:
    """The per-volume decision. Returns None when the volume should
    stay put (in the hysteresis band, inside its dwell, or simply
    content where it is)."""
    dwelt = now - st.since
    if dwelt < _dwell(cfg, st.state):
        return None
    cold_enough = (view.reads_window <= cfg.cool_threshold
                   and view.ewma <= cfg.cool_threshold)
    hot_enough = view.reads_window >= cfg.warm_threshold
    if st.state == HOT:
        # quiet guard: never EC a volume still taking writes, and
        # never bother with an empty one (a freshly-grown volume's
        # .dat is just a superblock — file_count is the honest signal)
        if cold_enough and view.file_count > 0 \
                and view.modified_age_s >= cfg.hot_dwell_s:
            return Transition(
                view.vid, "encode", WARM, view.size, view.collection,
                f"reads_window={view.reads_window:.0f} "
                f"ewma={view.ewma:.2f} <= cool={cfg.cool_threshold:g} "
                f"for dwell>={cfg.hot_dwell_s:g}s")
    elif st.state == WARM:
        if hot_enough:
            return Transition(
                view.vid, "decode", HOT, view.size, view.collection,
                f"reads_window={view.reads_window:.0f} >= "
                f"warm={cfg.warm_threshold:g}")
        if cfg.cold_backend and cfg.freeze_s > 0 \
                and dwelt >= cfg.freeze_s and cold_enough:
            return Transition(
                view.vid, "offload", COLD, view.size, view.collection,
                f"warm+idle {dwelt:.0f}s >= freeze={cfg.freeze_s:g}s")
    elif st.state == COLD:
        if hot_enough:
            return Transition(
                view.vid, "download", WARM, view.size, view.collection,
                f"reads_window={view.reads_window:.0f} >= "
                f"warm={cfg.warm_threshold:g}")
    return None


# plan order: heat-ups are user-facing latency and go first; inside a
# class, hottest (download/decode) or coldest (encode/offload) first
_KIND_RANK = {"download": 0, "decode": 1, "encode": 2, "offload": 3}


def plan_transitions(views: Dict[int, VolumeView],
                     states: Dict[int, VolState],
                     cfg: LifecycleConfig, now: float,
                     in_flight: int = 0) -> List[Transition]:
    """One policy pass: classify every volume, order, and cut to the
    cluster-wide cap. `in_flight` is the count of transitions already
    running (forced or carried over); the plan never pushes the total
    past cfg.max_inflight."""
    planned: List[Transition] = []
    for vid, view in views.items():
        st = states.get(vid)
        if st is None:
            continue
        t = _classify(view, st, cfg, now)
        if t is not None:
            planned.append(t)
    planned.sort(key=lambda t: (
        _KIND_RANK[t.kind],
        -views[t.vid].reads_window if t.kind in ("download", "decode")
        else views[t.vid].reads_window,
        t.vid))
    room = max(0, cfg.max_inflight - in_flight)
    return planned[:room]
