"""Heat-driven lifecycle: the policy engine that moves volumes
hot<->warm<->cold on its own (the decider half of the heat plane in
stats/heat.py). The counterpart of ``seaweedfs_tpu.lifecycle``.

The f4/Haystack blueprint (SURVEY) is a *lifecycle*: blobs migrate
between a replicated hot store and an erasure-coded warm store as
their access rate decays, automatically. Every mechanism already
exists in this tree — `-heat.track` read telemetry, the fused EC
encode/decode fleets, `storage/volume_tier` cloud offload,
`VolumeEcShardsToVolume` un-cooling, the master's leader-only crons —
and this package is the part that *decides*:

  policy.py   the pure state machine: HOT (replicated) -> WARM (EC)
              -> COLD (tier-offloaded) and back up, with hysteresis
              (separate cool/warm thresholds), per-state minimum dwell
              times, and a cluster-wide in-flight transition cap.
              Pure over fabricated views (the house planning-function
              pattern) — unit-testable without a cluster.
  engine.py   the master-side leader-only daemon: builds views from
              the heartbeat heat map, runs the planner, and executes
              transitions through the admin shell (`ec.encode
              -volumeId=a,b,c` grouped per pass so cools ride ONE
              fused fleet dispatch, `ec.decode`, `volume.tier.*`),
              byte-budget-paced via util/throttler. `-lifecycle.dryRun`
              reports every decision without acting.

Cost discipline (checked by tests/test_torch_lifecycle.py): a master
without `-lifecycle` holds NO engine — zero threads, heartbeats
byte-identical to the pre-lifecycle wire format, and the read path's
only heat branch is the `-heat.track` None check that predates this
package.
"""

from seaweedfs_tpu_torch.lifecycle.policy import (COLD, HOT, WARM,
                                            LifecycleConfig, Transition,
                                            VolumeView, plan_transitions,
                                            reconcile_states)
from seaweedfs_tpu_torch.lifecycle.engine import LifecycleEngine

__all__ = ["LifecycleConfig", "LifecycleEngine", "Transition",
           "VolumeView", "plan_transitions", "reconcile_states",
           "HOT", "WARM", "COLD"]
