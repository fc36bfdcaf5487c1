"""Background integrity scrub and self-repair.

The counterpart of ``seaweedfs_tpu.scrub``. Needle CRCs are checked on
reads, EC shards never again after encode; this package closes that gap:

  scanner   walks mounted volumes and EC volumes at a throttled pace,
            recomputing needle CRCs; a corrupt EC needle is pinned to its
            data shard by exclusion reconstruction on the card.
  planner   classifies damage (bad parity vs bad data shard vs
            unrecoverable), quarantines corrupt files with a .corrupt
            rename, and rebuilds shards through the fleet rebuild
            (needles come back from replicas).
  daemon    the control plane: a background thread per volume server
            with start/pause/status, whose fused stripe verify rides the
            fleet verify or the unified mesh scheduler.
"""

from seaweedfs_tpu_torch.scrub.daemon import ScrubDaemon, PassResult
from seaweedfs_tpu_torch.scrub.planner import (EcDamage, classify_ec_damage,
                                               repair_ec_volume,
                                               repair_needle)
from seaweedfs_tpu_torch.scrub.scanner import (EcNeedleScan, NeedleScan,
                                               scan_ec_volume_needles,
                                               scan_volume)

__all__ = [
    "ScrubDaemon", "PassResult",
    "EcDamage", "classify_ec_damage", "repair_ec_volume", "repair_needle",
    "EcNeedleScan", "NeedleScan", "scan_ec_volume_needles", "scan_volume",
]
