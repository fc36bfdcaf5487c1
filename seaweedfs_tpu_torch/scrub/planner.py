"""Scrub repair planner: classify damage, quarantine, reconstruct.

The counterpart of ``seaweedfs_tpu.scrub.planner``. Classification uses
both evidence streams the scanner produces:

  * needle-CRC localization names corrupt DATA shards directly.
  * the stripe verify (re-encode vs stored parity) names corrupt PARITY
    shards, but only when the data shards are clean: a corrupt data shard
    contaminates ALL recomputed parity streams, so parity mismatches are
    trusted only on a volume with no data-shard evidence.
  * when every checked parity stream disagrees and the needle sweep found
    nothing (damage in dead bytes of a data shard that no live CRC
    covers), the syndrome probe ``localize_from_parity_deltas`` names the
    culprit: a one-byte error e in data shard d shifts recomputed parity
    row p by exactly M[p,d]*e in GF(2^8), so the shard whose matrix column
    divides all observed deltas to the SAME e is the corrupt one. It is
    host numpy on the port's own ``gf256`` copy.

Repair is quarantine-then-rebuild: each condemned .ecNN is renamed to
.ecNN.corrupt (never deleted), then the fleet rebuild reconstructs it on
the card from the surviving >= 10 shards, byte-identical to the original.
RS(10,4) caps repairable damage at 4 shards per volume.

Needle repair in normal volumes has no parity to lean on: the good bytes
come from a replica (``replica_fetch``), validated against the corrupt
record's own stored CRC before being rewritten.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from seaweedfs_tpu_torch.ec import fleet
from seaweedfs_tpu_torch.ec.encoder import shard_file_name
from seaweedfs_tpu_torch.ops import gf256
from seaweedfs_tpu_torch.ops.rs_code import (
    DATA_SHARDS, PARITY_SHARDS, TOTAL_SHARDS, coding_matrix)
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.storage.needle import Needle, NeedleError, masked_crc
from seaweedfs_tpu_torch.storage.volume import (Volume, VolumeError,
                                                _WriteRequest)


@dataclass
class EcDamage:
    """Everything the scanner learned about one EC volume."""

    base: str
    bad_data: Set[int] = field(default_factory=set)
    parity_mismatch: Dict[int, int] = field(default_factory=dict)
    first_mismatch: Dict[int, int] = field(default_factory=dict)
    parity_checked: List[int] = field(default_factory=list)
    missing: List[int] = field(default_factory=list)


def _shard_byte(base: str, sid: int, offset: int) -> int:
    with open(shard_file_name(base, sid), "rb") as f:
        f.seek(offset)
        b = f.read(1)
    return b[0] if b else 0


def localize_from_parity_deltas(base: str, offsets,
                                parity_ids=None) -> Set[int]:
    """Syndrome probe: name the single corrupt DATA shard behind an
    every-parity-stream mismatch (see the module docstring). Probes one
    byte column per offset over the parity shards present (`parity_ids`,
    default all four); returns the data shards identified without
    ambiguity (empty: not single-shard damage; one parity row can never
    discriminate, so it returns nothing)."""
    m = coding_matrix()
    parity_ids = sorted(parity_ids) if parity_ids else \
        list(range(DATA_SHARDS, TOTAL_SHARDS))
    culprits: Set[int] = set()
    for offset in offsets:
        col = [_shard_byte(base, d, offset) for d in range(DATA_SHARDS)]
        delta = {}
        for sid in parity_ids:
            acc = 0
            for d in range(DATA_SHARDS):
                acc ^= int(gf256.GF_MUL_TABLE[m[sid, d], col[d]])
            delta[sid] = acc ^ _shard_byte(base, sid, offset)
        if not all(delta.values()):
            continue  # some parity agrees here: not a data-shard error
        cands = [d for d in range(DATA_SHARDS)
                 if len({gf256.gf_div(delta[sid], int(m[sid, d]))
                         for sid in parity_ids}) == 1]
        if len(parity_ids) >= 2 and len(cands) == 1:
            culprits.add(cands[0])
    return culprits


def classify_ec_damage(damage: EcDamage) -> Tuple[str, List[int]]:
    """-> (verdict, shard ids to rebuild). Verdicts:

    clean          nothing to do
    data           condemned data shard(s) (+ any missing files)
    parity         condemned parity shard(s) (+ any missing files)
    unrecoverable  more than PARITY_SHARDS shards condemned, or fewer
                   than DATA_SHARDS survivors to rebuild from
    """
    bad: Set[int] = set(damage.missing)
    verdict = "clean"
    if damage.bad_data:
        # data evidence wins; parity mismatches are contaminated and get
        # judged again by the post-repair verify round
        bad |= damage.bad_data
        verdict = "data"
    elif damage.parity_mismatch:
        bad |= set(damage.parity_mismatch)
        verdict = "parity"
    elif bad:
        verdict = "data" if any(s < DATA_SHARDS for s in bad) else "parity"
    if not bad:
        return "clean", []
    if len(bad) > PARITY_SHARDS or TOTAL_SHARDS - len(bad) < DATA_SHARDS:
        return "unrecoverable", sorted(bad)
    return verdict, sorted(bad)


def quarantine_shard(base: str, shard_id: int) -> bool:
    """<base>.ecNN -> <base>.ecNN.corrupt (never deleted). A prior
    quarantine of the same shard is rotated to .corrupt.old rather than
    clobbered."""
    path = shard_file_name(base, shard_id)
    if not os.path.exists(path):
        return False
    marker = path + ".corrupt"
    if os.path.exists(marker):
        os.replace(marker, marker + ".old")
    os.replace(path, marker)
    return True


def repair_ec_volume(base: str, bad_shards: List[int],
                     backend: str = "cuda",
                     unmount: Optional[Callable[[int], None]] = None,
                     remount: Optional[Callable[[int], None]] = None,
                     ) -> List[int]:
    """Quarantine and rebuild the condemned shards of one volume, through
    the fleet rebuild on the card (``backend="cuda"``).

    unmount/remount let the store drop its open fd on a shard before the
    rename and open it again after the rebuild. Returns the rebuilt shard
    ids; raises if fewer than DATA_SHARDS survivors remain."""
    with trace.span("scrub.repair", base=os.path.basename(base),
                    shards=len(bad_shards)):
        for sid in bad_shards:
            if unmount is not None:
                unmount(sid)
            quarantine_shard(base, sid)
        rebuilt = fleet.fleet_rebuild_ec_files(
            [base], backend=backend, wanted=list(bad_shards))[base]
        for sid in bad_shards:
            if remount is not None:
                remount(sid)
        return rebuilt


def verify_ec_repair(base: str, backend: str = "cuda") -> "fleet.VerifyResult":
    """Post-repair stripe verify of ONE volume (the daemon's second
    evidence round: after a data-shard rebuild, any parity mismatch that
    remains is genuine parity damage)."""
    with trace.span("scrub.reverify", base=os.path.basename(base)):
        return fleet.fleet_verify_ec_files([base], backend=backend)[base]


def repair_needle(v: Volume, corrupt: Needle,
                  replica_fetch: Callable[[int, Needle], Optional[bytes]],
                  ) -> bool:
    """Rewrite one CRC-bad needle from a replica's copy.

    The corrupt record's header (id, cookie, flags, checksum) survives,
    since only `data` failed its CRC, so the replica's bytes are validated
    against the LOCAL record's stored checksum before anything is written:
    a replica that is itself corrupt (or serves a newer overwrite) never
    lands here. The rewrite is a cookie-checked append committed directly
    under the volume lock with the seal lifted only inside that critical
    section, so no client write can slip onto a sealed volume through the
    repair window. It bypasses the group-commit writer, which would need
    the same lock. The bad record becomes dead space for vacuum."""
    data = replica_fetch(v.id, corrupt)
    if data is None or masked_crc(data) != corrupt.checksum:
        return False
    fixed = Needle(id=corrupt.id, cookie=corrupt.cookie, data=data,
                   flags=corrupt.flags, name=corrupt.name,
                   mime=corrupt.mime, pairs=corrupt.pairs,
                   last_modified=corrupt.last_modified, ttl=corrupt.ttl)
    with trace.span("scrub.repair", vid=v.id, needle=corrupt.id):
        req = _WriteRequest("write", fixed)
        with v._lock:
            was_ro, v.read_only = v.read_only, False
            try:
                v._apply_batch([req])
            finally:
                v.read_only = was_ro
        try:
            req.wait()
        except (NeedleError, VolumeError):
            return False
    return True
