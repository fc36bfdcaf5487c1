"""Scrub scanner: walk stored bytes and recompute their checksums.

The counterpart of ``seaweedfs_tpu.scrub.scanner``. Two surfaces, one per
on-disk format:

  * normal volumes: every LIVE needle record in the .dat (the copy the
    needle map points at; dead overwrites are vacuum's business) gets its
    masked CRC recomputed through ``verify_needle_integrity``, on the host.
  * EC volumes: each live .ecx entry is re-assembled from LOCAL shards and
    CRC-checked on the host. A failure is localized to the data shard at
    fault by single-shard-exclusion reconstruction, which runs through
    ``EcVolume._recover_interval`` and so through the ``gf_linear`` kernel
    on the card (or on the given codec). The stripe-level verify is
    batched across volumes by the daemon, not done here.

The scanner only reads; every repair decision belongs to
``scrub/planner.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Set, Tuple

from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
from seaweedfs_tpu_torch.ec.shard_bits import DATA_SHARDS
from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import (
    DataCorruptionError, Needle, NeedleError, actual_size,
    verify_needle_integrity)
from seaweedfs_tpu_torch.storage.volume import Volume

# What a corrupt record can throw at parse time: a CRC failure is a clean
# DataCorruptionError, but a truncated or garbled record dies lower
# (struct.unpack on a short tail, an index past the end). All of it is
# corruption evidence; none of it may abort the pass.
PARSE_ERRORS = (NeedleError, struct.error, IndexError, ValueError)


@dataclass
class NeedleScan:
    """One volume's needle sweep."""

    bytes_scanned: int = 0
    needles_verified: int = 0
    # (dat offset, parsed but CRC-bad needle): its header (id, cookie,
    # checksum) is the planner's handle on it
    corrupt: List[Tuple[int, Needle]] = field(default_factory=list)


def scan_volume(v: Volume, throttler=None) -> NeedleScan:
    """Verify every live needle of one mounted volume, on the volume's own
    scan fd (``scan_needles``); the needle map is consulted per record to
    skip dead copies."""
    res = NeedleScan()
    with trace.span("scrub.scan", vid=v.id):
        for offset, n in v.scan_needles():
            nv = v.nm.get(n.id)
            if nv is None or nv.offset != offset or \
                    not t.size_is_valid(nv.size):
                continue  # overwritten or deleted: not the live copy
            length = actual_size(n.size, v.version)
            res.bytes_scanned += length
            res.needles_verified += 1
            if throttler is not None:
                throttler.maybe_slowdown(length)
            try:
                verify_needle_integrity(n)
            except DataCorruptionError:
                res.corrupt.append((offset, n))
    return res


@dataclass
class EcNeedleScan:
    """One EC volume's needle sweep over local shards."""

    bytes_scanned: int = 0
    needles_verified: int = 0
    corrupt: List[int] = field(default_factory=list)   # needle ids
    bad_data_shards: Set[int] = field(default_factory=set)
    skipped_remote: int = 0   # needles touching non-local shards


def scan_ec_volume_needles(ecv: EcVolume, version: int = 3,
                           throttler=None,
                           rs: Optional[ReedSolomon] = None) -> EcNeedleScan:
    """CRC-verify every live .ecx needle assembled from LOCAL shards.

    A CRC failure is localized by single-shard exclusion: the needle is
    re-read with each touched data shard treated as missing (RS
    reconstruction from the others through ``rs``, the card's codec when
    None); the exclusion that makes the CRC pass names the corrupt shard.
    Needles spanning shards this server does not hold are skipped (their
    holder scrubs them).

    While tracing is on, each needle's read (``scrub.sweep.read``, tagged
    with its bytes) and parse with its CRC (``scrub.sweep.crc``) are
    spans, and so is a localization (``scrub.localize``); off, a needle
    costs one flag check."""
    res = EcNeedleScan()
    with trace.span("scrub.scan_ec", vid=ecv.volume_id):
        for i in range(len(ecv._keys)):
            size = int(ecv._sizes[i])
            if t.size_is_deleted(size):
                continue
            key = int(ecv._keys[i])
            traced = trace.active()
            try:
                if traced:
                    with trace.Span("scrub.sweep.read", None, {}) as sp:
                        placed, blob = _read_local_needle(ecv, key, version)
                        sp.tags["bytes"] = len(blob)
                else:
                    placed, blob = _read_local_needle(ecv, key, version)
            except NeedleError:
                continue  # tombstoned between snapshot and read
            if placed is None:
                res.skipped_remote += 1
                continue
            res.bytes_scanned += len(blob)
            res.needles_verified += 1
            if throttler is not None:
                throttler.maybe_slowdown(len(blob))
            try:
                if traced:
                    with trace.Span("scrub.sweep.crc", None, {}):
                        Needle.from_bytes(blob, version)
                else:
                    Needle.from_bytes(blob, version)
            except PARSE_ERRORS:  # CRC mismatch or a torn/short parse
                res.corrupt.append(key)
                with trace.span("scrub.localize", vid=ecv.volume_id):
                    res.bad_data_shards |= _localize_bad_shard(
                        ecv, placed, version, rs)
    return res


def _read_local_needle(ecv: EcVolume, key: int, version: int):
    """(placed intervals, the needle's record bytes) from local shards;
    (None, b"") when an interval lies on a shard this server does not
    hold. Raises NeedleError for a needle tombstoned since the
    snapshot."""
    _, _, intervals = ecv.locate_needle(key, version)
    placed = [iv.to_shard_and_offset(ecv.large_block,
                                     ecv.small_block) + (iv.size,)
              for iv in intervals]
    if any(sid not in ecv.shards for sid, _, _ in placed):
        return None, b""
    return placed, b"".join(ecv.shards[sid].read_at(off, ln)
                            for sid, off, ln in placed)


def _localize_bad_shard(ecv: EcVolume, placed, version: int,
                        rs: Optional[ReedSolomon]) -> Set[int]:
    """Which single data shard, if excluded and RS-reconstructed, makes
    the needle's CRC pass? Empty set: not localizable this way
    (multi-shard damage, or parity too corrupt to rebuild with); the
    planner then falls back on the stripe-verify evidence."""
    candidates = sorted({sid for sid, _, _ in placed if sid < DATA_SHARDS})
    for suspect in candidates:
        try:
            pieces = []
            for sid, off, ln in placed:
                if sid == suspect:
                    pieces.append(ecv._recover_interval(sid, off, ln,
                                                        None, rs))
                else:
                    pieces.append(ecv.shards[sid].read_at(off, ln))
            Needle.from_bytes(b"".join(pieces), version)
        except PARSE_ERRORS:
            continue
        return {suspect}
    return set()
