"""Vacuum: compact away deleted and overwritten needles.

The port of ``seaweedfs_tpu.storage.vacuum`` and the reference's
compaction (weed/storage/volume_vacuum.go): the live needles are copied
into shadow files (.cpd/.cpx) while the volume stays writable; the commit
catches up with the writes that landed meanwhile (makeupDiff), then
renames the shadows into place and reloads. The superblock's compaction
revision goes up by one, so replicas can tell a compacted peer.

Crash safety: the shadows are fsync'd, then .cpd -> .dat is renamed
BEFORE .cpx -> .idx. At load, ``recover_compaction`` resolves every
state a crash can leave:

  .cpd (with or without .cpx) -> the commit never reached the renames:
                                 drop the shadows (abort).
  .cpx only                   -> crash between the renames: the .dat is
                                 the compacted one, so finish by renaming
                                 .cpx -> .idx (roll forward).

Three things of the port's storage engine meet here. The group-commit
writer applies its batches under the volume lock and reads the volume's
.dat handle and needle map only inside it, so a batch queued while the
commit holds the lock lands in the new files after the reload, never in
the old handle. The kv needle map's LogKV (``<base>.idx.nmkv``) holds
offsets into the old .dat, and its crash reconciliation compares .idx
sequence numbers, not offsets: the commit removes it, and the reload
rebuilds it from the compacted .idx. The scan's end is taken under the
volume lock, so no batch is half-published at the snapshot.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import struct
from typing import Dict, Tuple

from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import Needle, NeedleError, actual_size
from seaweedfs_tpu_torch.storage.superblock import SuperBlock
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util.throttler import Throttler


@dataclasses.dataclass
class CompactState:
    cpd_path: str
    cpx_path: str
    scanned_until: int            # .dat offset the compact scan covered
    new_offsets: Dict[int, Tuple[int, int]]  # key -> (offset in .cpd, size)


def compact(v: Volume, preallocate: int = 0,
            compaction_mbps: float = 0.0) -> CompactState:
    """Phase 1: copy the live needles into <base>.cpd/.cpx.

    Writes go on meanwhile: the scan reads its own fd and the needle map
    is only read. Returns what commit_compact needs."""
    base = v.file_name()
    cpd_path, cpx_path = base + ".cpd", base + ".cpx"
    new_sb = SuperBlock(
        version=v.version,
        replica_placement=v.super_block.replica_placement,
        ttl=v.super_block.ttl,
        compaction_revision=(v.super_block.compaction_revision + 1) & 0xFFFF,
    )
    with v._lock:
        # no batch is in flight under the lock: every record below this
        # offset has its index entry published
        scanned_until = v.content_size
    new_offsets: Dict[int, Tuple[int, int]] = {}
    throttler = Throttler(compaction_mbps)
    with open(cpd_path, "wb") as out:
        out.write(new_sb.to_bytes())
        pos = out.tell()
        for offset, n in v.scan_needles():
            if offset >= scanned_until:
                # landed after the snapshot: _makeup_diff replays it (a
                # second copy here would leave a phantom in the index)
                break
            nv = v.nm.get(n.id)
            # only the live copy is kept: the map points at the newest
            # record, so older overwrites and deleted ids drop
            if nv is None or nv.offset != offset or \
                    not t.size_is_valid(nv.size):
                continue
            blob = n.to_bytes(v.version)
            if pos % t.NEEDLE_PADDING:
                pad = t.NEEDLE_PADDING - pos % t.NEEDLE_PADDING
                out.write(b"\x00" * pad)
                pos += pad
            out.write(blob)
            throttler.maybe_slowdown(len(blob))
            new_offsets[n.id] = (pos, n.size)
            pos += len(blob)
    with open(cpx_path, "wb") as out:
        for key, (offset, size) in new_offsets.items():
            out.write(idx_codec.entry_to_bytes(key, offset, size))
    return CompactState(cpd_path, cpx_path, scanned_until, new_offsets)


def commit_compact(v: Volume, state: CompactState) -> None:
    """Phase 2: fold in the writes made since the scan, swap the shadows
    into place and reload, all under the volume lock."""
    with v._lock:
        v.sync()
        _makeup_diff(v, state)
        # re-stamp the shadow superblock from the live one (keeping the
        # new revision): the replica placement may have changed while
        # the scan ran, and renaming a stale .cpd would revert it
        with open(state.cpd_path, "r+b") as cpd:
            shadow = SuperBlock.from_bytes(cpd.read(8))
            cpd.seek(0)
            cpd.write(SuperBlock(
                version=shadow.version,
                replica_placement=v.super_block.replica_placement,
                ttl=v.super_block.ttl,
                compaction_revision=shadow.compaction_revision).to_bytes())
        for p in (state.cpd_path, state.cpx_path):
            fd = os.open(p, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        v._dat.close()
        v.nm.close()
        # the kv map's offsets point into the old .dat: the reload
        # rebuilds it from the compacted .idx
        shutil.rmtree(v.idx_path + ".nmkv", ignore_errors=True)
        # .cpd first: a .cpx without a .cpd tells recover_compaction
        # that the .dat is already the compacted one
        os.replace(state.cpd_path, v.dat_path)
        os.replace(state.cpx_path, v.idx_path)
        v._load()


def recover_compaction(base_name: str) -> None:
    """Resolve the shadow files a crash mid-vacuum left (see the module
    docstring). A no-op without them; every load calls it."""
    cpd, cpx = base_name + ".cpd", base_name + ".cpx"
    if os.path.exists(cpd):
        os.remove(cpd)
        if os.path.exists(cpx):
            os.remove(cpx)
    elif os.path.exists(cpx):
        os.replace(cpx, base_name + ".idx")


def _makeup_diff(v: Volume, state: CompactState) -> None:
    """Replay the .dat records appended after the scan onto the shadows
    (reference makeupDiff, volume_vacuum.go:179)."""
    dat_size = v.content_size
    if dat_size <= state.scanned_until:
        return
    with open(v.dat_path, "rb") as f, \
            open(state.cpd_path, "r+b") as cpd, \
            open(state.cpx_path, "ab") as cpx:
        cpd.seek(0, os.SEEK_END)
        offset = _align(state.scanned_until)
        while offset + t.NEEDLE_HEADER_SIZE <= dat_size:
            f.seek(offset)
            header = f.read(t.NEEDLE_HEADER_SIZE)
            if len(header) < t.NEEDLE_HEADER_SIZE:
                break
            _, nid, size_u = struct.unpack(">IQI", header)
            body_size = t.size_to_int32(size_u)
            if t.size_is_deleted(body_size):
                body_size = 0
            length = actual_size(body_size, v.version)
            f.seek(offset)
            blob = f.read(length)
            if len(blob) < length:
                break
            try:
                n = Needle.from_bytes(blob, v.version, check_crc=False)
            except NeedleError:
                offset += length
                continue
            if len(n.data) == 0:
                # a delete marker: tombstone the id in the shadow index
                state.new_offsets.pop(nid, None)
                cpx.write(idx_codec.entry_to_bytes(
                    nid, 0, t.TOMBSTONE_SIZE))
            else:
                pos = _align(cpd.tell())
                if pos != cpd.tell():
                    cpd.write(b"\x00" * (pos - cpd.tell()))
                cpd.write(blob)
                state.new_offsets[nid] = (pos, n.size)
                cpx.write(idx_codec.entry_to_bytes(nid, pos, n.size))
            offset += length
    state.scanned_until = dat_size


def _align(pos: int) -> int:
    if pos % t.NEEDLE_PADDING:
        return pos + t.NEEDLE_PADDING - pos % t.NEEDLE_PADDING
    return pos


def vacuum_volume(v: Volume, garbage_threshold: float = 0.3) -> bool:
    """Compact and commit when the garbage ratio is above the threshold;
    the one-call form (reference topology_vacuum.go:147)."""
    if v.garbage_ratio() <= garbage_threshold:
        return False
    commit_compact(v, compact(v))
    return True
