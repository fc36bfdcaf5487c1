"""Offline volume tools: rebuild an index from the data file, export
needles to a tar archive.

The counterpart of ``seaweedfs_tpu.storage.fix``, and the reference's
weed/command/fix.go:21-100 (walk the .dat with a visitor that re-derives
the .idx entries; deleted records become tombstones) and
weed/command/export.go (dump the live needles into a tar archive). Both
work on the raw files, so they serve unmounted or damaged volumes.
"""

from __future__ import annotations

import io
import os
import struct
import tarfile
import time
from typing import Dict, Iterator, Tuple

from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import (Needle, NeedleError,
                                                actual_size)
from seaweedfs_tpu_torch.storage.superblock import (SUPER_BLOCK_SIZE,
                                                    SuperBlock)


def scan_dat(dat_path: str) -> Iterator[Tuple[int, Needle]]:
    """Yield (offset, needle) for every record of a raw .dat, delete
    markers (empty-data needles) included; the scan stops at a torn or
    garbled record, like the reference's."""
    size = os.path.getsize(dat_path)
    with open(dat_path, "rb") as f:
        version = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE)).version
        offset = SUPER_BLOCK_SIZE
        while offset + t.NEEDLE_HEADER_SIZE <= size:
            f.seek(offset)
            header = f.read(t.NEEDLE_HEADER_SIZE)
            if len(header) < t.NEEDLE_HEADER_SIZE:
                break
            _, _, size_u = struct.unpack(">IQI", header)
            body_size = t.size_to_int32(size_u)
            if t.size_is_deleted(body_size):
                body_size = 0
            length = actual_size(body_size, version)
            f.seek(offset)
            blob = f.read(length)
            if len(blob) < length:
                break
            try:
                n = Needle.from_bytes(blob, version, check_crc=False)
            except (NeedleError, struct.error, IndexError, ValueError):
                break
            yield offset, n
            offset += length


def rebuild_idx(base_name: str) -> int:
    """Write <base>.idx anew from <base>.dat and return its entry count.
    One entry per needle id, in the order of the id's first record; the
    newest record wins, and a delete marker becomes a tombstone entry
    (the reference's visitor, fix.go:40-66)."""
    entries: Dict[int, Tuple[int, int]] = {}  # id -> (offset, size)
    for offset, n in scan_dat(base_name + ".dat"):
        entries[n.id] = (offset, n.size if len(n.data) else
                         t.TOMBSTONE_SIZE)
    with open(base_name + ".idx", "wb") as out:
        out.write(b"".join(idx_codec.entry_to_bytes(nid, off, size)
                           for nid, (off, size) in entries.items()))
    return len(entries)


def export_tar(base_name: str, volume_id: int, output: str) -> int:
    """Write every live needle into a tar archive at ``output`` and
    return the count. A member is named by the needle's stored name, else
    "<vid>/<id>"; its mtime is the needle's append time."""
    live: Dict[int, Needle] = {}
    for _, n in scan_dat(base_name + ".dat"):
        if len(n.data) == 0:
            live.pop(n.id, None)
        else:
            live[n.id] = n
    with tarfile.open(output, "w") as tar:
        for nid, n in live.items():
            name = n.name.decode("utf-8", "replace") if n.name \
                else f"{volume_id}/{nid}"
            info = tarfile.TarInfo(name=name)
            info.size = len(n.data)
            info.mtime = int(n.append_at_ns / 1e9) if n.append_at_ns \
                else int(time.time())
            tar.addfile(info, io.BytesIO(bytes(n.data)))
    return len(live)
