"""Incremental volume backup and tail: ship the .dat delta since a time.

The port of ``seaweedfs_tpu.storage.volume_backup`` and the reference's
weed/storage/volume_backup.go and weed/server/volume_grpc_tail.go:

- ``sync_status``: tail offset, compaction revision and .idx size, the
  handshake a follower uses to choose between an incremental catch-up
  and a full copy (volume_backup.go:19-33);
- ``binary_search_by_append_at_ns``: the .idx is append-ordered, so the
  append times of the records it points at rise along it; the search
  reads each probe's time from the .dat (volume_backup.go:170-218);
- ``incremental_backup``/``apply_incremental``: the follower asks the
  source for every byte after its own newest append, appends them raw at
  its end, then scans the appended part into its needle map
  (volume_backup.go:65-118);
- ``scan_dat_from``: the needle-at-a-time replay of VolumeTailSender
  and VolumeTailReceiver (volume_grpc_tail.go:17-113).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, Tuple

from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import Needle, NeedleError, actual_size
from seaweedfs_tpu_torch.storage.volume import Volume, VolumeError


def sync_status(v: Volume) -> dict:
    """The VolumeSyncStatus payload (reference volume_backup.go:19-33)."""
    idx_size = os.path.getsize(v.idx_path) if os.path.exists(v.idx_path) \
        else 0
    return {
        "volume_id": v.id,
        "collection": v.collection,
        "replication": str(v.replica_placement),
        "ttl": str(v.ttl),
        "tail_offset": v.content_size,
        "compact_revision": v.super_block.compaction_revision,
        "idx_file_size": idx_size,
    }


def _read_append_at_ns(v: Volume, offset: int) -> int:
    """The append time of the record at a .dat offset: the 16-byte header
    for the size, then only the 8-byte time after the checksum, never the
    whole record (volume_backup.go:155-168 reads it the same way)."""
    header = v._dat.read_at(t.NEEDLE_HEADER_SIZE, offset)
    if len(header) < t.NEEDLE_HEADER_SIZE:
        raise VolumeError(f"short header read at {offset}")
    _, _, size_u = struct.unpack(">IQI", header)
    body = t.size_to_int32(size_u)
    if t.size_is_deleted(body):
        body = 0
    ts_off = offset + t.NEEDLE_HEADER_SIZE + body + t.NEEDLE_CHECKSUM_SIZE
    blob = v._dat.read_at(8, ts_off)
    if len(blob) < 8:
        raise VolumeError(f"short timestamp read at {ts_off}")
    return struct.unpack(">Q", blob)[0]


def last_append_at_ns(v: Volume) -> int:
    """The append time of the newest record (through the last .idx
    entry; volume_backup.go:111-153). 0 for an empty volume."""
    if not os.path.exists(v.idx_path):
        return 0
    size = os.path.getsize(v.idx_path)
    if size < t.NEEDLE_MAP_ENTRY_SIZE:
        return 0
    entry_count = size // t.NEEDLE_MAP_ENTRY_SIZE
    with open(v.idx_path, "rb") as f:
        f.seek((entry_count - 1) * t.NEEDLE_MAP_ENTRY_SIZE)
        _, offset, _ = idx_codec.parse_entry(f.read(t.NEEDLE_MAP_ENTRY_SIZE))
    return _read_append_at_ns(v, offset)


def binary_search_by_append_at_ns(v: Volume,
                                  since_ns: int) -> Tuple[int, bool]:
    """The first .dat offset whose record was appended after since_ns.

    Returns (offset, is_last); is_last=True means nothing is newer."""
    if not os.path.exists(v.idx_path):
        return 0, True
    entry_count = os.path.getsize(v.idx_path) // t.NEEDLE_MAP_ENTRY_SIZE
    if entry_count == 0:
        return 0, True
    with open(v.idx_path, "rb") as f:
        def entry_offset(m: int) -> int:
            f.seek(m * t.NEEDLE_MAP_ENTRY_SIZE)
            return idx_codec.parse_entry(
                f.read(t.NEEDLE_MAP_ENTRY_SIZE))[1]

        lo, hi = 0, entry_count
        while lo < hi:
            mid = (lo + hi) // 2
            if _read_append_at_ns(v, entry_offset(mid)) <= since_ns:
                lo = mid + 1
            else:
                hi = mid
        if lo == entry_count:
            return 0, True
        return entry_offset(lo), False


def scan_dat_from(v: Volume, offset: int, include_deleted: bool = True
                  ) -> Iterator[Tuple[int, Needle]]:
    """(offset, needle) of every record at or after a .dat offset; a torn
    tail ends the scan (volume_grpc_tail.go:96-143)."""
    size = v.content_size
    while offset + t.NEEDLE_HEADER_SIZE <= size:
        header = v._dat.read_at(t.NEEDLE_HEADER_SIZE, offset)
        if len(header) < t.NEEDLE_HEADER_SIZE:
            return
        _, _, size_u = struct.unpack(">IQI", header)
        body = t.size_to_int32(size_u)
        if t.size_is_deleted(body):
            body = 0
        length = actual_size(body, v.version)
        blob = v._dat.read_at(length, offset)
        if len(blob) < length:
            return
        try:
            n = Needle.from_bytes(blob, v.version, check_crc=False)
        except NeedleError:
            return
        if include_deleted or len(n.data) > 0:
            yield offset, n
        offset += length


def read_dat_range(v: Volume, offset: int, chunk: int = 1 << 20
                   ) -> Iterator[bytes]:
    """Raw .dat bytes from offset to the end, in chunks (the
    VolumeIncrementalCopy payload, not cut on needle boundaries)."""
    end = v.content_size
    while offset < end:
        data = v._dat.read_at(min(chunk, end - offset), offset)
        if not data:
            return
        yield data
        offset += len(data)


def apply_incremental(v: Volume, chunks) -> int:
    """The follower's side: append the raw delta at the end, then extend
    the needle map by scanning only the appended part
    (volume_backup.go:100-118). Returns the bytes appended."""
    with v._lock:
        start = v.content_size
        write_offset = start
        for chunk in chunks:
            if not chunk:
                continue
            v._dat.write_at(chunk, write_offset)
            write_offset += len(chunk)
        appended = write_offset - start
        if appended == 0:
            return 0
        for offset, n in scan_dat_from(v, start):
            if len(n.data) == 0:
                v.nm.delete(n.id, offset)
            else:
                v.nm.put(n.id, offset, n.size)
            if n.append_at_ns > v.last_append_at_ns:
                v.last_append_at_ns = n.append_at_ns
        v.nm.flush()
        v._dat.sync()
    return appended


def incremental_backup(v: Volume, source_stub) -> int:
    """Catch a local copy up from a source volume server over the
    VolumeIncrementalCopy stream (volume_backup.go:65-118). The caller
    checks compaction revisions and sizes first (reference
    command/backup.go)."""
    from seaweedfs_tpu_torch.pb import volume_server_pb2
    stream = source_stub.VolumeIncrementalCopy(
        volume_server_pb2.VolumeIncrementalCopyRequest(
            volume_id=v.id, since_ns=last_append_at_ns(v)))
    return apply_incremental(v, (resp.file_content for resp in stream))
