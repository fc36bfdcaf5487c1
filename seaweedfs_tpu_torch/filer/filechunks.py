"""Chunked-file interval math.

A file's content is a list of FileChunk protos, each covering
[offset, offset+size) of the logical file, stamped with mtime. Later
writes shadow earlier ones; the visible view is computed by interval
subtraction (reference: weed/filer/filechunks.go:56-300,
NonOverlappingVisibleIntervals at :226).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, replace
from typing import Iterable, List, Optional

from seaweedfs_tpu_torch.pb import filer_pb2


def total_size(chunks: Iterable[filer_pb2.FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)


def truncate_chunks(chunks: Iterable[filer_pb2.FileChunk],
                    length: int) -> List[filer_pb2.FileChunk]:
    """Clamp a chunk list at `length`: chunks fully past the cut are
    dropped, a straddling chunk keeps its bytes but shrinks its
    visible size (the interval read path honors per-chunk sizes, so
    no data rewrite is needed)."""
    kept: List[filer_pb2.FileChunk] = []
    for c in chunks:
        if c.offset >= length:
            continue
        if c.offset + c.size > length:
            c2 = filer_pb2.FileChunk()
            c2.CopyFrom(c)
            c2.size = length - c.offset
            kept.append(c2)
        else:
            kept.append(c)
    return kept


def etag_of_chunks(chunks: List[filer_pb2.FileChunk]) -> str:
    """One chunk: its own etag. Many: md5-of-etags with a part-count
    suffix, S3 multipart style (reference filer.ETagChunks)."""
    if len(chunks) == 1:
        return chunks[0].e_tag
    h = hashlib.md5()
    for c in chunks:
        h.update(c.e_tag.encode())
    return f"{h.hexdigest()}-{len(chunks)}"


@dataclass(frozen=True)
class VisibleInterval:
    start: int          # logical file offset
    stop: int
    file_id: str
    mtime: int
    chunk_offset: int   # where in the stored chunk this interval begins
    chunk_size: int     # full size of the stored chunk
    cipher_key: bytes = b""
    is_compressed: bool = False

    @property
    def is_full_chunk(self) -> bool:
        return self.chunk_offset == 0 and self.stop - self.start == self.chunk_size


def _merge_into_visibles(visibles: List[VisibleInterval],
                         chunk: filer_pb2.FileChunk) -> List[VisibleInterval]:
    new = VisibleInterval(
        start=chunk.offset, stop=chunk.offset + chunk.size,
        file_id=chunk.file_id, mtime=chunk.mtime, chunk_offset=0,
        chunk_size=chunk.size, cipher_key=bytes(chunk.cipher_key),
        is_compressed=chunk.is_compressed)
    out: List[VisibleInterval] = []
    for v in visibles:
        if v.stop <= new.start or v.start >= new.stop:
            out.append(v)
            continue
        if v.start < new.start:   # left remnant survives
            out.append(replace(v, stop=new.start))
        if v.stop > new.stop:     # right remnant survives, shifted
            cut = new.stop - v.start
            out.append(replace(v, start=new.stop,
                               chunk_offset=v.chunk_offset + cut))
    out.append(new)
    out.sort(key=lambda v: v.start)
    return out


def non_overlapping_visible_intervals(
        chunks: Iterable[filer_pb2.FileChunk]) -> List[VisibleInterval]:
    visibles: List[VisibleInterval] = []
    for chunk in sorted(chunks, key=lambda c: (c.mtime, c.offset)):
        visibles = _merge_into_visibles(visibles, chunk)
    return visibles


@dataclass(frozen=True)
class ChunkView:
    file_id: str
    offset: int         # read offset inside the stored chunk
    size: int           # bytes to read
    logic_offset: int   # where these bytes land in the file
    chunk_size: int
    cipher_key: bytes = b""
    is_compressed: bool = False

    @property
    def is_full_chunk(self) -> bool:
        return self.offset == 0 and self.size == self.chunk_size


def view_from_visibles(visibles: List[VisibleInterval], offset: int,
                       size: Optional[int]) -> List[ChunkView]:
    stop = float("inf") if size is None else offset + size
    views = []
    for v in visibles:
        lo = max(offset, v.start)
        hi = min(stop, v.stop)
        if lo >= hi:
            continue
        views.append(ChunkView(
            file_id=v.file_id,
            offset=v.chunk_offset + (lo - v.start),
            size=int(hi - lo),
            logic_offset=int(lo),
            chunk_size=v.chunk_size,
            cipher_key=v.cipher_key,
            is_compressed=v.is_compressed))
    return views


def view_from_chunks(chunks: Iterable[filer_pb2.FileChunk], offset: int = 0,
                     size: Optional[int] = None) -> List[ChunkView]:
    return view_from_visibles(
        non_overlapping_visible_intervals(chunks), offset, size)


def compact_file_chunks(chunks: List[filer_pb2.FileChunk]):
    """Split into (still-visible, fully-shadowed) chunk lists — the
    garbage list's blobs can be deleted (reference CompactFileChunks)."""
    visible_ids = {v.file_id for v in non_overlapping_visible_intervals(chunks)}
    compacted = [c for c in chunks if c.file_id in visible_ids]
    garbage = [c for c in chunks if c.file_id not in visible_ids]
    return compacted, garbage


def find_unused_file_chunks(old_chunks: List[filer_pb2.FileChunk],
                            new_chunks: List[filer_pb2.FileChunk]):
    """Chunks present in old but not referenced by new (for delete-on-
    update, reference MinusChunks)."""
    keep = {c.file_id for c in new_chunks}
    return [c for c in old_chunks if c.file_id not in keep]
