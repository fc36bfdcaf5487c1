"""Manifest chunks: chunks-of-chunks for super-large files.

When a file accumulates more than MANIFEST_BATCH chunks, batches are
serialized as FileChunkManifest protos, stored as blobs themselves, and
referenced by a single chunk with is_chunk_manifest=True — a two-level
chunk tree (reference: weed/filer/filechunk_manifest.go).
"""

from __future__ import annotations

from typing import Callable, List

from seaweedfs_tpu_torch.pb import filer_pb2

MANIFEST_BATCH = 1000


def has_chunk_manifest(chunks: List[filer_pb2.FileChunk]) -> bool:
    return any(c.is_chunk_manifest for c in chunks)


def separate_manifest_chunks(chunks):
    manifests = [c for c in chunks if c.is_chunk_manifest]
    plain = [c for c in chunks if not c.is_chunk_manifest]
    return manifests, plain


def resolve_chunk_manifest(
        fetch_fn: Callable[[filer_pb2.FileChunk], bytes],
        chunks: List[filer_pb2.FileChunk]) -> List[filer_pb2.FileChunk]:
    """Expand manifest chunks (recursively) into the full flat list.
    fetch_fn reads a chunk's stored bytes."""
    out: List[filer_pb2.FileChunk] = []
    for c in chunks:
        if not c.is_chunk_manifest:
            out.append(c)
            continue
        m = filer_pb2.FileChunkManifest()
        m.ParseFromString(fetch_fn(c))
        out.extend(resolve_chunk_manifest(fetch_fn, list(m.chunks)))
    return out


def maybe_manifestize(
        save_fn: Callable[[bytes], filer_pb2.FileChunk],
        chunks: List[filer_pb2.FileChunk],
        batch: int = MANIFEST_BATCH) -> List[filer_pb2.FileChunk]:
    """Fold plain chunks into manifest chunks when there are too many.
    save_fn stores a blob and returns its FileChunk. Existing manifest
    chunks pass through untouched."""
    manifests, plain = separate_manifest_chunks(chunks)
    if len(plain) <= batch:
        return chunks
    out = list(manifests)
    for i in range(0, len(plain), batch):
        group = plain[i:i + batch]
        if len(group) < batch:      # tail stays flat, like the reference
            out.extend(group)
            continue
        m = filer_pb2.FileChunkManifest(chunks=group)
        saved = save_fn(m.SerializeToString())
        mc = filer_pb2.FileChunk()
        mc.CopyFrom(saved)
        mc.is_chunk_manifest = True
        mc.offset = min(c.offset for c in group)
        mc.size = sum(c.size for c in group)
        mc.mtime = max(c.mtime for c in group)
        out.append(mc)
    return out
