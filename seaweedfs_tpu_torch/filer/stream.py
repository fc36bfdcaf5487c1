"""Chunk fetch + content streaming for the filer read path
(reference: weed/filer/stream.go:16-210, reader_at.go).

A chunk's stored bytes may be encrypted (cipher_key) and/or gzipped
(is_compressed); this layer undoes both, caches whole chunks in the
TieredChunkCache, and yields the visible byte ranges in order.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

from seaweedfs_tpu_torch.resilience import breaker, deadline
from seaweedfs_tpu_torch.util import http_client

from seaweedfs_tpu_torch.filer import filechunks
from seaweedfs_tpu_torch.filer.filechunk_manifest import resolve_chunk_manifest
from seaweedfs_tpu_torch.pb import filer_pb2
from seaweedfs_tpu_torch.util import compression
from seaweedfs_tpu_torch.util.chunk_cache import TieredChunkCache
from seaweedfs_tpu_torch.util.cipher import decrypt

LookupFn = Callable[[str], List[str]]  # fileId -> [volume server urls]


def filer_lookup_fn(stub) -> LookupFn:
    """fileId -> [volume server urls] resolved through a filer stub's
    LookupVolume (the way filer clients locate chunk bytes, reference
    filer_cat.go GetLookupFileIdFunction)."""
    def lookup(file_id: str):
        vid = file_id.split(",")[0]
        resp = stub.LookupVolume(
            filer_pb2.LookupVolumeRequest(volume_ids=[vid]))
        locs = resp.locations_map.get(vid)
        return [l.url for l in locs.locations] if locs else []
    return lookup


def _fetch_one(url: str, file_id: str) -> bytes:
    """One replica's raw stored chunk bytes; raises on any failure so
    hedged/failover callers can move to the next candidate."""
    # pooled keep-alive client: chunk fetches are the filer read
    # path's inner hop, and a fresh connection per chunk is both a
    # syscall tax and an occasional 1s SYN-retransmit p99 spike
    r = http_client.request(
        "GET", f"{url}/{file_id}",
        # raw stored bytes, no server-side decompression
        headers={"Accept-Encoding": "gzip"}, timeout=60.0)
    if r.status != 200:
        raise IOError(f"http {r.status}")
    return r.body


def fetch_chunk_bytes(lookup: LookupFn, file_id: str,
                      cipher_key: bytes = b"",
                      is_compressed: bool = False,
                      cache: Optional[TieredChunkCache] = None,
                      hedger=None) -> bytes:
    """The full decoded chunk (decrypted + decompressed).

    Candidate replicas are breaker-sorted (open-breaker peers last);
    with a resilience.Hedger wired (-resilience.hedge on the filer) a
    read that outlives the tracked p95 issues ONE hedge to the next
    replica and the first response wins."""
    if cache is not None:
        hit = cache.get(file_id)
        if hit is not None:
            return hit
    urls = breaker.sort_candidates(lookup(file_id))
    data = None
    if hedger is not None and len(urls) > 1:
        try:
            data = hedger.fetch(
                [lambda u=u: _fetch_one(u, file_id) for u in urls])
        except deadline.DeadlineExceeded:
            # same 504 contract as the non-hedged branch below —
            # DeadlineExceeded IS an OSError, so it must dodge the
            # rewrap or enabling hedging would turn 504s into 500s
            raise
        except (OSError, IOError) as e:
            raise IOError(f"fetch {file_id}: no reachable replica: {e}")
    else:
        err: Optional[Exception] = None
        for url in urls:
            try:
                data = _fetch_one(url, file_id)
                break
            except deadline.DeadlineExceeded:
                # a spent budget is not "no reachable replica" — it
                # must surface as the 504 the client's header asked for
                raise
            except OSError as e:  # incl. http_client._StaleConnection
                err = e
        if data is None:
            raise IOError(f"fetch {file_id}: no reachable replica: {err}")
    if cipher_key:
        data = decrypt(data, cipher_key)
    if is_compressed:
        data = compression.decompress(data)
    if cache is not None:
        cache.set(file_id, data)
    return data


def stream_content(lookup: LookupFn, chunks: List[filer_pb2.FileChunk],
                   offset: int = 0, size: Optional[int] = None,
                   cache: Optional[TieredChunkCache] = None,
                   hedger=None) -> Iterator[bytes]:
    """Yield the file's visible bytes for [offset, offset+size)."""
    def fetch(c: filer_pb2.FileChunk) -> bytes:
        return fetch_chunk_bytes(lookup, c.file_id, bytes(c.cipher_key),
                                 c.is_compressed, cache, hedger=hedger)

    chunks = resolve_chunk_manifest(fetch, list(chunks))
    views = filechunks.view_from_chunks(chunks, offset, size)
    pos = offset
    for view in views:
        if view.logic_offset > pos:  # hole: sparse zeros
            yield b"\x00" * (view.logic_offset - pos)
        whole = fetch_chunk_bytes(lookup, view.file_id, view.cipher_key,
                                  view.is_compressed, cache,
                                  hedger=hedger)
        yield whole[view.offset:view.offset + view.size]
        pos = view.logic_offset + view.size
    if size is not None and pos < offset + size:
        total = filechunks.total_size(chunks)
        stop = min(offset + size, total)
        if stop > pos:  # trailing hole inside the file
            yield b"\x00" * (stop - pos)


def read_all(lookup: LookupFn, chunks: List[filer_pb2.FileChunk],
             cache: Optional[TieredChunkCache] = None) -> bytes:
    return b"".join(stream_content(lookup, chunks, cache=cache))


class ChunkReader:
    """Random-access reader over a chunked file (reference reader_at.go);
    used by the WebDAV/mount read paths."""

    def __init__(self, lookup: LookupFn,
                 chunks: List[filer_pb2.FileChunk],
                 cache: Optional[TieredChunkCache] = None):
        def fetch(c: filer_pb2.FileChunk) -> bytes:
            return fetch_chunk_bytes(lookup, c.file_id,
                                     bytes(c.cipher_key),
                                     c.is_compressed, cache)
        self.lookup = lookup
        self.cache = cache
        self.chunks = resolve_chunk_manifest(fetch, list(chunks))
        self.visibles = filechunks.non_overlapping_visible_intervals(
            self.chunks)
        self.size = filechunks.total_size(self.chunks)

    def read_at(self, offset: int, size: int) -> bytes:
        size = max(0, min(size, self.size - offset))
        if size == 0:
            return b""
        views = filechunks.view_from_visibles(self.visibles, offset, size)
        out = bytearray(size)
        for v in views:
            whole = fetch_chunk_bytes(self.lookup, v.file_id, v.cipher_key,
                                      v.is_compressed, self.cache)
            piece = whole[v.offset:v.offset + v.size]
            start = v.logic_offset - offset
            out[start:start + len(piece)] = piece
        return bytes(out)
