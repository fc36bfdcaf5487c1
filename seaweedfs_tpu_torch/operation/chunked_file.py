"""Volume-level chunked files: manifest needles and a streaming reader.

The port of ``seaweedfs_tpu.operation.chunked_file``. A large file
uploaded straight to volume servers is split into ordinary needles plus
one JSON *chunk manifest* needle stored with FLAG_IS_CHUNK_MANIFEST. A GET
of the manifest's fid streams the chunks; a DELETE cascades to them.
``marshal`` writes the JAX package's bytes for the same chunks.

Reference: weed/operation/chunked_file.go (manifest codec + reader),
weed/operation/submit.go:128-232 (split upload + ?cm=true),
weed/server/volume_server_handlers_read.go:180-216 (GET resolve),
volume_server_handlers_write.go:124-137 (DELETE cascade).

The reader is a generator, not the reference's goroutine and pipe:
callers consume ``stream()`` block by block, the same backpressure.
"""

from __future__ import annotations

import gzip
import json
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

from seaweedfs_tpu_torch.util import http_client


@dataclass
class ChunkInfo:
    fid: str
    offset: int
    size: int


@dataclass
class ChunkManifest:
    name: str = ""
    mime: str = ""
    size: int = 0
    chunks: List[ChunkInfo] = field(default_factory=list)

    def marshal(self) -> bytes:
        return json.dumps({
            "name": self.name, "mime": self.mime, "size": self.size,
            "chunks": [{"fid": c.fid, "offset": c.offset, "size": c.size}
                       for c in self.chunks]}).encode()

    def delete_chunks(self, master_url: str) -> None:
        """Delete every sub-chunk; raises on the first reported error
        (reference ChunkManifest.DeleteChunks fails the whole cascade)."""
        from seaweedfs_tpu_torch.operation import operations
        results = operations.delete_files(
            master_url, [c.fid for c in self.chunks])
        for r in results:
            if r.get("error"):
                raise RuntimeError(
                    f"chunk delete {r.get('fid') or r.get('file_id')}: "
                    f"{r['error']}")


def load_chunk_manifest(buffer: bytes,
                        is_compressed: bool = False) -> ChunkManifest:
    if is_compressed:
        try:
            buffer = gzip.decompress(buffer)
        except OSError:
            pass  # reference logs and tries the raw bytes
    raw = json.loads(buffer)
    chunks = [ChunkInfo(fid=c["fid"], offset=int(c.get("offset", 0)),
                        size=int(c.get("size", 0)))
              for c in raw.get("chunks", [])]
    chunks.sort(key=lambda c: c.offset)
    return ChunkManifest(name=raw.get("name", ""),
                         mime=raw.get("mime", ""),
                         size=int(raw.get("size", 0)), chunks=chunks)


class ChunkedFileReader:
    """Seekable streaming view over a chunk list.

    `stream(offset, length)` yields byte blocks in order, resolving
    each chunk's fid through the master and issuing (ranged) GETs over
    the pooled data-plane client."""

    # location cache window: long enough that a 100-chunk GET does not
    # put the master on the data path, short enough that a moved volume
    # is re-resolved without reopening the reader
    LOCATION_TTL_S = 600.0

    def __init__(self, chunks: List[ChunkInfo], master_url: str):
        self.chunks = sorted(chunks, key=lambda c: c.offset)
        self.master_url = master_url
        self.total_size = sum(c.size for c in self.chunks)
        self._vol_urls: dict = {}  # volume id -> (monotonic ts, [urls])

    def _locations(self, fid: str, vid: int) -> List[str]:
        from seaweedfs_tpu_torch.operation import operations
        now = time.monotonic()
        cached = self._vol_urls.get(vid)
        if cached is not None and now - cached[0] < self.LOCATION_TTL_S:
            return cached[1]
        urls = operations.lookup(self.master_url, vid)
        if not urls:
            raise RuntimeError(f"no locations for chunk {fid}")
        self._vol_urls[vid] = (now, urls)
        return urls

    def _fetch_chunk(self, fid: str, headers: dict) -> "http_client.Response":
        """GET one chunk, failing over across the volume's replicas and,
        when every known location fails, forgetting them and asking the
        master once more, so one moved or dead volume server does not
        fail every later read of this reader (the reference looks each
        chunk up afresh, chunked_file.go:176). Unlike the JAX package's
        reader, a redirect counts as a stale location, not as the
        needle's answer, and the re-ask passes the lookup cache."""
        from seaweedfs_tpu_torch.operation.file_id import parse_fid
        vid = parse_fid(fid).volume_id
        # OSError covers http_client._StaleConnection too (clean close
        # or RST from a draining server: the case failover is for)
        last_err: Exception = RuntimeError(f"no locations for chunk {fid}")
        for attempt in range(2):
            try:
                urls = self._locations(fid, vid)
            except (RuntimeError, OSError) as e:
                last_err = e
                break
            for url in urls:
                try:
                    r = http_client.request("GET", f"{url}/{fid}",
                                            headers=headers, timeout=60.0)
                except OSError as e:
                    last_err = e
                    continue
                if r.status in (200, 206):
                    return r
                if r.status < 300 or 400 <= r.status < 500:
                    # a definitive per-needle answer (404 deleted, 416
                    # bad range, ...) is not a topology failure: no
                    # replica retry storm, no master re-lookup
                    raise RuntimeError(f"chunk {fid}: http {r.status}")
                # a 5xx, or a redirect: that server no longer holds the
                # volume (ec.encode moved it), so the location is stale
                last_err = RuntimeError(f"chunk {fid}: http {r.status}")
            # every known location failed: drop the memo, and the lookup
            # cache's answer, so the master is asked again, once
            self._vol_urls.pop(vid, None)
            from seaweedfs_tpu_torch.wdclient import lookup_cache
            if lookup_cache.enabled:
                lookup_cache.invalidate(self.master_url, vid)
        raise last_err

    def stream(self, offset: int = 0,
               length: Optional[int] = None) -> Iterator[bytes]:
        remaining = self.total_size - offset if length is None else length
        if offset < 0 or offset > self.total_size:
            raise ValueError(f"offset {offset} outside 0..{self.total_size}")
        for c in self.chunks:
            if remaining <= 0:
                return
            if offset >= c.offset + c.size:
                continue
            start = max(0, offset - c.offset)
            want = min(c.size - start, remaining)
            headers = {}
            if start or want < c.size:
                headers["Range"] = f"bytes={start}-{start + want - 1}"
            r = self._fetch_chunk(c.fid, headers)
            data = r.body
            if r.status == 200 and (start or want < len(data)):
                # server ignored the range (e.g. compressed chunk)
                data = data[start:start + want]
            if len(data) != want:
                # manifest size disagreeing with the stored needle must
                # surface loudly, not as misaligned bytes under an
                # already-sent Content-Length
                raise RuntimeError(
                    f"chunk {c.fid}: short read {len(data)} != {want}")
            yield data
            remaining -= want
            offset += want

    def read_all(self) -> bytes:
        return b"".join(self.stream())
