"""Client operations against a cluster: assign, upload, submit, lookup,
download, delete.

The port of ``seaweedfs_tpu.operation.operations``. The data path is
HTTP on the pooled client (``util/http_client.py``, which feeds the
circuit breaker), the control path RPC, like the reference's clients.
``submit`` splits a file larger than ``max_mb`` into chunk needles and a
manifest needle (``operation/chunked_file.py``); ``lookup`` and
``lookup_many`` go through the coalescing lookup cache when it is
enabled (``wdclient/lookup_cache.py``).

Reference: weed/operation/assign_file_id.go, upload_content.go,
submit.go, lookup.go, delete_content.go.
"""

from __future__ import annotations

import gzip as gzip_mod
import itertools
import json
import secrets
import urllib.parse
from typing import Dict, List, NamedTuple, Optional

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.operation.file_id import parse_fid
from seaweedfs_tpu_torch.pb import (master_pb2, master_stub,
                                    volume_server_pb2, volume_stub)
from seaweedfs_tpu_torch.resilience import breaker
from seaweedfs_tpu_torch.util import http_client
from seaweedfs_tpu_torch.util.fanout import FanOutPool

_BOUNDARY_PREFIX = secrets.token_hex(12)
_boundary_counter = itertools.count()

# per-server fan-out of batch deletes; no thread until the first delete
# that spans two servers
_delete_pool = FanOutPool(8, "delete-fanout")


class Assignment(NamedTuple):
    fid: str
    url: str
    public_url: str
    count: int


class HttpResponse(NamedTuple):
    status: int
    body: bytes
    headers: dict


def http_request(method: str, url: str, body: bytes = b"",
                 headers=None, timeout: float = 60.0) -> HttpResponse:
    """One request to "host:port/path" on the pooled client; headers
    come back with lowercase names."""
    r = http_client.request(method, url, body=body or None,
                            headers=headers, timeout=timeout)
    return HttpResponse(r.status, r.body, r.headers)


def assign(master_url: str, count: int = 1, replication: str = "",
           collection: str = "", ttl: str = "",
           data_center: str = "") -> Assignment:
    """Assign a fid through the master's /dir/assign (the reference's
    documented API, master_server_handlers.go)."""
    params = {"count": str(count)}
    if replication:
        params["replication"] = replication
    if collection:
        params["collection"] = collection
    if ttl:
        params["ttl"] = ttl
    if data_center:
        params["dataCenter"] = data_center
    r = http_client.request(
        "GET", f"{master_url}/dir/assign?{urllib.parse.urlencode(params)}")
    out = json.loads(r.body)
    if out.get("error"):
        raise RuntimeError(f"assign failed: {out['error']}")
    return Assignment(out["fid"], out["url"], out.get("publicUrl", ""),
                      out.get("count", count))


def assign_grpc(master_url: str, count: int = 1, replication: str = "",
                collection: str = "", ttl: str = "",
                data_center: str = "") -> Assignment:
    """The same assign over the master's RPC Assign."""
    resp = master_stub(master_url).Assign(master_pb2.AssignRequest(
        count=count, replication=replication, collection=collection,
        ttl=ttl, data_center=data_center))
    if resp.error:
        raise RuntimeError(f"assign failed: {resp.error}")
    return Assignment(resp.fid, resp.url, resp.public_url, resp.count)


def upload_data(url_fid: str, data: bytes, filename: str = "",
                mime: str = "", ttl: str = "", gzip: bool = False,
                fsync: bool = False, is_chunk_manifest: bool = False,
                timeout: float = 60.0) -> dict:
    """POST a blob to "host:port/fid" as multipart/form-data; optionally
    gzip-compressed (stored with the compressed flag). is_chunk_manifest
    marks the needle as a chunk manifest (?cm=true, reference
    needle_parse_upload.go:180)."""
    params = {}
    if ttl:
        params["ttl"] = ttl
    if fsync:
        params["fsync"] = "true"
    if is_chunk_manifest:
        params["cm"] = "true"
    qs = ("?" + urllib.parse.urlencode(params)) if params else ""
    if gzip:
        data = gzip_mod.compress(data)
    boundary = f"sw-{_BOUNDARY_PREFIX}{next(_boundary_counter):x}"
    disp = 'form-data; name="file"'
    if filename:
        disp += f'; filename="{filename}"'
    part_headers = f"Content-Disposition: {disp}\r\n"
    if mime:
        part_headers += f"Content-Type: {mime}\r\n"
    if gzip:
        part_headers += "Content-Encoding: gzip\r\n"
    body = b"".join([f"--{boundary}\r\n{part_headers}\r\n".encode(), data,
                     f"\r\n--{boundary}--\r\n".encode()])
    r = http_client.request(
        "POST", f"{url_fid}{qs}", body=body,
        headers={"Content-Type":
                 f"multipart/form-data; boundary={boundary}"},
        timeout=timeout)
    try:
        out = json.loads(r.body)
    except ValueError:
        out = None
    if not isinstance(out, dict) or out.get("error") or r.status >= 300:
        detail = out.get("error") if isinstance(out, dict) else \
            r.body[:200].decode("latin-1", "replace")
        raise RuntimeError(
            f"upload to {url_fid} failed (http {r.status}): {detail}")
    return out


def _assign_or_lease(master_url: str, leases, replication: str,
                     collection: str, ttl: str,
                     data_center: str = "") -> Assignment:
    """One fid: from a LeaseCache (operation/assign_lease.py) when the
    caller holds one, from a master assign otherwise."""
    if leases is not None:
        return leases.acquire(master_url, collection=collection,
                              replication=replication, ttl=ttl,
                              data_center=data_center)
    return assign(master_url, replication=replication,
                  collection=collection, ttl=ttl, data_center=data_center)


def upload(master_url: str, data: bytes, filename: str = "", mime: str = "",
           replication: str = "", collection: str = "", ttl: str = "",
           data_center: str = "", leases=None) -> str:
    """Assign + upload; returns the fid. A leased fid that fails at the
    volume server is invalidated (dropping its volume's banked siblings)
    and the upload retried once on a fresh master assign, so a leased fid
    is never written twice."""
    a = _assign_or_lease(master_url, leases, replication, collection,
                         ttl, data_center)
    try:
        upload_data(f"{a.url}/{a.fid}", data, filename=filename, mime=mime,
                    ttl=ttl)
    except (RuntimeError, OSError):
        if leases is None:
            raise
        leases.invalidate(a.fid)
        a = assign(master_url, replication=replication,
                   collection=collection, ttl=ttl, data_center=data_center)
        upload_data(f"{a.url}/{a.fid}", data, filename=filename, mime=mime,
                    ttl=ttl)
    return a.fid


def submit(master_url: str, data: bytes, filename: str = "",
           mime: str = "", replication: str = "", collection: str = "",
           ttl: str = "", max_mb: int = 0, leases=None) -> str:
    """Upload one file, split into chunk needles and a manifest needle
    when it is larger than max_mb MiB (reference operation/submit.go:
    128-232). Returns the fid to GET: the manifest's for a chunked file.
    When any chunk fails, the chunks already written are deleted."""
    if max_mb <= 0 or len(data) <= max_mb << 20:
        return upload(master_url, data, filename=filename, mime=mime,
                      replication=replication, collection=collection,
                      ttl=ttl, leases=leases)
    from seaweedfs_tpu_torch.operation.chunked_file import (ChunkInfo,
                                                            ChunkManifest)
    chunk_size = max_mb << 20
    cm = ChunkManifest(name=filename, mime=mime, size=len(data))
    try:
        for i, off in enumerate(range(0, len(data), chunk_size)):
            piece = data[off:off + chunk_size]
            a = _assign_or_lease(master_url, leases, replication,
                                 collection, ttl)
            upload_data(f"{a.url}/{a.fid}", piece,
                        filename=f"{filename}-{i + 1}" if filename else "",
                        ttl=ttl)
            cm.chunks.append(ChunkInfo(fid=a.fid, offset=off,
                                       size=len(piece)))
        a = _assign_or_lease(master_url, leases, replication,
                             collection, ttl)
        upload_data(f"{a.url}/{a.fid}", cm.marshal(), filename=filename,
                    mime="application/json", ttl=ttl,
                    is_chunk_manifest=True)
        return a.fid
    except Exception:
        try:
            cm.delete_chunks(master_url)
        except (RuntimeError, OSError, rpc.RpcError):
            pass  # the cleanup is best effort, as in the reference
        raise


def lookup(master_url: str, vid: int, collection: str = "") -> List[str]:
    """The volume server urls holding ``vid`` (normal replicas, else EC
    shard holders)."""
    from seaweedfs_tpu_torch.wdclient import lookup_cache
    if lookup_cache.enabled:
        # single-flight and TTL'd, not-found answers included
        res = lookup_cache.for_master(master_url, collection).lookup(vid)
        if res.error:
            raise RuntimeError(res.error)
        return [l.url for l in res.locations]
    resp = master_stub(master_url).LookupVolume(
        master_pb2.LookupVolumeRequest(volume_ids=[str(vid)],
                                       collection=collection))
    for vl in resp.volume_id_locations:
        if vl.error:
            raise RuntimeError(vl.error)
        return [l.url for l in vl.locations]
    return []


def lookup_many(master_url: str, vids,
                collection: str = "") -> Dict[int, List[str]]:
    """Resolve many vids at once. With the lookup cache enabled every
    miss rides ONE batched ``/dir/lookup?volumeIds=`` round trip; without
    it this is a loop over lookup(). A vid that fails resolves to []."""
    from seaweedfs_tpu_torch.wdclient import lookup_cache
    ordered = list(dict.fromkeys(vids))
    if lookup_cache.enabled:
        res = lookup_cache.for_master(
            master_url, collection).lookup_many(ordered)
        return {vid: [l.url for l in res[vid].locations]
                for vid in ordered}
    out: Dict[int, List[str]] = {}
    for vid in ordered:
        try:
            out[vid] = lookup(master_url, vid, collection)
        except RuntimeError:
            out[vid] = []
    return out


def download(master_url: str, fid: str, timeout: float = 60.0) -> bytes:
    """GET one fid from any of its volume's holders: replicas with an
    open breaker go last, and a failed holder falls through to the next."""
    vid = parse_fid(fid).volume_id
    urls = lookup(master_url, vid)
    if not urls:
        raise RuntimeError(f"no locations for {fid}")
    last_err: Optional[Exception] = None
    for url in breaker.sort_candidates(urls):
        try:
            return download_url(f"{url}/{fid}", timeout=timeout)
        except (OSError, RuntimeError) as e:
            last_err = e
    from seaweedfs_tpu_torch.wdclient import lookup_cache
    if lookup_cache.enabled:
        # every location failed the read: the cached answer was wrong
        lookup_cache.invalidate(master_url, vid)
    raise last_err


def download_url(url_fid: str, timeout: float = 60.0) -> bytes:
    """GET one needle by volume-server URL (no lookup)."""
    r = http_client.request("GET", url_fid, timeout=timeout)
    if r.status >= 300:
        raise RuntimeError(f"GET {url_fid}: http {r.status}")
    data = r.body
    if r.header("Content-Encoding") == "gzip":
        data = gzip_mod.decompress(data)
    return data


def delete_file(master_url: str, fid: str, timeout: float = 30.0) -> None:
    """DELETE one fid at its volume's first holder; a chunk manifest's
    holder deletes its chunks first."""
    urls = lookup(master_url, parse_fid(fid).volume_id)
    if not urls:
        return
    r = http_client.request("DELETE", f"{urls[0]}/{fid}", timeout=timeout)
    if r.status >= 300:
        raise RuntimeError(f"delete {fid}: http {r.status}")


def delete_files(master_url: str, fids: List[str]) -> List[dict]:
    """Batch delete, grouped by volume server, one BatchDelete per server
    on the fan-out pool (reference operation/delete_content.go fans out
    with goroutines). Every server is drained before the first failure
    is raised."""
    by_vid: Dict[int, List[str]] = {}
    results = []
    for fid in fids:
        try:
            by_vid.setdefault(parse_fid(fid).volume_id, []).append(fid)
        except ValueError as e:
            results.append({"fid": fid, "error": str(e)})
    from seaweedfs_tpu_torch.wdclient import lookup_cache
    if lookup_cache.enabled and len(by_vid) > 1:
        # one batched round trip; the per-vid lookups below answer locally
        lookup_cache.for_master(master_url).lookup_many(list(by_vid))
    by_server: Dict[str, List[str]] = {}
    for vid, group in by_vid.items():
        try:
            urls = lookup(master_url, vid)
        except RuntimeError as e:
            results.extend({"fid": f, "error": str(e)} for f in group)
            continue
        if not urls:
            results.extend({"fid": f, "error": "no locations"}
                           for f in group)
            continue
        # an open-breaker primary goes behind its healthy replicas
        by_server.setdefault(breaker.sort_candidates(urls)[0],
                             []).extend(group)

    def delete_on(url, group):
        resp = volume_stub(url).BatchDelete(
            volume_server_pb2.BatchDeleteRequest(file_ids=group))
        return [{"fid": r.file_id, "status": r.status,
                 "error": r.error, "size": r.size}
                for r in resp.results]

    servers = list(by_server.items())
    outcomes = _delete_pool.run(
        [lambda u=u, g=g: delete_on(u, g) for u, g in servers])
    first_exc = None
    for (_url, _group), (server_results, exc) in zip(servers, outcomes):
        if exc is not None:
            if first_exc is None:
                first_exc = exc
            continue
        results.extend(server_results)
    if first_exc is not None:
        raise first_exc
    return results
