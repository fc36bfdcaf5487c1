"""Client operations against a cluster: assign, upload, lookup.

The port of ``seaweedfs_tpu.operation.operations`` for clients and
``chip_smoke.py``: ``assign`` asks the master's ``/dir/assign``,
``upload`` POSTs a multipart body to the assigned volume server, and
``lookup`` asks the master over RPC. HTTP rides one keep-alive
connection per thread and host (``http.client``).

Reference: weed/operation/assign_file_id.go, upload_content.go,
lookup.go.
"""

from __future__ import annotations

import gzip as gzip_mod
import http.client
import itertools
import json
import secrets
import threading
import urllib.parse
from typing import List, NamedTuple

from seaweedfs_tpu_torch.pb import master_pb2, master_stub

_BOUNDARY_PREFIX = secrets.token_hex(12)
_boundary_counter = itertools.count()
_local = threading.local()


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
    """One request to "host:port/path" on this thread's keep-alive
    connection to that host; a stale connection is redialled once."""
    host, _, path = url.partition("/")
    conns = getattr(_local, "conns", None)
    if conns is None:
        conns = _local.conns = {}
    for attempt in (0, 1):
        conn = conns.get(host)
        if conn is None:
            conn = conns[host] = http.client.HTTPConnection(
                host, timeout=timeout)
        try:
            conn.request(method, "/" + path, body=body or None,
                         headers=headers or {})
            resp = conn.getresponse()
            data = resp.read()
            return HttpResponse(resp.status, data,
                                {k.lower(): v for k, v in
                                 resp.getheaders()})
        except (http.client.HTTPException, OSError):
            conn.close()
            conns.pop(host, None)
            if attempt:
                raise
    raise AssertionError("unreachable")


def close_connections() -> None:
    """Close this thread's keep-alive connections."""
    for conn in getattr(_local, "conns", {}).values():
        conn.close()
    _local.conns = {}


def assign(master_url: str, count: int = 1, replication: str = "",
           collection: str = "") -> Assignment:
    """Assign a fid via the master's /dir/assign."""
    params = {"count": str(count)}
    if replication:
        params["replication"] = replication
    if collection:
        params["collection"] = collection
    r = http_request("GET", f"{master_url}/dir/assign?"
                     f"{urllib.parse.urlencode(params)}")
    out = json.loads(r.body)
    if out.get("error"):
        raise RuntimeError(f"assign failed: {out['error']}")
    return Assignment(out["fid"], out["url"], out.get("publicUrl", ""),
                      out.get("count", count))


def upload_data(url_fid: str, data: bytes, filename: str = "",
                mime: str = "", gzip: bool = False,
                timeout: float = 60.0) -> dict:
    """POST a blob to "host:port/fid" as multipart/form-data; optionally
    gzip-compressed (the needle is then stored with its compressed
    flag)."""
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
    r = http_request(
        "POST", url_fid, body=body,
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


def upload(master_url: str, data: bytes, filename: str = "", mime: str = "",
           replication: str = "", collection: str = "") -> str:
    """Assign + upload; returns the fid."""
    a = assign(master_url, replication=replication, collection=collection)
    upload_data(f"{a.url}/{a.fid}", data, filename=filename, mime=mime)
    return a.fid


def lookup(master_url: str, vid: int, collection: str = "") -> List[str]:
    """The volume server urls holding ``vid`` (normal replicas, else EC
    shard holders)."""
    resp = master_stub(master_url).LookupVolume(
        master_pb2.LookupVolumeRequest(volume_ids=[str(vid)],
                                       collection=collection))
    for vl in resp.volume_id_locations:
        if vl.error:
            raise RuntimeError(vl.error)
        return [loc.url for loc in vl.locations]
    return []
