"""Shared HTTP data-path client for talking to a filer server —
used by the S3 and WebDAV gateways (metadata rides filer gRPC; bulk
bytes ride the filer's auto-chunking HTTP path).

Rides the pooled keep-alive client (util.http_client): gateway→filer
traffic is the S3 plane's inner hop, and a connection per request
costs a connect/teardown pair plus the occasional SYN-retransmit
second on a loaded loopback. Error contract preserved from the
urllib era: statuses >= 400 raise urllib.error.HTTPError, which the
gateways map to their own replies.
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.parse
from typing import Dict, Optional, Tuple

from seaweedfs_tpu_torch.util import http_client

TIMEOUT = 120.0


def filer_url(filer: str, path: str) -> str:
    return f"http://{filer}{urllib.parse.quote(path)}"


def _raise_for_status(url: str, r: "http_client.Response") -> None:
    if r.status >= 400:
        raise urllib.error.HTTPError(url, r.status, r.body[:200].decode(
            "latin-1", "replace"), r.headers, io.BytesIO(r.body))


def put(filer: str, path: str, data: bytes,
        mime: str = "") -> Tuple[dict, Dict[str, str]]:
    """PUT bytes; returns (json body, response headers) — the ETag
    header carries the chunked etag. Headers come back as the pooled
    client's case-insensitive HeaderDict."""
    headers = {"Content-Type": mime} if mime else None
    url = filer_url(filer, path)
    r = http_client.request("PUT", url, body=data, headers=headers,
                            timeout=TIMEOUT)
    _raise_for_status(url, r)
    return (json.loads(r.body) if r.body else {}), r.headers


def get(filer: str, path: str,
        range_header: Optional[str] = None,
        extra_headers: Optional[Dict[str, str]] = None
        ) -> Tuple[int, bytes, Dict[str, str]]:
    headers = dict(extra_headers or {})
    if range_header:
        headers["Range"] = range_header
    url = filer_url(filer, path)
    r = http_client.request("GET", url, headers=headers or None,
                            timeout=TIMEOUT)
    _raise_for_status(url, r)
    return r.status, r.body, r.headers
