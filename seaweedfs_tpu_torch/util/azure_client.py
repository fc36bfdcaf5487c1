"""Azure Blob REST client with SharedKey auth (stdlib only): the port of
``seaweedfs_tpu.util.azure_client``.

The reference pulls in azure-storage-blob-go for its Azure replication
sink (weed/replication/sink/azuresink/azure_sink.go); SharedKey is
HMAC-SHA256 over a canonicalized request (the same class of client as
``util/s3_client.py``'s SigV4), so the sink needs no SDK.

Covers Put/Get/Delete Blob and container listing, the operations the
replication sink uses. ``endpoint`` may point at a local emulator; the
default is https://<account>.blob.core.windows.net.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from email.utils import formatdate
from typing import Dict, Iterator, List, Optional, Tuple

API_VERSION = "2019-12-12"


class AzureError(Exception):
    def __init__(self, status: int, body: str = ""):
        super().__init__(f"Azure request failed: HTTP {status} "
                         f"{body[:200]}")
        self.status = status
        self.body = body


def string_to_sign(method: str, account: str, path: str,
                   query: List[Tuple[str, str]],
                   headers: Dict[str, str],
                   content_length: int) -> str:
    """The SharedKey canonical string (2015-02-21+ rules: empty
    Content-Length when zero). Shared with tests so the server side
    can verify signatures independently of the signing call."""
    h = {k.lower(): str(v) for k, v in headers.items()}
    ms_headers = "".join(
        f"{k}:{h[k]}\n" for k in sorted(h) if k.startswith("x-ms-"))
    canonical_resource = f"/{account}{path}"
    for k, v in sorted(query):
        canonical_resource += f"\n{k.lower()}:{v}"
    return "\n".join([
        method,
        h.get("content-encoding", ""),
        h.get("content-language", ""),
        str(content_length) if content_length else "",
        h.get("content-md5", ""),
        h.get("content-type", ""),
        "",  # Date: empty because x-ms-date is set
        h.get("if-modified-since", ""),
        h.get("if-match", ""),
        h.get("if-none-match", ""),
        h.get("if-unmodified-since", ""),
        h.get("range", ""),
    ]) + "\n" + ms_headers + canonical_resource


def sign(account: str, key_b64: str, sts: str) -> str:
    mac = hmac.new(base64.b64decode(key_b64), sts.encode("utf-8"),
                   hashlib.sha256)
    return base64.b64encode(mac.digest()).decode()


class AzureBlobClient:
    def __init__(self, account_name: str, account_key: str,
                 endpoint: Optional[str] = None, timeout: float = 60.0):
        self.account = account_name
        self.key = account_key
        self.base = (endpoint.rstrip("/") if endpoint else
                     f"https://{account_name}.blob.core.windows.net")
        self.timeout = timeout

    def _request(self, method: str, path: str,
                 query: Optional[List[Tuple[str, str]]] = None,
                 headers: Optional[Dict[str, str]] = None,
                 payload: bytes = b"") -> Tuple[int, Dict[str, str], bytes]:
        query = query or []
        headers = dict(headers or {})
        headers["x-ms-date"] = formatdate(time.time(), usegmt=True)
        headers["x-ms-version"] = API_VERSION
        sts = string_to_sign(method, self.account, path, query, headers,
                             len(payload))
        headers["Authorization"] = \
            f"SharedKey {self.account}:{sign(self.account, self.key, sts)}"
        qs = urllib.parse.urlencode(query)
        url = self.base + urllib.parse.quote(path) + \
            (f"?{qs}" if qs else "")
        req = urllib.request.Request(url, data=payload or None,
                                     method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            body = e.read().decode("utf-8", "replace")
            raise AzureError(e.code, body) from None

    # -- blob ops ------------------------------------------------------------

    def put_blob(self, container: str, key: str, data: bytes,
                 content_type: str = "application/octet-stream") -> None:
        self._request("PUT", f"/{container}/{key}", payload=data,
                      headers={"x-ms-blob-type": "BlockBlob",
                               "Content-Type": content_type})

    def get_blob(self, container: str, key: str) -> bytes:
        _, _, body = self._request("GET", f"/{container}/{key}")
        return body

    def delete_blob(self, container: str, key: str) -> None:
        try:
            self._request("DELETE", f"/{container}/{key}",
                          headers={"x-ms-delete-snapshots": "include"})
        except AzureError as e:
            if e.status != 404:  # absent blob: already converged
                raise

    def list_blobs(self, container: str,
                   prefix: str = "") -> Iterator[str]:
        marker = ""
        while True:
            query = [("restype", "container"), ("comp", "list")]
            if prefix:
                query.append(("prefix", prefix))
            if marker:
                query.append(("marker", marker))
            _, _, body = self._request("GET", f"/{container}",
                                       query=query)
            root = ET.fromstring(body)
            for blob in root.iter("Blob"):
                name = blob.findtext("Name")
                if name:
                    yield name
            marker = root.findtext("NextMarker") or ""
            if not marker:
                return
