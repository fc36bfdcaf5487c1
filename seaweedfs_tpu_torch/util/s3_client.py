"""Minimal S3-compatible REST client (SigV4) on the standard library.

The reference pulls in aws-sdk-go for its S3 cloud-tier backend and
replication sink (weed/storage/backend/s3_backend/s3_backend.go,
weed/replication/sink/s3sink); this image has no boto3, so the same
wire protocol is implemented directly: AWS Signature Version 4 over
plain HTTP requests (the port of ``seaweedfs_tpu.util.s3_client``). It is enough for object CRUD + ranged reads +
prefix listing against any S3-compatible endpoint — including this
package's own s3api gateway, which the tests use as the server side.
"""

from __future__ import annotations

import hashlib
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Dict, Iterator, List, Optional, Tuple

from seaweedfs_tpu_torch.util.aws_auth import canonical_query, sigv4_headers


class S3Error(Exception):
    def __init__(self, status: int, body: str = ""):
        super().__init__(f"S3 request failed: HTTP {status} {body[:200]}")
        self.status = status
        self.body = body


class S3Client:
    """One endpoint + credential pair; methods map 1:1 to S3 REST ops."""

    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1", timeout: float = 60.0):
        # endpoint is "host:port" (path-style addressing, like the
        # reference's ForcePathStyle for non-AWS endpoints)
        self.endpoint = endpoint.replace("http://", "").rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout = timeout

    # -- SigV4 ---------------------------------------------------------------

    def _sign(self, method: str, path: str, query: List[Tuple[str, str]],
              headers: Dict[str, str], payload: bytes,
              payload_hash: Optional[str] = None) -> Dict[str, str]:
        return sigv4_headers(method, self.endpoint, path, query, headers,
                             payload, self.access_key, self.secret_key,
                             self.region, "s3", payload_hash=payload_hash)

    def _request(self, method: str, path: str,
                 query: Optional[List[Tuple[str, str]]] = None,
                 headers: Optional[Dict[str, str]] = None,
                 payload: bytes = b"") -> Tuple[int, Dict[str, str], bytes]:
        query = query or []
        headers = dict(headers or {})
        signed = self._sign(method, path, query, headers, payload)
        # the SAME encoder (and order) as the canonical query string:
        # urlencode's quote_plus turns spaces into '+', which strict
        # SigV4 servers reject as SignatureDoesNotMatch
        qs = canonical_query(query)
        url = f"http://{self.endpoint}{urllib.parse.quote(path)}" + \
            (f"?{qs}" if qs else "")
        req = urllib.request.Request(url, data=payload or None,
                                     method=method, headers=signed)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            body = e.read().decode("utf-8", "replace")
            raise S3Error(e.code, body) from None

    # -- object ops ----------------------------------------------------------

    def put_object(self, bucket: str, key: str, data: bytes,
                   content_type: str = "application/octet-stream") -> str:
        status, headers, _ = self._request(
            "PUT", f"/{bucket}/{key}", payload=data,
            headers={"content-type": content_type})
        return headers.get("ETag", "").strip('"')

    def get_object(self, bucket: str, key: str,
                   byte_range: Optional[Tuple[int, int]] = None) -> bytes:
        headers = {}
        if byte_range is not None:
            headers["range"] = f"bytes={byte_range[0]}-{byte_range[1]}"
        _, _, body = self._request("GET", f"/{bucket}/{key}",
                                   headers=headers)
        return body

    def head_object(self, bucket: str, key: str) -> Optional[Dict[str, str]]:
        try:
            _, headers, _ = self._request("HEAD", f"/{bucket}/{key}")
            return headers
        except S3Error as e:
            if e.status == 404:
                return None
            raise

    def delete_object(self, bucket: str, key: str) -> None:
        try:
            self._request("DELETE", f"/{bucket}/{key}")
        except S3Error as e:
            if e.status != 404:
                raise

    def create_bucket(self, bucket: str) -> None:
        try:
            self._request("PUT", f"/{bucket}")
        except S3Error as e:
            if e.status not in (409,):  # BucketAlreadyExists is fine
                raise

    def list_objects(self, bucket: str, prefix: str = "",
                     max_keys: int = 1000) -> Iterator[Dict[str, str]]:
        token = ""
        while True:
            query = [("list-type", "2"), ("prefix", prefix),
                     ("max-keys", str(max_keys))]
            if token:
                query.append(("continuation-token", token))
            _, _, body = self._request("GET", f"/{bucket}", query=query)
            root = ET.fromstring(body)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[:root.tag.index("}") + 1]
            for item in root.findall(f"{ns}Contents"):
                yield {
                    "key": item.findtext(f"{ns}Key", ""),
                    "size": int(item.findtext(f"{ns}Size", "0")),
                    "etag": item.findtext(f"{ns}ETag", "").strip('"'),
                }
            if root.findtext(f"{ns}IsTruncated", "false") != "true":
                return
            token = root.findtext(f"{ns}NextContinuationToken", "")
            if not token:
                return

    def upload_file(self, local_path: str, bucket: str, key: str,
                    chunk: int = 8 << 20, progress=None) -> int:
        """Streaming whole-object PUT: one hashing pass (SigV4 needs
        the payload sha256 up front), then the body streams from the
        file — a multi-GB sealed .dat never sits in memory."""
        import os as _os
        size = _os.path.getsize(local_path)
        h = hashlib.sha256()
        with open(local_path, "rb") as f:
            for blk in iter(lambda: f.read(chunk), b""):
                h.update(blk)
        path = f"/{bucket}/{key}"
        headers = {"content-type": "application/octet-stream",
                   "content-length": str(size)}
        signed = self._sign("PUT", path, [], headers, b"",
                            payload_hash=h.hexdigest())
        url = f"http://{self.endpoint}{urllib.parse.quote(path)}"
        body = open(local_path, "rb")
        try:
            req = urllib.request.Request(url, data=body, method="PUT",
                                         headers=signed)
            try:
                with urllib.request.urlopen(req, timeout=self.timeout):
                    pass
            except urllib.error.HTTPError as e:
                raise S3Error(e.code,
                              e.read().decode("utf-8", "replace")) from None
        finally:
            body.close()
        if progress:
            progress(size)
        return size

    def download_file(self, bucket: str, key: str, local_path: str,
                      chunk: int = 8 << 20, progress=None) -> int:
        """Streaming GET straight to disk."""
        path = f"/{bucket}/{key}"
        signed = self._sign("GET", path, [], {}, b"")
        url = f"http://{self.endpoint}{urllib.parse.quote(path)}"
        req = urllib.request.Request(url, method="GET", headers=signed)
        total = 0
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r, \
                    open(local_path, "wb") as out:
                for blk in iter(lambda: r.read(chunk), b""):
                    out.write(blk)
                    total += len(blk)
                    if progress:
                        progress(len(blk))
        except urllib.error.HTTPError as e:
            raise S3Error(e.code,
                          e.read().decode("utf-8", "replace")) from None
        return total
