"""AWS Signature Version 4 on the standard library, for the clients that
speak an AWS wire protocol without an SDK: the S3 client
(util/s3_client.py). The port of ``seaweedfs_tpu.util.aws_auth``.

Reference counterpart: the aws-sdk-go signer the Go code relies on
(weed/replication/sink/s3sink, weed/notification/aws_sqs).
"""

from __future__ import annotations

import hashlib
import hmac
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple


def uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-_.~" if encode_slash else "-_.~/"
    return urllib.parse.quote(s, safe=safe)


def canonical_query(query: List[Tuple[str, str]]) -> str:
    return "&".join(f"{uri_encode(k)}={uri_encode(v)}"
                    for k, v in sorted(query))


def sigv4_headers(method: str, host: str, path: str,
                  query: List[Tuple[str, str]],
                  headers: Dict[str, str], payload: bytes,
                  access_key: str, secret_key: str,
                  region: str, service: str,
                  payload_hash: Optional[str] = None) -> Dict[str, str]:
    """Lower-cased headers dict including host/x-amz-date/
    x-amz-content-sha256/authorization, ready to send."""
    t = time.gmtime()
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", t)
    date = time.strftime("%Y%m%d", t)
    if payload_hash is None:
        payload_hash = hashlib.sha256(payload).hexdigest()
    h = {k.lower(): str(v) for k, v in headers.items()}
    h["host"] = host
    h["x-amz-date"] = amz_date
    h["x-amz-content-sha256"] = payload_hash
    signed = sorted(h)
    canonical = "\n".join([
        method,
        uri_encode(path, encode_slash=False),
        canonical_query(query),
        "".join(f"{k}:{' '.join(h[k].split())}\n" for k in signed),
        ";".join(signed),
        payload_hash,
    ])
    scope = f"{date}/{region}/{service}/aws4_request"
    signature = _signature(canonical, amz_date, scope,
                           signing_key(secret_key, date, region, service))
    h["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={signature}")
    return h


def presigned_target(method: str, host: str, path: str,
                     access_key: str, secret_key: str, region: str,
                     service: str, expires: int = 300,
                     t: Optional[time.struct_time] = None) -> str:
    """The request target (encoded path, then the query) of a SigV4
    query-presigned request: ``host`` the only signed header, the payload
    unsigned, ``X-Amz-Signature`` last. ``path`` is the unencoded path;
    it is encoded once, as the canonical request has it."""
    t = time.gmtime() if t is None else t
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", t)
    date = amz_date[:8]
    scope = f"{date}/{region}/{service}/aws4_request"
    query = canonical_query([
        ("X-Amz-Algorithm", "AWS4-HMAC-SHA256"),
        ("X-Amz-Credential", f"{access_key}/{scope}"),
        ("X-Amz-Date", amz_date), ("X-Amz-Expires", str(expires)),
        ("X-Amz-SignedHeaders", "host")])
    encoded = uri_encode(path, encode_slash=False)
    canonical = "\n".join([method, encoded, query, f"host:{host}\n",
                           "host", "UNSIGNED-PAYLOAD"])
    signature = _signature(canonical, amz_date, scope,
                           signing_key(secret_key, date, region, service))
    return f"{encoded}?{query}&X-Amz-Signature={signature}"


def signing_key(secret_key: str, date: str, region: str,
                service: str) -> bytes:
    """The date/region/service-scoped SigV4 key."""
    k = ("AWS4" + secret_key).encode()
    for part in (date, region, service, "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return k


def _signature(canonical: str, amz_date: str, scope: str,
               key: bytes) -> str:
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])
    return hmac.new(key, string_to_sign.encode(), hashlib.sha256).hexdigest()
