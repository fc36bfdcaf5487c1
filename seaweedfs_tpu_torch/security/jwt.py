"""HS256 JWTs scoped to a file id (reference: weed/security/jwt.go:21-67).

The port of ``seaweedfs_tpu.security.jwt``. Claims: exp + "fid". A
library only: neither this package's servers nor the JAX package's sign
or check a token (upstream's master signs one at /dir/assign and its
volume server checks it on writes). Implemented over hmac/hashlib, with
no jwt dependency.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Optional

SigningKey = bytes

_HEADER = base64.urlsafe_b64encode(
    json.dumps({"alg": "HS256", "typ": "JWT"},
               separators=(",", ":")).encode()).rstrip(b"=")


def _b64(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _unb64(data: str) -> bytes:
    pad = -len(data) % 4
    return base64.urlsafe_b64decode(data + "=" * pad)


class JwtError(Exception):
    pass


def encode_jwt(key: SigningKey, claims: dict) -> str:
    payload = _b64(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = _HEADER + b"." + payload
    sig = _b64(hmac.new(key, signing_input, hashlib.sha256).digest())
    return (signing_input + b"." + sig).decode()


def decode_jwt(key: SigningKey, token: str) -> dict:
    try:
        header, payload, sig = token.split(".")
    except ValueError:
        raise JwtError("malformed token") from None
    signing_input = f"{header}.{payload}".encode()
    want = hmac.new(key, signing_input, hashlib.sha256).digest()
    try:
        if not hmac.compare_digest(want, _unb64(sig)):
            raise JwtError("bad signature")
        claims = json.loads(_unb64(payload))
    except JwtError:
        raise
    except Exception as e:  # bad base64, bad json, wrong types
        raise JwtError(f"malformed token: {e}") from None
    if not isinstance(claims, dict):
        raise JwtError("claims not an object")
    exp = claims.get("exp")
    if exp is not None and time.time() > exp:
        raise JwtError("token expired")
    return claims


def gen_jwt_for_file_id(key: Optional[SigningKey], expires_seconds: int,
                        file_id: str) -> str:
    """Empty key ⇒ no auth configured ⇒ empty token (like the ref)."""
    if not key:
        return ""
    claims = {"fid": file_id}
    if expires_seconds:
        claims["exp"] = int(time.time()) + expires_seconds
    return encode_jwt(key, claims)


def verify_file_id_jwt(key: Optional[SigningKey], token: str,
                       file_id: str) -> None:
    """Raises JwtError unless the token authorizes this fid."""
    if not key:
        return
    if not token:
        raise JwtError("jwt required")
    claims = decode_jwt(key, token)
    if claims.get("fid") != file_id:
        raise JwtError(f"jwt fid {claims.get('fid')!r} != {file_id!r}")
