"""RS256 (RSASSA-PKCS1-v1_5 + SHA-256) signing on the standard library.

Enough to mint Google service-account JWTs without the `cryptography`
package: parse the PEM private key from a service-account JSON file
(PKCS#8 "PRIVATE KEY" or PKCS#1 "RSA PRIVATE KEY"), then sign with the
textbook m^d mod n. Used by notification/google_pub_sub.py — the
reference gets this from google-cloud-go's oauth2 stack.

The port of ``seaweedfs_tpu.util.rsa_sign``: PKCS#1 v1.5 is
deterministic, so a signature equals the JAX package's for the same key
and payload.
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
from typing import Dict, List, Tuple


class RsaKeyError(Exception):
    pass


# -- minimal DER ---------------------------------------------------------------


def _der_read(buf: bytes, pos: int) -> Tuple[int, bytes, int]:
    """One TLV: returns (tag, value, next_pos)."""
    tag = buf[pos]
    length = buf[pos + 1]
    pos += 2
    if length & 0x80:
        n = length & 0x7F
        length = int.from_bytes(buf[pos:pos + n], "big")
        pos += n
    return tag, buf[pos:pos + length], pos + length


def _der_ints(seq: bytes, count: int) -> List[int]:
    out, pos = [], 0
    while len(out) < count and pos < len(seq):
        tag, val, pos = _der_read(seq, pos)
        if tag != 0x02:
            raise RsaKeyError(f"expected INTEGER, got tag {tag:#x}")
        out.append(int.from_bytes(val, "big"))
    if len(out) < count:
        raise RsaKeyError("truncated RSA key")
    return out


def parse_private_key_pem(pem: str) -> Dict[str, int]:
    """-> {n, e, d} from a PKCS#8 or PKCS#1 RSA private key PEM."""
    m = re.search(
        r"-----BEGIN (RSA )?PRIVATE KEY-----(.*?)-----END (RSA )?"
        r"PRIVATE KEY-----", pem, re.S)
    if not m:
        raise RsaKeyError("no PRIVATE KEY block in PEM")
    der = base64.b64decode("".join(m.group(2).split()))
    tag, body, _ = _der_read(der, 0)
    if tag != 0x30:
        raise RsaKeyError("PEM body is not a DER SEQUENCE")
    if not m.group(1):
        # PKCS#8: version, AlgorithmIdentifier, OCTET STRING(PKCS#1)
        pos = 0
        _, _version, pos = _der_read(body, pos)
        _, _alg, pos = _der_read(body, pos)
        tag, inner, _ = _der_read(body, pos)
        if tag != 0x04:
            raise RsaKeyError("PKCS#8 without private-key octets")
        tag, body, _ = _der_read(inner, 0)
        if tag != 0x30:
            raise RsaKeyError("bad inner PKCS#1 structure")
    # PKCS#1 RSAPrivateKey: version, n, e, d, p, q, ...
    version, n, e, d = _der_ints(body, 4)
    return {"n": n, "e": e, "d": d}


# -- RSASSA-PKCS1-v1_5 / SHA-256 ----------------------------------------------

# DigestInfo prefix for SHA-256 (RFC 8017 §9.2 note 1)
_SHA256_PREFIX = bytes.fromhex(
    "3031300d060960864801650304020105000420")


def rs256_sign(key: Dict[str, int], data: bytes) -> bytes:
    n, d = key["n"], key["d"]
    k = (n.bit_length() + 7) // 8
    t = _SHA256_PREFIX + hashlib.sha256(data).digest()
    if k < len(t) + 11:
        raise RsaKeyError("RSA key too small for SHA-256 signature")
    em = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    sig = pow(int.from_bytes(em, "big"), d, n)
    return sig.to_bytes(k, "big")


def rs256_verify(n: int, e: int, data: bytes, sig: bytes) -> bool:
    """Verifier counterpart (used by tests and any local consumer)."""
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    em = pow(int.from_bytes(sig, "big"), e, n).to_bytes(k, "big")
    t = _SHA256_PREFIX + hashlib.sha256(data).digest()
    return em == b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t


# -- JWT ----------------------------------------------------------------------


def b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def make_jwt(key: Dict[str, int], claims: dict,
             headers: dict = None) -> str:
    header = {"alg": "RS256", "typ": "JWT", **(headers or {})}
    signing_input = (b64url(json.dumps(header).encode()) + "." +
                     b64url(json.dumps(claims).encode()))
    sig = rs256_sign(key, signing_input.encode())
    return signing_input + "." + b64url(sig)
