"""S3 authentication: AWS Signature V4 (+ V2 legacy), identity/action
ACLs (reference: weed/s3api/auth_signature_v4.go, auth_credentials.go).
The port of ``seaweedfs_tpu.s3api.auth``: the same decisions.

Identities carry credentials and coarse actions (Admin / Read / Write /
List / Tagging, optionally scoped ":bucket"). An empty Iam means open
access, like the reference before `s3.configure` runs.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Dict, List, Optional, Tuple

ACTION_ADMIN = "Admin"
ACTION_READ = "Read"
ACTION_WRITE = "Write"
ACTION_LIST = "List"
ACTION_TAGGING = "Tagging"

_UNSIGNED = {"authorization", "content-length", "user-agent",
             "x-amzn-trace-id", "expect", "connection",
             "accept-encoding"}


class S3AuthError(Exception):
    def __init__(self, code: str, message: str, status: int = 403):
        super().__init__(message)
        self.code = code
        self.status = status


@dataclass
class Credential:
    access_key: str
    secret_key: str


@dataclass
class Identity:
    name: str
    credentials: List[Credential] = field(default_factory=list)
    actions: List[str] = field(default_factory=list)

    def can_do(self, action: str, bucket: str) -> bool:
        if ACTION_ADMIN in self.actions:
            return True
        for a in self.actions:
            if a == action:
                return True
            if a == f"{action}:{bucket}":
                return True
        return False


@dataclass
class StreamCtx:
    """Signing context carried from the header verification into
    per-chunk verification of an aws-chunked body."""
    signing_key: bytes
    amz_date: str
    scope: str
    seed_signature: str


def strip_chunk_signing(data: bytes) -> bytes:
    """Decode aws-chunked framing WITHOUT verifying signatures — only
    for IAM-disabled (anonymous) deployments."""
    out = []
    pos = 0
    while pos < len(data):
        nl = data.find(b"\r\n", pos)
        if nl < 0:
            break
        try:
            n = int(data[pos:nl].split(b";")[0], 16)
        except ValueError:
            break
        if n == 0:
            break
        out.append(data[nl + 2:nl + 2 + n])
        pos = nl + 2 + n + 2
    return b"".join(out)


class Iam:
    def __init__(self, identities: Optional[List[Identity]] = None):
        self.identities = identities or []
        self._by_access_key: Dict[str, Tuple[Identity, Credential]] = {}
        for ident in self.identities:
            for cred in ident.credentials:
                self._by_access_key[cred.access_key] = (ident, cred)

    @property
    def is_enabled(self) -> bool:
        return bool(self.identities)

    def lookup(self, access_key: str) -> Tuple[Identity, Credential]:
        hit = self._by_access_key.get(access_key)
        if hit is None:
            raise S3AuthError("InvalidAccessKeyId",
                              f"access key {access_key!r} unknown")
        return hit

    # -- request authentication ----------------------------------------------

    def authenticate(self, method: str, path: str, query: str,
                     headers: Dict[str, str], payload: bytes) -> Identity:
        ident, _ = self.authenticate_and_decode(method, path, query,
                                                headers, payload)
        return ident

    def authenticate_and_decode(
            self, method: str, path: str, query: str,
            headers: Dict[str, str],
            payload: bytes) -> Tuple[Identity, bytes]:
        """Verify the request signature and return (identity, payload),
        with aws-chunked bodies decoded — per-chunk signatures verified
        when IAM is enabled. Anonymous passes when IAM is off."""
        streaming = headers.get("x-amz-content-sha256",
                                "").startswith("STREAMING-")
        if not self.is_enabled:
            if streaming:
                payload = strip_chunk_signing(payload)
            return Identity(name="anonymous",
                            actions=[ACTION_ADMIN]), payload
        auth = headers.get("authorization", "")
        qs = urllib.parse.parse_qs(query)
        if auth.startswith("AWS4-HMAC-SHA256"):
            ident, ctx = self._verify_v4_header(method, path, query,
                                                headers, payload, auth)
            if streaming:
                payload = self._decode_verified_chunks(payload, ctx)
            return ident, payload
        if streaming:
            raise S3AuthError("AccessDenied",
                              "chunked upload requires SigV4")
        if "X-Amz-Signature" in {k for k in qs}:
            return self._verify_v4_presigned(method, path, qs,
                                             headers), payload
        if auth.startswith("AWS "):
            return self._verify_v2(method, path, qs, headers,
                                   auth), payload
        raise S3AuthError("AccessDenied", "no credentials provided")

    def verify_post_policy(self, fields: Dict[str, str]) -> Identity:
        """Authenticate a POST-policy form upload: the SigV4 signature
        is over the RAW base64 policy string with the credential's
        date/region-scoped key (reference
        s3api/auth_signature_v4.go DoesPolicySignatureMatch)."""
        policy = fields.get("policy", "")
        if not policy:
            raise S3AuthError("AccessDenied", "form has no policy")
        if fields.get("x-amz-algorithm") != "AWS4-HMAC-SHA256":
            raise S3AuthError("AccessDenied", "unsupported algorithm")
        cred = fields.get("x-amz-credential", "")
        parts = cred.split("/")
        if len(parts) != 5 or parts[4] != "aws4_request":
            raise S3AuthError("AccessDenied",
                              f"malformed credential {cred!r}")
        access, date, region, service, _ = parts
        ident, c = self.lookup(access)
        key = self._signing_key(c.secret_key, date, region, service)
        want = hmac.new(key, policy.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want,
                                   fields.get("x-amz-signature", "")):
            raise S3AuthError("SignatureDoesNotMatch",
                              "policy signature mismatch")
        return ident

    # -- SigV4 ----------------------------------------------------------------

    @staticmethod
    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    def _signing_key(self, secret: str, date: str, region: str,
                     service: str) -> bytes:
        k = self._hmac(("AWS4" + secret).encode(), date)
        k = self._hmac(k, region)
        k = self._hmac(k, service)
        return self._hmac(k, "aws4_request")

    @staticmethod
    def _canonical_query(query: str, drop_signature: bool = False) -> str:
        pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
        if drop_signature:
            pairs = [(k, v) for k, v in pairs if k != "X-Amz-Signature"]
        pairs.sort()
        return "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}="
            f"{urllib.parse.quote(v, safe='-_.~')}" for k, v in pairs)

    @staticmethod
    def _canonical_uri(path: str) -> str:
        # For the S3 service the canonical URI is the raw request path as
        # the client sent it (AWS "no normalize" rule): real clients sign
        # the encoded path, so unquote/quote round-tripping here would
        # turn an encoded %2F in an object key into a literal '/' and
        # break their signatures.
        return path or "/"

    def _canonical_request(self, method: str, path: str, cq: str,
                           signed_headers: List[str],
                           headers: Dict[str, str],
                           payload_hash: str) -> str:
        ch = "".join(
            f"{h}:{' '.join(headers.get(h, '').split())}\n"
            for h in signed_headers)
        return "\n".join([method, self._canonical_uri(path), cq, ch,
                          ";".join(signed_headers), payload_hash])

    def _verify_v4_header(self, method, path, query, headers, payload,
                          auth) -> Tuple[Identity, "StreamCtx"]:
        try:
            parts = dict(
                p.strip().split("=", 1)
                for p in auth[len("AWS4-HMAC-SHA256"):].strip().split(","))
            cred_scope = parts["Credential"].split("/")
            access_key, date, region, service = (
                cred_scope[0], cred_scope[1], cred_scope[2], cred_scope[3])
            signed_headers = parts["SignedHeaders"].lower().split(";")
            got_sig = parts["Signature"]
        except (KeyError, IndexError, ValueError):
            raise S3AuthError("AuthorizationHeaderMalformed",
                              "cannot parse Authorization") from None
        ident, cred = self.lookup(access_key)
        payload_hash = headers.get("x-amz-content-sha256", "")
        if not payload_hash or payload_hash == "UNSIGNED-PAYLOAD":
            payload_hash = payload_hash or "UNSIGNED-PAYLOAD"
        elif payload_hash.startswith("STREAMING-"):
            pass  # chunk data verified in _decode_verified_chunks
        else:
            if hashlib.sha256(payload).hexdigest() != payload_hash:
                raise S3AuthError("XAmzContentSHA256Mismatch",
                                  "payload hash mismatch", 400)
        creq = self._canonical_request(
            method, path, self._canonical_query(query), signed_headers,
            headers, payload_hash)
        amz_date = headers.get("x-amz-date", "")
        scope = f"{date}/{region}/{service}/aws4_request"
        key = self._signing_key(cred.secret_key, date, region, service)
        sts = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(creq.encode()).hexdigest()])
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, got_sig):
            raise S3AuthError("SignatureDoesNotMatch",
                              "signature mismatch")
        return ident, StreamCtx(key, amz_date, scope, got_sig)

    def _decode_verified_chunks(self, data: bytes,
                                ctx: "StreamCtx") -> bytes:
        """Decode aws-chunked framing, verifying each chunk signature
        against the rolling chain seeded by the header signature
        (AWS SigV4 streaming; reference auth_signature_v4.go)."""
        empty_hash = hashlib.sha256(b"").hexdigest()
        prev_sig = ctx.seed_signature
        out = []
        pos = 0
        while pos < len(data):
            nl = data.find(b"\r\n", pos)
            if nl < 0:
                raise S3AuthError("IncompleteBody",
                                  "truncated chunk header", 400)
            header = data[pos:nl].decode("ascii", "replace")
            size_part, _, ext = header.partition(";")
            try:
                n = int(size_part, 16)
            except ValueError:
                raise S3AuthError("IncompleteBody",
                                  "bad chunk size", 400) from None
            chunk_sig = ""
            if ext.startswith("chunk-signature="):
                chunk_sig = ext[len("chunk-signature="):]
            chunk = data[nl + 2:nl + 2 + n]
            if len(chunk) != n:
                raise S3AuthError("IncompleteBody",
                                  "truncated chunk data", 400)
            sts = "\n".join([
                "AWS4-HMAC-SHA256-PAYLOAD", ctx.amz_date, ctx.scope,
                prev_sig, empty_hash,
                hashlib.sha256(chunk).hexdigest()])
            want = hmac.new(ctx.signing_key, sts.encode(),
                            hashlib.sha256).hexdigest()
            if not hmac.compare_digest(want, chunk_sig):
                raise S3AuthError("SignatureDoesNotMatch",
                                  "chunk signature mismatch")
            prev_sig = want
            if n == 0:
                break
            out.append(chunk)
            pos = nl + 2 + n + 2
        return b"".join(out)

    def _verify_v4_presigned(self, method, path, qs, headers) -> Identity:
        def one(k):
            v = qs.get(k)
            if not v:
                raise S3AuthError("AuthorizationQueryParametersError",
                                  f"missing {k}", 400)
            return v[0]

        cred_scope = one("X-Amz-Credential").split("/")
        access_key, date, region, service = (
            cred_scope[0], cred_scope[1], cred_scope[2], cred_scope[3])
        ident, cred = self.lookup(access_key)
        amz_date = one("X-Amz-Date")
        expires = int(one("X-Amz-Expires"))
        t0 = datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ") \
            .replace(tzinfo=timezone.utc)
        if datetime.now(timezone.utc) > t0 + timedelta(seconds=expires):
            raise S3AuthError("AccessDenied", "request expired")
        signed_headers = one("X-Amz-SignedHeaders").split(";")
        query = "&".join(f"{k}={urllib.parse.quote(v[0], safe='')}"
                         for k, v in qs.items())
        creq = self._canonical_request(
            method, path, self._canonical_query(query, drop_signature=True),
            signed_headers, headers, "UNSIGNED-PAYLOAD")
        sts = "\n".join([
            "AWS4-HMAC-SHA256", amz_date,
            f"{date}/{region}/{service}/aws4_request",
            hashlib.sha256(creq.encode()).hexdigest()])
        want = hmac.new(
            self._signing_key(cred.secret_key, date, region, service),
            sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, one("X-Amz-Signature")):
            raise S3AuthError("SignatureDoesNotMatch",
                              "signature mismatch")
        return ident

    # -- SigV2 (legacy) -------------------------------------------------------

    _SUBRESOURCES = {"acl", "delete", "lifecycle", "location", "logging",
                     "notification", "partNumber", "policy",
                     "requestPayment", "tagging", "torrent", "uploadId",
                     "uploads", "versionId", "versioning", "versions",
                     "website"}

    def _verify_v2(self, method, path, qs, headers, auth) -> Identity:
        import base64
        try:
            access_key, got_sig = auth[4:].split(":", 1)
        except ValueError:
            raise S3AuthError("AuthorizationHeaderMalformed",
                              "cannot parse V2 Authorization") from None
        ident, cred = self.lookup(access_key)
        sub = sorted((k, v[0]) for k, v in qs.items()
                     if k in self._SUBRESOURCES)
        resource = path
        if sub:
            resource += "?" + "&".join(
                k if not v else f"{k}={v}" for k, v in sub)
        amz = sorted((k, v) for k, v in headers.items()
                     if k.startswith("x-amz-"))
        amz_lines = "".join(f"{k}:{v}\n" for k, v in amz)
        # the Date line is blanked only when x-amz-date itself is used
        # (AWS SigV2 spec), not when any other x-amz-* header appears
        date_line = "" if "x-amz-date" in dict(amz) \
            else headers.get("date", "")
        sts = "\n".join([
            method,
            headers.get("content-md5", ""),
            headers.get("content-type", ""),
            date_line,
        ]) + "\n" + amz_lines + resource
        want = base64.b64encode(
            hmac.new(cred.secret_key.encode(), sts.encode(),
                     hashlib.sha1).digest()).decode()
        if not hmac.compare_digest(want, got_sig):
            raise S3AuthError("SignatureDoesNotMatch",
                              "V2 signature mismatch")
        return ident


def iam_from_dict(cfg: dict) -> Iam:
    """Build an Iam from the s3.configure JSON document
    ({"identities": [{"name", "credentials": [{"accessKey",
    "secretKey"}], "actions": [...]}]}) — the wire format the shell
    stores at /etc/iam/identity.json. The document is validated
    through iam_pb2.S3ApiConfiguration (reference weed/pb/iam.proto:17-31)
    with protobuf's JSON mapping (``pb/json_format.py``), which
    camelCases the field names: the wire document's casing."""
    from seaweedfs_tpu_torch.pb import iam_pb2, json_format
    try:
        conf = json_format.ParseDict(cfg, iam_pb2.S3ApiConfiguration(),
                                     ignore_unknown_fields=True)
    except json_format.ParseError as e:
        raise ValueError(f"bad s3 identity document: {e}")
    idents = []
    for ident in conf.identities:
        creds = [Credential(c.access_key, c.secret_key)
                 for c in ident.credentials]
        idents.append(Identity(name=ident.name, credentials=creds,
                               actions=list(ident.actions)))
    return Iam(idents)


def iam_from_toml(cfg) -> Iam:
    """Build an Iam from the [s3] section of a config
    (identities = [{name, access_key, secret_key, actions}, ...])."""
    idents = []
    for item in cfg.get("identities", []) or []:
        idents.append(Identity(
            name=item.get("name", ""),
            credentials=[Credential(item.get("access_key", ""),
                                    item.get("secret_key", ""))],
            actions=list(item.get("actions", []))))
    return Iam(idents)
