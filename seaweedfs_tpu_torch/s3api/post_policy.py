"""S3 POST-policy uploads: browser form uploads authorized by a signed
policy document.

Behavioral parity with the reference
(weed/s3api/s3api_object_handlers_postpolicy.go +
s3api/policy/postpolicyform.go), as ``seaweedfs_tpu.s3api.post_policy``
has it: the client POSTs multipart/form-data
to the bucket URL with a base64 policy JSON, a SigV4 signature over
that exact base64 string, and the file; the gateway verifies the
signature and the policy's conditions (expiration, eq, starts-with,
content-length-range) before storing the object.
"""

from __future__ import annotations

import base64
import datetime
import json
from typing import Dict, Optional, Tuple


class PolicyError(Exception):
    """A policy violation; .code maps to the S3 error code."""

    def __init__(self, code: str, message: str, status: int = 403):
        super().__init__(message)
        self.code = code
        self.status = status


def parse_form(content_type: str, body: bytes
               ) -> Tuple[Dict[str, str], Optional[bytes], str]:
    """multipart/form-data -> (fields lower-cased, file bytes, filename).
    Everything after the `file` part is ignored, like S3 ("fields after
    the file are not processed"). Parsing rides the shared
    util.multipart.iter_parts."""
    from seaweedfs_tpu_torch.util.multipart import iter_parts
    fields: Dict[str, str] = {}
    try:
        for name, filename, _headers, data in iter_parts(content_type,
                                                         body):
            if name == "file":
                return fields, data, filename
            if name:
                fields[name.lower()] = data.decode("utf-8", "replace")
    except ValueError as e:
        raise PolicyError("MalformedPOSTRequest", str(e), 400) from None
    return fields, None, ""


def _parse_expiration(s: str) -> datetime.datetime:
    s = s.replace("Z", "+00:00")
    try:
        exp = datetime.datetime.fromisoformat(s)
    except ValueError as e:
        raise PolicyError("MalformedPOSTRequest",
                          f"bad expiration: {e}", 400) from None
    if exp.tzinfo is None:   # naive timestamps are treated as UTC
        exp = exp.replace(tzinfo=datetime.timezone.utc)
    return exp


# form fields that need no covering condition (AWS: the signature, the
# policy itself, the file, and anything prefixed x-ignore-)
_EXEMPT_FIELDS = {"policy", "x-amz-signature", "file"}


def check_policy(policy_b64: str, values: Dict[str, str], size: int,
                 now: Optional[datetime.datetime] = None) -> None:
    """Enforce the decoded policy against the request: `values` carries
    the form fields plus the resolved bucket/key. Default-DENY like
    AWS/the reference's checkPostPolicy: every form field must be
    accounted for by a condition, or the signer's policy would not
    actually constrain the upload."""
    try:
        doc = json.loads(base64.b64decode(policy_b64))
    except (ValueError, TypeError) as e:
        raise PolicyError("MalformedPOSTRequest",
                          f"policy is not base64 JSON: {e}", 400) from None
    now = now or datetime.datetime.now(datetime.timezone.utc)
    exp = _parse_expiration(str(doc.get("expiration", "")))
    if now > exp:
        raise PolicyError("AccessDenied", "policy expired")
    covered = set()
    try:
        for cond in doc.get("conditions", []):
            if isinstance(cond, dict):
                for field, want in cond.items():
                    covered.add(field.lstrip("$").lower())
                    _check_eq(values, field, str(want))
                continue
            if not isinstance(cond, list) or not cond:
                raise PolicyError("MalformedPOSTRequest",
                                  f"bad condition {cond!r}", 400)
            op = str(cond[0]).lower()
            if op == "eq" and len(cond) == 3:
                covered.add(str(cond[1]).lstrip("$").lower())
                _check_eq(values, str(cond[1]), str(cond[2]))
            elif op == "starts-with" and len(cond) == 3:
                field = str(cond[1]).lstrip("$").lower()
                covered.add(field)
                got = values.get(field, "")
                if not got.startswith(str(cond[2])):
                    raise PolicyError(
                        "AccessDenied",
                        f"{field}={got!r} does not start with "
                        f"{cond[2]!r}")
            elif op == "content-length-range" and len(cond) == 3:
                lo, hi = int(cond[1]), int(cond[2])
                if not lo <= size <= hi:
                    raise PolicyError(
                        "EntityTooLarge" if size > hi
                        else "EntityTooSmall",
                        f"size {size} outside [{lo}, {hi}]", 400)
            else:
                raise PolicyError("MalformedPOSTRequest",
                                  f"unknown condition {cond!r}", 400)
    except PolicyError:
        raise
    except (TypeError, ValueError) as e:
        raise PolicyError("MalformedPOSTRequest",
                          f"bad condition value: {e}", 400) from None
    for field in values:
        if field in _EXEMPT_FIELDS or field.startswith("x-ignore-"):
            continue
        if field not in covered:
            raise PolicyError(
                "AccessDenied",
                f"form field {field!r} is not covered by any policy "
                f"condition")


def _check_eq(values: Dict[str, str], field: str, want: str) -> None:
    field = field.lstrip("$").lower()
    got = values.get(field, "")
    if got != want:
        raise PolicyError("AccessDenied",
                          f"{field}={got!r} != required {want!r}")
