"""Tenant identity for the multi-tenant QoS plane.

Resolution order (cheapest-first, first match wins):

  1. the explicit ``X-Seaweed-Tenant`` request header — the contract
     for clients that know who they are (and for cluster-internal hops:
     util/http_client and rpc forward the ambient tenant on every
     outbound call, so a replica fan-out or a shard fetch is charged to
     the ORIGINAL tenant, not to the forwarding server)
  2. the S3 access key parsed out of the SigV4 ``Authorization``
     header (``Credential=<KEY>/...``), as the JAX package resolves it
  3. the ``collection`` query parameter — collections are the
     reference's multi-tenancy unit (weed/storage collections), so
     assign/lookup traffic is charged per collection by default
  4. ``"default"`` — everyone else shares one bucket

The identity travels the process as a contextvar so work crossing a
FanOutPool hop (the pool copies the submitter's context) stays charged
to its tenant, and two reserved names exist:

  ``_internal``  background engines (scrub, lifecycle)
                 run under qos.internal_context(): exempt from
                 admission (shedding replication/repair would trade
                 latency for durability) but weighted LOW in the
                 weighted-fair pool queues, so the store never starves
                 foreground reads for its own housekeeping
  ``_other``     the overflow tenant once -qos.maxTenants distinct
                 names exist — bounds both bucket memory and the
                 qos metric label cardinality (the `metric` lint's
                 unbounded-label rule)
"""

from __future__ import annotations

import contextvars
from typing import Optional  # noqa: F401  # lint: dead-ok(used in the quoted contextvar annotation below)

HEADER = "X-Seaweed-Tenant"
HEADER_LOWER = "x-seaweed-tenant"
GRPC_KEY = "x-seaweed-tenant"

DEFAULT = "default"
INTERNAL = "_internal"
OTHER = "_other"

# ambient tenant of the calling thread/task; None = anonymous (and
# ALWAYS None while QoS is off — nothing ever sets it, so seams that
# forward it pay one None check)
current: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("qos_tenant", default=None)


def resolve(headers, path: str = "") -> str:
    """Resolve the tenant name from request metadata. `headers` is any
    case-insensitive mapping with .get (email.Message or HeaderDict);
    `path` is the raw request path (query string included)."""
    t = headers.get(HEADER_LOWER)
    if t:
        return t
    auth = headers.get("authorization")
    if auth:
        # SigV4: "AWS4-HMAC-SHA256 Credential=<KEY>/<date>/..." ;
        # SigV2: "AWS <KEY>:<sig>" — both yield the access key
        i = auth.find("Credential=")
        if i >= 0:
            i += len("Credential=")
            j = auth.find("/", i)
            if j > i:
                return auth[i:j]
        elif auth.startswith("AWS "):
            j = auth.find(":", 4)
            if j > 4:
                return auth[4:j]
    q = path.find("?")
    if q >= 0:
        for part in path[q + 1:].split("&"):
            if part.startswith("collection=") and len(part) > 11:
                return part[11:]
    return DEFAULT


class _Scope:
    """Context manager pinning the ambient tenant (re-entrant safe:
    each instance holds its own reset token)."""

    __slots__ = ("_name", "_token")

    def __init__(self, name: str):
        self._name = name
        self._token = None

    def __enter__(self):
        self._token = current.set(self._name)
        return self._name

    def __exit__(self, *exc):
        current.reset(self._token)
        return False


def as_tenant(name: str) -> _Scope:
    return _Scope(name)
