"""Multi-tenant QoS: admission control, weighted-fair scheduling, and
heat-aware backpressure, end to end. The counterpart of
``seaweedfs_tpu.qos``.

Three planes, one manager:

  admission    per-tenant token buckets (request rate + bytes rate,
               burst-capped) at the shared HTTP/RPC instrumentation
               seams (stats/metrics.instrument_http_handler and
               instrument_grpc_method), plus weighted per-tenant
               connection budgets in the async serving core
               (util/async_server.py): a tenant past its share is shed
               at frame time, before a worker thread runs
  scheduling   weighted-fair queueing on util/fanout.FanOutPool (one
               seam covers the replica fan-out, the hedger's fetches
               and the delete fan-out); scrub and lifecycle run as the
               low-weight ``_internal`` tenant, so housekeeping never
               starves foreground reads
  backpressure HTTP 429 + Retry-After computed from bucket refill
               time, RPC RESOURCE_EXHAUSTED — and util/retry honors
               the server's Retry-After on the way back up

Cost discipline (checked by tests/test_torch_qos.py):
with -qos off NOTHING here is constructed. configure() installs the
manager into each consumer seam as a module global; every seam's
disabled path is a single ``is None`` check and the tenant contextvar
is never set, so the pool submit path, the serving loop and both
instrument wrappers are unchanged.
"""

from __future__ import annotations

import sys
from typing import Optional

from seaweedfs_tpu_torch.qos import tenant
from seaweedfs_tpu_torch.qos.admission import (AdmissionBucket, QosConfig,
                                         QosManager)
from seaweedfs_tpu_torch.qos.fair import WeightedFairQueue

__all__ = ["AdmissionBucket", "QosConfig", "QosManager",
           "WeightedFairQueue", "configure", "enabled",
           "internal_context", "manager", "reset", "tenant"]

_manager: Optional[QosManager] = None


def manager() -> Optional[QosManager]:
    return _manager


def enabled() -> bool:
    return _manager is not None


def configure(cfg: Optional[QosConfig] = None) -> QosManager:
    """Build the process-wide manager and install it into every
    consumer seam. Idempotent per call — reconfiguring replaces the
    manager (tests; a live process configures once at startup)."""
    global _manager
    mgr = QosManager(cfg or QosConfig())
    _manager = mgr
    _install(mgr)
    return mgr


def reset() -> None:
    """Tear the manager out of every seam (tests). The disabled state
    is indistinguishable from never-configured."""
    global _manager
    _manager = None
    _install(None)


def _install(mgr: Optional[QosManager]) -> None:
    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.stats import metrics
    from seaweedfs_tpu_torch.util import fanout, http_client
    if mgr is not None:
        from seaweedfs_tpu_torch.util import async_server
        async_server._qos = mgr
    else:
        # clearing the seam never imports the async core
        async_server = sys.modules.get(
            "seaweedfs_tpu_torch.util.async_server")
        if async_server is not None:
            async_server._qos = None
    fanout._qos_sched = mgr
    metrics._qos_http = mgr
    tv = tenant.current if mgr is not None else None
    http_client._qos_tenant = tv
    rpc._qos_tenant = tv


class _NullCtx:
    """Reusable allocation-free no-op context (the disabled path of
    internal_context — background loops enter it every pass)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


def internal_context():
    """Tag the calling thread's work as the ``_internal`` background
    tenant (scrub, lifecycle): exempt from admission,
    low-weight in the fair queues, forwarded on outbound hops. A
    no-op while QoS is off."""
    if _manager is None:
        return _NULL_CTX
    return tenant.as_tenant(tenant.INTERNAL)
