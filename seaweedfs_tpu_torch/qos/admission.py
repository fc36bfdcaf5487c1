"""Admission control: per-tenant token buckets + explicit backpressure.

The counterpart of ``seaweedfs_tpu.qos.admission``. It generalizes util/throttler.Throttler — the blocking bytes/s pacer
the scrub and compaction paths use — into a NON-blocking admission
bucket: instead of sleeping the caller until the deficit is repaid,
try_admit() answers "no, and here is when" so the ingress seams can
shed with an honest ``Retry-After`` (HTTP 429, RPC
RESOURCE_EXHAUSTED) while the admitted path stays byte-identical.

Differences from Throttler, both deliberate:

  - the bucket starts FULL (Throttler starts empty so "the first bytes
    pay full price"): admission must not shed the first request after
    a restart — burst capacity is the contract for well-behaved bursts
  - overdraw is allowed for oversized charges: one charge larger than
    the whole burst (a single huge PUT against a small bytes bucket)
    admits whenever the bucket is full and drives the credit negative,
    so it is PACED by the sheds that follow instead of being
    unadmittable forever. Ordinary charges need full credit — the
    admit/shed boundary is exact, not a race against clock granularity

Retry-After math (documented in ARCHITECTURE.md): a shed at credit c
(<= 0) for a charge of n reports (n - c) / rate seconds — the exact
time the bucket needs to refill past the charge at the configured
rate. HTTP rounds that up to whole seconds (delta-seconds grammar).

Heat-aware shed ordering: when the GLOBAL bucket (cluster overload,
not per-tenant misbehavior) runs dry, traffic for provably-hot volumes
(stats/heat.HeatTracker window reads at or above the fleet mean) may
draw from a smaller hot-reserve bucket, so the traffic that keeps
cache-warm, demonstrably-demanded data flowing is the LAST to shed and
cold-volume traffic sheds first.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from seaweedfs_tpu_torch.qos import tenant as tenant_mod
from seaweedfs_tpu_torch.qos.fair import WeightedFairQueue
from seaweedfs_tpu_torch.stats import trace


class AdmissionBucket:
    """Non-blocking token bucket. try_admit(n) -> (retry_after, credit):
    retry_after 0.0 means n was charged; a positive value is the
    seconds until the bucket could afford the charge (nothing charged).
    rate <= 0 disables the bucket — one attribute check, no clock read.
    """

    __slots__ = ("rate", "burst", "disabled", "_lock", "_credit",
                 "_last")

    def __init__(self, rate: float, burst: float = 0.0):
        self.rate = float(rate)
        # default burst: 2 seconds at rate, floor 8 — small enough to
        # bound a cold-start stampede, big enough for request pipelines
        self.burst = float(burst) if burst > 0 else \
            max(2.0 * self.rate, 8.0)
        self.disabled = self.rate <= 0
        self._lock = threading.Lock()
        self._credit = self.burst       # guarded_by(self._lock)
        self._last = time.monotonic()   # guarded_by(self._lock)

    def try_admit(self, n: float = 1.0) -> Tuple[float, float]:
        if self.disabled:
            return 0.0, float("inf")
        now = time.monotonic()
        with self._lock:
            credit = min(self.burst,
                         self._credit + (now - self._last) * self.rate)
            self._last = now
            # need full credit for the charge; an oversized charge
            # (n > burst) only needs a full bucket — it overdraws and
            # the sheds that follow pace the repayment
            if credit >= (n if n < self.burst else self.burst):
                credit -= n
                self._credit = credit
                return 0.0, credit
            self._credit = credit
            return (n - credit) / self.rate, credit

    def tokens(self) -> float:
        """Current credit (refreshed); +inf when disabled."""
        if self.disabled:
            return float("inf")
        now = time.monotonic()
        with self._lock:
            self._credit = min(
                self.burst,
                self._credit + (now - self._last) * self.rate)
            self._last = now
            return self._credit


@dataclass
class QosConfig:
    """The -qos.* flag surface (command/servers.py:_add_qos_args)."""
    request_rate: float = 0.0        # per-tenant requests/s (0 = off)
    request_burst: float = 0.0       # requests of burst (0 = 2x rate)
    bytes_mbps: float = 0.0          # per-tenant body MB/s (0 = off)
    bytes_burst_s: float = 2.0       # seconds of bytes-rate burst
    global_request_rate: float = 0.0  # whole-process requests/s
    weights: Dict[str, float] = field(default_factory=dict)
    default_weight: float = 1.0
    internal_weight: float = 0.25    # scrub/lifecycle lane
    max_tenants: int = 64            # distinct names before _other
    heat_shed: bool = True           # prefer shedding cold traffic


_SHED_REASONS = ("requests", "bytes", "global", "conns")


class TenantState:
    """Per-tenant buckets + metric children, resolved ONCE at creation
    (labels() takes a lock per call — the instrument-wrapper rule).
    The counter children double as the /qos/status source of truth."""

    __slots__ = ("name", "weight", "internal", "req", "bts",
                 "admitted_c", "shed_c", "queued_h", "tok_req_g",
                 "tok_bytes_g")

    def __init__(self, name: str, weight: float, cfg: QosConfig):
        from seaweedfs_tpu_torch.stats.metrics import (
            QosAdmittedCounter, QosQueuedSecondsHistogram,
            QosShedCounter, QosTokensGauge)
        self.name = name
        self.weight = max(weight, 1e-3)
        self.internal = name == tenant_mod.INTERNAL
        self.req = AdmissionBucket(cfg.request_rate, cfg.request_burst)
        self.bts = AdmissionBucket(cfg.bytes_mbps * 1024 * 1024,
                                   cfg.bytes_mbps * 1024 * 1024 *
                                   cfg.bytes_burst_s)
        self.admitted_c = QosAdmittedCounter.labels(name)
        self.shed_c = {r: QosShedCounter.labels(name, r)
                       for r in _SHED_REASONS}
        self.queued_h = QosQueuedSecondsHistogram.labels(name)
        self.tok_req_g = QosTokensGauge.labels(name, "requests")
        self.tok_bytes_g = QosTokensGauge.labels(name, "bytes")


class QosManager:
    """The per-process QoS brain: tenant table, admission, weighted
    shares, heat-aware global shed, and the /qos/status payload.
    qos.configure() installs one of these into every consumer seam."""

    # fraction of global rate reserved for hot-volume traffic while
    # the global bucket is dry (heat-aware shed ordering)
    HOT_RESERVE_FRACTION = 0.25
    # how long a computed hot threshold stays cached (the overload
    # path must not recompute a fleet summary per shed decision)
    HOT_CUT_TTL_S = 1.0

    def __init__(self, cfg: QosConfig):
        self.cfg = cfg
        self._lock = threading.Lock()
        self._tenants: Dict[str, TenantState] = {}  # guarded_by(self._lock, writes)
        self._conns: Dict[str, int] = {}  # guarded_by(self._lock)
        self._global = AdmissionBucket(cfg.global_request_rate)
        self._hot_reserve = AdmissionBucket(
            cfg.global_request_rate * self.HOT_RESERVE_FRACTION)
        self.heat = None   # HeatTracker; the volume role attaches its own
        self._hot_cut = 1.0      # guarded_by(self._lock)
        self._hot_cut_at = 0.0   # guarded_by(self._lock)
        from seaweedfs_tpu_torch.stats.metrics import QosTenantsGauge
        QosTenantsGauge.set_function(lambda: float(len(self._tenants)))

    # -- tenant table --------------------------------------------------------

    def weight_of(self, name: str) -> float:
        w = self.cfg.weights.get(name)
        if w is not None:
            return max(w, 1e-3)
        if name == tenant_mod.INTERNAL:
            return max(self.cfg.internal_weight, 1e-3)
        return max(self.cfg.default_weight, 1e-3)

    def state_of(self, name: str) -> TenantState:
        """Get-or-create; past -qos.maxTenants distinct names the
        overflow maps to the shared "_other" tenant, bounding bucket
        memory and metric label cardinality alike."""
        st = self._tenants.get(name)
        if st is not None:
            return st
        with self._lock:
            st = self._tenants.get(name)
            if st is not None:
                return st
            if len(self._tenants) >= self.cfg.max_tenants and \
                    name != tenant_mod.OTHER:
                name = tenant_mod.OTHER
                st = self._tenants.get(name)
                if st is not None:
                    return st
            st = TenantState(name, self.weight_of(name), self.cfg)
            self._tenants[name] = st
            return st

    def make_wfq(self, pool_name: str) -> WeightedFairQueue:
        return WeightedFairQueue(self, pool_name)

    def resolve(self, headers, path: str = "") -> str:
        """Tenant identity from request metadata (the async serving loop
        calls this, so util/ modules never import the qos package)."""
        return tenant_mod.resolve(headers, path)

    def observe_queued(self, state: TenantState, waited: float) -> None:
        state.queued_h.observe(waited)
        if trace.is_enabled():
            with trace.span("qos.queue", tenant=state.name,
                            queued_ms=round(waited * 1000.0, 3)):
                pass

    # -- admission -----------------------------------------------------------

    def admit(self, name: str, nbytes: int = 0,
              vid: int = 0) -> Tuple[float, str]:
        """-> (retry_after, reason). retry_after 0.0 = admitted.
        Internal background work is exempt (it is deprioritized in the
        pool queues instead — shedding repair traffic would trade
        latency for durability)."""
        st = self.state_of(name)
        if st.internal:
            st.admitted_c.inc()
            return 0.0, ""
        ra, credit = st.req.try_admit(1.0)
        if not st.req.disabled:
            st.tok_req_g.set(credit)
        if ra > 0.0:
            st.shed_c["requests"].inc()
            return ra, "requests"
        if nbytes > 0 and not st.bts.disabled:
            ra, credit = st.bts.try_admit(float(nbytes))
            st.tok_bytes_g.set(credit)
            if ra > 0.0:
                st.shed_c["bytes"].inc()
                return ra, "bytes"
        if not self._global.disabled:
            ra, _ = self._global.try_admit(1.0)
            if ra > 0.0:
                # global overload, not tenant misbehavior: heat-aware
                # ordering sheds cold-volume traffic first
                if vid and self.heat is not None and \
                        self.cfg.heat_shed and self._is_hot(vid):
                    ra2, _ = self._hot_reserve.try_admit(1.0)
                    if ra2 == 0.0:
                        st.admitted_c.inc()
                        return 0.0, ""
                st.shed_c["global"].inc()
                return ra, "global"
        st.admitted_c.inc()
        return 0.0, ""

    def _is_hot(self, vid: int) -> bool:
        """Window reads at or above the fleet mean (cached ~1s; the
        summary walk must not run per shed decision)."""
        now = time.monotonic()
        with self._lock:
            if now - self._hot_cut_at > self.HOT_CUT_TTL_S:
                rows = self.heat.summary()
                if rows:
                    mean = sum(r["reads_window"] for r in rows) / \
                        len(rows)
                else:
                    mean = 1.0
                self._hot_cut = max(mean, 1.0)
                self._hot_cut_at = now
            cut = self._hot_cut
        return self.heat.window_reads(vid) >= cut

    # -- ingress seams -------------------------------------------------------

    def http_enter(self, handler, role: str):
        """Admission at the instrumented do_* dispatch. Admitted: the
        ambient tenant is pinned and the contextvar reset token
        returned (the wrapper resets it in its finally). Shed: the
        backpressure reply is written and None returned."""
        headers = handler.headers
        name = tenant_mod.resolve(headers, handler.path)
        nbytes = 0
        cl = headers.get("content-length")
        if cl:
            try:
                nbytes = int(cl)
            except ValueError:
                nbytes = 0
        vid = 0
        if self.heat is not None and self.cfg.heat_shed:
            vid = _vid_of(handler.path)
        if trace.is_enabled():
            with trace.span("qos.admit", tenant=name):
                ra, reason = self.admit(name, nbytes, vid)
        else:
            ra, reason = self.admit(name, nbytes, vid)
        if ra == 0.0:
            return tenant_mod.current.set(name)
        self.shed_reply(handler, role, name, ra, reason)
        return None

    def grpc_enter(self, context):
        """Admission at the instrumented unary RPC dispatch; aborts
        the call with RESOURCE_EXHAUSTED on shed (abort raises)."""
        name = None
        for k, v in (context.invocation_metadata() or ()):
            if k == tenant_mod.GRPC_KEY:
                name = v
                break
        if not name:
            name = tenant_mod.DEFAULT
        ra, reason = self.admit(name)
        if ra == 0.0:
            return tenant_mod.current.set(name)
        from seaweedfs_tpu_torch.rpc import StatusCode
        context.abort(
            StatusCode.RESOURCE_EXHAUSTED,
            "qos: tenant %s over %s budget; retry after %.3fs"
            % (name, reason, ra))
        return None   # unreachable; abort raises

    def shed_reply(self, handler, role: str, name: str, ra: float,
                   reason: str) -> None:
        """Write the backpressure reply: 429 + plain text carrying
        Retry-After = ceil(bucket refill time) in the delta-seconds
        grammar. (The JAX package's S3 role answers 503 + SlowDown XML;
        the port has no S3 role.)"""
        retry_after = max(1, int(math.ceil(ra)))
        hdrs = {"Retry-After": str(retry_after)}
        body = ("qos: tenant %s over %s budget; retry after %ds\n"
                % (name, reason, retry_after)).encode()
        handler.fast_reply(429, body, hdrs, ctype="text/plain")

    # -- connection accounting (async serving core) ---------------------------

    def conn_opened(self, name: str) -> None:
        with self._lock:
            self._conns[name] = self._conns.get(name, 0) + 1

    def conn_closed(self, name: str) -> None:
        with self._lock:
            n = self._conns.get(name, 0) - 1
            if n <= 0:
                self._conns.pop(name, None)
            else:
                self._conns[name] = n

    def conn_over_share(self, name: str, cap: int) -> bool:
        """Is this tenant past its weighted share of `cap` open
        connections? Shares divide cap by weight among tenants with
        connections open right now (floor 1 — a tenant can always hold
        one connection). Internal traffic is never conn-shed."""
        if name == tenant_mod.INTERNAL:
            return False
        w = self.weight_of(name)
        with self._lock:
            mine = self._conns.get(name, 0)
            total_w = sum(self.weight_of(t) for t in self._conns)
        if total_w <= 0.0:
            return False
        share = max(1.0, cap * w / total_w)
        if mine <= share:
            return False
        st = self.state_of(name)
        st.shed_c["conns"].inc()
        return True

    def most_over_share(self, counts: Dict[str, int],
                        cap: int) -> Optional[str]:
        """Among tenants holding idle keep-alive connections, the one
        furthest past its weighted share of the budget (None when
        nobody is over — the caller falls back to plain LRU)."""
        if not counts:
            return None
        total_w = sum(self.weight_of(t) for t in counts)
        if total_w <= 0.0:
            return None
        worst, worst_ratio = None, 1.0
        for t, n in counts.items():
            if t == tenant_mod.INTERNAL:
                continue
            share = max(1.0, cap * self.weight_of(t) / total_w)
            ratio = n / share
            if ratio > worst_ratio:
                worst, worst_ratio = t, ratio
        return worst

    # -- status --------------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            states = list(self._tenants.values())
            conns = dict(self._conns)
        tenants = {}
        for st in states:
            tenants[st.name] = {
                "weight": st.weight,
                "internal": st.internal,
                "admitted": int(st.admitted_c.value),
                "shed": {r: int(st.shed_c[r].value)
                         for r in _SHED_REASONS},
                "tokens": {
                    "requests": None if st.req.disabled
                    else round(st.req.tokens(), 3),
                    "bytes": None if st.bts.disabled
                    else round(st.bts.tokens(), 1),
                },
                "conns": conns.get(st.name, 0),
            }
        return {
            "enabled": True,
            "request_rate": self.cfg.request_rate,
            "bytes_mbps": self.cfg.bytes_mbps,
            "global_request_rate": self.cfg.global_request_rate,
            "max_tenants": self.cfg.max_tenants,
            "heat_shed": bool(self.heat is not None and
                              self.cfg.heat_shed),
            "tenants": tenants,
        }


def _vid_of(path: str) -> int:
    """Volume id out of a data-plane path ("/3,01637037d6" or
    "/dir/3,01..."), 0 when the path has no fid shape. Only called on
    the heat-aware shed path (volume role, heat tracking on)."""
    i = path.find(",")
    if i <= 0:
        return 0
    j = path.rfind("/", 0, i)
    try:
        return int(path[j + 1:i])
    except ValueError:
        return 0
