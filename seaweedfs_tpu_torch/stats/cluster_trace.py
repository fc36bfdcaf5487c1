"""Cluster-wide distributed tracing + flight recorder.

The counterpart of ``seaweedfs_tpu.stats.cluster_trace``. The span
tracer (stats/trace.py) sees one process; a request that fans
volume -> replica -> EC shard holder shatters into disconnected
per-process rings. This module is the Dapper-style glue:

  propagate   every traced request carries a 64-bit trace id and its
              current span id across hops — the `X-Seaweed-Trace`
              header on HTTP (riding util/http_client, the exact seam
              X-Seaweed-Deadline uses) and `x-seaweed-trace` metadata
              on the port's RPC (riding the rpc stubs). The shared ingress
              wrappers (stats.metrics.instrument_http_handler /
              instrument_grpc_method) re-anchor the context into the
              handler, and FanOutPool's contextvars.copy_context()
              carries it across thread hops for free.
  tail-sample ids always propagate; full span DETAIL survives only for
              requests that finish slow (duration >= max(-trace.slowMs,
              the tracked per-verb p95)) or errored, pinned in a
              bounded per-process ring. A short `recent` ring keeps the
              last N finished requests regardless, so stitching a slow
              request's trace still recovers the FAST downstream hops
              it touched (a tail decision on one server cannot reach
              back into a replica that already dropped its spans — the
              grace ring is what makes cluster stitching whole).
              `-trace.sample` head-samples a fraction unconditionally
              (the sampled bit rides the header so downstream keeps
              too).
  recorder    `/debug/requests` lists in-flight requests (verb, age,
              current span, peer, remaining deadline budget, trace
              id); a rate-limited slow-request log line carries the
              trace id; OpenMetrics exemplars on the request
              histograms link /metrics buckets to trace ids.
  collect     `/debug/trace?trace_id=` returns every span this process
              holds for one trace; `cluster.trace` (shell) fans that
              over the topology and stitches one Chrome trace.

Zero-cost-disabled contract (checked structurally by
tests/test_torch_observability.py): off by default; each ingress/egress seam pays ONE module-flag check; no
thread is ever spawned (pure data structures). Enable with
-trace.sample / -trace.slowMs or SEAWEED_TRACE_SAMPLE=<fraction>.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from seaweedfs_tpu_torch.resilience import deadline as deadline_mod
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.util import wlog

log = wlog.logger("trace")

# Wire names (HTTP header / gRPC metadata key). Value format:
# "<trace_id:016x>-<span_id:016x>[-s]"; the "-s" suffix marks a
# head-sampled trace so every downstream hop keeps its spans too.
HEADER = "X-Seaweed-Trace"
HEADER_LOWER = "x-seaweed-trace"
GRPC_KEY = "x-seaweed-trace"

# Retention bounds (per process).
SAMPLED_RING = 256        # kept (slow/errored/head-sampled) requests
RECENT_RING = 1024        # grace ring of ALL finished traced requests
MAX_SPANS_PER_REQUEST = 512

# Per-verb latency window for the tail threshold (the Hedger's p95
# discipline: sorted-window estimate, recomputed every N observations).
_P95_WINDOW = 128
_P95_RECALC = 16

# Rate limit for the structured slow-request log line.
_SLOW_LOG_INTERVAL_S = 1.0

_enabled = False
slow_ms = 200.0           # floor for the tail-keep threshold
sample = 0.0              # head-sample fraction (0..1)

_lock = threading.Lock()
# live_count()/table snapshots read lock-free (flight-recorder views
# may be one request stale); insert/remove lock
_live: Dict[int, "TraceCtx"] = {}  # guarded_by(_lock, writes)
_sampled: deque = deque(maxlen=SAMPLED_RING)
_recent: deque = deque(maxlen=RECENT_RING)
# per-verb trackers: finish() inserts via GIL-atomic setdefault on the
# hot path (the tracker's own window lock guards its contents); only
# reset() needs the module lock
_p95: Dict[str, "_VerbP95"] = {}  # guarded_by(_lock, writes)
_last_slow_log = 0.0


class _VerbP95:
    __slots__ = ("lat", "since", "p95", "_lock")

    def __init__(self):
        self.lat: deque = deque(maxlen=_P95_WINDOW)
        self.since = 0
        self.p95 = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> float:
        # locked like the Hedger's window: sorted() iterates the deque,
        # and a concurrent append from another finishing request would
        # raise "deque mutated during iteration" out of the ingress
        # wrapper's finally block
        with self._lock:
            self.lat.append(seconds)
            self.since += 1
            if self.since >= _P95_RECALC or len(self.lat) < _P95_RECALC:
                self.since = 0
                ordered = sorted(self.lat)
                self.p95 = ordered[int(0.95 * (len(ordered) - 1))]
            return self.p95


class TraceCtx:
    """One traced request in this process: its identity, its request
    span, and the bounded buffer its spans accumulate into. The buffer
    OBJECT is shared across thread hops (contextvars copies are
    shallow), so FanOutPool / hedge workers append to the same list."""

    __slots__ = ("trace_id", "span_id", "head", "role", "verb", "path",
                 "peer", "server", "t0", "buf", "dropped", "error",
                 "deadline", "current", "_span", "_token", "_key")

    def __init__(self, trace_id: int, parent_span: Optional[int],
                 head: bool, role: str, verb: str, path: str,
                 peer: str, server: str):
        self.trace_id = trace_id
        self.head = head
        self.role = role
        self.verb = verb
        self.path = path
        self.peer = peer
        self.server = server
        self.buf: List[trace.Span] = []
        self.dropped = 0
        self.error = False
        self.deadline = deadline_mod.get()
        # the request span: root of everything this process does for
        # the request; its parent is the CALLER's span from the header
        sp = trace.Span(f"request.{role}.{verb}", parent_span,
                        {"path": path, "peer": peer, "server": server})
        self._span = sp
        sp.trace_id = trace_id
        self.span_id = sp.id
        # most-recently-entered span name: the flight recorder's
        # "current span" column (approximate under concurrency, which
        # is fine for a live debugging table)
        self.current = sp.name
        self.t0 = 0.0       # set at begin()
        self._token = None
        self._key = sp.id

    def add_span(self, s: trace.Span) -> None:
        if len(self.buf) < MAX_SPANS_PER_REQUEST:
            self.buf.append(s)
        else:
            self.dropped += 1

    def trace_hex(self) -> str:
        return f"{self.trace_id:016x}"

    def current_span_name(self) -> str:
        return self.current

    def spans(self) -> List[dict]:
        out = [trace.span_dict(s) for s in [self._span] + self.buf]
        for d in out:
            d["role"] = self.role
            d["server"] = self.server
        return out


# -- enable/disable -----------------------------------------------------------


def enabled() -> bool:
    return _enabled


def enable(sample_fraction: Optional[float] = None,
           slow_threshold_ms: Optional[float] = None) -> None:
    global _enabled, sample, slow_ms
    if sample_fraction is not None:
        sample = min(max(float(sample_fraction), 0.0), 1.0)
    if slow_threshold_ms is not None:
        slow_ms = max(float(slow_threshold_ms), 0.0)
    _enabled = True
    trace._cluster_enabled = True
    from seaweedfs_tpu_torch.stats.metrics import TraceLiveGauge
    TraceLiveGauge.set_function(live_count)


def disable() -> None:
    global _enabled
    _enabled = False
    trace._cluster_enabled = False


def reset() -> None:
    """Drop all retained state (tests)."""
    with _lock:
        _live.clear()
        _sampled.clear()
        _recent.clear()
        _p95.clear()


# -- header codec -------------------------------------------------------------


def format_header(trace_id: int, span_id: int, head: bool = False) -> str:
    v = f"{trace_id:016x}-{span_id:016x}"
    return v + "-s" if head else v


def parse_header(value) -> Optional[Tuple[int, int, bool]]:
    """(trace_id, parent_span_id, head_sampled), or None on junk — a
    malformed header must never fail the request, it just starts a
    fresh trace."""
    if not value:
        return None
    parts = str(value).split("-")
    if len(parts) < 2:
        return None
    try:
        tid = int(parts[0], 16)
        sid = int(parts[1], 16)
    except ValueError:
        return None
    if tid == 0:
        return None
    return tid, sid, len(parts) > 2 and parts[2] == "s"


def outbound_header() -> Optional[str]:
    """Header/metadata value for the next hop: the ambient trace id
    plus the INNERMOST open span of this thread (so the remote request
    span nests under the local client-side span), falling back to the
    request span when no local span is open."""
    ctx = trace.request_ctx()
    if ctx is None:
        return None
    parent = trace.handoff() if trace._enabled else None
    if parent is None:
        stack = getattr(trace._tls, "stack", None)
        parent = stack[-1] if stack else ctx.span_id
    return format_header(ctx.trace_id, parent, ctx.head)


# -- ingress ------------------------------------------------------------------


def begin(role: str, verb: str, path: str, header_value,
          peer: str = "", server: str = "") -> TraceCtx:
    """Open a traced request at an ingress point. Returns the ctx the
    caller must pass to finish(); the contextvar is set so every span
    (and every hop) inside the handler inherits the trace."""
    parsed = parse_header(header_value)
    if parsed is not None:
        trace_id, parent_span, head = parsed
    else:
        trace_id = trace.next_span_id()
        parent_span = None
        head = sample > 0 and random.random() < sample
    ctx = TraceCtx(trace_id, parent_span, head, role, verb, path,
                   peer, server)
    ctx._span.__enter__()
    ctx.t0 = ctx._span.t0
    ctx._token = trace._req_ctx.set(ctx)
    with _lock:
        _live[ctx._key] = ctx
    return ctx


def finish(ctx: TraceCtx, exc: Optional[BaseException] = None,
           status: int = 0) -> Optional[str]:
    """Close a traced request: keep-or-drop (tail sampling), p95
    tracking, slow log. Returns the trace id hex when the request was
    KEPT (the exemplar hook), else None."""
    global _last_slow_log
    # reset the contextvar BEFORE closing the request span, or the
    # span's own __exit__ hook would append it into its own buffer
    trace._req_ctx.reset(ctx._token)
    ctx._span.__exit__(None, None, None)
    with _lock:
        _live.pop(ctx._key, None)
    dur = ctx._span.dur
    key = f"{ctx.role}.{ctx.verb}"
    tracker = _p95.get(key)
    if tracker is None:
        # lint: guard-ok(setdefault is GIL-atomic; two racing finishes agree on one tracker)
        tracker = _p95.setdefault(key, _VerbP95())
    p95 = tracker.observe(dur)
    ctx.error = ctx.error or exc is not None or status >= 500
    threshold = max(slow_ms / 1000.0, p95)
    if ctx.error:
        outcome = "error"
    elif dur >= threshold:
        outcome = "slow"
    elif ctx.head:
        outcome = "sample"
    else:
        outcome = "drop"
    from seaweedfs_tpu_torch.stats.metrics import TraceRequestsCounter
    TraceRequestsCounter.labels(outcome).inc()
    # ring appends under the lock: spans_for/sampled_traces snapshot
    # with list(ring), and a deque mutated mid-iteration raises
    with _lock:
        _recent.append(ctx)
        if outcome != "drop":
            _sampled.append(ctx)
    if outcome == "drop":
        return None
    if outcome in ("error", "slow"):
        now = time.monotonic()
        if now - _last_slow_log >= _SLOW_LOG_INTERVAL_S:
            _last_slow_log = now
            log.warning(
                "%s request trace=%s role=%s verb=%s path=%s peer=%s "
                "dur_ms=%.1f p95_ms=%.1f spans=%d",
                outcome, ctx.trace_hex(), ctx.role, ctx.verb, ctx.path,
                ctx.peer, dur * 1e3, p95 * 1e3, len(ctx.buf) + 1)
    return ctx.trace_hex()


# -- collector / flight recorder ----------------------------------------------


def spans_for(trace_id_hex: str) -> List[dict]:
    """Every span this process holds for one trace id: pinned sampled
    requests, the recent grace ring, and still-live requests (a
    mid-stall request shows its partial spans)."""
    try:
        tid = int(trace_id_hex, 16)
    except (TypeError, ValueError):
        return []
    out: List[dict] = []
    seen = set()
    with _lock:
        live = list(_live.values())
        pinned = list(_sampled) + list(_recent)
    for ctx in pinned + live:
        if ctx.trace_id != tid or ctx._key in seen:
            continue
        seen.add(ctx._key)
        spans = ctx.spans()
        if ctx in live and spans:
            # the request span is still open: export what ran so far
            spans[0]["dur_us"] = round(
                (time.perf_counter() - ctx.t0) * 1e6, 3)
            spans[0]["in_flight"] = True
        out.extend(spans)
    return out


def sampled_traces(limit: int = 50) -> List[dict]:
    """Newest-first summaries of kept requests (the no-param
    /debug/trace?sampled=1 listing an operator starts from)."""
    out = []
    with _lock:
        newest_first = list(_sampled)[::-1]
    for ctx in newest_first[:limit]:
        out.append({"trace_id": ctx.trace_hex(), "role": ctx.role,
                    "verb": ctx.verb, "path": ctx.path,
                    "server": ctx.server,
                    "dur_ms": round(ctx._span.dur * 1e3, 3),
                    "error": ctx.error,
                    "spans": len(ctx.buf) + 1})
    return out


def live_requests() -> List[dict]:
    """The flight recorder's live table: every in-flight traced
    request in this process."""
    now = time.perf_counter()
    mono = time.monotonic()
    with _lock:
        ctxs = list(_live.values())
    out = []
    for ctx in ctxs:
        d = {"trace_id": ctx.trace_hex(), "role": ctx.role,
             "verb": ctx.verb, "path": ctx.path, "peer": ctx.peer,
             "server": ctx.server,
             # the request-span id: a STABLE identity for this request
             # (cluster.requests dedupes on it — an in-process cluster
             # answers the same table from every endpoint)
             "id": f"{ctx.span_id:016x}",
             "age_ms": round((now - ctx.t0) * 1e3, 3),
             "current_span": ctx.current_span_name(),
             "spans": len(ctx.buf) + 1}
        if ctx.deadline is not None:
            d["deadline_left_ms"] = round((ctx.deadline - mono) * 1e3, 3)
        out.append(d)
    out.sort(key=lambda d: -d["age_ms"])
    return out


def live_count() -> int:
    return len(_live)


def debug_payload(raw_path: str, role: str, server: str) -> dict:
    """The JSON body for GET /debug/trace | /debug/requests on a ROLE
    http server (the data port), shared by the master and the volume server so the
    three carve-outs cannot drift. `raw_path` is the handler's
    self.path including the query string."""
    from urllib.parse import parse_qs
    path, _, query = raw_path.partition("?")
    params = parse_qs(query) if query else {}
    if path == "/debug/requests":
        return {"role": role, "server": server,
                "requests": live_requests()}
    tid = params.get("trace_id", [""])[0]
    if tid:
        return {"role": role, "server": server, "trace_id": tid,
                "spans": spans_for(tid)}
    return {"role": role, "server": server,
            "sampled": sampled_traces()}


# env enable for server subprocesses, like SEAWEED_TRACE
_env_sample = os.environ.get("SEAWEED_TRACE_SAMPLE", "")
if _env_sample not in ("", "0"):
    try:
        enable(sample_fraction=float(_env_sample),
               slow_threshold_ms=float(
                   os.environ.get("SEAWEED_TRACE_SLOW_MS", "") or slow_ms))
    except ValueError:
        pass
