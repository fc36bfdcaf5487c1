"""Lightweight span tracer: where the pipeline's time actually goes.

The counterpart of ``seaweedfs_tpu.stats.trace``. The fleet scheduler
(ec/fleet.py) runs as reader pool -> fused RS dispatch on the card ->
tagged retire -> per-volume writer lanes, four thread families handing
work to each other. This module records *spans*: named, tagged
[t0, t0+dur) intervals per thread, with parent/child nesting inside a
thread (thread-local stack) and explicit handoff tokens across threads
(the packing thread mints a token, the writer lane opens its span under
it), exported as Chrome trace-event JSON that chrome://tracing and
Perfetto load directly.

Cost discipline: tracing is OFF by default and `span()` checks the
module flags before allocating anything — the disabled path is one
function call returning a shared no-op context manager. Enabled spans
land in a bounded ring buffer (deque append is atomic under the GIL; no
lock on the hot path), so a forgotten-enabled tracer costs
memory-bounded ring slots, never unbounded growth.

Set SEAWEED_TRACE=1 to enable at import (for server subprocesses);
in-process callers use enable()/disable(). `/debug/trace` on the
metrics port serves the Chrome JSON of everything currently in the
ring. A span that pushes the oldest out of a full ring counts in
``SeaweedFS_trace_spans_dropped_total``.

Spans carry the OS thread id (``threading.get_native_id()``), and
``EPOCH_OFFSET`` maps their ``perf_counter`` stamps to Unix time, so spans
and a ``torch.profiler`` trace of the same window line up in time.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from seaweedfs_tpu_torch.stats.metrics import TraceSpansDroppedCounter

# Ring capacity: a fleet encode of 64 volumes emits a few spans per
# chunk — tens of thousands of spans for a big run. 1<<17 slots keep
# the whole run while bounding memory (~100 bytes/span -> ~13MB worst
# case).
DEFAULT_CAPACITY = 1 << 17

_enabled = bool(os.environ.get("SEAWEED_TRACE", "") not in ("", "0"))
_ring: deque = deque(maxlen=DEFAULT_CAPACITY)
_ids = itertools.count(1)      # .__next__ is atomic under the GIL
# Span ids are 64-bit and unique ACROSS processes: a per-process random
# high word (bit 62 forced so ids never collide with the small ids of a
# process that lost its randomness) ORed with the local counter. The
# cluster stitcher dedupes by span id, so two processes must never mint
# the same one.
_ID_BASE = (random.getrandbits(30) | (1 << 29)) << 33
_tls = threading.local()
_thread_names: Dict[int, str] = {}


def _epoch_offset(pairs: int = 5) -> float:
    """time.time() - perf_counter(), from the narrowest of ``pairs``
    perf_counter readings that bracket a time.time() reading."""
    best_width, best = float("inf"), 0.0
    for _ in range(pairs):
        a = time.perf_counter()
        wall = time.time()
        b = time.perf_counter()
        if b - a < best_width:
            best_width, best = b - a, wall - (a + b) / 2
    return best


# perf_counter -> wall-clock offset, taken at import and again by
# enable(), so a traced window maps onto the epoch with the offset of
# its own start: the cluster collector exports span timestamps on the
# epoch timebase so spans from different PROCESSES line up in one
# stitched view, and a device trace's events line up with the spans.
EPOCH_OFFSET = _epoch_offset()
_DROPPED = TraceSpansDroppedCounter.labels()

# Cluster-trace hook (stats/cluster_trace.py): when on, spans are also
# appended to the ambient request's bounded buffer, carried across
# threads by contextvars (FanOutPool copies the context at submit).
# Kept as one module flag + one ContextVar so the fully-disabled span()
# fast path stays two attribute checks.
_cluster_enabled = False
_req_ctx: "contextvars.ContextVar[Optional[object]]" = \
    contextvars.ContextVar("seaweed_trace_req", default=None)


def next_span_id() -> int:
    """A fresh 64-bit process-unique span/trace id."""
    return _ID_BASE | next(_ids)


def request_ctx():
    """The ambient cluster-trace request context (or None)."""
    return _req_ctx.get()


def is_enabled() -> bool:
    return _enabled


def enable(capacity: Optional[int] = None) -> None:
    """Turn tracing on (optionally resizing the ring, which clears it)
    and take ``EPOCH_OFFSET`` again."""
    global _enabled, _ring, EPOCH_OFFSET
    if capacity is not None and capacity != _ring.maxlen:
        _ring = deque(maxlen=capacity)
    EPOCH_OFFSET = _epoch_offset()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def clear() -> None:
    _ring.clear()
    _thread_names.clear()


class _NoopSpan:
    """Shared do-nothing context manager: the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def token(self) -> None:
        return None


NOOP = _NoopSpan()


class Span:
    __slots__ = ("name", "tags", "id", "parent_id", "t0", "dur", "tid",
                 "trace_id")

    def __init__(self, name: str, parent: Optional[int], tags: dict):
        self.name = name
        self.tags = tags
        self.id = _ID_BASE | next(_ids)
        self.parent_id = parent
        self.t0 = 0.0
        self.dur = 0.0
        self.tid = 0
        self.trace_id = 0

    def __enter__(self) -> "Span":
        tid = threading.get_native_id()
        self.tid = tid
        if tid not in _thread_names:
            _thread_names[tid] = threading.current_thread().name
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        if self.parent_id is None and stack:
            self.parent_id = stack[-1]
        if _cluster_enabled:
            ctx = _req_ctx.get()
            if ctx is not None:
                self.trace_id = ctx.trace_id
                ctx.current = self.name   # flight-recorder "where is it"
                if self.parent_id is None:
                    # first span on a pool/hedge worker thread: parent
                    # to the request span across the thread boundary
                    self.parent_id = ctx.span_id
        stack.append(self.id)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur = time.perf_counter() - self.t0
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] == self.id:
            stack.pop()
        if _enabled:
            ring = _ring
            if len(ring) == ring.maxlen:
                _DROPPED.inc()
            ring.append(self)
        if _cluster_enabled:
            ctx = _req_ctx.get()
            if ctx is not None:
                ctx.add_span(self)
        return False

    def token(self) -> int:
        """Handoff token: pass to span(parent=...) in another thread so
        the child nests under this span across the thread boundary."""
        return self.id


def span(name: str, parent: Optional[int] = None, **tags):
    """Context manager recording one span; no-op while disabled.

    `parent` is a handoff token from Span.token() (or handoff()) for
    cross-thread nesting; same-thread nesting is automatic. Callers on
    paths hot enough that even the kwargs dict matters should gate on
    is_enabled() themselves.

    Enabled means EITHER the local span ring (SEAWEED_TRACE) or the
    cluster tracer (stats/cluster_trace.py) is on — with both off the
    fast path is two module-flag checks returning the shared no-op.
    """
    if not _enabled and not _cluster_enabled:
        return NOOP
    return Span(name, parent, tags)


def active() -> bool:
    """True when span() would record anything right now — the guard
    hot callers use before building a tags dict."""
    return _enabled or (_cluster_enabled and _req_ctx.get() is not None)


def handoff() -> Optional[int]:
    """Token for the innermost open span of THIS thread (None when
    disabled or no span is open): hand it to the thread that continues
    the work so its spans parent here."""
    if not _enabled:
        return None
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


# -- export -------------------------------------------------------------------

def spans() -> List[Span]:
    """Snapshot of the ring, oldest first."""
    return list(_ring)


def chrome_trace(extra: Sequence[Span] = ()) -> dict:
    """Chrome trace-event JSON object (the 'JSON Object Format':
    {"traceEvents": [...]}), loadable by chrome://tracing / Perfetto.

    Spans become 'X' (complete) events; thread names become 'M'
    metadata events so Perfetto labels the lanes. ts/dur are in
    microseconds on the perf_counter timebase (arbitrary origin is fine
    for these viewers).
    """
    pid = os.getpid()
    events: List[dict] = []
    for tid, tname in list(_thread_names.items()):
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": tname}})
    for s in list(_ring) + list(extra):
        ev = {"ph": "X", "pid": pid, "tid": s.tid, "name": s.name,
              "ts": round(s.t0 * 1e6, 3), "dur": round(s.dur * 1e6, 3)}
        args = dict(s.tags) if s.tags else {}
        args["id"] = s.id
        if s.parent_id is not None:
            args["parent"] = s.parent_id
        if s.trace_id:
            args["trace"] = f"{s.trace_id:016x}"
        ev["args"] = args
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def span_dict(s: Span) -> dict:
    """One span as the cluster collector exports it: epoch-based
    microsecond timestamps (comparable across processes), hex ids."""
    d = {"name": s.name,
         "ts_us": round((s.t0 + EPOCH_OFFSET) * 1e6, 3),
         "dur_us": round(s.dur * 1e6, 3),
         "id": f"{s.id:016x}",
         "tid": s.tid}
    if s.parent_id:
        d["parent"] = f"{s.parent_id:016x}"
    if s.trace_id:
        d["trace"] = f"{s.trace_id:016x}"
    if s.tags:
        d["tags"] = {k: str(v) for k, v in s.tags.items()}
    return d


def chrome_trace_json() -> str:
    return json.dumps(chrome_trace())
