"""Lightweight span tracer for the fleet schedulers.

The counterpart of ``seaweedfs_tpu.stats.trace``, cut to what the port's
fleets use: named, tagged ``[t0, t0 + dur)`` intervals per thread, nested
within a thread by a thread-local stack and across threads by explicit
handoff tokens (the packing thread mints a token, a writer lane opens its
span under it), kept in a bounded ring buffer.

Tracing is off by default: ``span()`` checks the module flag before it
allocates anything and returns a shared no-op context manager. Set
``SEAWEED_TRACE=1`` to enable it at import, or call ``enable()``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import List, Optional

DEFAULT_CAPACITY = 1 << 17

_enabled = bool(os.environ.get("SEAWEED_TRACE", "") not in ("", "0"))
_ring: deque = deque(maxlen=DEFAULT_CAPACITY)
_ids = itertools.count(1)      # .__next__ is atomic under the GIL
_tls = threading.local()


def is_enabled() -> bool:
    return _enabled


def enable(capacity: Optional[int] = None) -> None:
    """Turn tracing on (optionally resizing the ring, which clears it)."""
    global _enabled, _ring
    if capacity is not None and capacity != _ring.maxlen:
        _ring = deque(maxlen=capacity)
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def clear() -> None:
    _ring.clear()


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
    __slots__ = ("name", "tags", "id", "parent_id", "t0", "dur", "tid")

    def __init__(self, name: str, parent: Optional[int], tags: dict):
        self.name = name
        self.tags = tags
        self.id = next(_ids)
        self.parent_id = parent
        self.t0 = 0.0
        self.dur = 0.0
        self.tid = 0

    def __enter__(self) -> "Span":
        self.tid = threading.get_ident()
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        if self.parent_id is None and stack:
            self.parent_id = stack[-1]
        stack.append(self.id)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur = time.perf_counter() - self.t0
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] == self.id:
            stack.pop()
        if _enabled:
            _ring.append(self)
        return False

    def token(self) -> int:
        """Handoff token: pass to span(parent=...) in another thread so
        the child nests under this span across the thread boundary."""
        return self.id


def span(name: str, parent: Optional[int] = None, **tags):
    """Context manager recording one span; no-op while disabled.
    ``parent`` is a handoff token from ``Span.token()`` or ``handoff()``
    for nesting across threads; nesting within a thread is automatic."""
    if not _enabled:
        return NOOP
    return Span(name, parent, tags)


def active() -> bool:
    """True when span() would record anything right now: the guard hot
    callers use before building a tags dict."""
    return _enabled


def handoff() -> Optional[int]:
    """Token of the innermost open span of THIS thread (None when
    disabled or no span is open): hand it to the thread that continues
    the work so its spans parent here."""
    if not _enabled:
        return None
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def spans() -> List[Span]:
    """Snapshot of the ring, oldest first."""
    return list(_ring)

