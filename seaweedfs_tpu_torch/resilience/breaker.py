"""Per-peer circuit breakers for the data plane.

The port of ``seaweedfs_tpu.resilience.breaker``: a dead volume server
must fail requests in microseconds, not hold a fan-out lane for a
connect timeout per request. The three states:

  CLOSED      traffic flows; ``threshold`` CONSECUTIVE failures open it
  OPEN        every call fails fast with BreakerOpen until
              ``cooldown_s`` has passed
  HALF_OPEN   one probe request goes through; success closes the
              breaker, failure opens it again (and restarts the cooldown)

State is keyed by peer netloc ("host:port") in a process-wide registry,
exported as ``SeaweedFS_breaker_state{peer}`` (0 closed, 1 half-open,
2 open) and a transitions counter.

What counts as failure: connection-level errors seen by
``util/http_client.request``, its only source. An HTTP response of any
status is proof of life and records success.

Off by default: ``enabled`` is False until ``-resilience.breaker``
(``configure(enable=True)``), and while it is off every entry point is
one module-flag check.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}

# module-level switch: the hot-path guard
enabled = False

_lock = threading.Lock()
_registry: Dict[str, "CircuitBreaker"] = {}  # guarded_by(_lock)
_threshold = 5
_cooldown_s = 5.0


class BreakerOpen(OSError):
    """Fail-fast refusal: the peer's breaker is open. An OSError, so the
    data plane treats it as the connect failure it predicts; the retry
    classifier never burns attempts on it."""

    def __init__(self, peer: str):
        super().__init__(f"circuit breaker open for {peer}")
        self.peer = peer


class CircuitBreaker:
    """One peer's state machine: allow() and record(ok), both O(1) under
    the breaker's own lock."""

    def __init__(self, peer: str, threshold: int = 5,
                 cooldown_s: float = 5.0):
        self.peer = peer
        self.threshold = max(1, int(threshold))
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._state = CLOSED  # guarded_by(self._lock)
        self._consecutive_failures = 0  # guarded_by(self._lock)
        self._opened_at = 0.0  # guarded_by(self._lock)
        self._probe_inflight = False  # guarded_by(self._lock)
        self._probe_started = 0.0  # guarded_by(self._lock)
        self._export(CLOSED)

    @property
    def state(self) -> int:
        emit: List[int] = []
        with self._lock:
            # OPEN -> HALF_OPEN shows lazily, so a status reader sees the
            # recoverable state without waiting for the next request
            if self._state == OPEN and \
                    time.monotonic() - self._opened_at >= self.cooldown_s:
                self._transition(HALF_OPEN, emit)
            st = self._state
        self._emit(emit)
        return st

    def allow(self) -> bool:
        """May a request go to this peer now? OPEN -> HALF_OPEN reserves
        the one probe slot for the caller that gets True."""
        emit: List[int] = []
        try:
            with self._lock:
                if self._state == CLOSED:
                    return True
                now = time.monotonic()
                if self._state == OPEN:
                    if now - self._opened_at < self.cooldown_s:
                        return False
                    self._transition(HALF_OPEN, emit)
                # HALF_OPEN: one probe in flight. A probe whose caller
                # never recorded (died, or gave up on its deadline) is
                # reclaimed after cooldown_s, or the breaker would wedge
                if self._probe_inflight and \
                        now - self._probe_started < self.cooldown_s:
                    return False
                self._probe_inflight = True
                self._probe_started = now
                return True
        finally:
            self._emit(emit)

    def record(self, ok: bool) -> None:
        emit: List[int] = []
        with self._lock:
            self._probe_inflight = False
            if ok:
                self._consecutive_failures = 0
                if self._state != CLOSED:
                    self._transition(CLOSED, emit)
            else:
                self._consecutive_failures += 1
                if self._state == HALF_OPEN or (
                        self._state == CLOSED and
                        self._consecutive_failures >= self.threshold):
                    self._opened_at = time.monotonic()
                    self._transition(OPEN, emit)
        self._emit(emit)

    def _transition(self, to: int, emit: List[int]) -> None:  # requires(self._lock)
        # the metrics export waits for _emit, after the lock is released:
        # the metric families take locks of their own
        self._state = to
        emit.append(to)

    def _emit(self, transitions: List[int]) -> None:
        if not transitions:
            return
        from seaweedfs_tpu_torch.stats.metrics import \
            BreakerTransitionsCounter
        for to in transitions:
            BreakerTransitionsCounter.labels(self.peer,
                                             _STATE_NAMES[to]).inc()
        # the gauge takes the CURRENT state, so two emits that interleave
        # out of order cannot leave it stale
        # lint: guard-ok(deliberate racy read: exporting the CURRENT state is the fix for out-of-order emits)
        self._export(self._state)

    def _export(self, state: int) -> None:
        from seaweedfs_tpu_torch.stats.metrics import BreakerStateGauge
        BreakerStateGauge.labels(self.peer).set(state)


# -- module-level registry ----------------------------------------------------


def configure(enable: Optional[bool] = None,
              threshold: Optional[int] = None,
              cooldown_s: Optional[float] = None) -> None:
    """Process-wide breaker settings (the -resilience.breaker* flags).
    Threshold and cooldown apply to breakers made afterwards."""
    global enabled, _threshold, _cooldown_s
    if enable is not None:
        enabled = enable
    if threshold is not None:
        _threshold = max(1, int(threshold))
    if cooldown_s is not None:
        _cooldown_s = float(cooldown_s)


def reset() -> None:
    """Drop every breaker and turn them off."""
    global enabled
    with _lock:
        _registry.clear()
        enabled = False


def for_peer(peer: str) -> CircuitBreaker:
    with _lock:
        b = _registry.get(peer)
    if b is None:
        # made outside the registry lock: __init__ exports the CLOSED
        # gauge, which takes the metric family's lock
        b = CircuitBreaker(peer, threshold=_threshold,
                           cooldown_s=_cooldown_s)
        with _lock:
            b = _registry.setdefault(peer, b)
    return b


def check(peer: str) -> None:
    """Raise BreakerOpen when ``peer``'s breaker refuses traffic; nothing
    while breakers are off."""
    if not enabled:
        return
    if not for_peer(peer).allow():
        raise BreakerOpen(peer)


def record(peer: str, ok: bool) -> None:
    if not enabled:
        return
    for_peer(peer).record(ok)


def is_open(peer: str) -> bool:
    """True when a breaker EXISTS for peer and is open; never makes one
    (sorting candidates must not fill the registry)."""
    if not enabled:
        return False
    with _lock:
        b = _registry.get(peer)
    return b is not None and b.state == OPEN


def sort_candidates(urls: Sequence[str]) -> List[str]:
    """Stable re-sort of peer candidates: open-breaker peers last, not
    dropped (a last attempt through them is the half-open probe when
    everything else is down too)."""
    urls = list(urls)
    if not enabled or len(urls) <= 1:
        return urls
    return sorted(urls, key=lambda u: 1 if is_open(u) else 0)
