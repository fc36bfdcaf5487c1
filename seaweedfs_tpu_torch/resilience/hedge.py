"""Hedged reads: a second request to another holder after p95.

The counterpart of ``seaweedfs_tpu.resilience.hedge`` ("The Tail at
Scale" containment move): when a read has taken longer than the tracked
p95, ONE hedge goes to the next candidate; the first response wins and
the loser is abandoned. Two bounds keep hedging from amplifying an
overload:

  budget   hedges are capped at `budget_pct` (default 5%) of all fetches
           this hedger mediates; denials are counted
           (SeaweedFS_hedge_budget_denied_total).
  lanes    at most `max_inflight` candidate fetches ride the pool at
           once. Past that, fetch() degrades to a plain inline call that
           still walks every candidate on failure, so an abandoned loser
           pinned on a stalled socket never blocks fresh requests.

Failover is not hedging: when the primary FAILS, the next candidate
launches at once and is not charged to the budget.

A server holds `hedger = None` unless -resilience.hedge is set, and a
constructed Hedger makes no thread until its first multi-candidate fetch.
In the port it hedges the volume server's remote EC shard reads
(server/volume.py), where a shard has more than one holder.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

from seaweedfs_tpu_torch.resilience import deadline as deadline_mod
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.stats.metrics import (HedgeDeniedCounter,
                                               HedgeIssuedCounter,
                                               HedgeRequestsCounter,
                                               HedgeWinsCounter)
from seaweedfs_tpu_torch.util.fanout import FanOutPool

# latency samples kept per hedger for the p95 estimate
_WINDOW = 128
# recompute the cached p95 every N observations (sorting 128 floats
# per fetch would be measurable on the hot path)
_RECALC_EVERY = 16


def _card_fault(e: BaseException) -> bool:
    """A fault of a kernel or of the card: it ends the fetch as it is,
    never fails over to another candidate (no fallback hides the card)."""
    from seaweedfs_tpu_torch.parallel.mesh_fleet import is_kernel_fault
    return is_kernel_fault(e)


class Hedger:
    """First-response-wins fetch over ordered candidate thunks."""

    def __init__(self, delay_floor_s: float = 0.010,
                 budget_pct: float = 0.05, max_inflight: int = 16,
                 name: str = "hedge"):
        self.delay_floor_s = delay_floor_s
        self.budget_pct = budget_pct
        self.max_inflight = max(2, int(max_inflight))
        self._pool = FanOutPool(self.max_inflight, name)
        self._lock = threading.Lock()
        self._lat: deque = deque(maxlen=_WINDOW)  # guarded_by(self._lock)
        self._since_recalc = 0  # guarded_by(self._lock)
        # delay() reads the cached p95 lock-free on the hot path
        self._p95 = delay_floor_s  # guarded_by(self._lock, writes)
        # ledger (mirrored in the SeaweedFS_hedge_* families)
        self.requests = 0
        self.hedges = 0
        self.wins = 0
        self.denied = 0
        self._inflight = 0

    def stop(self) -> None:
        """End the pool's workers (a server's stop); a fetch after it
        runs its candidates inline."""
        self._pool.stop()

    # -- latency tracking ----------------------------------------------------

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._lat.append(seconds)
            self._since_recalc += 1
            if self._since_recalc < _RECALC_EVERY:
                return
            self._since_recalc = 0
            snapshot = list(self._lat)
        # the O(n log n) sort runs OUTSIDE the lock — this lock sits on
        # every observed read's exit path, and two racing recalcs both
        # write a fresh-enough estimate (attribute store is atomic)
        ordered = sorted(snapshot)
        # lint: guard-ok(deliberate unlocked store: racing recalcs both write a fresh-enough estimate)
        self._p95 = ordered[int(0.95 * (len(ordered) - 1))]

    def hedge_delay(self) -> float:
        """How long the primary runs alone: max(tracked p95, floor)."""
        return max(self._p95, self.delay_floor_s)

    def _budget_ok(self) -> bool:
        if self.budget_pct <= 0:
            return False
        # denominator = EVERY fetch this hedger mediates (including
        # single-candidate ones): the budget bounds extra LOAD on the
        # cluster as a fraction of total read traffic, per the Dean &
        # Barroso framing — not a fraction of hedge-eligible reads.
        # +1 so the very first slow request may hedge; the pct bound
        # takes over as volume grows
        return self.hedges < self.budget_pct * self.requests + 1

    def _acquire_lane(self) -> bool:
        with self._lock:
            if self._inflight >= self.max_inflight - 1:
                return False
            self._inflight += 1
            return True

    def _release_lane(self) -> None:
        with self._lock:
            self._inflight -= 1

    # -- the fetch -----------------------------------------------------------

    def fetch(self, fns: Sequence[Callable[[], object]],
              timeout: float = 60.0):
        """Run fns[0]; after hedge_delay() launch fns[1] when the
        budget allows; first success wins, remaining attempts are
        abandoned. A FAILED attempt triggers the next candidate
        immediately (failover, unbudgeted). Raises the first error
        once every candidate has failed."""
        with self._lock:
            self.requests += 1
        HedgeRequestsCounter.inc()
        # request-scoped span on the caller thread; candidate thunks
        # run on the pool under copied contexts, so their own spans
        # land in the same trace and parent to the request span
        hsp = trace.span("hedge.fetch", candidates=len(fns)) \
            if trace.active() else trace.NOOP
        hsp.__enter__()
        try:
            return self._fetch(fns, timeout)
        finally:
            hsp.__exit__(None, None, None)

    def _fetch(self, fns: Sequence[Callable[[], object]],
               timeout: float):
        rem = deadline_mod.remaining()
        if rem is not None:
            if rem <= 0:
                raise deadline_mod.DeadlineExceeded("hedged fetch")
            timeout = min(timeout, rem)
        if len(fns) <= 1 or not self._acquire_lane():
            # single candidate, or the pool is saturated with
            # abandoned losers: no hedging, but failover (walking the
            # candidates on failure) is mandatory work and never
            # degrades away
            t0 = time.perf_counter()
            last_err: Optional[BaseException] = None
            for i, fn in enumerate(fns):
                try:
                    result = fn()
                except Exception as e:  # noqa: BLE001 - walk candidates
                    if _card_fault(e):
                        raise
                    last_err = e
                    continue
                if i == 0:
                    self.observe(time.perf_counter() - t0)
                return result
            raise last_err

        def final_error(err: Optional[BaseException]) -> BaseException:
            # a budget that expired MID-fetch shows up as the timeout
            # it shrank (RequestTimeout) or as per-candidate refusals;
            # the caller's contract is DeadlineExceeded either way —
            # the 504-vs-500 distinction at the server edges rides on
            # the type
            if deadline_mod.expired():
                return deadline_mod.DeadlineExceeded("hedged fetch")
            return err or TimeoutError("hedged fetch timed out")

        cond = threading.Condition()
        outcomes: List[tuple] = []   # (idx, result, exc)

        def run(idx: int, fn: Callable):
            try:
                r, e = fn(), None
            except BaseException as exc:  # noqa: BLE001 - latched
                r, e = None, exc
            finally:
                self._release_lane()
            with cond:
                outcomes.append((idx, r, e))
                cond.notify_all()

        t0 = time.perf_counter()
        end = t0 + timeout
        self._pool.submit(run, 0, fns[0])
        launched, hedged, denied_once = 1, False, False
        hedge_idx = -1   # which launch index was the speculative hedge
        first_err: Optional[BaseException] = None
        seen = 0
        with cond:
            while True:
                # consume newly-landed outcomes
                while seen < len(outcomes):
                    idx, result, exc = outcomes[seen]
                    seen += 1
                    if exc is None:
                        if idx == hedge_idx:
                            # only a SPECULATIVE winner is a hedge win;
                            # a failover winner was mandatory work
                            with self._lock:
                                self.wins += 1
                            HedgeWinsCounter.inc()
                        elif idx == 0:
                            self.observe(time.perf_counter() - t0)
                        return result
                    if _card_fault(exc):
                        raise exc
                    if first_err is None:
                        first_err = exc
                    if launched < len(fns):
                        # failover: mandatory, not speculative
                        if self._acquire_lane():
                            self._pool.submit(run, launched, fns[launched])
                            launched += 1
                        elif seen == launched:
                            # saturated and nothing else in flight
                            # (holding cond is safe: no worker of THIS
                            # fetch remains to contend for it): finish
                            # the remaining candidates inline, still
                            # walking on failure
                            for fn in fns[launched:]:
                                try:
                                    return fn()
                                except Exception as e:  # noqa: BLE001
                                    if _card_fault(e):
                                        raise
                                    if first_err is None:
                                        first_err = e
                            raise final_error(first_err)
                if seen == launched and launched >= len(fns):
                    raise final_error(first_err)
                now = time.perf_counter()
                if now >= end:
                    raise final_error(first_err)
                wait = end - now
                if not hedged and launched < len(fns):
                    fire_at = t0 + self.hedge_delay()
                    if now >= fire_at:
                        if not self._budget_ok():
                            # only a BUDGET refusal lands in the
                            # budget-denied counter; a saturated lane
                            # is a different condition and must not
                            # read as budget exhaustion on dashboards
                            if not denied_once:
                                denied_once = True
                                with self._lock:
                                    self.denied += 1
                                HedgeDeniedCounter.inc()
                        elif self._acquire_lane():
                            with self._lock:
                                self.hedges += 1
                            HedgeIssuedCounter.inc()
                            hedge_idx = launched
                            self._pool.submit(run, launched,
                                              fns[launched])
                            launched += 1
                        hedged = True
                    else:
                        wait = min(wait, fire_at - now)
                cond.wait(timeout=wait)
