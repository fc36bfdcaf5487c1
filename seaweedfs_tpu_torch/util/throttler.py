"""Bandwidth throttler for the fleet verify pass's reads (the counterpart
of ``seaweedfs_tpu.util.throttler``; reference weed/util/throttler.go)."""

from __future__ import annotations

import time


class Throttler:
    """Call maybe_slowdown(n) after processing n bytes; sleeps so the
    average rate stays at or below limit_mbps. 0 disables.

    Token bucket: credit accrues at the limit rate and is CAPPED at
    burst_s seconds worth, so a long idle period cannot bank unlimited
    budget — without the cap, a scrub that slept through a quiet hour
    would then read at full disk speed for an hour straight, exactly
    the IO spike the throttle exists to prevent. A call that overdraws
    the bucket sleeps until the deficit is repaid.

    limit_mbps=0 (any burst_s) is a guaranteed no-op: `disabled` is
    computed once at construction and maybe_slowdown pays exactly one
    attribute comparison — no clock read, no credit math — so the
    hot copy loops that call this per block can keep the call
    unconditionally.
    """

    def __init__(self, limit_mbps: float = 0.0, burst_s: float = 1.0):
        self.limit_bps = limit_mbps * 1024 * 1024
        self.burst_s = max(burst_s, 0.0)
        self.disabled = self.limit_bps <= 0
        self._credit = 0.0  # empty bucket: the first bytes pay full price
        self._last = time.monotonic()

    def maybe_slowdown(self, n: int) -> None:
        if self.disabled:
            return
        now = time.monotonic()
        self._credit = min(self.limit_bps * self.burst_s,
                           self._credit + (now - self._last) * self.limit_bps)
        self._credit -= n
        if self._credit < 0:
            time.sleep(-self._credit / self.limit_bps)
            self._credit = 0.0
        # stamp AFTER any sleep: the sleep itself repaid the deficit and
        # must not accrue as fresh credit on the next call
        self._last = time.monotonic()

    def tokens(self) -> float:
        """Current credit in bytes, refreshed to now (introspection for
        the QoS gauges and /status blocks); +inf when disabled. May be
        negative right after an overdraw that has not slept yet."""
        if self.disabled:
            return float("inf")
        now = time.monotonic()
        self._credit = min(self.limit_bps * self.burst_s,
                           self._credit + (now - self._last) * self.limit_bps)
        self._last = now
        return self._credit
