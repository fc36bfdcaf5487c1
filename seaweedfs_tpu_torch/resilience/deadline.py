"""Per-request deadline budget.

The counterpart of ``seaweedfs_tpu.resilience.deadline``, cut to what the
port uses: a contextvar holding the ABSOLUTE monotonic deadline of the
current request, and the reads of it. The decode fleet caps a caller's
wait to the budget left (``reads/decode_fleet.py``). With no deadline set
the hot path pays one ContextVar.get() returning None.
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager
from typing import Optional

# the remaining budget, in seconds, forwarded on an outbound HTTP request
# (util/http_client.py)
HEADER = "X-Seaweed-Deadline"
HEADER_LOWER = "x-seaweed-deadline"

_deadline: "contextvars.ContextVar[Optional[float]]" = \
    contextvars.ContextVar("seaweed_deadline", default=None)


class DeadlineExceeded(OSError):
    """The request's budget ran out. Subclasses OSError so data-plane
    error handling (which treats OSError as a failed hop) needs no new
    except arms."""

    def __init__(self, what: str = ""):
        super().__init__(f"deadline exceeded{': ' + what if what else ''}")


def get() -> Optional[float]:
    """The absolute monotonic deadline, or None when unbudgeted."""
    return _deadline.get()


def remaining() -> Optional[float]:
    """Seconds left in the budget (may be <= 0), or None."""
    d = _deadline.get()
    return None if d is None else d - time.monotonic()


def expired() -> bool:
    d = _deadline.get()
    return d is not None and time.monotonic() >= d


def check(what: str = "") -> None:
    """Raise DeadlineExceeded when the ambient budget is spent."""
    d = _deadline.get()
    if d is not None and time.monotonic() >= d:
        raise DeadlineExceeded(what)


def set_budget(seconds: float) -> "contextvars.Token":
    """Set the ambient budget to `seconds` from now — never EXTENDING
    an existing budget (an inner hop cannot grant itself more time than
    its caller gave it). Returns a token for reset()."""
    d = time.monotonic() + max(0.0, seconds)
    cur = _deadline.get()
    if cur is not None:
        d = min(cur, d)
    return _deadline.set(d)


def reset(token: "contextvars.Token") -> None:
    _deadline.reset(token)


@contextmanager
def budget(seconds: float):
    """`with deadline.budget(2.0): ...` — scoped budget."""
    token = set_budget(seconds)
    try:
        yield
    finally:
        reset(token)


def parse_header(value: str) -> Optional[float]:
    """Remaining seconds from an X-Seaweed-Deadline value; None on junk
    (a malformed header must never fail the request, it just carries no
    budget)."""
    try:
        rem = float(value)
    except (TypeError, ValueError):
        return None
    # NaN from a clock-confused peer carries no budget
    if rem != rem:
        return None
    return max(rem, 0.0)
