"""Waterfall retry with full jitter, a deadline cap and typed outcomes.

The port of ``seaweedfs_tpu.util.retry`` (reference weed/util/retry.go):
full jitter, U(0, wait), decorrelates the retries of many clients, and a
total deadline stops retrying work the caller has given up on.

Every attempt lands in SeaweedFS_retry_attempts_total{name,outcome}:
ok, retried, exhausted, nonretryable or deadline.

The default ``retryable=`` classifies through ``util/http_client.
classify``: connection-class errors (the request never reached the peer)
and busy answers retry; timeouts and errors after the request was sent
do not (the peer may have run it); an open breaker and a spent deadline
never burn attempts. Exceptions from outside the HTTP client retry.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


class NonRetryableError(Exception):
    pass


def default_retryable(e: Exception) -> bool:
    from seaweedfs_tpu_torch.util import http_client
    # "busy" is a 429/503 the peer answered WITHOUT running the request:
    # always safe to replay, after the pause it asked for
    return http_client.classify(e) in ("connect", "busy", "other")


def _count(name: str, outcome: str) -> None:
    from seaweedfs_tpu_torch.stats.metrics import RetryAttemptsCounter
    RetryAttemptsCounter.labels(name, outcome).inc()


def retry(name: str, fn: Callable[[], T], *, times: int = 6,
          wait_seconds: float = 0.05, backoff: float = 2.0,
          retryable: Optional[Callable[[Exception], bool]] = None,
          deadline: Optional[float] = None, jitter: bool = True,
          _sleep=time.sleep, _rand=random.random) -> T:
    """Run fn() up to ``times`` times with full-jitter exponential backoff
    (sleep k ~ U(0, wait_seconds * backoff**k) with jitter).

    ``deadline`` caps the whole call in seconds; it combines (min) with an
    ambient request deadline, sleeps are cut to the budget left, and a
    spent budget stops retrying. A budget spent at entry raises
    DeadlineExceeded without running fn. ``_sleep`` and ``_rand`` are
    the clock's and the jitter's seams.
    """
    from seaweedfs_tpu_torch.resilience import deadline as dl
    if retryable is None:
        retryable = default_retryable
    budget_end = None
    if deadline is not None:
        budget_end = time.monotonic() + deadline
    ambient = dl.get()
    if ambient is not None:
        budget_end = ambient if budget_end is None \
            else min(budget_end, ambient)
    if budget_end is not None and time.monotonic() >= budget_end:
        _count(name, "deadline")
        raise dl.DeadlineExceeded(f"retry {name}")

    wait = wait_seconds
    last: Exception = RuntimeError(f"{name}: retry never ran")
    for attempt in range(times):
        try:
            result = fn()
            _count(name, "ok")
            return result
        except NonRetryableError:
            _count(name, "nonretryable")
            raise
        except Exception as e:  # noqa: BLE001 - classified below
            last = e
            if not retryable(e):
                _count(name, "nonretryable")
                break
            if attempt == times - 1:
                _count(name, "exhausted")
                break
            pause = _rand() * wait if jitter else wait
            # a server-sent Retry-After beats the jittered guess; the
            # deadline below still caps it
            ra = getattr(e, "retry_after", 0.0)
            if ra and ra > 0:
                pause = float(ra)
            if budget_end is not None:
                remaining = budget_end - time.monotonic()
                if remaining <= 0:
                    _count(name, "deadline")
                    break
                pause = min(pause, remaining)
            _count(name, "retried")
            _sleep(pause)
            wait *= backoff
    raise last
