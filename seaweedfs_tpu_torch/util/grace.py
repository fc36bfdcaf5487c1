"""Graceful stop + profiling hooks.

Reference: weed/util/grace/signal_handling.go:16-50 (OnInterrupt signal
hooks) and weed/util/grace/pprof.go:11-34 (-cpuprofile/-memprofile).
The Python analogs: signal handlers that run registered cleanups once on
SIGINT/SIGTERM/SIGHUP, and cProfile for the CPU profile flag.
"""

from __future__ import annotations

import cProfile
import signal
import threading
from typing import Callable, List, Optional

_hooks: List[Callable[[], None]] = []
_installed = False
_fired = False
_lock = threading.Lock()
_profiler: Optional[cProfile.Profile] = None
_profile_path: Optional[str] = None


def on_interrupt(fn: Callable[[], None]) -> None:
    """Register a cleanup to run when the process receives
    SIGINT/SIGTERM (each runs once, LIFO, like the reference)."""
    global _installed
    with _lock:
        _hooks.append(fn)
        if not _installed:
            _installed = True
            for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
                try:
                    signal.signal(sig, _handle)
                except (ValueError, OSError):
                    pass  # not the main thread / unsupported signal


def _handle(signum, frame) -> None:
    run_hooks()
    raise SystemExit(128 + signum)


def run_hooks() -> None:
    """Run all registered cleanups exactly once (also called on normal
    shutdown so ctrl-C and clean exit share one path)."""
    global _fired
    with _lock:
        if _fired:
            return
        _fired = True
        hooks, _hooks[:] = list(_hooks), []
    stop_profiling()
    for fn in reversed(hooks):
        try:
            fn()
        # lint: swallow-ok(shutdown hooks are best-effort by contract)
        except Exception:
            pass


def reset() -> None:
    """Forget hooks + fired state (tests)."""
    global _fired
    with _lock:
        _hooks.clear()
        _fired = False


def setup_profiling(cpu_profile: Optional[str]) -> None:
    """Start a CPU profile that stop_profiling()/run_hooks() dumps to
    `cpu_profile` (pstats format, readable with `python -m pstats`)."""
    global _profiler, _profile_path
    if not cpu_profile:
        return
    _profile_path = cpu_profile
    _profiler = cProfile.Profile()
    _profiler.enable()


def stop_profiling() -> None:
    global _profiler
    if _profiler is not None:
        _profiler.disable()
        _profiler.dump_stats(_profile_path)
        _profiler = None
