"""The port's zero-cost gates for its dev tooling: the twins of
``tests/test_perf_gates.py``'s ``test_sanitizer_disabled_overhead`` and
``test_scheduler_disabled_overhead``, with the same bounds.

Unarmed, ``threading.Lock`` is the untouched C factory, and importing the
port (its sanitizer, explorer and analyzer included) spawns no thread.
Arming is reversible, and an ``explore()`` of either package restores
whatever factories it found, the other package's sanitizer wrappers
included.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stock_cycle_s(threading) -> float:
    lk = threading.Lock()
    t0 = time.perf_counter()
    for _ in range(200_000):
        with lk:
            pass
    return (time.perf_counter() - t0) / 200_000


def test_torch_sanitizer_disabled_overhead():
    """Unarmed, `threading.Lock` literally IS the untouched C factory;
    arming is reversible and the armed tax stays bounded."""
    import threading

    from seaweedfs_tpu_torch.util import sanitizer

    if os.environ.get("SEAWEED_SANITIZE"):
        pytest.skip("suite runs armed by explicit request")
    assert not sanitizer.armed(), \
        "sanitizer must be unarmed without SEAWEED_SANITIZE"
    assert threading.Lock is sanitizer._ORIG_LOCK, \
        "unarmed sanitizer must leave threading.Lock untouched"
    assert threading.RLock is sanitizer._ORIG_RLOCK
    assert not sanitizer.findings()

    stock = _stock_cycle_s(threading)
    assert stock < 2e-6, f"stock lock cycle {stock * 1e6:.3f} us?!"

    sanitizer.arm()
    try:
        assert sanitizer.armed()
        assert threading.Lock is not sanitizer._ORIG_LOCK
        wrapped = threading.Lock()
        t0 = time.perf_counter()
        for _ in range(20_000):
            with wrapped:
                pass
        armed_cost = (time.perf_counter() - t0) / 20_000
        assert armed_cost < 100e-6, \
            f"armed lock cycle {armed_cost * 1e6:.1f} us"
    finally:
        sanitizer.disarm()
        sanitizer.reset()
    assert threading.Lock is sanitizer._ORIG_LOCK
    assert threading.RLock is sanitizer._ORIG_RLOCK


_IMPORT_THREADS = r"""
import json, threading
before = {t.name for t in threading.enumerate()}
import seaweedfs_tpu_torch
from seaweedfs_tpu_torch import analysis
from seaweedfs_tpu_torch.util import sanitizer, scheduler
print(json.dumps({"before": sorted(before),
                  "after": sorted(t.name for t in threading.enumerate()),
                  "stock": threading.Lock is sanitizer._ORIG_LOCK}))
"""


def test_torch_import_spawns_no_thread():
    env = {k: v for k, v in os.environ.items()
           if k not in ("SEAWEED_SANITIZE", "SEAWEED_SCHED")}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_THREADS],
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["after"] == got["before"] == ["MainThread"]
    assert got["stock"]


def test_torch_scheduler_disabled_overhead():
    """Importing the explorer patches nothing and spawns no thread; arming
    is reversible; a wrapper made while armed keeps delegating; and an
    explore() of either package, run with the other's sanitizer armed,
    puts that sanitizer's wrappers back exactly."""
    import queue as queue_mod
    import threading
    import time as time_mod

    from seaweedfs_tpu.util import sanitizer as jax_sanitizer
    from seaweedfs_tpu.util import scheduler as jax_scheduler
    from seaweedfs_tpu_torch.util import sanitizer
    from seaweedfs_tpu_torch.util import scheduler

    if os.environ.get("SEAWEED_SCHED"):
        pytest.skip("suite runs armed by explicit request")
    assert not scheduler.armed(), \
        "scheduler must be unarmed without SEAWEED_SCHED"
    assert threading.Lock is sanitizer._ORIG_LOCK, \
        "unarmed scheduler must leave threading.Lock untouched"
    assert threading.RLock is sanitizer._ORIG_RLOCK
    assert threading.Event.__module__ == "threading"
    assert threading.Thread.__module__ == "threading"
    assert queue_mod.SimpleQueue.__module__ == "_queue"
    assert queue_mod.Queue.__module__ == "queue"
    assert time_mod.sleep.__module__ is None or \
        "scheduler" not in str(time_mod.sleep.__module__)
    assert not [t for t in threading.enumerate()
                if "sched" in t.name.lower()]

    stock = _stock_cycle_s(threading)
    assert stock < 2e-6, f"stock lock cycle {stock * 1e6:.3f} us?!"

    scheduler.arm()
    try:
        assert scheduler.armed()
        assert threading.Lock is not sanitizer._ORIG_LOCK
        leftover = threading.Lock()
    finally:
        scheduler.disarm()
    assert threading.Lock is sanitizer._ORIG_LOCK
    assert threading.RLock is sanitizer._ORIG_RLOCK
    assert queue_mod.SimpleQueue.__module__ == "_queue"
    with leftover:            # delegate mode: plain real lock
        assert leftover.locked()
    assert not scheduler.armed()

    # composition: each package's explorer over the other's sanitizer
    for san, sched in ((jax_sanitizer, scheduler),
                       (sanitizer, jax_scheduler)):
        san.arm()
        try:
            wrappers = (threading.Lock, threading.RLock)
            assert wrappers[0] is not sanitizer._ORIG_LOCK
            sched.explore(lambda: threading.Lock(), schedules=2, seed=0,
                          check=False)
            assert (threading.Lock, threading.RLock) == wrappers
            assert not sched.armed()
        finally:
            san.disarm()
            san.reset()
        assert threading.Lock is sanitizer._ORIG_LOCK
        assert threading.RLock is sanitizer._ORIG_RLOCK
