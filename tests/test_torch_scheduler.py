"""The port's schedule explorer (``util/scheduler.py``) against the JAX
package's.

The thirteen cases of ``tests/test_scheduler.py`` run against the port's
module with the same seeds, policies and schedule counts. Schedules are
deterministic, so wherever both explorers run the same scenario the seeds
of ``ExploreResult.failures`` are equal and each failure is the same kind
of error: the lost update, PCT's long-run schedule, the AB/BA deadlock,
the queues and virtual timeouts. The two real seams drive the port's
``util/fanout.FanOutPool`` and ``scrub/daemon.ScrubDaemon``: the racy
twin of the old ``ScrubDaemon.stop()`` fails on the schedules where the
JAX twin fails, and the port's daemon is clean over the same schedules.
"""

from __future__ import annotations

import queue
import threading
import time as time_mod
from types import SimpleNamespace

import pytest

from seaweedfs_tpu.util import scheduler as jax_scheduler
from seaweedfs_tpu_torch.util import sanitizer
from seaweedfs_tpu_torch.util import scheduler
from seaweedfs_tpu_torch.util.scheduler import (DeadlockError,
                                                ScheduleFailure, explore,
                                                replay)


def _signature(res):
    return [(f.seed, f.policy, f.depth, type(f.cause).__name__)
            for f in res.failures]


def explore_both(make, **kw):
    """``explore(make(), **kw)`` under the JAX explorer, then the port's:
    the failures (seed, policy, depth, error type) are equal. Returns the
    port's result."""
    want = jax_scheduler.explore(make(), check=False, **kw)
    got = explore(make(), check=False, **kw)
    assert _signature(got) == _signature(want)
    return got


# -- determinism --------------------------------------------------------------


def _lost_update_scenario(rounds=2):
    """Classic atomicity violation: read under one lock acquisition,
    write under another — the window between them loses updates."""
    def scenario():
        box = SimpleNamespace(n=0)
        lock = threading.Lock()

        def bump():
            for _ in range(rounds):
                with lock:
                    tmp = box.n
                with lock:
                    box.n = tmp + 1

        ts = [threading.Thread(target=bump) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert box.n == 2 * rounds, f"lost update: {box.n}"
    return scenario


def test_explore_finds_seeded_lost_update():
    res = explore_both(_lost_update_scenario, schedules=30, seed=0)
    assert res.failures, "30 schedules never interleaved the window?"
    assert all(isinstance(f, ScheduleFailure) for f in res.failures)
    assert "lost update" in str(res.failures[0].cause)


def test_replay_is_deterministic():
    res = explore_both(_lost_update_scenario, schedules=30, seed=0)
    seed = res.failures[0].seed
    outcomes = []
    for _ in range(3):
        with pytest.raises(ScheduleFailure) as ei:
            replay(_lost_update_scenario(), seed=seed)
        outcomes.append(str(ei.value.cause))
    assert len(set(outcomes)) == 1, \
        f"replay diverged across runs: {outcomes}"
    with pytest.raises(jax_scheduler.ScheduleFailure) as ei:
        jax_scheduler.replay(_lost_update_scenario(), seed=seed)
    assert str(ei.value.cause) == outcomes[0]
    # a NON-failing seed replays clean, deterministically
    ok_seeds = [seed + i for i in range(30)
                if seed + i not in {f.seed for f in res.failures}]
    if ok_seeds:
        replay(_lost_update_scenario(), seed=ok_seeds[0])


def test_check_mode_raises_with_repro_seed():
    with pytest.raises(ScheduleFailure) as ei:
        explore(_lost_update_scenario(), schedules=30, seed=0)
    with pytest.raises(jax_scheduler.ScheduleFailure) as jax_ei:
        jax_scheduler.explore(_lost_update_scenario(), schedules=30, seed=0)
    assert ei.value.seed == jax_ei.value.seed >= 0
    assert "replay(" in str(ei.value)
    assert str(ei.value) == str(jax_ei.value)


# -- PCT vs random ------------------------------------------------------------


def _ordering_bug_scenario():
    """The reader's invariant only breaks when the writer runs its
    whole loop uninterrupted FIRST — one long run plus one precisely
    placed switch. PCT's priority schedules produce exactly that
    shape; uniform random (which preempts constantly) essentially
    never does."""
    def scenario():
        state = {"n": 0}
        lock = threading.Lock()

        def writer():
            for i in range(16):
                with lock:
                    state["n"] = i

        def reader():
            with lock:
                snap = state["n"]
            assert snap < 15, f"reader saw completed writer: {snap}"

        ts = [threading.Thread(target=writer),
              threading.Thread(target=reader)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    return scenario


def test_pct_finds_ordering_bug_random_misses_at_n4():
    rand = explore_both(_ordering_bug_scenario, schedules=4, seed=0,
                        policy="random")
    assert not rand.failures, \
        "random at N=4 was never expected to reach this interleaving"
    pct = explore_both(_ordering_bug_scenario, schedules=4, seed=0,
                       policy="pct", depth=2)
    assert pct.failures, "pct at N=4 must find the long-run schedule"
    # and the pct seed replays under the pct policy, deterministically
    with pytest.raises(ScheduleFailure) as ei:
        replay(_ordering_bug_scenario(), seed=pct.failures[0].seed,
               policy="pct", depth=2)
    assert "completed writer" in str(ei.value.cause)


# -- primitives under exploration --------------------------------------------


def _queue_roundtrip_scenario():
    def scenario():
        q = queue.SimpleQueue()
        outer, inner = threading.Lock(), threading.Lock()
        got = []

        def producer():
            for i in range(4):
                with outer:
                    with inner:
                        q.put(i)
            q.put(None)

        def consumer():
            while True:
                item = q.get()
                if item is None:
                    return
                got.append(item)

        ts = [threading.Thread(target=producer),
              threading.Thread(target=consumer)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert got == [0, 1, 2, 3], got
    return scenario


def test_nested_lock_queue_roundtrip_under_exploration():
    res = explore_both(_queue_roundtrip_scenario, schedules=25, seed=0)
    assert not res.failures, res.failures[0]


def _backpressure_scenario():
    def scenario():
        q = queue.Queue(maxsize=1)

        def producer():
            for i in range(5):
                q.put(i)

        def consumer():
            assert [q.get() for _ in range(5)] == list(range(5))

        ts = [threading.Thread(target=producer),
              threading.Thread(target=consumer)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    return scenario


def test_bounded_queue_backpressure_deterministic():
    res = explore_both(_backpressure_scenario, schedules=25, seed=0)
    assert not res.failures, res.failures[0]


def _ab_ba_scenario():
    def scenario():
        a, b = threading.Lock(), threading.Lock()

        def t1():
            with a:
                with b:
                    pass

        def t2():
            with b:
                with a:
                    pass

        ts = [threading.Thread(target=t1), threading.Thread(target=t2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    return scenario


def test_deadlock_detected_not_hung():
    res = explore_both(_ab_ba_scenario, schedules=20, seed=0)
    dls = [f for f in res.failures
           if isinstance(f.cause, DeadlockError)]
    assert dls, "AB/BA never deadlocked in 20 schedules?"
    assert "blocked" in str(dls[0].cause)
    # the deadlocking seed replays as the same deadlock
    with pytest.raises(ScheduleFailure) as ei:
        replay(_ab_ba_scenario(), seed=dls[0].seed)
    assert isinstance(ei.value.cause, DeadlockError)


def test_virtual_timeout_fires_only_when_idle():
    def timeout_scenario():
        def scenario():
            ev = threading.Event()
            # nobody will ever set it: the timeout is the only way out,
            # and virtual time serves it without waiting wall-clock
            assert ev.wait(timeout=30.0) is False
        return scenario

    t0 = time_mod.monotonic()
    res = explore_both(timeout_scenario, schedules=5, seed=0)
    assert not res.failures
    assert time_mod.monotonic() - t0 < 30.0

    def no_spurious_timeout_scenario():
        def scenario():
            ev = threading.Event()
            t = threading.Thread(target=ev.set)
            t.start()
            # a setter exists: the wait must win via the event, never the
            # timeout (virtual time only advances when nothing can run)
            assert ev.wait(timeout=0.001) is True
            t.join()
        return scenario

    res = explore_both(no_spurious_timeout_scenario, schedules=10, seed=0)
    assert not res.failures, res.failures[0]


def test_condition_wait_raises_not_hangs_on_both_lock_flavors():
    # Condition over a scheduler-wrapped PLAIN Lock used to park the
    # registered thread on a raw waiter lock while it held the
    # scheduling token — a silent whole-run hang. Both flavors must
    # raise the documented error instead.
    for name in ("Lock", "RLock"):
        def make(name=name):
            def scenario():
                # resolve the factory INSIDE the run: captured before
                # arming it would be the stock C lock, not the wrapper
                cv = threading.Condition(getattr(threading, name)())
                with pytest.raises(RuntimeError, match="not supported"):
                    with cv:
                        cv.wait(0.01)
            return scenario
        res = explore_both(make, schedules=3, seed=0)
        assert not res.failures, res.failures[0]


def test_failure_repro_line_pins_pct_depth():
    pct = explore_both(_ordering_bug_scenario, schedules=4, seed=0,
                       policy="pct", depth=2)
    assert pct.failures
    assert "depth=2" in str(pct.failures[0]), \
        "the printed repro must pin the non-default pct depth"
    assert pct.failures[0].depth == 2


def test_factories_restored_after_explore():
    explore(lambda: None, schedules=2, seed=0, check=False)
    assert threading.Lock is sanitizer._ORIG_LOCK
    assert threading.RLock is sanitizer._ORIG_RLOCK
    assert queue.SimpleQueue.__module__ == "_queue"
    assert time_mod.sleep.__module__ != "seaweedfs_tpu_torch.util.scheduler"
    assert not scheduler.armed()


# -- real seams, explorer-driven ----------------------------------------------


def test_fanout_pool_submit_stop_race_explored():
    """A submit racing stop() must either run on a worker (enqueued ahead
    of the sentinels) or inline on the caller — its Future always
    resolves. A task that landed BEHIND the stop sentinels would hang its
    Future forever; here that would surface as a virtual TimeoutError in
    some schedule. The port's pool and the JAX pool are both clean over
    the same 30 schedules."""
    from seaweedfs_tpu.util.fanout import FanOutPool as JaxFanOutPool
    from seaweedfs_tpu_torch.util.fanout import FanOutPool

    def make(pool_cls):
        def scenario():
            pool = pool_cls(2, "schedtest")
            results = []

            def submitter():
                futs = [pool.submit(lambda i=i: i * 3) for i in range(3)]
                results.extend(f.wait(timeout=5) for f in futs)

            t = threading.Thread(target=submitter)
            t.start()
            pool.stop()
            t.join()
            assert [r for r, _exc in results] == [0, 3, 6], results
            assert all(exc is None for _r, exc in results)
        return scenario

    res = explore(make(FanOutPool), schedules=30, seed=0, check=False)
    assert not res.failures, res.failures[0]
    res = jax_scheduler.explore(make(JaxFanOutPool), schedules=30, seed=0,
                                check=False)
    assert not res.failures, res.failures[0]


def _racy_stop(daemon_cls):
    """The old ScrubDaemon.stop() over ``daemon_cls``, kept as the
    regression baseline (unlocked _stopping write + unlocked _thread
    read)."""
    class Racy(daemon_cls):
        def stop(self):
            self._stopping = True
            self._resume.set()
            self._wake.set()
            t = self._thread
            if t is not None:
                t.join(timeout=10)
            self._state = "idle"
    return Racy


def _scrub_stop_scenario(daemon_cls, **kwargs):
    def scenario():
        d = daemon_cls(SimpleNamespace(locations=[]), interval_s=0.0,
                       export_lag=False, **kwargs)
        t = threading.Thread(target=d.start)
        t.start()
        d.stop()
        t.join()
        leaked = d._thread
        assert leaked is None or not leaked.is_alive(), \
            "pass thread survived stop()"
    return scenario


def test_scrub_daemon_stop_start_race_fixed():
    """stop()'s unlocked _stopping write could land while a concurrent
    start() sat between its _stopping check and its thread spawn — stop()
    then read _thread as None, skipped the join, and the fresh pass
    thread outlived shutdown. The racy twin of the port's daemon fails on
    the seeds where the JAX twin fails over the same 40 schedules; the
    port's locked stop() is clean over them, and the failing seed
    replays against the racy twin."""
    from seaweedfs_tpu.scrub.daemon import ScrubDaemon as JaxScrubDaemon
    from seaweedfs_tpu_torch.scrub.daemon import ScrubDaemon

    old = explore(_scrub_stop_scenario(_racy_stop(ScrubDaemon),
                                       backend="cpu"),
                  schedules=40, seed=0, check=False)
    assert old.failures, \
        "explorer lost the pre-fix repro — schedule space changed?"
    assert any("survived stop" in str(f.cause) for f in old.failures)
    jax_old = jax_scheduler.explore(
        _scrub_stop_scenario(_racy_stop(JaxScrubDaemon)),
        schedules=40, seed=0, check=False)
    assert _signature(old) == _signature(jax_old)

    fixed = explore(_scrub_stop_scenario(ScrubDaemon, backend="cpu"),
                    schedules=40, seed=0, check=False)
    assert not fixed.failures, fixed.failures[0]

    # the failing seed is pinned: it must replay against the old code
    with pytest.raises(ScheduleFailure):
        replay(_scrub_stop_scenario(_racy_stop(ScrubDaemon), backend="cpu"),
               seed=old.failures[0].seed)
