"""Deterministic schedule explorer — systematic interleaving search.

The static `guard` check (seaweedfs_tpu_torch/analysis/guards.py) proves
which lock protects which state; the sanitizer (util/sanitizer.py)
catches lock-order cycles at runtime. Neither can demonstrate an
*atomicity* violation — a check-then-act split across two locked
regions that only corrupts state on one interleaving in a thousand.
This module makes those interleavings enumerable, in the style of
PCT/Coyote: a cooperative scheduler that serializes a small
multi-threaded test onto ONE runnable-at-a-time schedule chosen by a
seeded policy, so

    explore(fn, schedules=50, seed=0)

runs `fn` under 50 distinct deterministic interleavings and
`replay(fn, seed=<failing>)` reproduces a failure exactly — a
one-in-a-thousand CI flake becomes a unit test.

How it interposes (armed only — see the cost contract below): the
`threading.Lock`/`RLock`/`Event`/`Thread` and
`queue.Queue`/`queue.SimpleQueue` factories are swapped for
cooperative wrappers, and `time.sleep` becomes a scheduling point
(virtual time: a sleep never actually sleeps; timeouts fire only when
no other thread can run, which is the deterministic reading of "the
timeout elapsed first"). Every wrapper delegates to the real
primitive unless the calling thread is REGISTERED with the active
run, so background machinery (metrics pushers, pools spawned outside
the test) keeps working untouched. Threads started by a registered
thread during a run are themselves registered — the test's whole
thread tree runs cooperatively, one thread at a time, switching only
at interposition points.

Schedule policies:
  random  at every scheduling point, pick uniformly among runnable
          threads (seeded `random.Random`) — good breadth.
  pct     PCT (probabilistic concurrency testing): threads get random
          priorities; the highest-priority runnable thread runs;
          at d-1 pre-sampled change points the current top thread is
          demoted below everyone. Finds depth-d bugs that need one
          long uninterrupted run plus one precisely-placed preempt —
          the shape uniform-random almost never produces.

Deadlocks don't hang: when every registered thread is blocked and no
timed waiter remains, the run raises DeadlockError naming each
thread's blocked-on resource. Runaway schedules (spin loops) hit
max_steps and raise ScheduleLimitError.

Out of scope, by contract: `Condition.wait` from a registered thread
(raises — restructure the test or leave that seam to the sanitizer)
and synchronizers shared between registered and unregistered threads
(the cooperative and real views of such a primitive can diverge;
keep explored tests self-contained).

Cost contract (house rule, gated by
tests/test_torch_perf_gates.py::test_torch_scheduler_disabled_overhead): unarmed, importing
this module is one env read — `threading.Lock` stays the stock C
factory and no thread is ever spawned at import. `explore()` arms on
entry and restores the previous factories on exit, so the tree never
pays for exploration it didn't ask for. `SEAWEED_SCHED=1` arms at
import (wrappers in delegate mode until a run starts);
`SEAWEED_SCHED_SCHEDULES` / `SEAWEED_SCHED_SEED` /
`SEAWEED_SCHED_MAX_STEPS` override explore()'s defaults.
"""

from __future__ import annotations

import os
import queue as _queue_mod
import random
import threading
import time as _time_mod
from collections import deque
from typing import Callable, List, Optional

import _thread

__all__ = ["explore", "replay", "arm", "disarm", "armed",
           "ExploreResult", "ScheduleFailure", "DeadlockError",
           "ScheduleLimitError"]


class DeadlockError(RuntimeError):
    """Every registered thread is blocked and no timeout can fire."""


class ScheduleLimitError(RuntimeError):
    """The schedule exceeded max_steps (spin loop in the test?)."""


class _Aborted(BaseException):
    """Internal: unwind a registered thread after its run died."""


class ScheduleFailure(AssertionError):
    """One schedule failed; carries everything that reproduces it
    (seed, policy, AND depth — a pct failure found at depth=2 samples
    different change points under the default, so the printed repro
    must pin it)."""

    def __init__(self, seed: int, policy: str, cause: BaseException,
                 depth: int = 3):
        self.seed = seed
        self.policy = policy
        self.depth = depth
        self.cause = cause
        repro = f"replay(fn, seed={seed}, policy={policy!r}"
        if policy == "pct":
            repro += f", depth={depth}"
        repro += ")"
        super().__init__(
            f"schedule seed={seed} policy={policy} failed: "
            f"{type(cause).__name__}: {cause} — reproduce with "
            f"{repro}")


# -- run/thread state ---------------------------------------------------------

_RUNNABLE, _RUNNING, _BLOCKED, _FINISHED = range(4)


class _TState:
    __slots__ = ("seq", "thread", "gate", "status", "blocked_on",
                 "timed", "wake_reason", "joiners", "priority",
                 "name")

    def __init__(self, seq: int, thread):
        self.seq = seq
        self.thread = thread
        self.name = getattr(thread, "name", f"t{seq}")
        # handed to the thread when it is scheduled; starts held
        self.gate = _thread.allocate_lock()
        self.gate.acquire()
        self.status = _RUNNABLE
        self.blocked_on = ""
        self.timed = False
        self.wake_reason = ""
        self.joiners: List["_TState"] = []
        self.priority = 0.0


class _RandomPolicy:
    name = "random"

    def on_register(self, run: "_Run", ts: _TState) -> None:
        pass

    def pick(self, run: "_Run", cands: List[_TState]) -> _TState:
        return run.rng.choice(cands)


class _PCTPolicy:
    name = "pct"

    def __init__(self, depth: int = 3, horizon: int = 128):
        self.depth = max(1, depth)
        self.horizon = max(2, horizon)
        self.change_points: set = set()
        self._demote = -1.0

    def bind(self, run: "_Run") -> None:
        k = min(self.depth - 1, self.horizon - 1)
        if k > 0:
            self.change_points = set(
                run.rng.sample(range(1, self.horizon), k))

    def on_register(self, run: "_Run", ts: _TState) -> None:
        ts.priority = run.rng.random()

    def pick(self, run: "_Run", cands: List[_TState]) -> _TState:
        if run.step in self.change_points:
            top = max(cands, key=lambda s: (s.priority, -s.seq))
            top.priority = self._demote
            self._demote -= 1.0
        return max(cands, key=lambda s: (s.priority, -s.seq))


class _Run:
    def __init__(self, seed: int, policy, max_steps: int):
        self.mutex = _thread.allocate_lock()
        self.rng = random.Random(seed)
        self.seed = seed
        self.policy = policy
        self.max_steps = max_steps
        self.step = 0
        self.seq = 0
        self.states: List[_TState] = []
        self.failures: List[BaseException] = []
        self.abort: Optional[type] = None   # DeadlockError et al
        self.abort_msg = ""
        # the main thread parks here while late worker threads drain
        self.drain_waiters: List[_TState] = []
        if hasattr(policy, "bind"):
            policy.bind(self)

    # -- registration (run.mutex held or single-threaded) --

    def register(self, thread) -> _TState:
        ts = _TState(self.seq, thread)
        self.seq += 1
        self.states.append(ts)
        self.policy.on_register(self, ts)
        return ts

    # -- core switch machinery --

    def _runnable(self, extra: Optional[_TState] = None
                  ) -> List[_TState]:
        out = [s for s in self.states if s.status == _RUNNABLE]
        if extra is not None:
            out.append(extra)
        return sorted(out, key=lambda s: s.seq)

    def _dispatch(self, ts: _TState) -> None:
        ts.status = _RUNNING
        ts.wake_reason = "go"
        ts.gate.release()

    def _check_abort(self) -> None:
        if self.abort is not None:
            raise self.abort(self.abort_msg)

    def _bump_step(self) -> None:
        self.step += 1
        if self.step > self.max_steps:
            self._trigger_abort(
                ScheduleLimitError,
                f"schedule exceeded {self.max_steps} steps — "
                "spin loop under exploration?")
            raise self.abort(self.abort_msg)

    def _trigger_abort(self, exc_type, msg: str) -> None:
        """mutex held: poison the run and wake every blocked thread so
        each unwinds with the abort instead of hanging."""
        if self.abort is None:
            self.abort = exc_type
            self.abort_msg = msg
        # wake BLOCKED and RUNNABLE threads alike: both are parked on
        # their gate (a never-yet-scheduled thread included) and would
        # otherwise leak as zombies when the run unwinds
        for s in self.states:
            if s.status in (_BLOCKED, _RUNNABLE):
                s.status = _RUNNING
                s.wake_reason = "abort"
                s.gate.release()

    def yield_point(self, ts: _TState) -> None:
        """Non-blocking scheduling point: the policy may preempt."""
        nxt = None
        with self.mutex:
            self._check_abort()
            self._bump_step()
            cands = self._runnable(extra=ts)
            chosen = self.policy.pick(self, cands)
            if chosen is not ts:
                ts.status = _RUNNABLE
                self._dispatch(chosen)
                nxt = chosen
        if nxt is not None:
            ts.gate.acquire()
            if self.abort is not None and ts.wake_reason == "abort":
                raise self.abort(self.abort_msg)

    def block(self, ts: _TState, waiters: Optional[List[_TState]],
              what: str, timed: bool) -> str:
        """Blocking scheduling point; returns the wake reason:
        'go' (resource event) or 'timeout' (virtual time fired)."""
        with self.mutex:
            self._check_abort()
            self._bump_step()
            ts.status = _BLOCKED
            ts.blocked_on = what
            ts.timed = timed
            if waiters is not None:
                waiters.append(ts)
            self._schedule_next()
        ts.gate.acquire()
        if self.abort is not None and ts.wake_reason == "abort":
            raise self.abort(self.abort_msg)
        return ts.wake_reason

    def _schedule_next(self) -> None:
        """mutex held: hand the token onward after the current thread
        blocked or finished."""
        cands = self._runnable()
        if cands:
            self._dispatch(self.policy.pick(self, cands))
            return
        timed = sorted((s for s in self.states
                        if s.status == _BLOCKED and s.timed),
                       key=lambda s: s.seq)
        if timed:
            # virtual time advances only when nothing else can run:
            # the policy-chosen timed waiter sees its timeout fire
            chosen = self.policy.pick(self, timed)
            chosen.timed = False
            chosen.status = _RUNNING
            chosen.wake_reason = "timeout"
            chosen.gate.release()
            return
        blocked = [s for s in self.states if s.status == _BLOCKED]
        if blocked:
            self._trigger_abort(DeadlockError,
                                "all threads blocked: " + "; ".join(
                                    f"{s.name} on {s.blocked_on}"
                                    for s in blocked))
        # else: every thread finished — nothing to do

    def wake(self, waiters: List[_TState]) -> None:
        """mutex held: a resource event makes its waiters runnable
        (they still wait to be SCHEDULED — this is not a dispatch)."""
        for s in waiters:
            if s.status == _BLOCKED:
                s.status = _RUNNABLE
                s.timed = False
        del waiters[:]

    def finish_thread(self, ts: _TState) -> None:
        with self.mutex:
            ts.status = _FINISHED
            self.wake(ts.joiners)
            self.wake(self.drain_waiters)
            self._schedule_next()


# -- arming: factory interposition -------------------------------------------

_armed = False
_RUN: Optional[_Run] = None
_tls = threading.local()

_PREV: dict = {}


def armed() -> bool:
    return _armed


def _state() -> Optional[_TState]:
    return getattr(_tls, "state", None)


def _ctx():
    """(run, tstate) when the CALLING thread is registered with the
    active run; (None, None) otherwise — the delegate-mode check every
    wrapper makes first."""
    run = _RUN
    if run is None:
        return None, None
    st = _state()
    if st is None:
        return None, None
    return run, st


class _SchedLock:
    """Cooperative Lock: logical ownership for registered threads, a
    real lock (built from the pre-arm factory) for everyone else."""

    _reentrant = False

    def __init__(self, real_factory):
        self._real = real_factory()
        self._owner: Optional[_TState] = None
        self._depth = 0
        self._waiters: List[_TState] = []

    def acquire(self, blocking: bool = True, timeout: float = -1):
        run, st = _ctx()
        if st is None:
            if timeout is None or timeout < 0:
                return self._real.acquire(blocking)
            return self._real.acquire(blocking, timeout)
        run.yield_point(st)          # preemption before the CS
        while True:
            with run.mutex:
                if self._owner is None:
                    self._owner = st
                    self._depth = 1
                    return True
                if self._owner is st and self._reentrant:
                    self._depth += 1
                    return True
            if not blocking:
                return False
            r = run.block(st, self._waiters, f"lock {id(self):#x}",
                          timed=timeout is not None and timeout >= 0)
            if r == "timeout":
                return False

    def release(self) -> None:
        run, st = _ctx()
        if st is None:
            self._real.release()
            return
        with run.mutex:
            if self._owner is not st:
                raise RuntimeError("release of unacquired sched lock")
            self._depth -= 1
            if self._depth > 0:
                return
            self._owner = None
            run.wake(self._waiters)
        run.yield_point(st)          # preemption after the CS

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        run, st = _ctx()
        if st is None:
            return self._real.locked()
        # lint: guard-ok(introspection peek; cooperative threads serialize on the run token)
        return self._owner is not None

    def _at_fork_reinit(self) -> None:
        if hasattr(self._real, "_at_fork_reinit"):
            self._real._at_fork_reinit()
        # lint: guard-ok(fork re-init runs single-threaded in the child)
        self._owner = None
        # lint: guard-ok(fork re-init runs single-threaded in the child)
        self._depth = 0
        del self._waiters[:]

    # Condition's private protocol, on BOTH lock flavors (a Condition
    # built over a plain Lock reaches these too — leaving them off the
    # base class made cv.wait() park a registered thread on a raw
    # waiter lock while it still held the scheduling token, hanging
    # the whole run with no DeadlockError). Supported
    # in delegate mode only: a registered thread raises instead.
    def _release_save(self):
        run, st = _ctx()
        if st is not None:
            raise RuntimeError(
                "Condition.wait on a scheduler-wrapped lock inside an "
                "explored run is not supported — restructure the test "
                "around Event/Queue, or leave this seam to the "
                "sanitizer")
        if hasattr(self._real, "_release_save"):
            return self._real._release_save()
        self._real.release()       # plain-Lock default protocol
        return None

    def _acquire_restore(self, state) -> None:
        if hasattr(self._real, "_acquire_restore"):
            self._real._acquire_restore(state)
        else:
            self._real.acquire()

    def _is_owned(self) -> bool:
        run, st = _ctx()
        if st is not None:
            # lint: guard-ok(cooperative ownership peek; only the token-holding thread reaches here)
            return self._owner is st
        if hasattr(self._real, "_is_owned"):
            return self._real._is_owned()
        # plain-Lock default: owned iff a non-blocking acquire fails
        if self._real.acquire(False):
            self._real.release()
            return False
        return True


class _SchedRLock(_SchedLock):
    _reentrant = True


class _SchedEvent:
    """Cooperative Event; delegate mode is a textbook flag+condition
    over pre-arm primitives."""

    def __init__(self):
        self._flag = False
        self._real_cv = _PREV["Condition"](_PREV["Lock"]())
        self._waiters: List[_TState] = []

    def is_set(self) -> bool:
        return self._flag

    isSet = is_set

    def set(self) -> None:
        run, st = _ctx()
        with self._real_cv:
            self._flag = True
            self._real_cv.notify_all()
        if st is not None:
            with run.mutex:
                run.wake(self._waiters)
            run.yield_point(st)

    def clear(self) -> None:
        with self._real_cv:
            self._flag = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        run, st = _ctx()
        if st is None:
            with self._real_cv:
                if not self._flag:
                    self._real_cv.wait(timeout)
                return self._flag
        run.yield_point(st)
        while not self._flag:
            r = run.block(st, self._waiters, "event.wait",
                          timed=timeout is not None)
            if r == "timeout":
                return self._flag
        return True


class _SchedQueue:
    """Cooperative queue.Queue/SimpleQueue stand-in: one deque is the
    single source of truth for both modes."""

    def __init__(self, maxsize: int = 0):
        self.maxsize = maxsize
        self._items: deque = deque()
        self._real_cv = _PREV["Condition"](_PREV["Lock"]())
        self._getters: List[_TState] = []
        self._putters: List[_TState] = []
        self._joiners: List[_TState] = []
        self._unfinished = 0

    def _full(self) -> bool:
        # lint: guard-ok(len peek is GIL-atomic; put/get re-check under their mode's lock)
        return 0 < self.maxsize <= len(self._items)

    def qsize(self) -> int:
        # lint: guard-ok(introspection; len peek is GIL-atomic and may be stale)
        return len(self._items)

    def empty(self) -> bool:
        # lint: guard-ok(introspection; truthiness peek is GIL-atomic and may be stale)
        return not self._items

    def full(self) -> bool:
        return self._full()

    def _wait_real(self, endtime: Optional[float]) -> bool:
        """One delegate-mode condition wait against a DEADLINE, not a
        restarted timeout — a wakeup that loses the race to a sibling
        must not reset the clock (queue.Queue semantics)."""
        if endtime is None:
            self._real_cv.wait()
            return True
        remaining = endtime - _time_mod.monotonic()
        if remaining <= 0:
            return False
        return self._real_cv.wait(remaining)

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        run, st = _ctx()
        if st is None:
            endtime = None if timeout is None \
                else _time_mod.monotonic() + timeout
            with self._real_cv:
                while self._full():
                    if not block or not self._wait_real(endtime):
                        raise _queue_mod.Full
                self._items.append(item)
                self._unfinished += 1
                self._real_cv.notify_all()
            return
        run.yield_point(st)
        while True:
            with run.mutex:
                if not self._full():
                    self._items.append(item)
                    self._unfinished += 1
                    run.wake(self._getters)
                    break
            if not block:
                raise _queue_mod.Full
            r = run.block(st, self._putters, "queue.put",
                          timed=timeout is not None)
            if r == "timeout":
                raise _queue_mod.Full
        with self._real_cv:
            self._real_cv.notify_all()

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True,
            timeout: Optional[float] = None):
        run, st = _ctx()
        if st is None:
            endtime = None if timeout is None \
                else _time_mod.monotonic() + timeout
            with self._real_cv:
                while not self._items:
                    if not block or not self._wait_real(endtime):
                        raise _queue_mod.Empty
                item = self._items.popleft()
                self._real_cv.notify_all()
                return item
        run.yield_point(st)
        while True:
            with run.mutex:
                if self._items:
                    item = self._items.popleft()
                    run.wake(self._putters)
                    return item
            if not block:
                raise _queue_mod.Empty
            r = run.block(st, self._getters, "queue.get",
                          timed=timeout is not None)
            if r == "timeout":
                raise _queue_mod.Empty

    def get_nowait(self):
        return self.get(block=False)

    def task_done(self) -> None:
        run, st = _ctx()
        with self._real_cv:
            # lint: guard-ok(count mutates under _real_cv in delegate mode and under the run token cooperatively)
            self._unfinished = max(0, self._unfinished - 1)
            # lint: guard-ok(read under _real_cv; cooperative mutators hold the run token besides)
            done = self._unfinished == 0
            if done:
                self._real_cv.notify_all()
        if st is not None and done:
            with run.mutex:
                run.wake(self._joiners)
            run.yield_point(st)

    def join(self) -> None:
        """Block until every put() has a matching task_done() —
        queue.Queue semantics in both modes (cooperative block under a
        run, condition wait in delegate mode)."""
        run, st = _ctx()
        if st is None:
            with self._real_cv:
                # lint: guard-ok(read under _real_cv, the delegate-mode count lock)
                while self._unfinished:
                    self._real_cv.wait()
            return
        run.yield_point(st)
        # lint: guard-ok(cooperative re-check; task_done wakes _joiners when the count hits zero)
        while self._unfinished:
            run.block(st, self._joiners, "queue.join", timed=False)


def _make_sched_thread(orig_thread_cls):
    class _SchedThread(orig_thread_cls):
        _sched_ts: Optional[_TState] = None

        def start(self) -> None:
            run, st = _ctx()
            if st is None:
                super().start()
                return
            with run.mutex:
                self._sched_ts = run.register(self)
            # the _started handshake inside Thread.start() is an Event
            # set by the NEW OS thread before it reaches our gate —
            # run it in delegate mode (real event) or the cooperative
            # wait would park this thread where only real signaling
            # exists. No user code runs in that window, so schedule
            # determinism is unaffected.
            _tls.state = None
            try:
                super().start()
            finally:
                _tls.state = st
            run.yield_point(st)   # the new thread is now schedulable

        def run(self) -> None:
            ts = self._sched_ts
            if ts is None:
                super().run()
                return
            run = _RUN
            _tls.state = ts
            ts.gate.acquire()     # wait to be scheduled the first time
            try:
                if ts.wake_reason == "abort" and run is not None \
                        and run.abort is not None:
                    raise _Aborted
                super().run()
            except _Aborted:
                pass
            except BaseException as e:  # noqa: BLE001 - recorded, surfaces as the schedule's failure
                if run is not None and not isinstance(
                        e, (DeadlockError, ScheduleLimitError)):
                    run.failures.append(e)
            finally:
                _tls.state = None
                if run is not None:
                    run.finish_thread(ts)

        def join(self, timeout: Optional[float] = None) -> None:
            run, st = _ctx()
            ts = self._sched_ts
            if st is None or ts is None:
                super().join(timeout)
                return
            run.yield_point(st)
            while ts.status != _FINISHED:
                r = run.block(st, ts.joiners, f"join {self.name}",
                              timed=timeout is not None)
                if r == "timeout":
                    return
            super().join()        # the OS thread is already exiting

    return _SchedThread


def _sched_sleep(seconds: float) -> None:
    run, st = _ctx()
    if st is None:
        _PREV["sleep"](seconds)
        return
    # virtual time: a sleep is a scheduling point, never a real wait
    run.yield_point(st)


def arm() -> None:
    """Swap the factories for cooperative wrappers (delegate mode
    until a run starts). explore() calls this on entry; SEAWEED_SCHED=1
    does it at import."""
    global _armed
    if _armed:
        return
    _PREV.update(
        Lock=threading.Lock, RLock=threading.RLock,
        Event=threading.Event, Thread=threading.Thread,
        Condition=threading.Condition,
        Queue=_queue_mod.Queue, SimpleQueue=_queue_mod.SimpleQueue,
        sleep=_time_mod.sleep)
    _armed = True
    prev_lock, prev_rlock = _PREV["Lock"], _PREV["RLock"]
    threading.Lock = lambda: _SchedLock(prev_lock)
    threading.RLock = lambda: _SchedRLock(prev_rlock)
    threading.Event = _SchedEvent
    threading.Thread = _make_sched_thread(_PREV["Thread"])
    _queue_mod.Queue = _SchedQueue
    _queue_mod.SimpleQueue = _SchedQueue
    _time_mod.sleep = _sched_sleep


def disarm() -> None:
    """Restore the pre-arm factories. Wrapper objects created while
    armed keep working (they delegate once no run is active)."""
    global _armed
    if not _armed:
        return
    _armed = False
    threading.Lock = _PREV["Lock"]
    threading.RLock = _PREV["RLock"]
    threading.Event = _PREV["Event"]
    threading.Thread = _PREV["Thread"]
    _queue_mod.Queue = _PREV["Queue"]
    _queue_mod.SimpleQueue = _PREV["SimpleQueue"]
    _time_mod.sleep = _PREV["sleep"]


# -- the public exploration API ----------------------------------------------


class ExploreResult:
    def __init__(self, schedules: int, policy: str):
        self.schedules = schedules
        self.policy = policy
        self.failures: List[ScheduleFailure] = []

    @property
    def ok(self) -> bool:
        return not self.failures

    def __repr__(self) -> str:
        return (f"<ExploreResult {self.policy} "
                f"{self.schedules - len(self.failures)}/"
                f"{self.schedules} ok>")


def _policy_for(policy: str, depth: int):
    if policy == "random":
        return _RandomPolicy()
    if policy == "pct":
        return _PCTPolicy(depth=depth)
    raise ValueError(f"unknown schedule policy {policy!r}")


def _run_one(fn: Callable[[], None], seed: int, policy: str,
             depth: int, max_steps: int) -> Optional[BaseException]:
    """One schedule: returns the failure (or None). Must be called
    armed; arms the run for the duration of fn()."""
    global _RUN
    if _RUN is not None:
        raise RuntimeError("explore() does not nest")
    run = _Run(seed, _policy_for(policy, depth), max_steps)
    st = run.register(threading.current_thread())
    st.status = _RUNNING
    _tls.state = st
    _RUN = run
    failure: Optional[BaseException] = None
    try:
        fn()
        # drain: let every spawned thread run to completion so the
        # next schedule starts clean
        while True:
            with run.mutex:
                alive = [s for s in run.states
                         if s is not st and s.status != _FINISHED]
                if not alive:
                    break
            run.block(st, run.drain_waiters, "drain", timed=False)
    except (DeadlockError, ScheduleLimitError, _Aborted) as e:
        failure = e if not isinstance(e, _Aborted) else None
        _drain_abort(run, st)
    except BaseException as e:  # noqa: BLE001 - the schedule's verdict, re-raised by the caller
        failure = e
        _drain_abort(run, st)
    finally:
        _tls.state = None
        _RUN = None
    if failure is None and run.failures:
        failure = run.failures[0]
    if failure is None and run.abort is not None:
        failure = run.abort(run.abort_msg)
    return failure


def _drain_abort(run: _Run, st: _TState) -> None:
    """The main thread is unwinding: poison the run so blocked workers
    raise instead of hanging, then wait for the OS threads to exit."""
    with run.mutex:
        run._trigger_abort(
            run.abort or _Aborted,
            run.abort_msg or "schedule unwound by a main-thread "
            "failure")
    for s in run.states:
        if s is not st:
            try:
                # real join (bypassing the cooperative override):
                # every worker either finished or is unwinding on the
                # abort it was just woken with
                _PREV["Thread"].join.__get__(s.thread)(5.0)
            except RuntimeError:
                pass   # never started


def explore(fn: Callable[[], None], schedules: Optional[int] = None,
            seed: Optional[int] = None, policy: str = "random",
            depth: int = 3, max_steps: Optional[int] = None,
            check: bool = True) -> ExploreResult:
    """Run `fn` under `schedules` deterministic interleavings (seeds
    seed, seed+1, ...). With check=True (default) the first failing
    schedule raises ScheduleFailure carrying its seed; check=False
    returns the full ExploreResult instead."""
    schedules = int(os.environ.get("SEAWEED_SCHED_SCHEDULES", "20")) \
        if schedules is None else schedules
    seed = int(os.environ.get("SEAWEED_SCHED_SEED", "0")) \
        if seed is None else seed
    max_steps = int(os.environ.get("SEAWEED_SCHED_MAX_STEPS", "20000")) \
        if max_steps is None else max_steps
    result = ExploreResult(schedules, policy)
    was_armed = _armed
    arm()
    try:
        for i in range(schedules):
            failure = _run_one(fn, seed + i, policy, depth, max_steps)
            if failure is not None:
                sf = ScheduleFailure(seed + i, policy, failure,
                                     depth=depth)
                result.failures.append(sf)
                if check:
                    raise sf from failure
    finally:
        if not was_armed:
            disarm()
    return result


def replay(fn: Callable[[], None], seed: int, policy: str = "random",
           depth: int = 3, max_steps: Optional[int] = None) -> None:
    """Deterministically re-run the single schedule `seed` — the
    repro command ScheduleFailure prints. Raises the failure."""
    explore(fn, schedules=1, seed=seed, policy=policy, depth=depth,
            max_steps=max_steps, check=True)


if os.environ.get("SEAWEED_SCHED"):
    arm()
