"""Runtime concurrency sanitizer — the `go test -race` stand-in.

The counterpart of ``seaweedfs_tpu.util.sanitizer``. The static
analyzer (`seaweedfs_tpu_torch/analysis/`) catches what syntax
can prove; this module catches what only execution reveals. Armed, it
replaces the `threading.Lock` / `threading.RLock` factories with
wrappers that feed two detectors:

  lock-order graph   every time a thread acquires lock B while
                     holding lock A, the edge A->B is recorded (with
                     the full acquisition stack the first time the
                     edge appears). If adding an edge closes a cycle
                     — some other thread acquired them in the
                     opposite order — a `cycle` finding is emitted
                     carrying BOTH acquisition stacks: a potential
                     deadlock caught without having to lose the race.

  hold-time watchdog a lock held longer than SEAWEED_SANITIZE_HOLD_MS
                     (default 200) produces a `hold` finding with the
                     release-side stack — the runtime complement of
                     the analyzer's blocking-under-lock check, and
                     the one that sees through helper-function
                     indirection.

Zero-cost-disabled contract (the house rule): unarmed, this module is
an env read at import — `threading.Lock` stays the untouched C
factory, no wrapper, no graph, nothing (gated by
tests/test_torch_perf_gates.py). Armed via `SEAWEED_SANITIZE=1` in
the environment (before the process imports `seaweedfs_tpu_torch`, so
module-level locks are wrapped too) or by calling `arm()` at runtime
(tests; locks created before that stay plain).

Findings surface three ways: the `findings()` API, an optional
`SEAWEED_SANITIZE_OUT` file findings append to as JSON lines
(subprocess harvest for the bench and chaos harnesses), and the
`SeaweedFS_sanitizer_findings_total{kind}` counter. The port's chaos
and cluster E2E suites run armed (tests/test_torch_chaos.py,
tests/test_torch_cluster.py) and assert no cycle was ever observed —
every 32-way scenario doubles as a race hunt.

Two sanitizers in one process. A process that imports this package
and the JAX package has two of these modules, and one
`SEAWEED_SANITIZE` arms both. Each wraps whatever factory it finds
when it arms, so the original this module keeps is the interpreter's
own, found under any wrapper installed before this module was
imported (`_stock`): `disarm()` puts the stock factories back
whichever sanitizer armed first. The JAX module keeps what it found,
so disarm that one first when this one armed first.

Instance-keyed on purpose: two locks created at the same source line
are distinct graph nodes, so a per-object lock correctly nested under
another instance of its own class never false-positives; the report
names each lock by its creation site.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback
from typing import Dict, List, Optional, Set, Tuple



def _stock(name: str):
    """The interpreter's own `threading.<name>` factory. A sanitizer
    armed before this module was imported (the JAX package's, or a
    second copy of this one) has replaced it with a wrapper whose
    module keeps the factory it replaced as `_ORIG_<NAME>`: follow
    those back to the factory `threading` or `_thread` defined. Any
    other wrapper is kept as it is, as the JAX module keeps whatever
    it finds."""
    fn = getattr(threading, name)
    while getattr(fn, "__module__", None) not in ("threading", "_thread"):
        inner = getattr(fn, "__globals__", {}).get(f"_ORIG_{name.upper()}")
        if inner is None or inner is fn:
            break
        fn = inner
    return fn


_ORIG_LOCK = _stock("Lock")
_ORIG_RLOCK = _stock("RLock")

_armed = False
_hold_threshold_s = float(os.environ.get("SEAWEED_SANITIZE_HOLD_MS",
                                         "200") or 200) / 1000.0
_out_path = os.environ.get("SEAWEED_SANITIZE_OUT", "")

# all sanitizer bookkeeping hides behind this one plain RLock; user
# code never holds it, so it cannot participate in user deadlocks.
# Reentrant because a GC pass triggered while we hold it can run a
# lock's __del__, which needs it too
_graph_lock = _ORIG_RLOCK()
_edges: Dict[Tuple[int, int], str] = {}     # (a,b) -> acquisition stack
_adj: Dict[int, Set[int]] = {}              # a -> {b}
_radj: Dict[int, Set[int]] = {}             # b -> {a} (for O(degree) GC)
_names: Dict[int, str] = {}                 # lock id -> creation site
_findings: List[dict] = []
_reported_cycles: Set[Tuple[int, int]] = set()

_tls = threading.local()


def armed() -> bool:
    return _armed


def findings() -> List[dict]:
    with _graph_lock:
        return list(_findings)


def cycles() -> List[dict]:
    return [f for f in findings() if f["kind"] == "cycle"]


def reset() -> None:
    """Drop graph + findings (tests); wrappers stay armed."""
    with _graph_lock:
        _edges.clear()
        _adj.clear()
        _radj.clear()
        _findings.clear()
        _reported_cycles.clear()


def _publish(finding: dict) -> None:
    """File append + metrics bump for one finding. MUST be called
    WITHOUT _graph_lock held: the metric family lock is taken inside
    labels(), and a concurrent labels() call creating a child lock
    takes _graph_lock — holding _graph_lock here would be the exact
    lock-order inversion this module exists to catch (and would
    deadlock the sanitizer against its own ledger)."""
    if _out_path:
        try:
            with open(_out_path, "a") as f:
                f.write(json.dumps(finding) + "\n")
        except OSError:
            pass
    # metrics import deferred: the sanitizer must be importable before
    # (and without) the stats stack
    try:
        from seaweedfs_tpu_torch.stats.metrics import \
            SanitizerFindingsCounter
        SanitizerFindingsCounter.labels(finding["kind"]).inc()
    except Exception:  # lint: swallow-ok(sanitizer must never take a process down)
        pass


def _held() -> List["_SanLockBase"]:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _site(skip: int = 2) -> str:
    """filename:lineno of the code that created the lock — skipping
    threading.py internals so a bare Condition()'s default RLock is
    named after the Condition's creator, not threading.py:238."""
    f = traceback.extract_stack(limit=skip + 8)
    for fr in reversed(f[:-skip] or f):
        if fr.filename != _THIS_FILE and \
                not fr.filename.endswith(("threading.py", "queue.py")):
            return f"{fr.filename}:{fr.lineno}"
    return "<unknown>"


_THIS_FILE = __file__


def _stack() -> str:
    frames = traceback.extract_stack()
    keep = [fr for fr in frames if fr.filename != _THIS_FILE]
    return "".join(traceback.format_list(keep[-12:]))


class _SanLockBase:
    """Shared acquire/release bookkeeping around an inner lock."""

    __slots__ = ("_inner", "_site", "_acquired_at", "_depth")

    def __init__(self, inner, site: str):
        self._inner = inner
        self._site = site
        self._acquired_at = 0.0
        self._depth = 0
        with _graph_lock:
            _names[id(self)] = site

    # -- the two detectors ---------------------------------------------------

    def _on_acquired(self) -> None:
        held = _held()
        # the held list is maintained UNCONDITIONALLY — a release that
        # lands in a disarm window must still unlist the lock, or
        # re-arming would record edges from locks the thread no longer
        # holds and fabricate phantom cycles
        if any(h is self for h in held):      # reentrant RLock acquire
            self._depth += 1
            return
        self._depth = 1
        self._acquired_at = time.monotonic()
        held.append(self)
        if not _armed or len(held) == 1:
            return
        me = id(self)
        stack = None
        new_findings = []
        with _graph_lock:
            for h in held[:-1]:
                edge = (id(h), me)
                if edge not in _edges:
                    if stack is None:
                        stack = _stack()
                    _edges[edge] = stack
                    _adj.setdefault(id(h), set()).add(me)
                    _radj.setdefault(me, set()).add(id(h))
                    f = self._cycle_check(id(h), me)
                    if f is not None:
                        _findings.append(f)
                        new_findings.append(f)
        for f in new_findings:   # file I/O + metrics OUTSIDE the lock
            _publish(f)

    def _cycle_check(self, frm: int, to: int) -> Optional[dict]:  # requires(_graph_lock)
        # caller holds _graph_lock: is there now a path to -> ... -> frm?
        # (we just added frm -> to; a path back closes the cycle).
        # Returns the finding — the caller records it under the lock
        # and publishes it after release
        pair = (min(frm, to), max(frm, to))
        if pair in _reported_cycles:
            return None
        path = self._find_path(to, frm)   # [to, ..., frm]
        if path is None:
            return None
        _reported_cycles.add(pair)
        nodes = [frm] + path[:-1]         # the cycle, each node once
        return {
            "kind": "cycle",
            "locks": [_names.get(x, "?") for x in nodes],
            # one entry per edge of the cycle, each carrying the full
            # stack of the acquisition that first created that edge —
            # for the classic AB/BA case: both sides' stacks
            "stacks": [
                {"edge": f"{_names.get(a, '?')} -> {_names.get(b, '?')}",
                 "stack": _edges.get((a, b), "?")}
                for a, b in zip(nodes, nodes[1:] + nodes[:1])
                if (a, b) in _edges
            ],
        }

    @staticmethod
    def _find_path(frm: int, to: int) -> Optional[List[int]]:  # requires(_graph_lock)
        # iterative DFS over _adj; returns the node list frm..to
        seen = {frm}
        stack = [(frm, [frm])]
        while stack:
            node, path = stack.pop()
            if node == to:
                return path
            for nxt in _adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _on_release(self) -> None:
        held = _held()
        if not any(h is self for h in held):
            return
        if self._depth > 1:                    # reentrant release
            self._depth -= 1
            return
        self._depth = 0
        try:
            held.remove(self)   # unconditional — see _on_acquired
        except ValueError:
            pass
        if not _armed:
            return
        dur = time.monotonic() - self._acquired_at
        if dur >= _hold_threshold_s:
            finding = {"kind": "hold", "lock": self._site,
                       "held_s": round(dur, 4),
                       "stack": _stack()}
            with _graph_lock:
                _findings.append(finding)
            _publish(finding)   # file I/O + metrics outside the lock

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._on_acquired()
        return got

    def release(self) -> None:
        self._on_release()
        self._inner.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        # stdlib (threading, concurrent.futures) re-initializes module
        # locks in the child after fork
        self._inner._at_fork_reinit()
        self._depth = 0
        self._acquired_at = 0.0

    def __del__(self) -> None:
        # drop this lock's graph node so a recycled id() can never
        # alias onto stale edges (which could fabricate a cycle).
        # O(degree of this node), NOT O(graph) — a server churns locks
        # by the hundred-thousand (every Event/Queue/Future), and a
        # whole-graph scan per GC'd lock goes quadratic
        try:
            me = id(self)
            with _graph_lock:
                _names.pop(me, None)
                for b in _adj.pop(me, ()):
                    _edges.pop((me, b), None)
                    peers = _radj.get(b)
                    if peers is not None:
                        peers.discard(me)
                for a in _radj.pop(me, ()):
                    _edges.pop((a, me), None)
                    peers = _adj.get(a)
                    if peers is not None:
                        peers.discard(me)
                # and its reported pairs: a new lock at the recycled id
                # would otherwise never report a cycle of its own (the
                # JAX module keeps them)
                if _reported_cycles:
                    _reported_cycles.difference_update(
                        [p for p in _reported_cycles if me in p])
        except Exception:  # lint: swallow-ok(interpreter-shutdown teardown must never raise)
            pass

    def __repr__(self) -> str:
        return f"<sanitized {self._inner!r} @ {self._site}>"


class _SanLock(_SanLockBase):
    __slots__ = ()


class _SanRLock(_SanLockBase):
    """RLock wrapper: also speaks Condition's private protocol so a
    Condition built over a sanitized RLock keeps full-depth
    release/reacquire semantics."""

    __slots__ = ()

    def _release_save(self):
        # carry the wrapper's recursion depth through Condition.wait's
        # opaque state: restoring to depth 1 regardless would make the
        # first post-wait release look final while the inner RLock is
        # still held, silently dropping edge tracking
        saved_depth = self._depth
        self._depth = 0
        self._on_release()
        return (self._inner._release_save(), saved_depth)

    def _acquire_restore(self, state) -> None:
        inner_state, saved_depth = state
        self._inner._acquire_restore(inner_state)
        self._on_acquired()
        self._depth = max(saved_depth, 1)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


def _make_lock():
    return _SanLock(_ORIG_LOCK(), _site())


def _make_rlock():
    return _SanRLock(_ORIG_RLOCK(), _site())


def arm() -> None:
    """Patch the threading factories. Locks created BEFORE arming stay
    plain (arm before importing the package — e.g. via the env var —
    to cover module-level locks)."""
    global _armed
    if _armed:
        return
    _armed = True
    threading.Lock = _make_lock
    threading.RLock = _make_rlock


def disarm() -> None:
    """Restore the stock factories. Wrapper locks created while armed
    keep working (their recording is gated on the module flag)."""
    global _armed
    if not _armed:
        return
    _armed = False
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK


def configure(hold_ms: Optional[float] = None,
              out_path: Optional[str] = None) -> None:
    global _hold_threshold_s, _out_path
    if hold_ms is not None:
        _hold_threshold_s = float(hold_ms) / 1000.0
    if out_path is not None:
        _out_path = out_path


if os.environ.get("SEAWEED_SANITIZE"):
    arm()
