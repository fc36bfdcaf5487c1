"""The port's runtime concurrency sanitizer (``util/sanitizer.py``) against
the JAX package's.

The eleven cases of ``tests/test_sanitizer.py`` run against the port's
module: lock-order cycles caught with both stacks, reported once, a
consistent order clean, the hold watchdog, Condition waits on both lock
types, RLock reentrancy, the stdlib's machinery working over wrapped
locks, the JSON-lines out file and the publish path outside the graph
lock. The same scenarios under each package's sanitizer give findings of
the same shape, and the port's ``SeaweedFS_sanitizer_findings_total``
counts each kind. A garbage-collected lock takes its reported cycle
pairs with it, so a new lock at a recycled id reports its own cycle (the
JAX module keeps the pairs).

A test process imports both packages, so one ``SEAWEED_SANITIZE`` arms
both sanitizers. Two subprocesses, one for each import order, show that
a cycle among locks made after both armed is reported by the port's, and
that after disarming the interpreter's own lock factories are back.

Each case disarms and resets in ``finally``, so no later test in the same
worker inherits wrappers.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from seaweedfs_tpu.util import sanitizer as jax_sanitizer
from seaweedfs_tpu_torch.stats.metrics import SanitizerFindingsCounter
from seaweedfs_tpu_torch.util import sanitizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arm(mod):
    mod.reset()
    mod.arm()
    mod.configure(hold_ms=100)


def _disarm(mod):
    mod.disarm()
    mod.reset()
    mod.configure(hold_ms=200)


@pytest.fixture
def _armed():
    _arm(sanitizer)
    try:
        yield
    finally:
        _disarm(sanitizer)


def _ab_ba(a, b):
    """Run the classic AB/BA interleaving (sequentially — the
    sanitizer catches the ORDER inversion without losing the race)."""
    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    for fn in (t1, t2):
        th = threading.Thread(target=fn)
        th.start()
        th.join()


def test_ab_ba_cycle_reported_with_both_stacks(_armed):
    a, b = threading.Lock(), threading.Lock()
    _ab_ba(a, b)
    cyc = sanitizer.cycles()
    assert len(cyc) == 1, cyc
    f = cyc[0]
    assert len(f["locks"]) == 2
    # both acquisition stacks: the A->B edge (taken in t1) and the
    # B->A edge (taken in t2), each carrying its full traceback
    assert len(f["stacks"]) == 2
    joined = "".join(e["stack"] for e in f["stacks"])
    assert "in t1" in joined and "in t2" in joined


def test_cycle_reported_once_not_per_acquisition(_armed):
    a, b = threading.Lock(), threading.Lock()
    for _ in range(3):
        _ab_ba(a, b)
    assert len(sanitizer.cycles()) == 1


def test_consistent_order_is_not_a_cycle(_armed):
    a, b = threading.Lock(), threading.Lock()

    def t():
        with a:
            with b:
                pass

    for _ in range(2):
        th = threading.Thread(target=t)
        th.start()
        th.join()
    assert not sanitizer.findings()


def test_hold_watchdog_fires_on_sleep_under_lock(_armed):
    lk = threading.Lock()
    with lk:
        time.sleep(0.15)
    holds = [f for f in sanitizer.findings() if f["kind"] == "hold"]
    assert len(holds) == 1
    assert holds[0]["held_s"] >= 0.1
    assert "test_torch_sanitizer" in holds[0]["stack"]


def test_condition_wait_releases_the_lock_no_false_hold(_armed):
    cv = threading.Condition(threading.Lock())

    def waker():
        time.sleep(0.15)
        with cv:
            cv.notify_all()

    th = threading.Thread(target=waker)
    th.start()
    with cv:
        # waits > hold threshold, but wait() RELEASES the lock — the
        # watchdog must see two short holds, not one long one
        cv.wait(timeout=2.0)
    th.join()
    assert not sanitizer.findings(), sanitizer.findings()


def test_rlock_reentrancy_is_not_an_edge(_armed):
    r = threading.RLock()
    with r:
        with r:
            pass
    assert not sanitizer.findings()


def test_sanitized_locks_keep_stdlib_machinery_working(_armed):
    import queue
    q = queue.Queue()
    q.put("x")
    assert q.get(timeout=1.0) == "x"
    ev = threading.Event()
    ev.set()
    assert ev.wait(0.5)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        assert pool.submit(lambda: 7).result(timeout=5) == 7


def test_out_file_receives_json_lines(_armed, tmp_path):
    out = tmp_path / "san.jsonl"
    sanitizer.configure(out_path=str(out))
    try:
        a, b = threading.Lock(), threading.Lock()
        _ab_ba(a, b)
    finally:
        sanitizer.configure(out_path="")
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert any(rec["kind"] == "cycle" for rec in lines)


def test_three_lock_cycle_detected(_armed):
    a, b, c = (threading.Lock(), threading.Lock(), threading.Lock())
    order = [(a, b), (b, c), (c, a)]

    def take(first, second):
        with first:
            with second:
                pass

    for pair in order:
        th = threading.Thread(target=take, args=pair)
        th.start()
        th.join()
    cyc = sanitizer.cycles()
    assert len(cyc) == 1
    assert len(cyc[0]["locks"]) == 3
    assert len(cyc[0]["stacks"]) == 3


def test_condition_wait_on_reentrant_rlock_keeps_depth(_armed):
    """Condition.wait releases an RLock to full depth and restores it;
    the wrapper's recursion depth must survive the round trip so the
    first post-wait release is NOT treated as final."""
    r = threading.RLock()
    cv = threading.Condition(r)
    probe = threading.Lock()

    def waker():
        time.sleep(0.05)
        with cv:
            cv.notify_all()

    th = threading.Thread(target=waker)
    th.start()
    with r:                      # depth 1
        with r:                  # depth 2
            cv.wait(timeout=2.0)
            # back at depth 2 here; inner release must NOT unlist r
        # still held at depth 1: acquiring another lock must record
        # the edge r -> probe
        with probe:
            pass
    th.join()
    assert (id(r), id(probe)) in sanitizer._edges, \
        "edge from reentrantly-held RLock after cv.wait was dropped"


def test_publish_path_never_holds_graph_lock(_armed, tmp_path):
    """A cycle finding's metrics bump creates metric child locks; if it
    ran under _graph_lock that would be the sanitizer deadlocking on
    its own ledger. The publish completes, and no edge leaves the graph
    lock (it is a plain lock, never a node)."""
    sanitizer.configure(out_path=str(tmp_path / "out.jsonl"))
    try:
        a, b = threading.Lock(), threading.Lock()
        _ab_ba(a, b)
        assert sanitizer.cycles()
        assert not any(edge[0] == id(sanitizer._graph_lock)
                       for edge in sanitizer._edges)
    finally:
        sanitizer.configure(out_path="")


def _cycles_over_a_recycled_pair():
    """(cycles of a first AB/BA pair, whether its pair is still listed
    as reported once both locks are gone, cycles of a second pair, and
    whether the second pair took the first one's ids)."""
    mod = sanitizer if threading.Lock.__module__ == sanitizer.__name__ \
        else jax_sanitizer
    a, b = threading.Lock(), threading.Lock()
    _ab_ba(a, b)
    first = len(mod.cycles())
    ids = {id(a), id(b)}
    del a, b
    gc.collect()
    kept = bool(mod._reported_cycles)
    a, b = threading.Lock(), threading.Lock()
    recycled = {id(a), id(b)} == ids
    _ab_ba(a, b)
    return first, kept, len(mod.cycles()) - first, recycled


def test_a_recycled_lock_id_reports_its_own_cycle():
    """A lock that is garbage-collected takes its reported cycle pairs
    with it, as it takes its edges: a new lock at the same id (CPython
    reuses the memory at once) reports its own cycle. The JAX module
    keeps the pair, so there a cycle of the new pair goes unreported."""
    got = {}
    for name, mod in (("jax", jax_sanitizer), ("port", sanitizer)):
        _arm(mod)
        try:
            got[name] = _cycles_over_a_recycled_pair()
        finally:
            _disarm(mod)
    assert got["port"][:3] == (1, False, 1)
    assert got["jax"][:2] == (1, True)
    if got["jax"][3]:
        assert got["jax"][2] == 0


# -- against the JAX sanitizer, and the counter ----------------------------------


def _scenarios():
    """AB/BA, a three-lock cycle and one long hold, under whichever
    sanitizer is armed (the locks are made after arming)."""
    a, b, c = threading.Lock(), threading.Lock(), threading.Lock()
    _ab_ba(a, b)
    for first, second in ((a, b), (b, c), (c, a)):
        th = threading.Thread(target=_ab_ba, args=(first, second))
        th.start()
        th.join()
    with c:
        time.sleep(0.15)


def test_findings_have_the_jax_shape_on_the_same_scenarios():
    shapes = {}
    for name, mod in (("jax", jax_sanitizer), ("port", sanitizer)):
        _arm(mod)
        try:
            _scenarios()
            shapes[name] = sorted(
                (f["kind"], len(f.get("locks", ())),
                 len(f.get("stacks", ()))) for f in mod.findings())
        finally:
            _disarm(mod)
    assert shapes["port"] == shapes["jax"]
    assert ("cycle", 2, 2) in shapes["port"]
    assert ("hold", 0, 0) in shapes["port"]


def test_findings_counter_counts_each_kind(_armed):
    before = {k: SanitizerFindingsCounter.labels(k).value
              for k in ("cycle", "hold")}
    a, b = threading.Lock(), threading.Lock()
    _ab_ba(a, b)
    with a:
        time.sleep(0.15)
    kinds = [f["kind"] for f in sanitizer.findings()]
    assert sorted(kinds) == ["cycle", "hold"]
    for k in ("cycle", "hold"):
        assert SanitizerFindingsCounter.labels(k).value == before[k] + 1
    assert SanitizerFindingsCounter.name == \
        "SeaweedFS_sanitizer_findings_total"


# -- both packages armed in one process ------------------------------------------

_BOTH_ARMED = r"""
import json, sys, threading
stock = (threading.Lock, threading.RLock)
first = sys.argv[1]
for pkg in (("seaweedfs_tpu_torch", "seaweedfs_tpu") if first == "port"
            else ("seaweedfs_tpu", "seaweedfs_tpu_torch")):
    __import__(pkg)
from seaweedfs_tpu.util import sanitizer as jax_san
from seaweedfs_tpu_torch.util import sanitizer as port_san
assert jax_san.armed() and port_san.armed()
assert (port_san._ORIG_LOCK, port_san._ORIG_RLOCK) == stock
assert threading.Lock is not stock[0]


def ab_ba(a, b):
    for x, y in ((a, b), (b, a)):
        def take():
            with x:
                with y:
                    pass
        th = threading.Thread(target=take)
        th.start()
        th.join()


ab_ba(threading.Lock(), threading.Lock())
ab_ba(threading.RLock(), threading.RLock())
out = {"port": len(port_san.cycles()), "jax": len(jax_san.cycles())}
restored = []
for order in (["jax", "port"], ["port", "jax"]):
    for name in order:
        {"jax": jax_san, "port": port_san}[name].arm()
    for name in order:
        {"jax": jax_san, "port": port_san}[name].disarm()
    restored.append((threading.Lock, threading.RLock) == stock)
out["restored"] = restored
print(json.dumps(out))
"""


@pytest.mark.parametrize("first", ["port", "jax"])
def test_both_sanitizers_armed_in_one_process(first):
    """``SEAWEED_SANITIZE=1`` and both packages imported, in either order.
    The port's sanitizer keeps the interpreter's own factories as its
    originals, reports the AB/BA cycles of locks made after both armed
    (the JAX one also sees them when it armed last, on top of the
    port's wrappers), and after ``disarm()`` the stock factories are
    back. Disarming JAX's first puts them back in both import orders;
    disarming the port's first does so where JAX was imported first.
    Where the port was imported first, the JAX module puts back the
    port's wrapper it found at import: that is the JAX module's rule,
    and the JAX package stays as it is."""
    env = dict(os.environ, SEAWEED_SANITIZE="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _BOTH_ARMED, first],
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["port"] == 2
    assert got["jax"] == (2 if first == "port" else 0)
    # disarm JAX's, then the port's: stock in both orders; the port's
    # first: stock where JAX's armed first
    assert got["restored"] == [True, first == "jax"]
