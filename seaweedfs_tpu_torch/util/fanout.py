"""A bounded worker pool that costs nothing until its first task.

The counterpart of ``seaweedfs_tpu.util.fanout`` (the JAX package's
substitute for the reference's goroutine fan-outs). In the port the hedger
(``resilience/hedge.py``) runs its candidate fetches on one, the volume
server its replica POSTs (``-replicate.parallel``) and the client its
delete fan-out. With ``-qos`` on, a pool's backlog is ordered by the QoS
manager's weighted-fair queue (``qos/fair.py``) instead of FIFO.

Constructing a FanOutPool makes a queue and a lock, no thread. Workers are
made one per submit up to the cap on the first tasks and then stay
(daemon threads), so a server whose reads never hedge, or whose writes
never fan out to a replica, never grows one.
"""

from __future__ import annotations

import contextvars
import queue
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

# Weighted-fair scheduling seam: qos.configure() installs its manager
# here (reset() clears it). None, the default, keeps submit() one
# identity check away from the plain FIFO path.
_qos_sched = None

# queue token standing in for one task parked in the pool's weighted-
# fair queue: the SimpleQueue stays the worker WAKEUP channel (stop()
# sentinel semantics untouched), the WFQ decides the ORDER
_WFQ_TOKEN = object()


class Future:
    """Result slot for one submitted task: wait() -> (result, exc)."""

    __slots__ = ("_ev", "result", "exc")

    def __init__(self):
        self._ev = threading.Event()
        self.result: Any = None
        self.exc: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None
             ) -> Tuple[Any, Optional[BaseException]]:
        if not self._ev.wait(timeout):
            raise TimeoutError("fan-out task still running")
        return self.result, self.exc

    def done(self) -> bool:
        return self._ev.is_set()


class FanOutPool:
    """Bounded daemon-worker pool; zero threads until the first submit().

    A task must never wait on a future of its own pool (a saturated pool
    would deadlock)."""

    def __init__(self, size: int = 8, name: str = "fanout",
                 inflight_gauge=None):
        self.size = max(1, int(size))
        self.name = name
        # tasks submitted but not finished; an optional gauge mirrors it
        # (SeaweedFS_ingest_pipeline_occupancy on the filer's pool)
        self._inflight_gauge = inflight_gauge
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        # thread_count() reads lock-free (introspection may be stale)
        self._threads: List[threading.Thread] = []  # guarded_by(self._lock, writes)
        self._stopping = False  # guarded_by(self._lock)
        # weighted-fair backlog, built lazily on the first submit made
        # while QoS is on (None forever otherwise)
        self._wfq = None  # guarded_by(self._lock, writes)

    def thread_count(self) -> int:
        return len(self._threads)

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:   # stop() sentinel
                return
            if item is _WFQ_TOKEN:
                wfq = self._wfq
                item = wfq.pop() if wfq is not None else None
                if item is None:
                    continue
            self._run_task(*item)

    def _run_task(self, fut: Future, ctx, fn: Callable, args) -> None:
        try:
            fut.result = ctx.run(fn, *args)
        except BaseException as e:  # noqa: BLE001 - latched, not lost
            fut.exc = e
        finally:
            if self._inflight_gauge is not None:
                self._inflight_gauge.dec()
            fut._ev.set()

    def submit(self, fn: Callable, *args) -> Future:
        # the task runs in a COPY of the submitter's context, so request
        # state (the resilience deadline above all) follows the work
        # across the thread hop
        ctx = contextvars.copy_context()
        fut = Future()
        if self._inflight_gauge is not None:
            self._inflight_gauge.inc()
        # enqueue, the stopping check and the spawn are one step against
        # stop(): a task queued under the lock sits AHEAD of stop()'s
        # sentinels and always gets a worker; a submit that sees
        # _stopping runs inline instead
        qos = _qos_sched
        with self._lock:
            stopping = self._stopping
            if not stopping:
                if qos is not None:
                    # weighted-fair path: the task parks in the WFQ
                    # (ordered by tenant weight), a token wakes one
                    # worker; transport and stop semantics unchanged
                    wfq = self._wfq
                    if wfq is None:
                        wfq = self._wfq = qos.make_wfq(self.name)
                    wfq.put((fut, ctx, fn, args))
                    # lint: block-ok(SimpleQueue.put never blocks; the lock orders enqueue against stop's sentinels)
                    self._q.put(_WFQ_TOKEN)
                else:
                    # lint: block-ok(SimpleQueue.put never blocks; the lock orders enqueue against stop's sentinels)
                    self._q.put((fut, ctx, fn, args))
                if len(self._threads) < self.size:
                    t = threading.Thread(
                        target=self._worker, daemon=True,
                        name=f"{self.name}-{len(self._threads)}")
                    # started inside the lock: stop() joins what sits in
                    # _threads, and joining an unstarted thread raises
                    t.start()
                    self._threads.append(t)
        if stopping:
            self._run_task(fut, ctx, fn, args)
        return fut

    def run(self, fns: Sequence[Callable]
            ) -> List[Tuple[Any, Optional[BaseException]]]:
        """Run every thunk concurrently; (result, exc) pairs in order.
        Always waits for every task, so an early failure never leaves a
        sibling's socket half-read in a shared connection pool."""
        if len(fns) == 1:  # no thread hop for a fan-out of one
            try:
                return [(fns[0](), None)]
            except BaseException as e:  # noqa: BLE001 - latched, not lost
                return [(None, e)]
        futs = [self.submit(fn) for fn in fns]
        return [f.wait() for f in futs]

    def stop(self, join_timeout: float = 2.0) -> None:
        """Drain and stop every worker. Queued tasks still run (the
        sentinels sit behind them); later submits run inline."""
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            threads = list(self._threads)
        for _ in threads:
            self._q.put(None)
        for t in threads:
            t.join(timeout=join_timeout)
