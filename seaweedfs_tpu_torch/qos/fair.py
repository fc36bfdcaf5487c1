"""Weighted-fair queueing for the shared FanOutPool seam.

Start-time fair queueing on virtual time: each enqueue stamps a
virtual finish time ``max(vtime, tenant's last finish) + 1/weight``
and workers always pop the smallest stamp. A weight-16 tenant's tasks
therefore interleave 16:1 against weight-1 tasks under contention, and
a newly-arriving high-weight task jumps (almost) the whole backlog of
a low-weight flood (tests/test_torch_qos.py holds the dequeue order
against the JAX package's). With a single tenant the heap degenerates to
FIFO (stamps are monotonic), so fairness costs nothing observable when
nobody competes.

The queue replaces only the ORDERING of FanOutPool's backlog, not its
transport: fanout keeps its SimpleQueue for worker wakeups (a token
per task) and its stop() sentinel semantics, so shutdown and the
inline-after-stop contract are untouched.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Optional

from seaweedfs_tpu_torch.qos import tenant as tenant_mod


class WeightedFairQueue:
    """One per FanOutPool (built lazily on the pool's first submit
    while QoS is on). put() reads the ambient tenant contextvar; pop()
    never blocks — the pool only wakes a worker per queued item."""

    __slots__ = ("_mgr", "name", "_lock", "_heap", "_vtime",
                 "_vfinish", "_seq")

    def __init__(self, manager, name: str):
        self._mgr = manager
        self.name = name
        self._lock = threading.Lock()
        self._heap: list = []      # guarded_by(self._lock)
        self._vtime = 0.0          # guarded_by(self._lock)
        # last virtual finish per tenant; bounded — names here are
        # manager-normalized (maxTenants overflow maps to _other)
        self._vfinish: dict = {}   # guarded_by(self._lock)
        self._seq = 0              # guarded_by(self._lock)

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def put(self, item: Any) -> None:
        name = tenant_mod.current.get()
        if name is None:
            name = tenant_mod.DEFAULT
        st = self._mgr.state_of(name)
        now = time.monotonic()
        with self._lock:
            start = self._vtime
            last = self._vfinish.get(st.name, 0.0)
            if last > start:
                start = last
            vf = start + 1.0 / st.weight
            self._vfinish[st.name] = vf
            self._seq += 1
            heapq.heappush(self._heap, (vf, self._seq, st, now, item))

    def pop(self) -> Optional[Any]:
        with self._lock:
            if not self._heap:
                return None
            vf, _seq, st, t_enq, item = heapq.heappop(self._heap)
            if vf > self._vtime:
                self._vtime = vf
        self._mgr.observe_queued(st, time.monotonic() - t_enq)
        return item
