"""The device side of a traced run: ``torch.profiler`` around the window,
the K1 launches the window made, and what the trace says.

``LaunchLog`` wraps ``ops.gf_kernel.gf_linear`` (every caller reaches it
through the module) and keeps, while on, the shape of each launch on the
card: the bytes K1 must move, ``(S + O) x lanes``, are computed here from
those shapes, not taken from the program. ``Probe`` starts the profiler,
switches the log on, and on ``stop`` synchronises, switches the log off,
stops the profiler and writes the Chrome trace. So the trace holds every
logged launch, and at most a few more at its edges: the roofline share
read from them can only come out low, never high.
"""

from __future__ import annotations

import heapq
import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
K1_NAME = "gf_linear"


class LaunchLog:
    def __init__(self):
        self.on = False
        self.launches: List[Tuple[int, int, int]] = []   # (O, S, lanes)
        self._lock = threading.Lock()
        from seaweedfs_tpu_torch.ops import gf_kernel
        self._module = gf_kernel
        self._orig = gf_kernel.gf_linear
        orig = self._orig

        def logged(matrix, data):
            out = orig(matrix, data)
            if self.on and data.device.type == "cuda":
                s = data.shape[-2]
                with self._lock:
                    self.launches.append(
                        (out.shape[-2], s, data.numel() // s))
            return out
        gf_kernel.gf_linear = logged

    def close(self) -> None:
        self._module.gf_linear = self._orig


class Probe:
    """``torch.profiler`` over the CUDA activity of this process."""

    def __init__(self, path: str, launch_log: Optional[LaunchLog]):
        self.path = path
        self.log = launch_log
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        if self.log is not None:
            self.log.on = True

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        if self.log is not None:
            self.log.on = False
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        self.prof = None


def device_events(path: str) -> List[Tuple[str, float, float]]:
    """(name, start, end) in Unix seconds of every kernel, copy and set
    on the card in a Chrome trace written by ``torch.profiler``."""
    with open(path) as f:
        d = json.load(f)
    base_us = d.get("baseTimeNanoseconds", 0) / 1e3
    out = []
    for e in d.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            t0 = (float(e["ts"]) + base_us) / 1e6
            out.append((e["name"], t0, t0 + float(e.get("dur", 0)) / 1e6))
    return out


def _union(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(events: Sequence[Tuple[str, float, float]], t0: float,
              t1: float, launches: Sequence[Tuple[int, int, int]] = (),
              spans: Sequence[Tuple[str, float, float]] = ()) -> dict:
    """What the card did in the window [t0, t1] (Unix seconds): busy
    seconds (union of every kernel, copy and set), time by operation,
    K1's kernel seconds against its launches' bytes, and the idle time
    by the innermost program span open at each gap's middle."""
    clipped = [(n, max(a, t0), min(b, t1)) for n, a, b in events
               if b > t0 and a < t1]
    busy_iv = _union([(a, b) for _, a, b in clipped])
    busy = sum(b - a for a, b in busy_iv)
    by_name: Dict[str, float] = {}
    for n, a, b in clipped:
        key = n if len(n) <= 96 else n[:93] + "..."
        by_name[key] = by_name.get(key, 0.0) + (b - a)
    k1 = [(a, b) for n, a, b in events if K1_NAME in n]
    gaps = []
    edge = t0
    for a, b in busy_iv + [(t1, t1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    idle: Dict[str, float] = {}
    todo = sorted(spans, key=lambda x: x[1])
    active: List[Tuple[float, float, str]] = []   # (end, length, name)
    k = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while k < len(todo) and todo[k][1] <= mid:
            n, s, e = todo[k]
            heapq.heappush(active, (e, e - s, n))
            k += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        live = [x for x in active if x[0] >= mid]
        label = min(live, key=lambda x: x[1])[2] if live \
            else "no program span"
        idle[label] = idle.get(label, 0.0) + (b - a)
    return {
        "window_s": t1 - t0,
        "busy_s": busy,
        "events": len(events),
        "events_in_window": len(clipped),
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                            key=lambda x: -x[1])[:10],
        "k1_kernels": len(k1),
        "k1_kernel_s": sum(b - a for a, b in k1),
        "k1_launches": len(launches),
        "k1_bytes": sum((o + s) * lanes for o, s, lanes in launches),
    }
