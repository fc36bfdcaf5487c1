"""Fid lease cache: one master assign covers dozens of uploads.

The port of ``seaweedfs_tpu.operation.assign_lease``. The master's assign
with count=N reserves N contiguous file keys on one writable volume; the
reference amortizes assigns with count=N leases that the client spends
locally (weed/command/benchmark.go hands each writer a batch and derives
the i-th fid from the base). This module is that idea as a shared cache:

  - one pool per (master, collection, replication, ttl, data_center)
  - acquire() pops a leased fid locally; a miss assigns count=N and
    banks the rest
  - below the low-water mark the pool refills in the background (one
    one-shot daemon thread per pool at a time), so steady ingest seldom
    waits on the master
  - leases carry a TTL: a banked fid points at a volume the master
    thought writable at assign time, and that belief goes stale (the
    volume fills, goes read-only, is EC-encoded); expired leases are
    dropped, never handed out
  - invalidate(fid) drops every banked lease on that fid's volume: the
    caller saw a volume-server error, so its siblings are presumed bad

Cost discipline: constructing a LeaseCache starts nothing; the refill
thread exists only after the first acquire() that crosses the low-water
mark, and a cache that is never constructed costs the upload path one
``is None`` check.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, NamedTuple, Optional, Tuple

from seaweedfs_tpu_torch.operation import operations
from seaweedfs_tpu_torch.operation.file_id import format_fid, parse_fid

DEFAULT_LEASE_TTL_S = 10.0


class _Lease(NamedTuple):
    fid: str
    volume_id: int
    url: str
    public_url: str
    expires_at: float  # monotonic


_PoolKey = Tuple[str, str, str, str, str]


class LeaseCache:
    """Per-(collection, replication, ttl, data_center) fid lease pools.

    Thread-safe; acquire() is a pop under a lock on the hot path.
    assign_fn is injectable for tests (defaults to operations.assign,
    the pooled HTTP /dir/assign path).
    """

    def __init__(self, count: int = 32, low_water: Optional[int] = None,
                 lease_ttl_s: float = DEFAULT_LEASE_TTL_S,
                 assign_fn=operations.assign):
        self.count = max(2, int(count))
        self.low_water = self.count // 4 if low_water is None \
            else max(0, int(low_water))
        self.lease_ttl_s = lease_ttl_s
        self._assign_fn = assign_fn
        self._lock = threading.Lock()
        self._pools: Dict[_PoolKey, Deque[_Lease]] = {}  # guarded_by(self._lock)
        self._refilling: set = set()  # guarded_by(self._lock)
        # lock-free reads are the drain-phase double-check; _bank
        # re-checks under the lock before touching the pools
        self._closed = False  # guarded_by(self._lock, writes)
        # single-flight for the MISS path: a cold pool hit by W pipeline
        # workers at once must cost one count=N round trip, not W
        self._fill_locks: Dict[_PoolKey, threading.Lock] = {}  # guarded_by(self._lock)
        # ledger (exact under the lock; exported via the depth gauge)
        self.assign_round_trips = 0
        self.served_from_pool = 0

    # -- internals -------------------------------------------------------------

    def _depth_locked(self) -> int:  # requires(self._lock)
        return sum(len(p) for p in self._pools.values())

    def _export_depth_locked(self) -> None:  # requires(self._lock)
        from seaweedfs_tpu_torch.stats.metrics import IngestLeaseDepthGauge
        IngestLeaseDepthGauge.set(self._depth_locked())

    def _assign_batch(self, key: _PoolKey):
        """One count=N master round trip -> (first Assignment, rest)."""
        from seaweedfs_tpu_torch.stats import trace
        master, collection, replication, ttl, dc = key
        # after close() nothing gets banked, so reserving N keys would
        # leak N-1 fids per drain-phase upload — ask for exactly one
        count = 1 if self._closed else self.count
        sp = trace.span("ingest.assign", count=count) \
            if trace.is_enabled() else trace.NOOP
        with sp:
            a = self._assign_fn(
                master, count=count, replication=replication,
                collection=collection, ttl=ttl, data_center=dc)
        from seaweedfs_tpu_torch.stats.metrics import IngestLeaseAssignsCounter
        IngestLeaseAssignsCounter.inc()
        with self._lock:
            self.assign_round_trips += 1
        granted = max(1, min(count, a.count or 1))
        f = parse_fid(a.fid)
        expires = time.monotonic() + self.lease_ttl_s
        leases = [
            _Lease(format_fid(f.volume_id, f.key + i, f.cookie),
                   f.volume_id, a.url, a.public_url, expires)
            for i in range(granted)]
        return leases[0], leases[1:]

    def _bank(self, key: _PoolKey, leases) -> None:
        with self._lock:
            if self._closed:   # shutdown: stop banking, serve direct
                return
            self._pools.setdefault(key, deque()).extend(leases)
            self._export_depth_locked()

    def _refill_async(self, key: _PoolKey) -> None:
        def run():
            try:
                if not self._closed:
                    first, rest = self._assign_batch(key)
                    self._bank(key, [first] + rest)
            except Exception:
                # next miss refills synchronously and surfaces it
                from seaweedfs_tpu_torch.stats import metrics
                metrics.swallowed("lease.refill")
            finally:
                with self._lock:
                    self._refilling.discard(key)

        # lint: thread-ok(refill outlives the triggering request by design; a spent budget must not kill the bank)
        threading.Thread(target=run, daemon=True,
                         name="ingest-lease-refill").start()

    # -- public API ------------------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return self._depth_locked()

    def _pop(self, key: _PoolKey) -> Optional[_Lease]:
        """Pop one live lease; discards expired ones; kicks the async
        refill below the low-water mark."""
        now = time.monotonic()
        lease = None
        spawn_refill = False
        expired = 0
        with self._lock:
            pool = self._pools.get(key)
            while pool:
                cand = pool.popleft()
                if cand.expires_at > now:
                    lease = cand
                    break
                expired += 1
            if lease is not None:
                self.served_from_pool += 1
                # low_water=0 disables the async refill entirely:
                # misses refill synchronously, nothing else does
                if not self._closed and \
                        0 < self.low_water >= len(pool) and \
                        key not in self._refilling:
                    self._refilling.add(key)
                    spawn_refill = True
            self._export_depth_locked()
        if expired:
            from seaweedfs_tpu_torch.stats.metrics import \
                IngestLeaseDiscardsCounter
            IngestLeaseDiscardsCounter.labels("expired").inc(expired)
        if lease is not None and spawn_refill:
            self._refill_async(key)
        return lease

    def acquire(self, master_url: str, collection: str = "",
                replication: str = "", ttl: str = "",
                data_center: str = "") -> operations.Assignment:
        """A fid ready to upload to — from the pool when possible, via
        one count=N master round trip otherwise."""
        key = (master_url, collection, replication, ttl, data_center)
        lease = self._pop(key)
        if lease is not None:
            from seaweedfs_tpu_torch.stats.metrics import \
                IngestLeaseServedCounter
            IngestLeaseServedCounter.inc()
            return operations.Assignment(lease.fid, lease.url,
                                         lease.public_url, 1)
        with self._lock:
            fill_lock = self._fill_locks.setdefault(key, threading.Lock())
        with fill_lock:
            # single-flight: a sibling may have filled while we queued
            lease = self._pop(key)
            if lease is not None:
                return operations.Assignment(lease.fid, lease.url,
                                             lease.public_url, 1)
            first, rest = self._assign_batch(key)
            self._bank(key, rest)
        return operations.Assignment(first.fid, first.url,
                                     first.public_url, 1)

    def close(self) -> None:
        """Shutdown: drop the banked leases and stop starting refills.
        acquire() keeps working, straight from the master, so in-flight
        uploads drain instead of failing."""
        with self._lock:
            self._closed = True
            self._pools.clear()
            self._export_depth_locked()

    def invalidate(self, fid: str) -> int:
        """The caller's upload to `fid` failed at the volume server:
        drop every banked lease on that volume (they share its fate).
        Returns how many were dropped."""
        try:
            vid = parse_fid(fid).volume_id
        except ValueError:
            return 0
        dropped = 0
        with self._lock:
            for key, pool in self._pools.items():
                keep = deque(l for l in pool if l.volume_id != vid)
                dropped += len(pool) - len(keep)
                self._pools[key] = keep
            self._export_depth_locked()
        if dropped:
            from seaweedfs_tpu_torch.stats.metrics import \
                IngestLeaseDiscardsCounter
            IngestLeaseDiscardsCounter.labels("volume_error").inc(dropped)
        return dropped
