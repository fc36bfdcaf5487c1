"""Degraded-read decode fleet: fused RS reconstruction for serving.

The counterpart of ``seaweedfs_tpu.reads.decode_fleet``.
``EcVolume._recover_in_place`` solves a one-row RS reconstruction per
request: under concurrent degraded traffic every handler thread pays its
own shard fetches and its own tiny kernel launch, whose host cost is ten
times the kernel's. This fleet lifts the batch dimension to requests
ACROSS handlers, the same move ``ec/fleet.py`` makes for encode, verify
and rebuild:

  queue     handler threads enqueue reconstruction requests and block
            on a per-request event; a single dispatcher thread owns
            batching, so admission costs one queue put.
  window    the dispatcher takes the first request immediately and
            drains the queue for at most `batch_window_s` more; a lone
            request never waits longer than the window, and under load
            the window fills toward `MAX_BATCH`.
  fetch     source rows (10 per request: local shard reads + remote
            shard fetches) run on a shared reader pool, overlapped
            ACROSS the whole batch.
  solve     requests sharing a (present, missing) signature share one
            decode matrix, so their spans pad to a common width and
            stack into ONE `[B, 10, span]` reconstruct: on the card, one
            kernel launch from one pinned host buffer.
  latch     errors stay per request: an unreachable volume (fewer than
            10 rows) fails only its own request's event; the rest of
            the batch decodes normally.

  mesh      with ``use_mesh=True`` the fused decode of two or more
            spans rides the mesh (``parallel/mesh_fleet.sharded_reconstruct``)
            when a multi-card mesh exists at the first decode(); a
            scheduler failure re-solves on the fleet's own codec, but a
            kernel that does not build or launch fails the requests.

Constructing the fleet spawns nothing (no thread, no pool, no CUDA
context) until the first decode() call.
"""

from __future__ import annotations

import contextvars
import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from seaweedfs_tpu_torch.ec import fleet as _fleet
from seaweedfs_tpu_torch.ec.ec_volume import EcShardNotFound
from seaweedfs_tpu_torch.ops.rs_code import (
    DATA_SHARDS, TOTAL_SHARDS, ReedSolomon)
from seaweedfs_tpu_torch.resilience import deadline as deadline_mod
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.stats.metrics import (
    FleetMeshFallbacksCounter, ReadsDecodedBytesCounter,
    ReadsDegradedBatchHistogram, ReadsDegradedCounter)

log = logging.getLogger(__name__)

# How long the dispatcher keeps the window open after the first request
# of a batch: long enough to fuse a concurrent burst, short enough to
# be invisible next to the shard fetches a degraded read already pays.
BATCH_WINDOW_S = 0.002

# Fused spans per decode dispatch (the [B, 10, span] B bound).
MAX_BATCH = 64

# Reader-pool width for source-row fetches, shared by the whole batch.
FLEET_READERS = 8


# Ceiling on waiting for one source-row fetch future: local reads are
# instant and remote reads carry their own gRPC deadline, so anything
# past this is a wedged peer — fail the ROW, keep the batch moving.
FETCH_TIMEOUT_S = 30.0


class _Request:
    __slots__ = ("ecv", "missing", "offset", "length", "remote_reader",
                 "rows", "ids", "result", "error", "done", "_local_futs",
                 "_remote_futs", "_candidates")

    def __init__(self, ecv, missing: int, offset: int, length: int,
                 remote_reader: Optional[Callable]):
        self.ecv = ecv
        self.missing = missing
        self.offset = offset
        self.length = length
        self.remote_reader = remote_reader
        self.rows: List[np.ndarray] = []
        self.ids: List[int] = []
        self.result: Optional[bytes] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


def _read_local(shard, offset: int, length: int) -> Optional[bytes]:
    try:
        b = shard.read_at(offset, length)
    except OSError:
        return None
    return b if len(b) == length else None


def _read_remote(remote_reader, sid: int, offset: int,
                 length: int) -> Optional[bytes]:
    try:
        b = remote_reader(sid, offset, length)
    # lint: swallow-ok(remote fetch must never poison the batch; errors latch per request)
    except Exception:
        return None
    return b if b is not None and len(b) == length else None


def _in_context(ctx, fn: Callable) -> Callable:
    """``fn`` run in a copy of ``ctx`` on whichever pool thread calls it
    (one Context cannot be entered by two threads at once)."""
    def run(*args):
        return ctx.copy().run(fn, *args)
    return run


def _await_row(fut) -> Optional[bytes]:
    """One fetch future's row, or None if it failed or wedged — a
    stuck row costs its request a source shard, never the dispatcher."""
    try:
        return fut.result(timeout=FETCH_TIMEOUT_S)
    # lint: swallow-ok(a wedged row costs a source shard; the decode latches real errors)
    except Exception:
        return None


class DegradedReadFleet:
    """Fuses concurrent degraded-read reconstructions into batched RS
    decode dispatches. Thread-safe; threads spawn lazily on first use."""

    def __init__(self, backend: str = "cuda",
                 batch_window_s: float = BATCH_WINDOW_S,
                 use_mesh: bool = False):
        self.backend = backend
        self.batch_window_s = batch_window_s
        self.use_mesh = use_mesh
        # written once inside _ensure_started's locked section before
        # the dispatcher spawns (happens-before via Thread.start), so
        # worker-side reads are lock-free by design
        self._rs: Optional[ReedSolomon] = None  # guarded_by(self._start_lock, writes)
        self._mesh = None  # guarded_by(self._start_lock, writes)
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._start_lock = threading.Lock()
        self._dispatcher: Optional[threading.Thread] = None  # guarded_by(self._start_lock, writes)
        self._pool: Optional[ThreadPoolExecutor] = None  # guarded_by(self._start_lock, writes)
        self._workers: Optional[ThreadPoolExecutor] = None  # guarded_by(self._start_lock, writes)
        self._stopping = False  # guarded_by(self._start_lock, writes)
        # introspection for tests/bench: fused dispatches issued and
        # their occupancy (also exported via the Prometheus histogram)
        self.dispatches = 0
        self.spans_decoded = 0

    # -- lifecycle ----------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._dispatcher is not None:
            return
        with self._start_lock:
            if self._dispatcher is not None or self._stopping:
                return
            # the codec (and on "cuda" its context and side stream) is
            # made here, at the first degraded read; both batch workers
            # share it, so every fused decode goes to one stream
            self._rs = ReedSolomon(backend=self.backend)
            if self.use_mesh:
                # resolved ONCE, at the first degraded read: a one-card
                # host keeps the fleet's own codec, no per-batch probing
                mesh_fleet = _fleet.mesh_fleet_or_none()
                if mesh_fleet is not None:
                    try:
                        self._mesh = mesh_fleet._resolve_mesh(None)
                    except mesh_fleet.MeshError:
                        self._mesh = None
            # lint: thread-ok(decode fleet pool; decode enforces the deadline on the caller thread)
            self._pool = ThreadPoolExecutor(
                max_workers=FLEET_READERS,
                thread_name_prefix="reads-fetch")
            # batches process on a small worker pool, NOT on the
            # dispatcher: a batch wedged behind one blackholed peer
            # must stall only itself, never batch formation for
            # healthy volumes (head-of-line containment). The
            # semaphore mirrors the pool width so the dispatcher can
            # tell when every worker is busy — and keep accumulating
            # instead of queueing micro-batches behind them.
            # lint: thread-ok(decode batch workers; decode enforces the deadline on the caller thread)
            self._workers = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="reads-batch")
            self._slots = threading.Semaphore(2)
            # lint: thread-ok(dispatcher daemon; requests rendezvous on per-request events)
            t = threading.Thread(target=self._run, name="reads-decode",
                                 daemon=True)
            t.start()
            self._dispatcher = t

    def stop(self) -> None:
        # snapshot the machinery under the SAME lock that builds it: a
        # stop() racing a first-request _ensure_started either sees the
        # fully-built dispatcher/pools (and joins them) or wins the
        # lock first, after which _ensure_started's _stopping check
        # refuses to build: no just-spawned dispatcher or pool escapes
        # shutdown
        with self._start_lock:
            self._stopping = True
            dispatcher = self._dispatcher
            workers = self._workers
            pool = self._pool
            if dispatcher is None:
                return
        self._q.put(None)
        dispatcher.join(timeout=10)
        if workers is not None:
            workers.shutdown(wait=True)
        if pool is not None:
            pool.shutdown(wait=True)
        # requests that slipped in between the dispatcher's final
        # drain and its exit must not wait out their 60s timeout
        self._fail_pending("decode fleet stopped")

    # -- serving surface ----------------------------------------------------

    def decode(self, ecv, missing_shard: int, offset: int, length: int,
               remote_reader: Optional[Callable] = None) -> bytes:
        """Reconstruct one interval of `ecv`'s missing shard. Blocks
        until the fused batch containing it retires; raises
        EcShardNotFound when fewer than 10 source rows are reachable."""
        self._ensure_started()
        if self._stopping:
            raise EcShardNotFound(
                f"vid {ecv.volume_id} shard {missing_shard}: decode "
                "fleet stopped")
        # request-scoped span on the CALLER thread: the fleet's own
        # batch/decode spans are shared across requests, this one shows
        # how long THIS request waited on fused reconstruction
        sp = trace.span("reads.degraded", vid=ecv.volume_id,
                        shard=missing_shard, length=length) \
            if trace.active() else trace.NOOP
        with sp:
            return self._decode_blocking(ecv, missing_shard, offset,
                                         length, remote_reader)

    def _decode_blocking(self, ecv, missing_shard: int, offset: int,
                         length: int,
                         remote_reader: Optional[Callable]) -> bytes:
        if remote_reader is not None and trace.request_ctx() is not None:
            # a traced request: its remote row fetches on the pool
            # threads carry its trace context, so the peers' spans
            # stitch under it
            remote_reader = _in_context(contextvars.copy_context(),
                                        remote_reader)
        req = _Request(ecv, missing_shard, offset, length, remote_reader)
        self._q.put(req)
        if self._stopping:
            # stop() may have drained the queue between our check and
            # the put — fail whatever is queued (including req) now
            # rather than letting callers wait out the full timeout
            self._fail_pending("decode fleet stopped")
        # a request whose client already gave up must not pin this
        # handler thread for the full fleet timeout — cap the wait to
        # the ambient budget (the batch may still retire for siblings)
        wait_s = 60.0
        rem = deadline_mod.remaining()
        if rem is not None:
            if rem <= 0:
                raise deadline_mod.DeadlineExceeded(
                    f"degraded read vid {ecv.volume_id}")
            wait_s = min(wait_s, rem)
        if not req.done.wait(timeout=wait_s):
            if deadline_mod.expired():
                raise deadline_mod.DeadlineExceeded(
                    f"degraded read vid {ecv.volume_id} "
                    f"shard {missing_shard}")
            req.error = EcShardNotFound(
                f"vid {ecv.volume_id} shard {missing_shard}: decode "
                "fleet timed out")
        if req.error is not None:
            raise req.error
        return req.result

    # -- dispatcher ---------------------------------------------------------

    def _run(self) -> None:
        while True:
            req = self._q.get()
            if req is None:
                self._fail_pending("decode fleet stopped")
                return
            batch = [req]
            deadline = time.monotonic() + self.batch_window_s
            while len(batch) < MAX_BATCH:
                try:
                    # whatever is ALREADY queued fuses for free; the
                    # blocking window only opens once the batch proves
                    # concurrent — a lone request never waits
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    if len(batch) == 1:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                if nxt is None:
                    self._submit(batch)
                    self._fail_pending("decode fleet stopped")
                    return
                batch.append(nxt)
            # while every worker is busy, keep draining the queue into
            # THIS batch — the accumulation that makes fused decode
            # dispatches full exactly when decode is the bottleneck.
            # An idle fleet takes a slot immediately: a lone request
            # still never waits.
            got_slot = self._slots.acquire(blocking=False)
            while not got_slot and len(batch) < MAX_BATCH:
                try:
                    nxt = self._q.get(timeout=0.002)
                except queue.Empty:
                    pass
                else:
                    if nxt is None:
                        self._slots.acquire()
                        self._submit(batch, have_slot=True)
                        self._fail_pending("decode fleet stopped")
                        return
                    batch.append(nxt)
                got_slot = self._slots.acquire(blocking=False)
            if not got_slot:
                self._slots.acquire()  # batch full: wait for a worker
            self._submit(batch, have_slot=True)

    def _submit(self, batch: List[_Request], have_slot: bool = False) -> None:
        if not have_slot:
            self._slots.acquire()
        self._workers.submit(self._process_guarded, batch)

    def _process_guarded(self, batch: List[_Request]) -> None:
        try:
            self._process(batch)
        except BaseException as e:  # noqa: BLE001 - latch, never die
            log.exception("degraded decode batch failed")
            for r in batch:
                if r.error is None and r.result is None:
                    r.error = e
                r.done.set()
        finally:
            self._slots.release()

    def _fail_pending(self, why: str) -> None:
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                return
            if r is not None:
                r.error = EcShardNotFound(why)
                r.done.set()

    def _process(self, batch: List[_Request]) -> None:
        sp = trace.span("reads.batch", spans=len(batch)) \
            if trace.is_enabled() else trace.NOOP
        with sp:
            self._fetch_rows(batch)
            self._solve(batch)
        for req in batch:
            req.done.set()

    def _fetch_rows(self, batch: List[_Request]) -> None:
        """Gather 10 source rows per request, overlapped across the
        batch: all local reads first (parallel), then remote fetches
        only for each request's deficit."""
        # phase A: every request's local shard reads, in flight at once
        for req in batch:
            req._local_futs = []
            for sid in range(TOTAL_SHARDS):
                if sid == req.missing:
                    continue
                shard = req.ecv.shards.get(sid)
                if shard is not None:
                    req._local_futs.append((sid, self._pool.submit(
                        _read_local, shard, req.offset, req.length)))
        # phase B: collect locals; submit the remote deficit (+1 slack)
        for req in batch:
            local_ok = set()
            for sid, fut in req._local_futs:
                b = _await_row(fut)
                if b is not None and len(req.ids) < DATA_SHARDS:
                    req.ids.append(sid)
                    req.rows.append(np.frombuffer(b, dtype=np.uint8))
                    local_ok.add(sid)
            req._candidates = [
                sid for sid in range(TOTAL_SHARDS)
                if sid != req.missing and sid not in local_ok] \
                if req.remote_reader is not None else []
            deficit = DATA_SHARDS - len(req.ids)
            req._remote_futs = []
            if deficit > 0 and req._candidates:
                take, req._candidates = (req._candidates[:deficit + 1],
                                         req._candidates[deficit + 1:])
                for sid in take:
                    req._remote_futs.append((sid, self._pool.submit(
                        _read_remote, req.remote_reader, sid,
                        req.offset, req.length)))
        # phase C: collect remotes. On a failure the WHOLE remaining
        # candidate set is submitted at once — chained one-by-one
        # top-ups would serialize this thread behind each wedged
        # peer's timeout in turn (head-of-line for the whole fleet)
        for req in batch:
            futs = list(req._remote_futs)
            while futs and len(req.ids) < DATA_SHARDS:
                sid, fut = futs.pop(0)
                b = _await_row(fut)
                if b is not None:
                    if len(req.ids) < DATA_SHARDS:
                        req.ids.append(sid)
                        req.rows.append(np.frombuffer(b, dtype=np.uint8))
                elif req._candidates:
                    spares, req._candidates = req._candidates, []
                    futs.extend(
                        (nxt, self._pool.submit(
                            _read_remote, req.remote_reader, nxt,
                            req.offset, req.length))
                        for nxt in spares)
            if len(req.ids) < DATA_SHARDS:
                req.error = EcShardNotFound(
                    f"vid {req.ecv.volume_id} shard {req.missing}: only "
                    f"{len(req.ids)} shards reachable, need {DATA_SHARDS}")
                continue
            # canonical sid order: locals landed first, remotes after,
            # so sort rows with ids — the (present, missing) signature
            # must not depend on discovery order or identical shard
            # sets split into separate dispatches
            order = sorted(range(DATA_SHARDS), key=lambda i: req.ids[i])
            req.rows = [req.rows[i] for i in order]
            req.ids = [req.ids[i] for i in order]

    def _solve(self, batch: List[_Request]) -> None:
        """Group healthy requests by decode signature and issue one
        fused [B, 10, span] reconstruct per group."""
        groups: Dict[Tuple[Tuple[int, ...], int], List[_Request]] = {}
        for req in batch:
            if req.error is not None:
                continue
            # ids were sorted at the end of the fetch phase, so the
            # signature (and hence the decode matrix) is canonical
            groups.setdefault((tuple(req.ids), req.missing),
                              []).append(req)
        for (present, missing), members in groups.items():
            span = max(r.length for r in members)
            # one host buffer, pinned on "cuda", filled in place: the
            # fused batch's only host copy
            staged = self._rs.host_buffer((len(members), DATA_SHARDS, span))
            src = staged.numpy()
            for i, r in enumerate(members):
                for row, data in enumerate(r.rows):
                    src[i, row, :len(data)] = data
                src[i, :, r.length:] = 0
            sp = trace.span("reads.decode", batch=len(members),
                            span=span) if trace.is_enabled() else trace.NOOP
            try:
                with sp:
                    out = self._mesh_solve(present, missing, src) \
                        if self._mesh is not None and len(members) >= 2 \
                        else None
                    if out is None:
                        out = self._rs.reconstruct_some(
                            list(present), [missing], staged)  # [B,1,span]
            except BaseException as e:  # noqa: BLE001 - latch per group
                for r in members:
                    r.error = e
                continue
            self.dispatches += 1
            self.spans_decoded += len(members)
            ReadsDegradedBatchHistogram.observe(len(members))
            ReadsDegradedCounter.inc(len(members))
            for i, r in enumerate(members):
                r.result = out[i, 0, :r.length].tobytes()
                ReadsDecodedBytesCounter.inc(float(r.length))

    def _mesh_solve(self, present, missing: int,
                    src: np.ndarray) -> Optional[np.ndarray]:
        """The group's fused decode over the mesh, or None after a
        scheduler failure (counted), which the caller re-solves on the
        fleet's own codec. A fault of a kernel or of the card is no
        scheduler failure: it propagates and fails the group."""
        from seaweedfs_tpu_torch.parallel import mesh_fleet
        try:
            return mesh_fleet.sharded_reconstruct(
                self._mesh, list(present), [missing], src)
        except Exception as e:  # noqa: BLE001 - any scheduler failure demotes
            if mesh_fleet.is_kernel_fault(e):
                raise
            FleetMeshFallbacksCounter.labels("error").inc()
            log.warning("mesh decode fell back (%r); re-solving on the "
                        "fleet's codec", e)
            return None
