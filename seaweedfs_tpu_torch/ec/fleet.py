"""Cross-volume batched EC scheduler: the port's one engine for encode,
rebuild and verify.

The counterpart of ``seaweedfs_tpu.ec.fleet``, byte for byte the same
shard files. A single volume is a fleet of one (``encoder.write_ec_files``
and ``encoder.rebuild_ec_files`` call this module). The batch dimension
runs over chunks ACROSS volumes:

  stage     same-sized spans from many volumes fuse into one
            [B, 10, span] dispatch: each batch is ONE host buffer
            (``ReedSolomon.host_buffer``, pinned on "cuda"), and each
            reader fills its span's slot of it straight from disk, so
            the codec uploads the bytes where they were read.
  feed      a bounded reader pool prefetches spans ahead of the card.
            Spans are consumed in submission order (round-robin rounds
            over the volumes), so per-volume row order is preserved by
            construction while reads overlap compute.
  dispatch  on "cuda" one fused batch is one async H2D + kernel + D2H on
            the codec's side stream; the "cpu" backend is lifted to the
            same handle contract by a small encode pool.
  retire    a tagged completion queue: a single retire thread awaits
            dispatches strictly in submission order and hands every
            volume's writes to that volume's writer LANE (per-volume
            FIFO, parallel across volumes).

A volume over 10 * large_block bytes is encoded as the reference stripes
it: first its large rows, each cut into [10, min(chunk, large_block)]
spans of the ten strided .dat blocks, then its small-row tail.
"""

from __future__ import annotations

import functools
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from seaweedfs_tpu_torch.ec import encoder as _encoder
from seaweedfs_tpu_torch.ec.encoder import (
    LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, default_chunk_for, shard_file_name)
from seaweedfs_tpu_torch.ops.rs_code import (
    DATA_SHARDS, TOTAL_SHARDS, ReedSolomon)
from seaweedfs_tpu_torch.resilience import failpoint as _failpoint
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.stats.metrics import (
    FleetDispatchBatchHistogram, FleetDispatchedBytesCounter,
    FleetMeshFallbacksCounter, FleetReaderQueueGauge,
    FleetStageSecondsHistogram, FleetWriterBacklogGauge)


def mesh_fleet_or_none():
    """The unified mesh scheduler module (``parallel/mesh_fleet``), or
    None when it cannot be imported. A None counts as a mesh fallback;
    the caller then runs the fleet path."""
    try:
        from seaweedfs_tpu_torch.parallel import mesh_fleet
        return mesh_fleet
    except ImportError:
        FleetMeshFallbacksCounter.labels("unavailable").inc()
        return None

# Reader-pool width: enough to keep several volumes' sequential reads
# in flight without degrading each stream to fully random IO.
FLEET_READERS = 4

# Fused dispatches in flight at once — the writer-queue bound: double
# buffering, the card computes one batch while the host reads the next
# and writes the last. Peak host memory is ~(depth + 2) fused batches
# (queued + filling + retiring).
FLEET_DEPTH = 2

# Encode pool of the "cpu" backend: torch releases the GIL, so two
# in-flight fused encodes use two cores, the host-side analogue of the
# card's async dispatch queue.
FLEET_ENCODERS = max(2, min(4, os.cpu_count() or 2))

# Writer lanes: each volume's writes stay FIFO on one lane, but lanes
# run in parallel, so the fleet's file writes (the larger half of the
# IO: 14 bytes out per 10 in) spread across cores instead of
# serializing behind a single writer thread.
FLEET_WRITERS = max(2, min(4, os.cpu_count() or 2))

# Bound on queued writes per lane: with ~chunk-sized spans this caps
# writer-side buffering at a few spans per lane.
_LANE_QUEUE = 4


# Stage-latency children resolved once at import: labels() takes a
# lock per call, and a stage interval closes for every chunk-sized
# unit of work.
_STAGE_HIST = {s: FleetStageSecondsHistogram.labels(s)
               for s in ("read", "upload", "dispatch", "rs", "retire",
                         "write", "verify")}


class _StageTimer:
    """One pipeline-stage interval: always observed into the per-stage
    latency histogram, and additionally recorded as a trace span when
    tracing is enabled (parented across threads via a handoff token).
    Span allocation is gated on the trace flag so the disabled path
    costs one histogram observe per chunk-sized unit of work."""

    __slots__ = ("_hist", "_span", "_t0")

    def __init__(self, stage: str, parent: Optional[int] = None, **tags):
        self._hist = _STAGE_HIST[stage]
        self._span = trace.span("fleet." + stage, parent=parent, **tags) \
            if trace.is_enabled() else trace.NOOP

    def __enter__(self) -> "_StageTimer":
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._hist.observe(time.perf_counter() - self._t0)
        return self._span.__exit__(*exc)

    def token(self) -> Optional[int]:
        """Handoff token of the underlying span (None when disabled)."""
        return self._span.token()


class TaggedPipeline:
    """Tagged completion queue: fused dispatches retire FIFO, writes
    fan out to per-volume writer lanes.

    One retire thread awaits dispatch handles strictly in submission
    order and routes each tagged span's parity write to `tag % lanes`. All of a
    volume's writes carry the volume's tag, so they land on ONE lane in
    enqueue order (per-volume FIFO by construction) while different
    volumes' writes proceed in parallel. Data-shard writes (`write`)
    need no handle and go straight to the lane from the packing thread;
    they interleave with parity writes on the lane but touch disjoint
    files (.ec00-09 vs .ec10-13), so only the per-file order matters —
    and each file's writes come from a single ordered source.
    """

    def __init__(self, depth: int = FLEET_DEPTH,
                 writers: int = FLEET_WRITERS):
        self._lanes: List["queue.Queue[Optional[Tuple]]"] = [
            queue.Queue(maxsize=_LANE_QUEUE)
            for _ in range(max(1, writers))]
        self._retireq: "queue.Queue[Optional[Tuple]]" = \
            queue.Queue(maxsize=max(1, depth))
        self._exc: Optional[BaseException] = None
        # per-lane backlog gauges resolved once: labels() locks per call
        self._lane_gauges = [FleetWriterBacklogGauge.labels(str(i))
                             for i in range(len(self._lanes))]
        self._writers = [
            # lint: gate-ok(TaggedPipeline is built per fleet pass: construction is first use) # lint: thread-ok(fleet writers carry explicit volume tags, not request context)
            threading.Thread(target=self._drain_lane, args=(q, i),
                             name=f"fleet-write-{i}", daemon=True)
            for i, q in enumerate(self._lanes)]
        # lint: gate-ok(TaggedPipeline is built per fleet pass: construction is first use) # lint: thread-ok(retire thread carries explicit tags, not request context)
        self._retirer = threading.Thread(
            target=self._retire_loop, name="fleet-retire", daemon=True)
        for t in self._writers:
            t.start()
        self._retirer.start()

    def _put_lane(self, tag: int, fn: Callable[[], None],
                  token: Optional[int],
                  timeout_s: Optional[float] = None) -> None:
        lane = tag % len(self._lanes)
        # inc/dec deltas, not set(qsize): several schedulers may run
        # concurrently and share these children, so the gauge must SUM
        # their backlogs rather than keep the last scheduler's view
        self._lane_gauges[lane].inc()
        try:
            self._lanes[lane].put((fn, token), timeout=timeout_s)
        except queue.Full:
            self._lane_gauges[lane].dec()  # never entered the lane
            raise

    def write(self, tag: int, fn: Callable[[], None],
              timeout_s: Optional[float] = None) -> None:
        """Enqueue one ordered write on `tag`'s lane (no handle).
        With timeout_s, a lane that stays full that long raises
        queue.Full instead of blocking the caller behind a wedged
        writer — same stall contract as submit()."""
        self._raise_pending()
        self._put_lane(tag, fn, trace.handoff(), timeout_s)

    def submit(self, handle,
               tagged: Sequence[Tuple[int, Callable]],
               timeout_s: Optional[float] = None) -> None:
        """Queue a dispatch: when `handle` resolves (FIFO), span i's
        output goes to `tagged[i] = (tag, fn)` as `fn(outs[i])` on
        tag's lane. With timeout_s, waiting `timeout_s` for a free
        in-flight slot raises queue.Full instead of blocking forever
        behind a wedged retire."""
        self._raise_pending()
        self._retireq.put((handle, list(tagged), trace.handoff()),
                          timeout=timeout_s)

    def _retire_loop(self) -> None:
        while True:
            item = self._retireq.get()
            if item is None:
                return
            if self._exc is not None:
                continue  # failed: keep draining, write nothing more
            handle, tagged, token = item
            try:
                # the retire stage is where async dispatches resolve:
                # on "cuda" this wait IS the card's time (the event after
                # the D2H), on "cpu" the encode pool's compute; the lane
                # puts after it are writer-side backpressure
                with _StageTimer("retire", parent=token,
                                 spans=len(tagged)) as st:
                    outs = handle.result()
                    for (tag, fn), out in zip(tagged, outs):
                        self._put_lane(tag, functools.partial(fn, out),
                                       st.token())
            except BaseException as e:  # surfaced on submit/drain
                if self._exc is None:
                    self._exc = e

    def _drain_lane(self, q: "queue.Queue[Optional[Tuple]]",
                    lane: int) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            self._lane_gauges[lane].dec()
            if self._exc is not None:
                continue
            fn, token = item
            try:
                with _StageTimer("write", parent=token, lane=lane):
                    fn()
            except BaseException as e:
                if self._exc is None:
                    self._exc = e

    def _raise_pending(self) -> None:
        # _exc stays latched once set: clearing it here would re-enable
        # the retire/writer threads after they skipped a failed span,
        # letting later spans land past a hole in the shard files
        if self._exc is not None:
            raise self._exc

    def drain(self) -> None:
        """Flush every queued write, stop all threads, re-raise the
        first error (if any). The pipeline is spent afterwards."""
        self._retireq.put(None)
        self._retirer.join()
        for q in self._lanes:
            q.put(None)
        for t in self._writers:
            t.join()
        self._raise_pending()


class _Gathered:
    """Handle over several in-flight per-span encodes: .result() is the
    list of per-span outputs, ordered like the batch's slots."""

    def __init__(self, handles):
        self._handles = handles

    def result(self) -> List[np.ndarray]:
        return [h.result() for h in self._handles]


def _rs_staged(fn, arr: np.ndarray, parent: Optional[int]) -> np.ndarray:
    """One "cpu"-backend RS compute task, attributed to the 'rs' stage
    (on "cuda" the card's time shows in 'retire' instead, where
    handle.result() waits)."""
    with _StageTimer("rs", parent=parent):
        return fn(arr)


class _Batch:
    """One fused dispatch's input, staged in place: a [cap, 10, width]
    ``ReedSolomon.host_buffer`` (pinned on "cuda") whose leading rows
    are handed out as slots, one per span, for the readers to fill
    straight from disk. The codec takes the filled rows as they are."""

    __slots__ = ("buf", "arr", "rows", "slots")

    def __init__(self, rs: ReedSolomon, cap: int, width: int):
        self.buf = rs.host_buffer((cap, DATA_SHARDS, width))
        self.arr = self.buf.numpy()
        self.rows = 0
        self.slots: List[np.ndarray] = []  # one view per span, fill order

    def take(self, rows: int) -> np.ndarray:
        """The next `rows` rows of the buffer: one span's slot."""
        slot = self.arr[self.rows:self.rows + rows]
        self.rows += rows
        self.slots.append(slot)
        return slot

    def staged(self):
        """The filled leading rows, as the host tensor the codec uploads
        (a short last batch leaves the rest of the buffer unused)."""
        return self.buf[:self.rows]


class _Dispatcher:
    """Uniform async-handle dispatch over the codec's backends.

    On "cuda" a fused batch, already staged in its pinned buffer, is
    issued as ONE async dispatch on the codec's side stream (H2D,
    kernel, D2H): the card computes while the host does IO, and handles
    retire in submission order. There is no host encode pool on this
    path. On "cpu" each slot of the (unpinned) batch goes to a small
    encode pool as its own task and the handles are gathered. Either
    way .result() yields one output per slot, shaped like the slot with
    the map's output rows in place of the 10 data rows.
    """

    def __init__(self, rs: ReedSolomon):
        self._rs = rs
        self._pool = None
        if rs.backend == "cpu":
            # lint: thread-ok(fleet dispatch pool; work items are explicit, no ambient request state)
            self._pool = ThreadPoolExecutor(
                max_workers=FLEET_ENCODERS,
                thread_name_prefix="fleet-encode")

    def batch(self, cap: int, width: int) -> _Batch:
        return _Batch(self._rs, cap, width)

    def encode(self, batch: _Batch):
        if _failpoint._armed:
            _failpoint.hit("fleet.dispatch", op="encode")
        return self._dispatch(batch, self._rs.encode_async, self._rs.encode)

    def reconstruct(self, present, missing, batch: _Batch):
        if _failpoint._armed:
            _failpoint.hit("fleet.dispatch", op="reconstruct")
        return self._dispatch(
            batch,
            functools.partial(self._rs.reconstruct_some_async, present,
                              missing),
            functools.partial(self._rs.reconstruct_some, present, missing))

    def _dispatch(self, batch: _Batch, submit_async, compute):
        if self._pool is None:
            return _SplitHandle(submit_async(batch.staged()),
                                [s.shape[0] for s in batch.slots])
        token = trace.handoff()
        return _Gathered([self._pool.submit(_rs_staged, compute, s, token)
                          for s in batch.slots])

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class _SplitHandle:
    """Adapt one fused async handle back to per-slot outputs. The
    outputs are numpy views of the handle's pinned output tensor; each
    view's ``.base`` chain holds that tensor, so the pinned block stays
    allocated until the last writer lane drops its view."""

    def __init__(self, handle, rows: List[int]):
        self._handle = handle
        self._rows = rows

    def result(self) -> List[np.ndarray]:
        out = self._handle.result()
        if len(self._rows) == 1:
            return [out]
        parts, row = [], 0
        for r in self._rows:
            parts.append(out[row:row + r])
            row += r
        return parts


class _VolState:
    __slots__ = ("base", "dat_size", "n_rows", "tag", "start")

    def __init__(self, base: str, dat_size: int, n_rows: int, tag: int = 0,
                 start: int = 0):
        self.base = base
        self.dat_size = dat_size
        self.n_rows = n_rows
        self.tag = tag  # writer-lane key: all this volume's writes
        #                 share it, so they stay FIFO on one lane
        self.start = start  # .dat offset of the first row of n_rows


def _append_rows(base: str, shard_ids: Sequence[int], valid: int,
                 arr: np.ndarray) -> None:
    """Append ``arr[r, row, :valid]`` for every span row r to shard
    ``shard_ids[row]``: the slices go straight to the (buffered) file
    object — no ascontiguousarray / tobytes staging copies on the write
    path."""
    for row, sid in enumerate(shard_ids):
        with open(shard_file_name(base, sid), "ab") as f:
            for r in range(arr.shape[0]):
                f.write(arr[r, row, :valid])


def _round_robin_spans(vols: List[_VolState], span_rows: int):
    """Yield (vol, row0, rows) in rounds over the volumes: round r
    hands out rows [r*span, (r+1)*span) of every volume still alive.
    Submission order == pack order == per-volume row order."""
    pending = [(v, 0) for v in vols if v.n_rows > 0]
    while pending:
        nxt = []
        for v, row0 in pending:
            rows = min(span_rows, v.n_rows - row0)
            yield v, row0, rows
            if row0 + rows < v.n_rows:
                nxt.append((v, row0 + rows))
        pending = nxt


def _shard_spans(vols: List[_VolState], span: int):
    """((vol, offset, valid), 1) for every `span`-wide slice of each
    volume's shards, round-robin: a span is one row of its batch, and
    `valid` of its bytes lie before the shard's end."""
    return (((v, row0 * span, min(span, v.dat_size - row0 * span)), 1)
            for v, row0, _ in _round_robin_spans(vols, 1))


def _grouped(spans, batch_rows: int):
    """(item, rows) spans, in order, in runs that close at `batch_rows`
    rows: one run per fused dispatch (the last may be short)."""
    group, acc = [], 0
    for item, rows in spans:
        group.append((item, rows))
        acc += rows
        if acc >= batch_rows:
            yield group
            group, acc = [], 0
    if group:
        yield group


def _drive_batches(groups, prefetch: int, new_batch: Callable[[int], _Batch],
                   submit_read: Callable, flush: Callable) -> None:
    """THE fill/flush loop of the three fleet passes. `groups` yields
    each batch's spans (``_grouped``); one ``new_batch(rows)`` buffer is
    taken per batch, sized to them exactly. Up to `prefetch` reads stay
    in flight, each reading straight into its slot of its batch
    (``submit_read(item, slot)`` returns the read's future); reads
    retire in submission order, and each batch goes to
    ``flush(items, batch)`` once its last slot is read."""
    inflight: deque = deque()
    pending: deque = deque()  # spans of the batch being filled, unread
    filling: Optional[_Batch] = None

    def fill() -> None:
        nonlocal filling
        while len(inflight) < prefetch:
            if not pending:
                group = next(groups, None)
                if group is None:
                    break
                filling = new_batch(sum(rows for _, rows in group))
                pending.extend(group)
            item, rows = pending.popleft()
            inflight.append((item, filling,
                             submit_read(item, filling.take(rows))))
            # inc/dec deltas so concurrent schedulers SUM on the
            # shared gauge instead of overwriting each other's depth
            FleetReaderQueueGauge.inc()

    try:
        fill()
        items: List = []
        while inflight:
            item, batch, fut = inflight.popleft()
            FleetReaderQueueGauge.dec()
            fut.result()
            items.append(item)
            fill()
            # spans retire in order, so the batch's last one is the one
            # no later span of the same batch follows
            if not inflight or inflight[0][1] is not batch:
                flush(items, batch)
                items = []
    finally:
        FleetReaderQueueGauge.dec(len(inflight))  # error path leftovers


class _Pass:
    """One fleet pass's scaffold, set up here and torn down on exit: the
    dispatcher on its codec, the reader pool, the tagged pipeline, and
    the ``fleet.<op>`` root span whose token parents the readers. Files
    handed to ``closing`` are closed in the same teardown. ``drive``
    runs one stream of same-width spans through it."""

    def __init__(self, op: str, backend: str, device, volumes: int):
        self.dispatcher = _Dispatcher(ReedSolomon(backend=backend,
                                                  device=device))
        # lint: thread-ok(per-pass reader pool; work items are explicit, no ambient request state)
        self._pool = ThreadPoolExecutor(max_workers=FLEET_READERS,
                                        thread_name_prefix="fleet-read")
        # a volume's writes all take one lane: more lanes than volumes
        # would start writer threads that never write
        self._pipe = TaggedPipeline(writers=min(FLEET_WRITERS, volumes))
        self._root = trace.span("fleet." + op, volumes=volumes,
                                backend=backend)
        self._files: List = []
        self._token: Optional[int] = None

    def __enter__(self) -> "_Pass":
        self._root.__enter__()
        self._token = self._root.token()
        return self

    def __exit__(self, *exc) -> bool:
        self._pool.shutdown(wait=True)
        try:
            self._pipe.drain()  # may re-raise the latched pipeline error
        finally:
            self.dispatcher.close()
            for f in self._files:
                f.close()
            self._root.__exit__(None, None, None)
        return False

    def closing(self, f):
        """`f`, closed when the pass ends, whatever fails."""
        self._files.append(f)
        return f

    def read(self, fn: Callable, *args):
        """Queue ``fn(*args, parent)`` on the reader pool, parented to
        the pass's root span; returns its future."""
        return self._pool.submit(fn, *args, self._token)

    def drive(self, spans, batch_rows: int, width: int, read: Callable,
              retire: Callable, dispatch: Optional[Callable] = None,
              stage: Optional[Callable] = None, span_rows: int = 1) -> None:
        """Run `spans`, ((vol, ...), rows) items, through
        ``_drive_batches`` in [batch_rows, 10, width] batches.
        ``read(item, slot)`` queues a span's read and returns its future;
        ``dispatch(batch)`` (default: encode) issues a filled batch;
        ``retire(item, out)`` runs on the volume's writer lane with the
        span's output, and ``stage(item, slot)``, if given, on the same
        lane with its input, before the dispatch retires."""
        dispatch = dispatch or self.dispatcher.encode

        def flush(items, batch: _Batch) -> None:
            with _StageTimer("dispatch", batch=len(items)):
                handle = dispatch(batch)
            FleetDispatchBatchHistogram.observe(len(items))
            FleetDispatchedBytesCounter.inc(
                float(sum(s.nbytes for s in batch.slots)))
            if stage is not None:
                # enqueued here, in batch order, so per-volume FIFO
                # holds; the slot views keep the batch's buffer alive
                # until written
                for item, slot in zip(items, batch.slots):
                    self._pipe.write(item[0].tag,
                                     functools.partial(stage, item, slot))
            self._pipe.submit(handle, [
                (item[0].tag, functools.partial(retire, item))
                for item in items])

        spans_per_batch = -(-batch_rows // span_rows)
        _drive_batches(_grouped(spans, batch_rows),
                       max(FLEET_READERS, 2 * spans_per_batch),
                       lambda rows: self.dispatcher.batch(rows, width),
                       read, flush)


def _read_span(base: str, offset: int, dest: np.ndarray,
               parent: Optional[int]) -> None:
    """Small rows of one volume's .dat from byte `offset`, read in place
    into its batch slot `dest` [rows, 10, small] and zero-padded past
    EOF: one sequential read per span (``encoder._read_padded`` zeroes
    the tail). Runs on a reader-pool thread, attributed to the 'read'
    stage and parented to the scheduler's root span."""
    with _StageTimer("read", parent=parent, vol=os.path.basename(base)):
        with open(base + ".dat", "rb") as f:
            _encoder._read_padded(f, offset, dest.reshape(-1))


def _read_large_span(base: str, offset: int, stride: int, valid: int,
                     dest: np.ndarray, parent: Optional[int]) -> None:
    """One span of a large row, read in place into its batch slot `dest`
    [10, width]: row i holds the `valid` bytes of the .dat at
    ``offset + i * stride``, then zeros."""
    with _StageTimer("read", parent=parent, vol=os.path.basename(base)):
        with open(base + ".dat", "rb") as f:
            for i in range(DATA_SHARDS):
                _encoder._read_padded(f, offset + i * stride, dest[i, :valid])
        dest[:, valid:] = 0


def fleet_write_ec_files(base_names: Sequence[str], backend: str = "cuda",
                         large_block: int = LARGE_BLOCK_SIZE,
                         small_block: int = SMALL_BLOCK_SIZE,
                         chunk: Optional[int] = None,
                         device=None) -> None:
    """Generate .ec00-.ec13 for MANY volumes, fusing chunks across
    volumes into shared RS dispatches.

    Rows are consumed exactly like the reference encoder
    (ec_encoder.go:194-231): large rows while MORE than 10*large_block
    remains, then zero-padded small rows. A large row goes to the card
    as [1, 10, min(chunk, large_block)] spans; small rows fuse across
    volumes, about `chunk` bytes of them per dispatch (64 MiB on
    "cuda"). `device` binds the fused dispatches to one card (default:
    the current one).
    """
    if chunk is None:
        chunk = default_chunk_for(backend)
    row_bytes = DATA_SHARDS * small_block
    stripe = DATA_SHARDS * large_block
    vols = []
    # creating/truncating 14 output files per volume is write-side IO,
    # so it carries the write stage's span/metric attribution
    with _StageTimer("write", setup=len(base_names)):
        for tag, base in enumerate(base_names):
            size = os.path.getsize(base + ".dat")
            start = max(0, (size - 1) // stripe) * stripe  # large rows
            vols.append(_VolState(base, size, -(-(size - start) // row_bytes),
                                  tag, start))
            for i in range(TOTAL_SHARDS):  # create/truncate all 14 outputs
                open(shard_file_name(base, i), "wb").close()
    alive = [v for v in vols if v.n_rows > 0]
    if not alive:
        return  # all empty: 14 empty shard files each, same as serial
    # One fused dispatch ≈ `chunk` bytes of small rows; span size is the
    # per-volume slice of it, so a full round across the fleet fuses
    # into one dispatch (a single volume gets the whole chunk).
    batch_rows = max(1, chunk // row_bytes)
    span_rows = max(1, batch_rows // len(alive))
    width = min(chunk, large_block)
    large = (((v, r * stripe + c, min(width, large_block - c)), 1)
             for v in alive for r in range(v.start // stripe)
             for c in range(0, large_block, width))
    small = (((v, v.start + row0 * row_bytes, small_block), rows)
             for v, row0, rows in _round_robin_spans(alive, span_rows))

    def stage(item, slot: np.ndarray) -> None:
        # data shards need no parity: they go to the lane at dispatch
        _append_rows(item[0].base, range(DATA_SHARDS), item[2], slot)

    def retire(item, out: np.ndarray) -> None:
        _append_rows(item[0].base, range(DATA_SHARDS, TOTAL_SHARDS),
                     item[2], out)

    with _Pass("encode", backend, device, len(alive)) as p:
        # every large span of a volume is queued before its small rows,
        # and each lane is FIFO, so each shard file gets its large-row
        # bytes first
        p.drive(large, 1, width,
                lambda item, slot: p.read(
                    _read_large_span, item[0].base, item[1], large_block,
                    item[2], slot[0]),
                retire, stage=stage)
        p.drive(small, batch_rows, small_block,
                lambda item, slot: p.read(
                    _read_span, item[0].base, item[1], slot),
                retire, stage=stage, span_rows=span_rows)


# --- fleet rebuild -----------------------------------------------------------

def fleet_rebuild_ec_files(base_names: Sequence[str], backend: str = "cuda",
                           chunk: Optional[int] = None,
                           wanted: Optional[List[int]] = None,
                           device=None) -> Dict[str, List[int]]:
    """Regenerate missing .ecNN from >=10 present ones, for MANY volumes.

    ``wanted`` restricts which missing shards get rebuilt (decode to a
    volume needs only the data shards; reference generateMissingEcFiles,
    ec_encoder.go:88-118). Volumes sharing a (present, missing)
    signature share one decode matrix, so their shard chunks fuse into
    single [B, 10, span] reconstruct dispatches. Tail spans are
    zero-padded to the bucket width (GF maps send 0 to 0) and trimmed on
    writeback. Returns {base_name: rebuilt shard ids} (empty list where
    nothing was missing).

    `chunk` is per shard ROW here: one fused batch is [B, 10, span]
    with B * span ~= chunk, so 10 * chunk bytes of sources (640 MiB of
    pinned staging at the card's 64 MiB default). `device` binds the
    dispatches to one card (default: the current one).
    """
    if chunk is None:
        chunk = default_chunk_for(backend)
    rebuilt: Dict[str, List[int]] = {}
    groups: Dict[Tuple[Tuple[int, ...], Tuple[int, ...]],
                 List[Tuple[str, int]]] = {}
    for base in base_names:
        present = [i for i in range(TOTAL_SHARDS)
                   if os.path.exists(shard_file_name(base, i))]
        missing = [i for i in
                   (range(TOTAL_SHARDS) if wanted is None else wanted)
                   if i not in present]
        rebuilt[base] = missing
        if not missing:
            continue
        if len(present) < DATA_SHARDS:
            raise ValueError(
                f"cannot rebuild {base}: only {len(present)} shards present")
        shard_size = os.path.getsize(shard_file_name(base, present[0]))
        groups.setdefault((tuple(present), tuple(missing)),
                          []).append((base, shard_size))
    for (present, missing), members in groups.items():
        _fleet_rebuild_group(list(present), list(missing), members, backend,
                             chunk, device)
    return rebuilt


def _read_present_span(base: str, present: List[int], shard_size: int,
                       offset: int, dest: np.ndarray,
                       parent: Optional[int] = None) -> None:
    """The [10, span] slice at `offset` of the first 10 present shards,
    read in place into its batch slot `dest` and zeroed past each
    shard's end (the buffer comes uninitialised)."""
    with _StageTimer("read", parent=parent, vol=os.path.basename(base)):
        want = min(dest.shape[1], max(shard_size - offset, 0))
        for row, sid in enumerate(present[:DATA_SHARDS]):
            got = 0
            if want > 0:
                with open(shard_file_name(base, sid), "rb") as f:
                    f.seek(offset)
                    got = f.readinto(memoryview(dest[row])[:want])
            dest[row, got:] = 0


def _fleet_rebuild_group(present: List[int], missing: List[int],
                         members: List[Tuple[str, int]], backend: str,
                         chunk: int, device=None) -> None:
    for base, _ in members:
        for sid in missing:
            open(shard_file_name(base, sid), "wb").close()
    # Uniform span width so spans from different volumes stack into one
    # [B, 10, span] dispatch of ~chunk bytes per shard row, capped at the
    # largest shard so a lone small volume stages no slab of zeros
    span = max(1, min(chunk // len(members),
                      max(size for _, size in members)))
    vols = [_VolState(base, size, -(-size // span), tag)
            for tag, (base, size) in enumerate(members)]
    with _Pass("rebuild", backend, device, len(members)) as p:
        p.drive(_shard_spans(vols, span), len(members), span,
                lambda item, slot: p.read(
                    _read_present_span, item[0].base, present,
                    item[0].dat_size, item[1], slot[0]),
                lambda item, out: _append_rows(item[0].base, missing,
                                               item[2], out),
                dispatch=functools.partial(p.dispatcher.reconstruct,
                                           present, missing))


# --- fleet verify ------------------------------------------------------------

@dataclass
class VerifyResult:
    """Outcome of verifying one volume's EC files.

    parity_mismatch maps a parity shard id (10..13) to its count of
    bytes that differ from the re-encoded parity; first_mismatch holds
    the first differing shard offset per shard. `missing` lists shard
    files absent on disk — those are known damage (the rebuild path's
    job), not verification subjects. A volume with any data shard
    missing cannot be re-encoded and is reported with verified=False.
    """

    parity_mismatch: Dict[int, int] = field(default_factory=dict)
    first_mismatch: Dict[int, int] = field(default_factory=dict)
    missing: List[int] = field(default_factory=list)
    parity_checked: List[int] = field(default_factory=list)
    bytes_verified: int = 0
    spans: int = 0
    verified: bool = True

    @property
    def clean(self) -> bool:
        return self.verified and not self.parity_mismatch \
            and not self.missing


def fleet_verify_ec_files(base_names: Sequence[str], backend: str = "cuda",
                          chunk: Optional[int] = None,
                          throttler=None,
                          device=None) -> Dict[str, "VerifyResult"]:
    """Verify EC stripe consistency for MANY volumes in one fused pass.

    Data shards are re-encoded through the same fleet dispatcher as
    `fleet_write_ec_files` (spans from all volumes fuse into shared
    [B, 10, span] RS dispatches) and the recomputed parity is compared
    byte for byte against the stored .ec10-13 on the host, on each
    volume's writer lane. Nothing on disk is touched; mismatches are
    reported per parity shard (a corrupt DATA shard surfaces as all
    four parity shards disagreeing at the same offsets).

    `throttler` (util.throttler.Throttler) paces the read side so a
    background scrub stays inside its IO budget; `device` binds the
    dispatches to one card (default: the current one).
    """
    if chunk is None:
        chunk = default_chunk_for(backend)
    results: Dict[str, VerifyResult] = {}
    fleet: List[Tuple[str, int, List[int]]] = []  # (base, size, parity ids)
    for base in base_names:
        r = VerifyResult()
        results[base] = r
        present = [i for i in range(TOTAL_SHARDS)
                   if os.path.exists(shard_file_name(base, i))]
        r.missing = [i for i in range(TOTAL_SHARDS) if i not in present]
        data_present = [i for i in present if i < DATA_SHARDS]
        parity_present = [i for i in present if i >= DATA_SHARDS]
        if len(data_present) < DATA_SHARDS or not parity_present:
            # can't re-encode without every data shard (or compare
            # without any parity): known damage, rebuild's job
            r.verified = False
            continue
        r.parity_checked = parity_present
        shard_size = os.path.getsize(shard_file_name(base, 0))
        fleet.append((base, shard_size, parity_present))
    if not fleet:
        return results
    # span: the per-volume slice of one ~chunk-sized fused dispatch,
    # capped at the largest shard so small fleets don't read (and
    # RS-encode) chunk-sized slabs of zero padding per 100KB shard
    span = max(1, min(chunk // max(1, len(fleet)),
                      max(size for _, size, _ in fleet)))
    vols = [(_VolState(base, size, -(-size // span), tag), parity)
            for tag, (base, size, parity) in enumerate(fleet)]
    parity_by_tag = {v.tag: parity for v, parity in vols}
    data_present = list(range(DATA_SHARDS))
    # parity fds cached per volume for the whole pass: each volume's
    # compares run FIFO on ITS writer lane (single reader per fd), and
    # per-span open/close would cost thousands of syscalls per volume
    # once large fleets shrink the span.
    parity_fds: Dict[str, Dict[int, object]] = {}

    def compare(item, out: np.ndarray) -> None:
        """Runs on v's writer lane: recomputed parity [1, 4, span] vs
        the stored parity slices."""
        v, offset, valid = item
        with _StageTimer("verify", vol=os.path.basename(v.base)):
            parity = out[0]
            r = results[v.base]
            for sid in parity_by_tag[v.tag]:
                f = parity_fds[v.base][sid]
                f.seek(offset)
                stored = f.read(valid)
                stored_arr = np.frombuffer(stored, dtype=np.uint8)
                row = parity[sid - DATA_SHARDS][:len(stored_arr)]
                diff = np.nonzero(row != stored_arr)[0]
                if len(diff):
                    r.parity_mismatch[sid] = \
                        r.parity_mismatch.get(sid, 0) + len(diff)
                    # spans retire in offset order on this volume's
                    # lane, so the first recorded hit is the lowest
                    r.first_mismatch.setdefault(sid, offset + int(diff[0]))
                if len(stored_arr) < valid:
                    # a truncated parity shard is missing bytes the
                    # data shards say should exist: every absent byte
                    # is a mismatch, not a free pass
                    r.parity_mismatch[sid] = \
                        r.parity_mismatch.get(sid, 0) + \
                        (valid - len(stored_arr))
                    r.first_mismatch.setdefault(
                        sid, offset + len(stored_arr))
            r.bytes_verified += DATA_SHARDS * valid
            r.spans += 1

    with _Pass("verify", backend, device, len(fleet)) as p:
        # opened inside the pass: an open() racing a concurrent shard
        # delete must still tear the pass down and close earlier fds
        for v, parity in vols:
            fds = parity_fds[v.base] = {}
            for sid in parity:
                fds[sid] = p.closing(open(shard_file_name(v.base, sid), "rb"))

        def read(item, slot: np.ndarray):
            v, offset, _ = item
            if throttler is not None:
                # pace on the read side: one span costs 10 data reads
                # plus the parity reads the compare will issue
                throttler.maybe_slowdown(
                    (DATA_SHARDS + len(parity_by_tag[v.tag])) * span)
            return p.read(_read_present_span, v.base, data_present,
                          v.dat_size, offset, slot[0])

        p.drive(_shard_spans([v for v, _ in vols], span), len(fleet), span,
                read, compare)
    return results
