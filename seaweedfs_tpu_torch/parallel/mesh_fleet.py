"""The unified mesh scheduler: ONE scheduler feeds every card.

The counterpart of ``seaweedfs_tpu.parallel.mesh_fleet``, with the same
files out and the same ``VerifyResult`` fields. ``fleet_write_ec_files_sharded``
(parallel/mesh.py) runs one independent fleet scheduler per card; this
module runs a single scheduler whose fused ``[dp, rows, lanes]`` buckets
are split over the whole mesh:

  geometry  every bucket of a pass has one shape: dp span slots (spans
            from any volumes), each card's block of lanes padded to a
            multiple of 16 (the kernels' uint4 width), tails zero-padded
            (GF maps send 0 to 0).
  staging   readers fill their slots of the bucket in place; on a mesh of
            cards the bucket is pinned host memory, so a card's contiguous
            block (every block when sp = 1) goes to the card as it lies.
  dispatch  ``_TorchDispatch`` queues, on each card's own side stream, the
            H2D of its ``[b, rows, lanes/sp]`` block, one ``gf_linear``
            launch and what the op chains on the device output; handles
            retire FIFO.
  chaining  verify re-encodes the data shards and compares the parity,
            still on the card, with the stored parity (``gf_compare``):
            only ``[B, 4]`` counts and first offsets come back. Rebuild
            with check decodes (``gf_linear``), assembles the stripe on
            the card, re-encodes it (``gf_linear``) and compares it with
            the surviving parity (``gf_compare``), so a corrupt survivor
            cannot mint corrupt shards.
  combining the per-card results of a lane-split row reach the host and
            are summed (counts) or reduced to the least hit (first
            offsets), as JAX's ``psum`` and global ``argmax`` do.
  hardening ``DEFAULT_TIMEOUT_S`` bounds the wait for a bucket slot
            (capped by the ambient deadline budget); the ``pod_*`` entry
            points fall back to the per-card fleet schedulers on a
            scheduler failure (``MeshError`` and the like), never on a
            fault of a kernel or of the card (``is_kernel_fault``).

Unlike the JAX package, nothing here quantizes shapes: XLA compiled one
program per shape, so ``sharded_reconstruct`` padded its lanes to a
power-of-two grid; the kernels take any shape, so only B is padded to a
multiple of dp and lanes to a multiple of 16 * sp.

The bucket handoff (reader pool -> pack -> dispatch -> FIFO retire ->
per-volume writer lanes) reuses ``ec/fleet.TaggedPipeline`` and takes an
injected dispatch, so the schedule explorer can drive it
(tests/test_torch_mesh.py). Importing this module queries no device and
starts no thread; the default mesh is built at first use.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seaweedfs_tpu_torch.ec import encoder as _encoder
from seaweedfs_tpu_torch.ec import fleet as _fleet
from seaweedfs_tpu_torch.ec.encoder import (
    LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, shard_file_name)
from seaweedfs_tpu_torch.native.builder import BuildError, KernelLaunchError
from seaweedfs_tpu_torch.ops import gf_compare, gf_kernel
from seaweedfs_tpu_torch.ops.rs_code import (
    DATA_SHARDS, TOTAL_SHARDS, coding_matrix)
from seaweedfs_tpu_torch.parallel.mesh import Mesh, decode_matrix, make_mesh
from seaweedfs_tpu_torch.resilience import deadline as deadline_mod
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.stats.metrics import (
    FleetMeshBucketsCounter, FleetMeshFallbacksCounter,
    FleetMeshInflightGauge)

log = logging.getLogger(__name__)

# Bytes of .dat data per fused bucket (before lane padding).
DEFAULT_BUCKET_MB = 32

# Default bound on waiting for a bucket slot (on the slowest in-flight
# dispatch): a wedged card surfaces as MeshError and the pod entry points
# fall back instead of hanging the caller.
DEFAULT_TIMEOUT_S = 30.0

# Encode passes hold 14 output fds per volume; 64 volumes per pass (896
# fds) stay under the default 1024 RLIMIT_NOFILE soft limit. Bigger
# batches run as back-to-back passes.
MAX_VOLUMES_PER_PASS = 64

PARITY_SHARDS = TOTAL_SHARDS - DATA_SHARDS

_INT32_MAX = (1 << 31) - 1

# The kernels load 16 lanes at a time (uint4) only where a row's lane count
# is a multiple of 16: every card's block of a bucket is padded to one.
LANE_ALIGN = 16


class MeshError(RuntimeError):
    """Base: the unified mesh scheduler could not complete the pass."""


class MeshUnavailable(MeshError):
    """No usable multi-card mesh."""


class MeshDispatchTimeout(MeshError):
    """A bucket dispatch exceeded timeout_s / the ambient deadline."""


class MeshVerifyMismatch(MeshError):
    """rebuild(check=True): re-encoded stripes disagree with parity."""


class MeshStats:
    """Per-pass introspection: buckets, live spans and their slots."""

    __slots__ = ("op", "buckets", "spans", "slots", "bytes_in",
                 "wall_s")

    def __init__(self, op: str):
        self.op = op
        self.buckets = 0
        self.spans = 0        # live (non-padding) spans packed
        self.slots = 0        # buckets * dp
        self.bytes_in = 0     # live .dat/.ecNN bytes uploaded
        self.wall_s = 0.0

    @property
    def occupancy(self) -> float:
        """Live spans per bucket slot: 1.0 = every dp slot earned."""
        return self.spans / self.slots if self.slots else 0.0


def _geometry(mesh) -> Tuple[int, int]:
    """(dp, sp) of a Mesh, or a plain (dp, sp) tuple: the seam the
    schedule-explorer tests use to drive the handoff without cards."""
    if isinstance(mesh, tuple):
        return mesh
    return mesh.shape["dp"], mesh.shape["sp"]


def _lanes_for(span_bytes: int, sp: int) -> int:
    unit = LANE_ALIGN * sp
    return -(-span_bytes // unit) * unit


def is_kernel_fault(e: BaseException) -> bool:
    """A failure no scheduler fallback may hide: a kernel that does not
    build or launch, or a fault the card reports later (an asynchronous
    kernel error at synchronize, card memory exhausted while staging).
    The fleet would rerun the work with its compare on the host."""
    if isinstance(e, (BuildError, KernelLaunchError,
                      torch.cuda.OutOfMemoryError)):
        return True
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(e, accelerator_error):
        return True
    return isinstance(e, RuntimeError) and str(e).startswith("CUDA error")


@functools.lru_cache(maxsize=1)
def _default_mesh() -> Mesh:
    """The process-wide mesh over every card, built at first use. One
    card is nothing to shard over: that is MeshUnavailable, and the pod
    entry points take the fleet path."""
    n = torch.cuda.device_count()
    if n < 2:
        raise MeshUnavailable(f"{n} CUDA device(s): nothing to shard over")
    return make_mesh(devices=[torch.device("cuda", i) for i in range(n)])


def _resolve_mesh(mesh):
    if mesh is None:
        try:
            return _default_mesh()
        except MeshUnavailable:
            raise
        except Exception as e:
            raise MeshUnavailable(f"mesh unavailable: {e!r}") from e
    return mesh


# -- the card dispatch ---------------------------------------------------------

class _MeshPending:
    """One bucket's work in flight on every card of the mesh: result()
    waits for each card's event and combines the per-card outputs."""

    def __init__(self, combine: Callable, cards: List[tuple]):
        self._combine = combine
        self._cards = cards   # (i, j, event or None, outputs, inputs)

    def result(self):
        outs = []
        for i, j, event, host_outs, _inputs in self._cards:
            if event is not None:
                event.synchronize()
            outs.append((i, j, [o.numpy() for o in host_outs]))
        self._cards = []      # the pinned inputs may be reused now
        return self._combine(outs)


class _TorchDispatch:
    """Dispatch of one op over the mesh. For each card, its ``[b, rows,
    lanes/sp]`` slab of the bucket goes from pinned memory to the card's
    own side stream, and one ``gf_linear`` launch runs on it; verify
    chains ``gf_compare``, rebuild with check ``gf_linear`` (decode) ->
    stripe assembly -> ``gf_linear`` (re-encode) -> ``gf_compare``. The
    card's outputs go back to pinned memory and an event follows them.
    Buckets made by ``empty`` are pinned already, so a contiguous slab
    is not copied again. A mesh of CPU devices runs the same ops on the
    kernels' plain versions, synchronously."""

    def __init__(self, mesh: Mesh, op: str,
                 rebuild: Optional[Tuple[Tuple[int, ...], Tuple[int, ...],
                                         bool]] = None):
        self._mesh = mesh
        self._op = op
        self._rebuild = rebuild   # (present, missing, check)
        enc = coding_matrix()[DATA_SHARDS:]
        dec = decode_matrix(rebuild[0], rebuild[1]) if rebuild else None
        self._pinned = any(d.type == "cuda" for d in mesh.flat)
        self._cards = []
        for i, row in enumerate(mesh.devices):
            for j, dev in enumerate(row):
                stream = torch.cuda.Stream(dev) if dev.type == "cuda" \
                    else None
                self._cards.append((
                    i, j, dev, stream, gf_kernel.prepare_matrix(enc, dev),
                    None if dec is None else
                    gf_kernel.prepare_matrix(dec, dev)))

    def empty(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        """A bucket array for the readers to fill in place: pinned host
        memory on a mesh of cards (it lives while the array or a view of
        it does), plain memory on a mesh of CPU devices."""
        if not self._pinned:
            return np.empty(shape, dtype=dtype)
        return torch.empty(shape, dtype=torch.uint8 if dtype == np.uint8
                           else torch.int32, pin_memory=True).numpy()

    @staticmethod
    def _host(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
        if dev.type != "cuda" or arr.flags.c_contiguous:
            # the H2D reads a contiguous slab where it lies (pinned when
            # `empty` made the bucket); the pending handle keeps it alive
            return torch.from_numpy(np.ascontiguousarray(arr))
        staged = torch.empty(arr.shape, dtype=torch.uint8 if arr.dtype ==
                             np.uint8 else torch.int32, pin_memory=True)
        staged.numpy()[...] = arr
        return staged

    def __call__(self, bucket: np.ndarray, aux=None) -> _MeshPending:
        dp, sp = _geometry(self._mesh)
        b = bucket.shape[0] // dp
        lanes = bucket.shape[-1]
        n = lanes // sp
        cards = []
        with _fleet._StageTimer("upload", bytes=bucket.nbytes):
            for i, j, dev, stream, enc, dec in self._cards:
                rows = slice(i * b, (i + 1) * b)
                cols = slice(j * n, (j + 1) * n)
                inputs = [self._host(bucket[rows, :, cols], dev)]
                if self._op == "verify":
                    stored, limits = aux
                    inputs += [self._host(stored[rows, :, cols], dev),
                               self._host(limits[rows], dev)]
                ctx = torch.cuda.stream(stream) if stream is not None \
                    else contextlib.nullcontext()
                with ctx:
                    dev_in = [t.to(dev, non_blocking=True) for t in inputs]
                    outs = self._compute(dev_in, enc, dec, j * n, lanes)
                    if stream is None:
                        cards.append((i, j, None, outs, inputs))
                        continue
                    host_outs = []
                    for o in outs:
                        h = torch.empty(o.shape, dtype=o.dtype,
                                        pin_memory=True)
                        h.copy_(o, non_blocking=True)
                        host_outs.append(h)
                    event = torch.cuda.Event()
                    event.record(stream)
                cards.append((i, j, event, host_outs, inputs))
        return _MeshPending(functools.partial(self._combine, dp * b, lanes),
                            cards)

    def _compute(self, x: List[torch.Tensor], enc, dec, offset: int,
                 lanes: int) -> List[torch.Tensor]:
        if self._op == "encode":
            return [gf_kernel.gf_linear(enc, x[0])]
        if self._op == "verify":
            parity = gf_kernel.gf_linear(enc, x[0])
            return list(gf_compare.gf_compare(parity, x[1], x[2], offset))
        present, missing, check = self._rebuild
        src = x[0]
        rebuilt = gf_kernel.gf_linear(
            dec, src[:, :DATA_SHARDS].contiguous())
        if not check:
            return [rebuilt]
        # the full 14-row stripe from survivors + rebuilt rows, on the card
        rows = [src[:, present.index(sid)] if sid in present
                else rebuilt[:, missing.index(sid)]
                for sid in range(TOTAL_SHARDS)]
        want = gf_kernel.gf_linear(
            enc, torch.stack(rows[:DATA_SHARDS], dim=1))
        limits = torch.full(want.shape[:2], lanes, dtype=torch.int32,
                            device=src.device)
        counts, _ = gf_compare.gf_compare(
            want, torch.stack(rows[DATA_SHARDS:], dim=1), limits, offset)
        return [rebuilt, counts.sum(dim=1, dtype=torch.int32)]

    def _combine(self, batch: int, lanes: int, outs):
        """Per-card outputs -> the bucket's: lane blocks side by side,
        verify counts summed and first offsets reduced to the least hit
        (0 where no block hit), check counts summed over sp."""
        if len(outs) == 1:
            parts = outs[0][2]
            return parts[0] if len(parts) == 1 else tuple(parts)
        if self._op == "verify":
            counts = np.zeros((batch, PARITY_SHARDS), dtype=np.int64)
            best = np.full((batch, PARITY_SHARDS), _INT32_MAX, np.int64)
            for i, _j, (c, f) in outs:
                rows = slice(i * c.shape[0], (i + 1) * c.shape[0])
                counts[rows] += c
                best[rows] = np.where(c > 0, np.minimum(best[rows], f),
                                      best[rows])
            return (counts.astype(np.int32),
                    np.where(counts > 0, best, 0).astype(np.int32))
        first = outs[0][2][0]
        n = first.shape[-1]
        out = np.empty((batch, first.shape[1], lanes), dtype=np.uint8)
        bad = np.zeros(batch, dtype=np.int32)
        for i, j, parts in outs:
            b = parts[0].shape[0]
            out[i * b:(i + 1) * b, :, j * n:(j + 1) * n] = parts[0]
            if len(parts) > 1:
                bad[i * b:(i + 1) * b] += parts[1]
        if self._op == "rebuild" and self._rebuild[2]:
            return out, bad
        return out


def sharded_reconstruct(mesh, present: Sequence[int],
                        missing: Sequence[int],
                        src: np.ndarray) -> np.ndarray:
    """One fused ``[B, 10, span]`` reconstruct over the mesh (the
    degraded-read decode fleet's seam with ``use_mesh``). Pads B up to a
    multiple of dp and span up to one of 16 * sp; trims on return."""
    mesh = _resolve_mesh(mesh)
    dp, sp = _geometry(mesh)
    b, rows, span = src.shape
    bp = -(-b // dp) * dp
    lanes = _lanes_for(span, sp)
    if (bp, lanes) != (b, span):
        padded = np.zeros((bp, rows, lanes), dtype=np.uint8)
        padded[:b, :, :span] = src
        src = padded
    out = _TorchDispatch(mesh, "rebuild",
                         (tuple(present), tuple(missing), False))(
        np.ascontiguousarray(src, dtype=np.uint8)).result()
    return out[:b, :, :span]


# -- per-pass machinery -------------------------------------------------------

class _ShardFiles:
    """Per-volume shard fds held open for the whole pass. All of one
    volume's writes run FIFO on one writer lane, so each fd has a single
    writing thread; the outer map is built before any lane starts."""

    def __init__(self, bases: Sequence[str]):
        self._fds: Dict[str, Dict[int, object]] = {b: {} for b in bases}

    def create(self, base: str, sids: Sequence[int]) -> None:
        """Truncate + hold open each of `base`'s output shards."""
        for sid in sids:
            self._fds[base][sid] = open(shard_file_name(base, sid), "wb")

    def write(self, base: str, sid: int, parts: Sequence) -> None:
        f = self._fds[base][sid]
        for p in parts:
            f.write(p)

    def close(self) -> None:
        for fds in self._fds.values():
            for f in fds.values():
                f.close()
            fds.clear()


class _SliceHandle:
    """Adapt one bucket's dispatch output (a _MeshPending, or plain arrays
    or a tuple of them from an injected test dispatch) to TaggedPipeline's
    list-of-per-span-outputs contract: result() resolves the bucket once
    and hands each live slot its slice."""

    def __init__(self, raw, n_live: int):
        self._raw = raw
        self._n = n_live
        self._retired = False

    def _retire_once(self) -> None:
        # result() and abandon() are both called only by the single
        # retire thread, once per handle; the flag guards the gauge
        if not self._retired:
            self._retired = True
            FleetMeshInflightGauge.dec()

    def abandon(self) -> None:
        """Error drain: the retire loop skips result() after a latched
        failure; the bucket still leaves the in-flight gauge."""
        self._retire_once()

    def result(self) -> List:
        try:
            raw = self._raw
            if hasattr(raw, "result"):
                raw = raw.result()
            if isinstance(raw, tuple):  # chained: (counts, firsts) etc.
                parts = [np.asarray(o) for o in raw]
                return [tuple(p[i] for p in parts)
                        for i in range(self._n)]
            out = np.asarray(raw)
            return [out[i] for i in range(self._n)]
        finally:
            self._retire_once()


class _InlineResult:
    __slots__ = ("_v",)

    def __init__(self, v):
        self._v = v

    def result(self):
        return self._v


class _InlinePool:
    """FLEET_READERS = 0: reads run inline on the dispatch loop (no
    futures), so the schedule explorer drives exactly the bucket
    handoff."""

    def submit(self, fn, *args, **kw):
        return _InlineResult(fn(*args, **kw))

    def shutdown(self, wait: bool = True) -> None:
        return None


class _MeshRun:
    """One unified-scheduler pass: ONE reader pool (``FLEET_READERS``),
    ONE dispatch loop, ``FLEET_DEPTH`` in-flight buckets retiring FIFO
    through a TaggedPipeline onto per-volume writer lanes.

    The dispatch loop runs on the CALLER thread; `submit` blocks only
    when the in-flight buckets fill the pipeline, and that wait is
    bounded by ``DEFAULT_TIMEOUT_S`` and the ambient deadline budget."""

    def __init__(self, dispatch: Callable, op: str):
        self._dispatch = dispatch
        self._stats = MeshStats(op)
        self._timeout_s = DEFAULT_TIMEOUT_S
        self.readers = _fleet.FLEET_READERS
        if self.readers <= 0:
            self._pool = _InlinePool()
        else:
            # lint: thread-ok(per-pass reader pool; work items are explicit, no ambient request state)
            self._pool = ThreadPoolExecutor(
                max_workers=self.readers, thread_name_prefix="mesh-read")
        self._pipe = _fleet.TaggedPipeline(depth=max(1, _fleet.FLEET_DEPTH))
        self._abandoned = False
        self._buckets_counter = FleetMeshBucketsCounter.labels(op)
        # bucket arrays the readers fill: pinned on a mesh of cards
        self.empty = getattr(dispatch, "empty", np.empty)

    @property
    def stats(self) -> MeshStats:
        return self._stats

    @property
    def pool(self):
        return self._pool

    def _slot_timeout(self) -> Optional[float]:
        t = self._timeout_s if self._timeout_s > 0 else None
        rem = deadline_mod.remaining()
        if rem is not None:
            if rem <= 0:
                # budget spent mid-pass: finish() must not wait on a
                # drain that can sit behind a wedged dispatch
                self._abandoned = True
                raise deadline_mod.DeadlineExceeded("mesh dispatch")
            t = rem if t is None else min(t, rem)
        return t

    def submit(self, bucket: np.ndarray, aux,
               tagged: Sequence[Tuple[int, Callable]],
               live_bytes: int) -> None:
        st = self._stats
        timeout_s = self._slot_timeout()  # may raise DeadlineExceeded
        with _fleet._StageTimer("dispatch", batch=len(tagged)):
            handle = _SliceHandle(self._dispatch(bucket, aux),
                                  len(tagged))
        st.buckets += 1
        st.spans += len(tagged)
        st.slots += bucket.shape[0]
        st.bytes_in += live_bytes
        self._buckets_counter.inc()
        FleetMeshInflightGauge.inc()
        try:
            self._pipe.submit(handle, tagged, timeout_s=timeout_s)
        except queue.Full:
            self._abandoned = True
            handle.abandon()  # never entered the pipe
            raise MeshDispatchTimeout(
                f"mesh {st.op}: no bucket retired within "
                f"{self._timeout_s}s ({st.buckets} dispatched)")
        except BaseException:
            handle.abandon()  # latched pipeline error: never retires
            raise

    def write(self, tag: int, fn: Callable[[], None]) -> None:
        """Data-shard write on `tag`'s lane, stall-bounded like
        submit()."""
        try:
            self._pipe.write(tag, fn, timeout_s=self._slot_timeout())
        except queue.Full:
            self._abandoned = True
            raise MeshDispatchTimeout(
                f"mesh {self._stats.op}: writer lane {tag} stayed full "
                f"for {self._timeout_s}s")

    def finish(self, error: bool) -> None:
        """Tear down pools; drain the pipeline unless the pass timed out
        (a wedged retire thread cannot be joined: it is daemon and is
        abandoned, the documented fallback contract)."""
        self._pool.shutdown(wait=not self._abandoned)
        if not self._abandoned:
            if error:
                try:
                    self._pipe.drain()
                # lint: swallow-ok(first error already propagating; drain is cleanup)
                except Exception:
                    pass
            else:
                self._pipe.drain()


def _drive_buckets(gen, dp: int, run: _MeshRun, new_bucket: Callable,
                   submit_read: Callable, flush: Callable) -> None:
    """THE fill/pack/flush loop of every op: pull work units off `gen`,
    keep up to max(readers, 2*dp) reads in flight on the run's pool, each
    reading straight into its slot of the bucket its pack ships in (one
    `new_bucket()` per dp units), retire them in submission order and
    hand each full (or final short) pack with its bucket to `flush`,
    which submits its dispatch."""
    inflight: deque = deque()
    prefetch = max(run.readers, 2 * dp)
    filling, slot = None, dp

    def fill() -> None:
        nonlocal filling, slot
        while len(inflight) < prefetch:
            nxt = next(gen, None)
            if nxt is None:
                break
            if slot == dp:
                filling, slot = new_bucket(), 0
            inflight.append((nxt, filling,
                             submit_read(nxt, filling, slot)))
            slot += 1

    fill()
    pack: List = []
    while inflight:
        item, bucket, fut = inflight.popleft()
        fut.result()
        pack.append(item)
        fill()
        if len(pack) == dp or not inflight:
            flush(pack, bucket)
            pack = []


def _span_geometry(dp: int, sp: int,
                   small_block: int) -> Tuple[int, int]:
    """(span_rows, lanes): rows of small_block per span slot, and the
    padded lane width every bucket of the pass shares."""
    bucket_bytes = DEFAULT_BUCKET_MB << 20
    span_rows = max(1, bucket_bytes // (dp * DATA_SHARDS * small_block))
    return span_rows, _lanes_for(span_rows * small_block, sp)


class _FdCache:
    """Per-pass read-side fd cache: one raw O_RDONLY fd per shard file,
    shared by the reader pool; reads go through positionless
    ``os.preadv`` straight into the destination rows."""

    __slots__ = ("_fds", "_lock")

    def __init__(self):
        self._lock = threading.Lock()
        self._fds: Dict[str, int] = {}  # guarded_by(self._lock)

    def fd(self, path: str) -> int:
        with self._lock:
            fd = self._fds.get(path)
            if fd is None:
                fd = os.open(path, os.O_RDONLY)
                self._fds[path] = fd
            return fd

    def pread_into(self, path: str, offset: int, view) -> int:
        """Fill `view` (a writable memoryview) from path@offset; returns
        bytes read (short at EOF)."""
        return os.preadv(self.fd(path), [view], offset)

    def close(self) -> None:
        with self._lock:
            fds = list(self._fds.values())
            self._fds.clear()
        for fd in fds:
            os.close(fd)


def _read_shard_rows(base: str, sids: Sequence[int], shard_size: int,
                     offset: int, dest: np.ndarray, parent: Optional[int],
                     fds: _FdCache) -> None:
    """Fill `dest` [len(sids), lanes] with the slice at `offset` of the
    named shard files, zero past what each file holds (`dest` is a reused
    bucket slot)."""
    with _fleet._StageTimer("read", parent=parent,
                            vol=os.path.basename(base)):
        want = min(dest.shape[1], max(shard_size - offset, 0))
        for row, sid in enumerate(sids):
            got = fds.pread_into(shard_file_name(base, sid), offset,
                                 memoryview(dest[row])[:want]) \
                if want > 0 else 0
            dest[row, got:] = 0


def _read_span_matrix(base: str, row0: int, rows: int, row_bytes: int,
                      small_block: int, dest: np.ndarray,
                      parent: Optional[int]) -> None:
    """Rows [row0, row0+rows) of one .dat as the shard-major
    [10, rows*small_block] matrix, written into the bucket slot `dest`
    [10, lanes]: zero past EOF and past the span."""
    with _fleet._StageTimer("read", parent=parent,
                            vol=os.path.basename(base)):
        buf = np.empty(rows * row_bytes, dtype=np.uint8)
        with open(base + ".dat", "rb") as f:
            _encoder._read_padded(f, row0 * row_bytes, buf)
        w = rows * small_block
        np.copyto(dest[:, :w].reshape(DATA_SHARDS, rows, small_block),
                  buf.reshape(rows, DATA_SHARDS, small_block)
                  .transpose(1, 0, 2))
        dest[:, w:] = 0


# -- encode -------------------------------------------------------------------

def mesh_write_ec_files(base_names: Sequence[str], mesh=None,
                        small_block: int = SMALL_BLOCK_SIZE,
                        _dispatch: Optional[Callable] = None
                        ) -> MeshStats:
    """Encode MANY volumes' .ec00-.ec13 through the unified mesh
    scheduler: one reader pool feeds fixed-shape [dp, 10, lanes] buckets
    (spans from any volumes, round-robin, so per-volume row order holds
    by construction). Byte-identical to `write_ec_files` per volume
    (uniform small rows; oversized volumes are the caller's job, see
    pod_write_ec_files)."""
    if not base_names:
        return MeshStats("encode")
    dat_sizes = {}
    for b in base_names:
        dat_sizes[b] = os.path.getsize(b + ".dat")
        if dat_sizes[b] > DATA_SHARDS * LARGE_BLOCK_SIZE:
            raise ValueError(
                f"{b}.dat needs large-row striping — route through "
                "pod_write_ec_files/write_ec_files")
    if _dispatch is None:
        mesh = _resolve_mesh(mesh)
    dp, sp = _geometry(mesh)
    span_rows, lanes = _span_geometry(dp, sp, small_block)
    row_bytes = DATA_SHARDS * small_block
    vols = [_fleet._VolState(b, dat_sizes[b], -(-dat_sizes[b] // row_bytes),
                             tag)
            for tag, b in enumerate(base_names)]
    dispatch = _dispatch if _dispatch is not None \
        else _TorchDispatch(mesh, "encode")
    run = _MeshRun(dispatch, "encode")
    files = _ShardFiles(base_names)
    t0 = time.perf_counter()
    root = trace.span("fleet.mesh.encode", volumes=len(vols), dp=dp, sp=sp)
    root.__enter__()
    token = root.token()
    ok = False
    try:
        with _fleet._StageTimer("write", setup=len(vols)):
            for v in vols:
                files.create(v.base, range(TOTAL_SHARDS))
        gen = _fleet._round_robin_spans(
            [v for v in vols if v.n_rows > 0], span_rows)

        def new_bucket() -> np.ndarray:
            return run.empty((dp, DATA_SHARDS, lanes), np.uint8)

        def submit_read(item, bucket, slot):
            v, row0, rows = item
            return run.pool.submit(
                _read_span_matrix, v.base, row0, rows, row_bytes,
                small_block, bucket[slot], token)

        def flush(pack, bucket) -> None:
            tagged, live = [], 0
            for slot, (v, _row0, rows) in enumerate(pack):
                w = rows * small_block
                live += w * DATA_SHARDS
                # data shards are straight copies: onto the volume's
                # lane now (pack order == per-volume row order); the
                # view keeps the bucket alive until written
                run.write(v.tag, functools.partial(
                    _write_data_rows, files, v.base, bucket[slot, :, :w]))
                tagged.append((v.tag, functools.partial(
                    _write_parity_rows, files, v.base, w)))
            bucket[len(pack):] = 0
            run.submit(bucket, None, tagged, live)

        _drive_buckets(gen, dp, run, new_bucket, submit_read, flush)
        ok = True
    finally:
        try:
            run.finish(error=not ok)
        finally:
            files.close()
            run.stats.wall_s = time.perf_counter() - t0
            root.__exit__(None, None, None)
    return run.stats


def _write_data_rows(files: _ShardFiles, base: str,
                     m: np.ndarray) -> None:
    for i in range(DATA_SHARDS):
        files.write(base, i, [m[i]])


def _write_parity_rows(files: _ShardFiles, base: str, w: int,
                       out: np.ndarray) -> None:
    """One retired slot's parity [P, lanes]: append the live prefix."""
    for p in range(out.shape[0]):
        files.write(base, DATA_SHARDS + p,
                    [np.ascontiguousarray(out[p, :w])])


# -- verify -------------------------------------------------------------------

def mesh_verify_ec_files(base_names: Sequence[str], mesh=None,
                         throttler=None,
                         _dispatch: Optional[Callable] = None
                         ) -> Dict[str, "_fleet.VerifyResult"]:
    """`fleet_verify_ec_files` on the unified mesh scheduler: data shards
    are re-encoded in sharded buckets and compared against the stored
    parity on the card (``gf_compare`` chained on the ``gf_linear``
    output); only [B, 4] counts and first offsets come home. The results
    equal the fleet verifier's field for field (a truncated parity tail
    counts every absent byte, at retire time on the host)."""
    results: Dict[str, _fleet.VerifyResult] = {}
    live: List[Tuple[str, int, List[int], Dict[int, int]]] = []
    for base in base_names:
        r = _fleet.VerifyResult()
        results[base] = r
        present = [i for i in range(TOTAL_SHARDS)
                   if os.path.exists(shard_file_name(base, i))]
        r.missing = [i for i in range(TOTAL_SHARDS) if i not in present]
        data_present = [i for i in present if i < DATA_SHARDS]
        parity_present = [i for i in present if i >= DATA_SHARDS]
        if len(data_present) < DATA_SHARDS or not parity_present:
            r.verified = False
            continue
        r.parity_checked = parity_present
        sizes = {sid: os.path.getsize(shard_file_name(base, sid))
                 for sid in parity_present}
        live.append((base, os.path.getsize(shard_file_name(base, 0)),
                     parity_present, sizes))
    if not live:
        return results
    if _dispatch is None:
        mesh = _resolve_mesh(mesh)
    dp, sp = _geometry(mesh)
    # per-slot span: a dp-slot slice of one bucket, capped at the largest
    # shard (small fleets must not encode padding slabs)
    span = max(1, min((DEFAULT_BUCKET_MB << 20) // (dp * DATA_SHARDS),
                      max(size for _, size, _, _ in live)))
    lanes = _lanes_for(span, sp)
    vols = [(_fleet._VolState(base, size, -(-size // span) if size else 0,
                              tag), parity, sizes)
            for tag, (base, size, parity, sizes) in enumerate(live)]
    meta = {v.tag: (parity, sizes) for v, parity, sizes in vols}
    dispatch = _dispatch if _dispatch is not None \
        else _TorchDispatch(mesh, "verify")
    run = _MeshRun(dispatch, "verify")
    root = trace.span("fleet.mesh.verify", volumes=len(vols), dp=dp, sp=sp)
    root.__enter__()
    token = root.token()
    t0 = time.perf_counter()
    fds = _FdCache()   # read-side fds cached for the whole pass

    def new_bucket():
        limits = run.empty((dp, PARITY_SHARDS), np.int32)
        limits[...] = 0
        return (run.empty((dp, DATA_SHARDS, lanes), np.uint8),
                run.empty((dp, PARITY_SHARDS, lanes), np.uint8), limits)

    def read_one(v: "_fleet._VolState", offset: int, bucket,
                 slot: int) -> None:
        data, stored, limits = bucket
        parity, sizes = meta[v.tag]
        _read_shard_rows(v.base, range(DATA_SHARDS), v.dat_size, offset,
                         data[slot], token, fds)
        valid = min(span, v.dat_size - offset)
        # stored lanes at and past a row's limit are never compared
        for sid in parity:
            have = min(max(sizes[sid] - offset, 0), valid)
            limits[slot, sid - DATA_SHARDS] = have
            if have > 0:
                fds.pread_into(
                    shard_file_name(v.base, sid), offset,
                    memoryview(stored[slot, sid - DATA_SHARDS])[:have])

    def retire_span(v: "_fleet._VolState", offset: int, out) -> None:
        counts, firsts = out
        parity, sizes = meta[v.tag]
        valid = min(span, v.dat_size - offset)
        with _fleet._StageTimer("verify", vol=os.path.basename(v.base)):
            r = results[v.base]
            for sid in parity:
                k = sid - DATA_SHARDS
                have = min(max(sizes[sid] - offset, 0), valid)
                n = int(counts[k])
                if n:
                    r.parity_mismatch[sid] = \
                        r.parity_mismatch.get(sid, 0) + n
                    r.first_mismatch.setdefault(
                        sid, offset + int(firsts[k]))
                if have < valid:
                    # truncated parity: every absent byte the data
                    # shards vouch for is a mismatch (fleet rule)
                    r.parity_mismatch[sid] = \
                        r.parity_mismatch.get(sid, 0) + (valid - have)
                    r.first_mismatch.setdefault(sid, offset + have)
            r.bytes_verified += DATA_SHARDS * valid
            r.spans += 1

    ok = False
    try:
        gen = ((v, row0 * span) for v, row0, _rows in
               _fleet._round_robin_spans([v for v, _, _ in vols], 1))

        def submit_read(item, bucket, slot):
            v, offset = item
            if throttler is not None:
                parity, _ = meta[v.tag]
                throttler.maybe_slowdown(
                    (DATA_SHARDS + len(parity)) * span)
            return run.pool.submit(read_one, v, offset, bucket, slot)

        def flush(pack, bucket) -> None:
            data, stored, limits = bucket
            tagged, livebytes = [], 0
            for v, offset in pack:
                livebytes += DATA_SHARDS * min(span,
                                               max(v.dat_size - offset, 0))
                tagged.append((v.tag, functools.partial(
                    retire_span, v, offset)))
            data[len(pack):] = 0
            stored[len(pack):] = 0
            run.submit(data, (stored, limits), tagged, livebytes)

        _drive_buckets(gen, dp, run, new_bucket, submit_read, flush)
        ok = True
    finally:
        try:
            run.finish(error=not ok)
        finally:
            fds.close()
            run.stats.wall_s = time.perf_counter() - t0
            root.__exit__(None, None, None)
    return results


# -- rebuild ------------------------------------------------------------------

def mesh_rebuild_ec_files(base_names: Sequence[str], mesh=None,
                          wanted: Optional[List[int]] = None,
                          check: bool = False) -> Dict[str, List[int]]:
    """`fleet_rebuild_ec_files` on the unified mesh scheduler: volumes
    sharing a (present, missing) signature share decode dispatches,
    bucketed over the whole mesh. With check=True every rebuilt slab is
    re-encoded on the card with its stripe and compared against the
    surviving parity; any disagreement unlinks the volume's rebuilt files
    and raises MeshVerifyMismatch."""
    mesh = _resolve_mesh(mesh)
    wanted_set = None if wanted is None else set(wanted)
    rebuilt: Dict[str, List[int]] = {}
    groups: Dict[Tuple[Tuple[int, ...], ...],
                 List[Tuple[str, int]]] = {}
    for base in base_names:
        present = [i for i in range(TOTAL_SHARDS)
                   if os.path.exists(shard_file_name(base, i))]
        absent = [i for i in range(TOTAL_SHARDS) if i not in present]
        write = absent if wanted_set is None \
            else [i for i in absent if i in wanted_set]
        rebuilt[base] = write
        if not write:
            continue
        if len(present) < DATA_SHARDS:
            raise ValueError(
                f"cannot rebuild {base}: only {len(present)} shards "
                "present")
        # check mode re-encodes the FULL stripe against surviving parity,
        # so every absent shard is decoded even when the caller wants
        # only a subset written
        missing = absent if check else write
        shard_size = os.path.getsize(shard_file_name(base, present[0]))
        groups.setdefault((tuple(present), tuple(missing), tuple(write)),
                          []).append((base, shard_size))
    for (present, missing, write), members in groups.items():
        # the same RLIMIT_NOFILE budget as encode/verify
        for i in range(0, len(members), MAX_VOLUMES_PER_PASS):
            _mesh_rebuild_group(mesh, present, missing, write,
                                members[i:i + MAX_VOLUMES_PER_PASS], check)
    return rebuilt


def _mesh_rebuild_group(mesh, present: Tuple[int, ...],
                        missing: Tuple[int, ...],
                        write: Tuple[int, ...],
                        members: List[Tuple[str, int]],
                        check: bool) -> None:
    dp, sp = _geometry(mesh)
    # check mode reads ALL present rows (the recheck needs the stripe's
    # surviving parity); plain rebuild reads only the decode's 10
    n_rows = len(present) if check else DATA_SHARDS
    span = max(1, min((DEFAULT_BUCKET_MB << 20) // (dp * n_rows),
                      max(size for _, size in members)))
    lanes = _lanes_for(span, sp)
    vols = [_fleet._VolState(base, size, -(-size // span) if size else 0,
                             tag)
            for tag, (base, size) in enumerate(members)]
    write_set = set(write)
    bad_vols: List[str] = []
    run = _MeshRun(_TorchDispatch(mesh, "rebuild", (present, missing, check)),
                   "rebuild")
    files = _ShardFiles([base for base, _ in members])
    root = trace.span("fleet.mesh.rebuild", volumes=len(members),
                      dp=dp, sp=sp, check=check)
    root.__enter__()
    token = root.token()
    fds = _FdCache()   # read-side fds cached for the whole pass

    def retire_span(v: "_fleet._VolState", offset: int, out) -> None:
        if check:
            rows, bad = out
            if int(bad):
                bad_vols.append(v.base)
        else:
            rows = out
        valid = min(span, v.dat_size - offset)
        for row, sid in enumerate(missing):
            if sid in write_set:
                files.write(v.base, sid,
                            [np.ascontiguousarray(rows[row, :valid])])

    ok = False
    try:
        for v in vols:
            files.create(v.base, write)
        gen = ((v, row0 * span) for v, row0, _r in
               _fleet._round_robin_spans(vols, 1))

        def new_bucket() -> np.ndarray:
            return run.empty((dp, n_rows, lanes), np.uint8)

        def submit_read(item, bucket, slot):
            v, offset = item
            return run.pool.submit(
                _read_shard_rows, v.base, present[:n_rows], v.dat_size,
                offset, bucket[slot], token, fds)

        def flush(pack, bucket) -> None:
            tagged, livebytes = [], 0
            for v, offset in pack:
                livebytes += n_rows * min(span,
                                          max(v.dat_size - offset, 0))
                tagged.append((v.tag, functools.partial(
                    retire_span, v, offset)))
            bucket[len(pack):] = 0
            run.submit(bucket, None, tagged, livebytes)

        _drive_buckets(gen, dp, run, new_bucket, submit_read, flush)
        ok = True
    finally:
        try:
            run.finish(error=not ok)
        finally:
            fds.close()
            files.close()
            root.__exit__(None, None, None)
    if bad_vols:
        # these rebuilt shards are corrupt reconstructions of ABSENT
        # files: unlink them so no presence scan sees them as servable
        bad = sorted(set(bad_vols))
        for base in bad:
            for sid in write:
                try:
                    os.unlink(shard_file_name(base, sid))
                except FileNotFoundError:
                    pass
        raise MeshVerifyMismatch(
            "rebuilt stripes disagree with surviving parity: " +
            ", ".join(bad))


# -- the pod entry points (fallback ladder) -----------------------------------
#
# the mesh when it can, the per-card fleet schedulers when it cannot, the
# per-volume path for large-row volumes. Only scheduler failures demote:
# a fault of a kernel or of the card (is_kernel_fault) propagates.

def _fallback(op: str, reason: str, exc: Optional[BaseException] = None
              ) -> None:
    FleetMeshFallbacksCounter.labels(reason).inc()
    if exc is not None:
        log.warning("mesh %s fell back (%s): %r — rerunning on the "
                    "per-card fleet schedulers", op, reason, exc)


def _demote(op: str, e: Exception) -> None:
    """Count a failed mesh attempt by its reason."""
    if isinstance(e, MeshUnavailable):
        _fallback(op, "unavailable")
        log.debug("mesh %s unavailable: %s", op, e)
    elif isinstance(e, MeshDispatchTimeout):
        _fallback(op, "timeout", e)
    else:   # any other scheduler failure
        _fallback(op, "error", e)


def _batch_mesh(mesh, n_volumes: int):
    """The mesh to ride, or MeshUnavailable when there is none or the
    batch cannot fill its dp slots."""
    m = _resolve_mesh(mesh)
    dp, _sp = _geometry(m)
    if n_volumes < dp:
        raise MeshUnavailable(f"{n_volumes} volume(s) < dp {dp}")
    return m


def pod_write_ec_files(base_names: Sequence[str], backend: str = "cuda",
                       mesh=None,
                       small_block: int = SMALL_BLOCK_SIZE) -> str:
    """Encode a fleet of volumes on the strongest available scheduler.

    Ladder: (1) oversized volumes take the per-volume large-row path;
    (2) the rest ride the unified mesh scheduler when a multi-card mesh
    exists and the batch fills its dp slots; (3) a MeshError or other
    scheduler failure falls back to the per-card fleet schedulers,
    re-encoding the unfinished volumes from scratch (already-completed
    64-volume chunks are not redone). A fault of a kernel or of the card
    propagates. Returns the path taken: "mesh" | "fleet"."""
    big = [b for b in base_names
           if os.path.getsize(b + ".dat") > DATA_SHARDS * LARGE_BLOCK_SIZE]
    for b in big:
        _encoder.write_ec_files(b, backend=backend,
                                small_block=small_block)
    big_set = set(big)
    rest = [b for b in base_names if b not in big_set]
    if not rest:
        return "fleet"
    done = 0
    try:
        m = _batch_mesh(mesh, len(rest))
        for i in range(0, len(rest), MAX_VOLUMES_PER_PASS):
            mesh_write_ec_files(rest[i:i + MAX_VOLUMES_PER_PASS],
                                mesh=m, small_block=small_block)
            done = i + MAX_VOLUMES_PER_PASS
        return "mesh"
    except deadline_mod.DeadlineExceeded:
        raise   # a spent budget: a fallback can't help
    except Exception as e:  # noqa: BLE001 - any scheduler failure demotes
        if is_kernel_fault(e):
            raise
        _demote("encode", e)
    from seaweedfs_tpu_torch.parallel.mesh import fleet_write_ec_files_sharded

    fleet_write_ec_files_sharded(rest[done:], backend=backend,
                                 small_block=small_block)
    return "fleet"


def pod_verify_ec_files(base_names: Sequence[str], backend: str = "cuda",
                        mesh=None, throttler=None
                        ) -> Dict[str, "_fleet.VerifyResult"]:
    """Verify a fleet on the mesh when possible, with the same ladder as
    pod_write_ec_files (verify writes nothing, so a failed mesh attempt
    simply re-verifies on the fleet)."""
    try:
        m = _batch_mesh(mesh, len(base_names))
        out: Dict[str, _fleet.VerifyResult] = {}
        for i in range(0, len(base_names), MAX_VOLUMES_PER_PASS):
            out.update(mesh_verify_ec_files(
                base_names[i:i + MAX_VOLUMES_PER_PASS], mesh=m,
                throttler=throttler))
        return out
    except deadline_mod.DeadlineExceeded:
        raise
    except Exception as e:  # noqa: BLE001 - any scheduler failure demotes
        if is_kernel_fault(e):
            raise
        _demote("verify", e)
    return _fleet.fleet_verify_ec_files(base_names, backend=backend,
                                        throttler=throttler)
