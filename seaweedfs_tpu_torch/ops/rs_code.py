"""Reed-Solomon RS(10,4) codec over GF(2^8), on the card or the CPU.

The same API as ``seaweedfs_tpu.ops.rs_code.ReedSolomon`` and the same
systematic Vandermonde-derived coding matrix, so shards are
byte-identical to the JAX package's and the reference's
(weed/storage/erasure_coding/ec_encoder.go:17-23).

Backends:
  - "cuda" (the default): the GF(2^8) map runs as the hand-written kernel
    ``csrc/gf_linear.cu`` (``ops.gf_kernel``). Without a CUDA device the
    constructor raises; it never falls back to the CPU.
  - "cpu": the kernel's plain PyTorch version on host tensors, for tests.

Every encode, rebuild and degraded read is one GF(2^8) linear map: the
decode map is (coding matrix restricted to surviving rows)^-1 composed with
the rows wanted.

On "cuda" the host's share of a map is traced as ``codec.alloc`` (pinned
buffers) and ``codec.submit`` (queueing H2D, kernel, D2H and the event);
the host's wait on the event is timed by its caller (``fleet.retire``).
The copies are counted in ``SeaweedFS_codec_h2d_bytes_total`` and
``SeaweedFS_codec_d2h_bytes_total``, and the host copy made before an
H2D (the staging of a pageable input into pinned memory) in
``SeaweedFS_codec_host_copy_bytes_total``: a caller that reads straight
into a ``host_buffer`` makes none.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import gf256, gf_kernel
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.stats.metrics import (CodecD2HBytesCounter,
                                               CodecH2DBytesCounter,
                                               CodecHostCopyBytesCounter)

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS

BACKENDS = ("cuda", "cpu")

# resolved once: labels() takes a lock per call
_H2D_BYTES = CodecH2DBytesCounter.labels()
_D2H_BYTES = CodecD2HBytesCounter.labels()
_HOST_COPY_BYTES = CodecHostCopyBytesCounter.labels()


def _span(backend: str, name: str):
    """A ``codec.*`` span on "cuda"; the shared no-op on "cpu", which
    stages nothing."""
    return trace.span(name) if backend == "cuda" else trace.NOOP


@functools.lru_cache(maxsize=16)
def coding_matrix(data_shards: int = DATA_SHARDS,
                  total_shards: int = TOTAL_SHARDS) -> np.ndarray:
    m = gf256.rs_coding_matrix(data_shards, total_shards)
    m.setflags(write=False)
    return m


def _codec_device(backend: str, device) -> torch.device:
    """The device a codec computes on: on "cuda" the given card, else the
    current one; on "cpu" the host."""
    want = None if device is None else torch.device(device)
    if want is not None and want.type != backend:
        raise ValueError(f"backend {backend!r} cannot run on {want}")
    if backend == "cpu":
        return want or torch.device("cpu")
    if want is None or want.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return want


class _Resolved:
    """An already-computed result (the CPU backend)."""

    def __init__(self, value: np.ndarray):
        self._value = value

    def result(self) -> np.ndarray:
        return self._value


class PendingApply:
    """A GF map in flight on the codec's side stream: H2D, kernel and D2H
    are queued, and an event is recorded after the D2H. ``result()``
    waits on that event and returns the pinned host output as numpy."""

    def __init__(self, event: torch.cuda.Event, out_host: torch.Tensor,
                 src_host: torch.Tensor):
        self._event = event
        self._out = out_host
        # the staging buffer must outlive the queued H2D
        self._src = src_host

    def result(self) -> np.ndarray:
        self._event.synchronize()
        self._src = None
        return self._out.numpy()


class ReedSolomon:
    def __init__(self, data_shards: int = DATA_SHARDS,
                 parity_shards: int = PARITY_SHARDS,
                 backend: str = "cuda", device=None):
        if data_shards <= 0 or parity_shards < 0:
            raise ValueError("bad shard counts")
        if data_shards > gf_kernel.MAX_ROWS or \
                data_shards + parity_shards > 256:
            raise ValueError("too many shards for the GF(2^8) kernel")
        if backend not in BACKENDS:
            raise ValueError(f"unknown RS backend {backend!r}; "
                             f"expected one of {BACKENDS}")
        if backend == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "RS backend 'cuda' needs a CUDA device and none is "
                "available; pass backend='cpu' to run on the host")
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.matrix = coding_matrix(data_shards, self.total_shards)
        self.backend = backend
        self.device = _codec_device(backend, device)
        # One side stream per codec, made here on the codec's card (the
        # codec itself is made at first use): every dispatch of this codec
        # goes to it, so handles retire in submission order whichever
        # thread submits.
        self._stream: Optional[torch.cuda.Stream] = \
            torch.cuda.Stream(self.device) if backend == "cuda" else None
        self._decode_lock = threading.Lock()
        self._decode_cache: dict = {}  # guarded_by(self._decode_lock)

    # -- host staging --------------------------------------------------------

    def host_buffer(self, shape) -> torch.Tensor:
        """An uninitialised uint8 host tensor to read shard rows into:
        pinned on "cuda", so the H2D copy is a true async DMA. Fill it in
        place through ``.numpy()``."""
        with _span(self.backend, "codec.alloc"):
            return torch.empty(tuple(shape), dtype=torch.uint8,
                               pin_memory=self.backend == "cuda")

    # -- matrix helpers ------------------------------------------------------

    def _decode_matrix(self, present: tuple, wanted: tuple) -> np.ndarray:
        """GF(2^8) map from shards[present[:data_shards]] to shards[wanted]."""
        if len(present) < self.data_shards:
            raise ValueError(
                f"need >= {self.data_shards} shards, have {len(present)}")
        present = present[: self.data_shards]
        key = (present, wanted)
        with self._decode_lock:
            cached = self._decode_cache.get(key)
        if cached is not None:
            return cached
        inv = gf256.mat_inv(self.matrix[list(present)])
        m = gf256.mat_mul(self.matrix[list(wanted)], inv)
        m.setflags(write=False)
        with self._decode_lock:
            if len(self._decode_cache) < 512:
                m = self._decode_cache.setdefault(key, m)
        return m

    # -- linear-map dispatch -------------------------------------------------

    def _submit(self, matrix: np.ndarray, shards):
        """Queue ``matrix`` applied to ``[..., S, N]`` shards (numpy or a
        host tensor); returns a handle with ``.result()`` -> numpy."""
        host = torch.from_numpy(np.ascontiguousarray(shards, dtype=np.uint8)) \
            if isinstance(shards, np.ndarray) else shards.contiguous()
        if host.dtype != torch.uint8 or host.device.type != "cpu":
            raise ValueError("shards must be uint8 on the host")
        if self.backend == "cpu":
            gm = gf_kernel.prepare_matrix(matrix, self.device)
            return _Resolved(gf_kernel.gf_linear(gm, host).numpy())
        # pageable memory would make the H2D a synchronous staged copy
        staged = None if host.is_pinned() else self.host_buffer(host.shape)
        with trace.span("codec.alloc"):
            out_host = torch.empty(
                host.shape[:-2] + (matrix.shape[0], host.shape[-1]),
                dtype=torch.uint8, pin_memory=True)
        with trace.span("codec.submit"):
            # the matrix tables upload here on a cache miss (a few KB)
            gm = gf_kernel.prepare_matrix(matrix, self.device)
            if staged is not None:
                staged.copy_(host)
                _HOST_COPY_BYTES.inc(host.numel())
                host = staged
            with torch.cuda.stream(self._stream):
                dev = host.to(self.device, non_blocking=True)
                out = gf_kernel.gf_linear(gm, dev)
                out_host.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
        _H2D_BYTES.inc(host.numel())
        _D2H_BYTES.inc(out_host.numel())
        return PendingApply(event, out_host, host)

    def _apply(self, matrix: np.ndarray, shards) -> np.ndarray:
        return self._submit(matrix, shards).result()

    def _check_data(self, data):
        if data.shape[-2] != self.data_shards:
            raise ValueError(f"expected {self.data_shards} data shards")

    # -- public API ----------------------------------------------------------

    def encode(self, data) -> np.ndarray:
        """data: [..., D, N] uint8 -> parity [..., P, N] uint8."""
        return self.encode_async(data).result()

    def encode_async(self, data):
        """Pipelined encode: returns a handle whose ``.result()`` gives the
        parity. On "cuda" the work is queued on the codec's side stream
        and the caller is free to do host IO until it asks for the result.
        ``data`` may be numpy or a (pinned) host tensor from
        ``host_buffer``."""
        if isinstance(data, np.ndarray):
            data = np.asarray(data, dtype=np.uint8)
        self._check_data(data)
        return self._submit(self.matrix[self.data_shards:], data)

    def encode_all(self, data) -> np.ndarray:
        """data: [..., D, N] -> all shards [..., D+P, N]."""
        data = np.asarray(data, dtype=np.uint8)
        return np.concatenate([data, self.encode(data)], axis=-2)

    def verify(self, shards) -> bool:
        """shards: [..., D+P, N]; True iff parity matches data."""
        shards = np.asarray(shards, dtype=np.uint8)
        if shards.shape[-2] != self.total_shards:
            raise ValueError(f"expected {self.total_shards} shards")
        parity = self.encode(shards[..., : self.data_shards, :])
        return bool(np.array_equal(parity, shards[..., self.data_shards:, :]))

    def decode_matrix(self, present: Sequence[int],
                      wanted: Sequence[int]) -> np.ndarray:
        """The GF(2^8) map shards[present[:D]] -> shards[wanted]
        (read-only)."""
        return self._decode_matrix(tuple(present), tuple(wanted))

    def reconstruct_some(self, present: Sequence[int], wanted: Sequence[int],
                         shard_data) -> np.ndarray:
        """Compute shards ``wanted`` from shards ``present``.

        shard_data: [..., len(present), N] uint8, rows ordered like
        ``present``. Only the first ``data_shards`` rows are used.
        """
        return self.reconstruct_some_async(present, wanted,
                                           shard_data).result()

    def reconstruct_some_async(self, present: Sequence[int],
                               wanted: Sequence[int], shard_data):
        """``reconstruct_some`` with the same handle contract as
        ``encode_async``."""
        m = self._decode_matrix(tuple(present), tuple(wanted))
        if isinstance(shard_data, np.ndarray):
            shard_data = np.asarray(shard_data, dtype=np.uint8)
        return self._submit(m, shard_data[..., : self.data_shards, :])

    def reconstruct(self, shards: list, data_only: bool = False) -> list:
        """Fill in the missing (None) entries of a full shard list in place
        (reference ec_encoder.go:233-287 Reconstruct/ReconstructData)."""
        if len(shards) != self.total_shards:
            raise ValueError(f"expected list of {self.total_shards}")
        present = [i for i, s in enumerate(shards) if s is not None]
        limit = self.data_shards if data_only else self.total_shards
        missing = [i for i in range(limit) if shards[i] is None]
        if not missing:
            return shards
        if len(present) < self.data_shards:
            raise ValueError(
                f"unrecoverable: only {len(present)} of {self.data_shards} "
                "required shards present")
        src = np.stack([np.asarray(shards[i], dtype=np.uint8)
                        for i in present[: self.data_shards]], axis=-2)
        out = self.reconstruct_some(present, missing, src)
        for row, idx in enumerate(missing):
            shards[idx] = np.ascontiguousarray(out[..., row, :])
        return shards
