"""GF(2^8) linear map: the CUDA kernel's wrapper and its plain version.

``gf_linear(matrix, data)`` computes ``out[..., o, n] = XOR_s
matrix[o, s] * data[..., s, n]`` over GF(2^8) (polynomial 0x11D) for a
``[O, S]`` matrix (O, S <= 14) and ``[..., S, N]`` uint8 data. It is the
one kernel under RS encode, rebuild, degraded reads and decode, and the
port of the TPU kernel ``seaweedfs_tpu/ops/rs_pallas.py::_kernel`` (and of
the XLA map ``rs_kernel.gf_linear``); see ``csrc/gf_linear.cu`` for its
design and bound.

- A CUDA tensor launches the kernel on ``torch.cuda.current_stream()``
  (the codec's side stream when called from ``rs_code``) and bumps
  ``LAUNCHES``. A failed build or launch raises; nothing falls back.
- A CPU tensor goes to ``gf_linear_plain``: bit-plane expansion, a float32
  matmul against the ``[O*8, S*8]`` GF(2) bit-matrix, ``& 1``, pack — the
  formulation of ``rs_kernel.gf_linear_gemm``. It is exact: every dot
  product sums at most S*8 <= 112 ones, integers that float32 (and TF32)
  hold exactly.

The kernel is compiled with nvcc at first use from ``csrc/`` into
``seaweedfs_tpu_torch/_build/`` and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import threading
from dataclasses import dataclass

import numpy as np
import torch

from seaweedfs_tpu_torch.native.builder import (
    PACKAGE_DIR, KernelLaunchError, build_shared)
from seaweedfs_tpu_torch.ops import gf256

MAX_ROWS = 14  # O and S limit of the kernel (shared-memory tables)

# Kernel launches made by gf_linear; a run sets it to 0 and reads it back
# to show that its work went through the kernel.
LAUNCHES = 0

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "gf_linear.cu")

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = ""


def nvcc_command() -> list:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def load() -> ctypes.CDLL:
    """The kernel library, built with nvcc on first call."""
    global _lib, BUILD_LOG
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                path, BUILD_LOG = build_shared(SOURCE, "gf_linear",
                                               nvcc_command())
                lib = ctypes.CDLL(path)
                lib.gf_linear_launch.restype = ctypes.c_int
                lib.gf_linear_launch.argtypes = [
                    ctypes.c_void_p,     # tables [G, S, 2, 16] words
                    ctypes.c_int,        # O
                    ctypes.c_int,        # S
                    ctypes.c_void_p,     # data [B, S, N]
                    ctypes.c_void_p,     # out [B, O, N]
                    ctypes.c_longlong,   # B
                    ctypes.c_longlong,   # N
                    ctypes.c_void_p,     # cudaStream_t
                ]
                _lib = lib
    return _lib


@dataclass(frozen=True)
class GfMatrix:
    """A GF(2^8) matrix prepared for one device."""
    matrix: np.ndarray    # [O, S] uint8 (read-only host copy)
    # [G, S, 2, 16] int32, G = ceil(O / 4): the kernel's packed nibble
    # tables (nibble_tables); byte o of word [g, s, h, v] is
    # m[4g + o, s] * (v << 4h)
    tables: torch.Tensor
    m2: torch.Tensor      # [O*8, S*8] float32 GF(2) bit-matrix, shard-major

    @property
    def rows(self) -> int:
        return self.matrix.shape[0]

    @property
    def cols(self) -> int:
        return self.matrix.shape[1]


def prepare_matrix(matrix, device) -> GfMatrix:
    """Tables and bit-matrix of an ``[O, S]`` uint8 matrix on ``device``.

    Cached by the matrix bytes, shape and device, so every distinct encode
    or decode map gets its own entry and repeat calls reuse device memory.
    """
    m = np.ascontiguousarray(matrix, dtype=np.uint8)
    if m.ndim != 2 or not (1 <= m.shape[0] <= MAX_ROWS
                           and 1 <= m.shape[1] <= MAX_ROWS):
        raise ValueError(f"GF matrix must be [O, S] with 1 <= O, S <= "
                         f"{MAX_ROWS}, got shape {m.shape}")
    return _prepare(m.tobytes(), m.shape, str(torch.device(device)))


@functools.lru_cache(maxsize=128)
def _prepare(matrix_bytes: bytes, shape: tuple, device: str) -> GfMatrix:
    m = np.frombuffer(matrix_bytes, dtype=np.uint8).reshape(shape)
    tables = torch.from_numpy(nibble_tables(m).view(np.int32))
    m2 = torch.from_numpy(gf256.gf256_matrix_to_gf2(m).astype(np.float32))
    return GfMatrix(matrix=m, tables=tables.to(device), m2=m2.to(device))


def nibble_tables(m: np.ndarray) -> np.ndarray:
    """The kernel's tables of an ``[O, S]`` matrix: ``[G, S, 2, 16]``
    uint32, G = ceil(O / 4). Since ``c * x = c * (x & 0x0F) ^ c * (x &
    0xF0)``, byte o (little-endian) of word ``[g, s, h, v]`` is
    ``m[4g + o, s] * (v << 4h)``, and 0 for rows past O."""
    o, s = m.shape
    groups = (o + 3) // 4
    padded = np.zeros((groups * 4, s), dtype=np.uint8)
    padded[:o] = m
    v = np.arange(16, dtype=np.uint8)
    x = np.stack([v, v << 4])                                   # [2, 16]
    prod = gf256.GF_MUL_TABLE[padded[:, :, None, None], x]     # [4G, S, 2, 16]
    prod = prod.reshape(groups, 4, s, 2, 16).transpose(0, 2, 3, 4, 1)
    return np.ascontiguousarray(prod).view("<u4")[..., 0]


def gf_linear(matrix, data: torch.Tensor) -> torch.Tensor:
    """``[O, S]`` matrix (numpy or GfMatrix) applied to ``[..., S, N]``
    uint8 ``data`` -> ``[..., O, N]`` uint8, on ``data``'s device."""
    global LAUNCHES
    gm = matrix if isinstance(matrix, GfMatrix) else \
        prepare_matrix(matrix, data.device)
    if data.dtype != torch.uint8 or data.dim() < 2 or \
            data.shape[-2] != gm.cols:
        raise ValueError(f"data must be uint8 [..., {gm.cols}, N], got "
                         f"{data.dtype} {tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if gm.tables.device != data.device:
        raise ValueError(f"matrix prepared for {gm.tables.device}, data on "
                         f"{data.device}")
    if data.device.type == "cpu":
        return gf_linear_plain(gm.m2, data)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    n = data.shape[-1]
    out = torch.empty(data.shape[:-2] + (gm.rows, n), dtype=torch.uint8,
                      device=data.device)
    if out.numel() == 0:
        return out
    lib = load()
    with torch.cuda.device(data.device):
        err = lib.gf_linear_launch(
            gm.tables.data_ptr(), gm.rows, gm.cols, data.data_ptr(),
            out.data_ptr(), out.numel() // (gm.rows * n), n,
            torch.cuda.current_stream(data.device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"gf_linear kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def gf_linear_plain(m2: torch.Tensor, data: torch.Tensor,
                    max_lanes: int = 1 << 22) -> torch.Tensor:
    """Plain PyTorch GF(2^8) map: ``m2`` is the ``[O*8, S*8]`` bit-matrix
    of ``gf256.gf256_matrix_to_gf2`` (row o*8+k, column s*8+j), ``data``
    ``[..., S, N]`` uint8. Lanes go through in slabs of ``max_lanes`` so
    the float32 bit-planes stay bounded."""
    o8, s8 = m2.shape
    o, s = o8 // 8, s8 // 8
    n = data.shape[-1]
    batch = int(np.prod(data.shape[:-2], dtype=np.int64))
    x = data.reshape(batch, s, n)
    out = torch.empty((batch, o, n), dtype=torch.uint8, device=data.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    weights = (1 << torch.arange(8, device=data.device)).view(1, 1, 8, 1)
    mf = m2.to(device=data.device, dtype=torch.float32)
    step = max(1, max_lanes // max(batch, 1))
    for p in range(0, n, step):
        chunk = x[:, :, p:p + step]
        w = chunk.shape[-1]
        bits = (chunk[:, :, None, :] >> shifts.view(1, 1, 8, 1)) & 1
        acc = torch.matmul(mf, bits.reshape(batch, s * 8, w).float())
        ob = (acc.to(torch.int32) & 1).view(batch, o, 8, w)
        out[:, :, p:p + step] = (ob * weights).sum(dim=2).to(torch.uint8)
    return out.reshape(data.shape[:-2] + (o, n))
