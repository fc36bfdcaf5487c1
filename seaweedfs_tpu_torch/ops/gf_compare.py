"""Masked byte compare: the CUDA kernel's wrapper and its plain version.

``gf_compare(a, b, limits, lane_offset)`` holds two ``[..., N]`` uint8
tensors against each other row by row. Lane n of a row sits at the global
position ``lane_offset + n``, and only positions below the row's
``limits`` entry count. It returns ``counts`` (the bytes that differ) and
``firsts`` (the least differing position, 0 where the row matches), both
int32 of ``a.shape[:-1]``. It is the port of the XLA program
``seaweedfs_tpu/parallel/mesh_fleet.py::_mesh_compare_fn`` (mesh verify's
chained compare, and the count of the rebuild check); see
``csrc/gf_compare.cu`` for its design and bound.

- A CUDA tensor launches the kernel on ``torch.cuda.current_stream()`` and
  bumps ``LAUNCHES``. A failed build raises ``BuildError``, a refused
  launch ``KernelLaunchError``; nothing falls back.
- A CPU tensor goes to ``gf_compare_plain``: ``(a != b) & (pos < limits)``
  summed, and the first index by ``argmax`` of the int mask.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Tuple

import torch

from seaweedfs_tpu_torch.native.builder import (
    PACKAGE_DIR, KernelLaunchError, build_shared)
from seaweedfs_tpu_torch.ops.gf_kernel import nvcc_command

# Kernel launches made by gf_compare (one per call on a CUDA tensor).
LAUNCHES = 0

SOURCE = os.path.join(PACKAGE_DIR, "csrc", "gf_compare.cu")

_INT32_MAX = (1 << 31) - 1

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = ""


def load() -> ctypes.CDLL:
    """The kernel library, built with nvcc on first call."""
    global _lib, BUILD_LOG
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                path, BUILD_LOG = build_shared(SOURCE, "gf_compare",
                                               nvcc_command())
                lib = ctypes.CDLL(path)
                lib.gf_compare_launch.restype = ctypes.c_int
                lib.gf_compare_launch.argtypes = [
                    ctypes.c_void_p,     # a [R, N]
                    ctypes.c_void_p,     # b [R, N]
                    ctypes.c_void_p,     # limits [R] int32
                    ctypes.c_void_p,     # counts [R] int32
                    ctypes.c_void_p,     # firsts [R] int32
                    ctypes.c_longlong,   # R
                    ctypes.c_longlong,   # N
                    ctypes.c_longlong,   # lane offset
                    ctypes.c_void_p,     # cudaStream_t
                ]
                _lib = lib
    return _lib


def _check(a: torch.Tensor, b: torch.Tensor, limits: torch.Tensor,
           lane_offset: int) -> None:
    if a.dtype != torch.uint8 or b.dtype != torch.uint8 or a.dim() < 1:
        raise ValueError(f"a and b must be uint8 [..., N], got {a.dtype} "
                         f"and {b.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if limits.dtype != torch.int32 or limits.shape != a.shape[:-1]:
        raise ValueError(f"limits must be int32 {tuple(a.shape[:-1])}, got "
                         f"{limits.dtype} {tuple(limits.shape)}")
    if not (a.device == b.device == limits.device):
        raise ValueError(f"devices differ: {a.device}, {b.device}, "
                         f"{limits.device}")
    if not (a.is_contiguous() and b.is_contiguous()
            and limits.is_contiguous()):
        raise ValueError("a, b and limits must be contiguous")
    if lane_offset < 0 or lane_offset + a.shape[-1] > _INT32_MAX:
        raise ValueError(f"lane positions [{lane_offset}, "
                         f"{lane_offset + a.shape[-1]}) do not fit int32")


def gf_compare(a: torch.Tensor, b: torch.Tensor, limits: torch.Tensor,
               lane_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(counts, firsts)`` of ``a`` against ``b`` under ``limits``, on
    ``a``'s device (see the module docstring)."""
    global LAUNCHES
    _check(a, b, limits, lane_offset)
    if a.device.type == "cpu":
        return gf_compare_plain(a, b, limits, lane_offset)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    counts = torch.empty(limits.shape, dtype=torch.int32, device=a.device)
    firsts = torch.empty(limits.shape, dtype=torch.int32, device=a.device)
    rows = limits.numel()
    if rows == 0:
        return counts, firsts
    lib = load()
    with torch.cuda.device(a.device):
        err = lib.gf_compare_launch(
            a.data_ptr(), b.data_ptr(), limits.data_ptr(),
            counts.data_ptr(), firsts.data_ptr(), rows, a.shape[-1],
            lane_offset, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"gf_compare kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return counts, firsts


def gf_compare_plain(a: torch.Tensor, b: torch.Tensor, limits: torch.Tensor,
                     lane_offset: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ``gf_compare``: the mask ``(a != b) & (pos <
    limits)`` of ``_mesh_compare_fn``, summed, and its first index by
    ``argmax`` (the first maximum) where the row has a hit."""
    n = a.shape[-1]
    if n == 0:
        zeros = torch.zeros(limits.shape, dtype=torch.int32, device=a.device)
        return zeros, zeros.clone()
    pos = torch.arange(lane_offset, lane_offset + n, device=a.device)
    mask = (a != b) & (pos < limits.unsqueeze(-1))
    counts = mask.sum(-1, dtype=torch.int32)
    first = mask.to(torch.uint8).argmax(-1).to(torch.int32) + lane_offset
    return counts, torch.where(counts > 0, first, torch.zeros_like(first))
