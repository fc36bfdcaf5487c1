"""CRC-32C (Castagnoli), the needle checksum, for the benchmark's writer.

``crc32c_bytes`` is the plain byte-serial definition; ``crc32c_many``
computes many ranges of one buffer with ``native/crc32c.c``, built with
the host compiler at first use into ``ecbench/_build/`` under a name that
carries a hash of the source and the command, so a checkout builds it
once. ``masked`` is upstream's stored form of the checksum
(``weed/storage/needle/crc.go``: the snappy-style rotation).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from typing import Sequence

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "native", "crc32c.c")
BUILD_DIR = os.path.join(HERE, "_build")
POLY_REFLECTED = 0x82F63B78

_lib = None


def _table() -> list:
    out = []
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ POLY_REFLECTED if c & 1 else c >> 1
        out.append(c)
    return out


TABLE = _table()


def crc32c_bytes(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked(c):
    """Upstream's stored needle checksum of a CRC-32C (int or uint32/int64
    array)."""
    if isinstance(c, np.ndarray):
        c = c.astype(np.uint64)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _load():
    global _lib
    if _lib is None:
        cmd = ["gcc", "-O3", "-shared", "-fPIC"]
        if platform.machine() in ("x86_64", "AMD64"):
            cmd.append("-msse4.2")
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(cmd).encode()).hexdigest()[:16]
        path = os.path.join(BUILD_DIR, f"libecbench_crc32c-{digest}.so")
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            subprocess.run(cmd + ["-o", tmp, SOURCE], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.crc32c_many.restype = None
        lib.crc32c_many.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_void_p]
        _lib = lib
    return _lib


def crc32c_many(buf: np.ndarray, offsets: Sequence[int],
                lengths: Sequence[int]) -> np.ndarray:
    """uint32 CRC-32C of ``buf[o:o+n]`` for each (o, n) of a flat uint8
    array."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    lens = np.ascontiguousarray(lengths, dtype=np.int64)
    if len(offs) != len(lens) or (len(offs) and (
            offs.min() < 0 or (offs + lens).max() > len(buf))):
        raise ValueError("ranges must lie inside the buffer")
    out = np.zeros(len(offs), dtype=np.uint32)
    _load().crc32c_many(buf.ctypes.data, offs.ctypes.data, lens.ctypes.data,
                        len(offs), out.ctypes.data)
    return out
