"""CRC32-Castagnoli for needle checksums, bound with ctypes.

``crc32c`` runs the g++-built ``crc32c.cpp``; it is on every needle write
and read, where a pure-Python loop (about 1 µs per byte) is unusable.
The library is built at first use and there is no silent fallback: if it
cannot be built, ``load`` raises (``Volume`` calls it when it opens).
``crc32c_plain`` is the table-driven Python version the tests hold the
library against.
"""

from __future__ import annotations

import ctypes
import os
import platform
import threading

from seaweedfs_tpu_torch.native.builder import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "crc32c.cpp")
_lib = None  # guarded_by(_lib_lock, writes)
_lib_lock = threading.Lock()


def _command() -> list:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
    if platform.machine() in ("x86_64", "AMD64"):
        cmd.append("-msse4.2")
    return cmd


def load() -> ctypes.CDLL:
    """The CRC library, built on first call; raises BuildError if g++
    cannot build it."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                path, _ = build_shared(_SRC, "crc32c", _command())
                lib = ctypes.CDLL(path)
                lib.crc32c.restype = ctypes.c_uint32
                lib.crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                                       ctypes.c_longlong]
                _lib = lib
    return _lib


def crc32c(data, value: int = 0) -> int:
    """Castagnoli CRC32 of a bytes-like object."""
    lib = _lib or load()
    if type(data) is not bytes:
        data = bytes(memoryview(data))
    if not data:
        return value
    return int(lib.crc32c(value, data, len(data)))


def _table() -> list:
    tab = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
        tab.append(c)
    return tab


_TABLE = _table()


def crc32c_plain(data, value: int = 0) -> int:
    """Byte-at-a-time table CRC32C: the plain version of ``crc32c``."""
    crc = (~value) & 0xFFFFFFFF
    for b in bytes(memoryview(data)):
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return (~crc) & 0xFFFFFFFF
