"""Compile one C++/CUDA source into a shared library at first use.

Libraries land in ``seaweedfs_tpu_torch/_build/`` under a name that carries
a hash of the source and the compiler command, so an edited source is
rebuilt and concurrent processes (test workers) never load a half-written
file: each compiles to a private temporary name and renames it into place.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import List, Tuple

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")


class BuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    """A kernel wrapper's launch was refused: the C entry point returned
    a non-zero cudaError_t. Never demoted to another path."""


def build_shared(source: str, name: str, command: List[str],
                 timeout: float = 600.0) -> Tuple[str, str]:
    """Build ``source`` with ``command + ["-o", out, source]``.

    Returns (library path, compiler output). The output is empty when the
    library was already built. Raises BuildError when the compiler is
    missing or fails.
    """
    with open(source, "rb") as f:
        digest = hashlib.sha256(
            f.read() + "\0".join(command).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    try:
        proc = subprocess.run(command + ["-o", tmp, source],
                              capture_output=True, text=True,
                              timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise BuildError(f"{command[0]}: cannot build {source}: {e}") from e
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise BuildError(f"{' '.join(command)} {source} failed "
                         f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out, log
