"""PyTorch/CUDA port of seaweedfs_tpu's erasure-coding path.

One volume goes through RS(10,4) erasure coding on an NVIDIA GPU via the
same store-level entry points the volume server calls
(``ec.store_ec``): encode, rebuild of lost shards, degraded needle reads
and decode back to a volume. The GF(2^8) linear map that carries all of
them is a hand-written CUDA kernel (``csrc/gf_linear.cu``, wrapped by
``ops.gf_kernel``).

The package imports torch and numpy only; it keeps its own copies of the
storage formats it needs. Entry points default to the card
(``backend="cuda"``); ``backend="cpu"`` runs the kernels' plain PyTorch
versions and exists for tests.
"""

# the JAX package's version: both print "seaweedfs-tpu <version>"
__version__ = "0.1.0"

import os as _os

if _os.environ.get("SEAWEED_SANITIZE"):
    # arm the runtime concurrency sanitizer BEFORE any submodule
    # creates its module-level locks, so they are wrapped too; when
    # the env var is unset this whole block is one dict lookup
    # (tests/test_torch_perf_gates.py)
    from seaweedfs_tpu_torch.util import sanitizer as _sanitizer  # noqa: F401
