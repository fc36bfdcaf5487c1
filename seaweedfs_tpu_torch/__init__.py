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
