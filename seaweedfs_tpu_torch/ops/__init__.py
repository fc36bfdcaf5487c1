"""GPU compute: GF(2^8) arithmetic, the GF-linear CUDA kernel, the RS codec."""
