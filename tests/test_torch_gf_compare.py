"""The port's masked-compare kernel module held against the JAX package.

``seaweedfs_tpu_torch.ops.gf_compare.gf_compare_plain`` (what a CPU tensor
runs, and what the CUDA kernel is compared with on the card) must equal
the XLA program it replaces, ``mesh_fleet._mesh_compare_fn``, exactly:
int32 counts and first indices, over many shapes, limits and mismatch
patterns. The kernel's own arithmetic (16-lane units, per-byte masks under
the limit, the first hit of each thread, the order-free merge of blocks)
is held the same way through a Python model of ``csrc/gf_compare.cu``.
The tolerance is exact integers.
"""

import numpy as np
import pytest
import torch

import jax

from seaweedfs_tpu.parallel import make_mesh as jax_make_mesh
from seaweedfs_tpu.parallel import mesh_fleet as jax_mesh_fleet

from seaweedfs_tpu_torch.native.builder import KernelLaunchError
from seaweedfs_tpu_torch.ops import gf_compare

INT_MAX = (1 << 31) - 1

# (B, P, N): the verify bucket's [B, 4, span] at tiny widths, ragged and
# 16-aligned lanes, and rows of one lane
SHAPES = [(1, 4, 1), (1, 4, 15), (2, 4, 16), (1, 4, 17), (3, 4, 127),
          (2, 4, 128), (1, 1, 1000), (4, 4, 4097), (2, 2, 33)]
PATTERNS = ["random", "none", "first", "last", "at_limit", "dense"]


@pytest.fixture(scope="module")
def jax_compare():
    return jax_mesh_fleet._mesh_compare_fn(
        jax_make_mesh(devices=jax.devices()[:1]))


def _case(shape, pattern, seed):
    """a, b, limits: b differs from a where `pattern` says, limits mix
    0, partial and full."""
    rng = np.random.default_rng(seed)
    b_, p, n = shape
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = a.copy()
    limits = rng.integers(0, n + 1, (b_, p)).astype(np.int32)
    limits.flat[0] = n
    if limits.size > 1:
        limits.flat[-1] = 0
    if n == 0 or pattern == "none":
        hit = np.zeros(shape, dtype=bool)
    elif pattern == "random":
        hit = rng.random(shape) < 0.05
    elif pattern == "dense":
        hit = rng.random(shape) < 0.9
    else:
        hit = np.zeros(shape, dtype=bool)
        for r in np.ndindex(b_, p):
            lane = {"first": 0, "last": n - 1,
                    "at_limit": min(int(limits[r]), n - 1)}[pattern]
            hit[r + (lane,)] = True
            if pattern == "at_limit" and limits[r] > 0:
                hit[r + (int(limits[r]) - 1,)] = True  # last one counted
    b[hit] ^= rng.integers(1, 256, int(hit.sum()), dtype=np.uint8)
    return a, b, limits


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_mesh_compare(jax_compare, shape, pattern):
    a, b, limits = _case(shape, pattern,
                         SHAPES.index(shape) * 10 + PATTERNS.index(pattern))
    counts, firsts = gf_compare.gf_compare(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(limits))
    want_c, want_f = jax_compare(a, b, limits)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(firsts.numpy(), np.asarray(want_f))
    assert counts.dtype == firsts.dtype == torch.int32


def test_plain_matches_jax_on_the_8_device_mesh():
    """The JAX program sharded P('dp', None, 'sp') over 4 x 2 devices:
    its global argmax is what the port's per-block merge must give."""
    compare = jax_mesh_fleet._mesh_compare_fn(jax_make_mesh(8))
    a, b, limits = _case((4, 4, 2 * 777), "random", 5)
    want_c, want_f = compare(a, b, limits)
    got_c, got_f = gf_compare.gf_compare(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(limits))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


def _merge(blocks):
    """The mesh's combine of lane blocks: counts summed, firsts the least
    over the blocks that hit, 0 where none did."""
    counts = sum(c.astype(np.int64) for c, _ in blocks)
    best = np.full(counts.shape, INT_MAX, dtype=np.int64)
    for c, f in blocks:
        best = np.where(c > 0, np.minimum(best, f), best)
    return counts, np.where(counts > 0, best, 0)


@pytest.mark.parametrize("sp", [2, 3, 4, 7])
@pytest.mark.parametrize("pattern", ["random", "last", "at_limit", "none"])
def test_lane_blocks_merge_to_the_whole_row(sp, pattern):
    a, b, limits = _case((3, 4, 7 * 64), pattern, sp)
    n = a.shape[-1] // sp
    blocks = []
    for j in range(sp):
        sl = slice(j * n, (j + 1) * n)
        c, f = gf_compare.gf_compare_plain(
            torch.from_numpy(np.ascontiguousarray(a[..., sl])),
            torch.from_numpy(np.ascontiguousarray(b[..., sl])),
            torch.from_numpy(limits), lane_offset=j * n)
        blocks.append((c.numpy(), f.numpy()))
    whole = gf_compare.gf_compare_plain(
        torch.from_numpy(a[..., :sp * n].copy()),
        torch.from_numpy(b[..., :sp * n].copy()), torch.from_numpy(limits))
    counts, firsts = _merge(blocks)
    np.testing.assert_array_equal(counts, whole[0].numpy())
    np.testing.assert_array_equal(firsts, whole[1].numpy())


def test_zero_lanes_and_zero_rows():
    for shape in [(2, 4, 0), (0, 4, 5)]:
        a = torch.zeros(shape, dtype=torch.uint8)
        c, f = gf_compare.gf_compare(
            a, a.clone(), torch.zeros(shape[:2], dtype=torch.int32))
        assert c.shape == f.shape == shape[:2]
        assert not c.any() and not f.any()


@pytest.mark.parametrize("bad", ["dtype", "shape", "limits_dtype",
                                 "limits_shape", "noncontig", "offset"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    a = torch.zeros((2, 4, 32), dtype=torch.uint8)
    b = a.clone()
    limits = torch.zeros((2, 4), dtype=torch.int32)
    offset = 0
    if bad == "dtype":
        b = b.to(torch.int16)
    elif bad == "shape":
        b = b[..., :16]
    elif bad == "limits_dtype":
        limits = limits.long()
    elif bad == "limits_shape":
        limits = limits[:1]
    elif bad == "noncontig":
        a = torch.zeros((2, 4, 64), dtype=torch.uint8)[..., ::2]
    else:
        offset = INT_MAX
    with pytest.raises(ValueError):
        gf_compare.gf_compare(a, b, limits, offset)


# -- a model of the CUDA kernel -------------------------------------------------

def _kernel_model(a, b, limits, offset, vec, threads=4, grid_x=3):
    """csrc/gf_compare.cu replayed in Python on [R, N] rows: blocks of
    `threads` take 16-lane units by stride, a unit is four little-endian
    words (uint4 loads when `vec`, else bytes below N), ``__vcmpne4`` is
    0xFF per differing byte, the bytes at or past the limit are masked,
    ``__popc >> 3`` counts and ``__ffs`` gives a thread's first hit; the
    blocks merge by sum and min (atomicAdd/atomicMin), and INT_MAX maps
    to 0."""
    rows, n = a.shape
    counts = np.zeros(rows, dtype=np.int64)
    firsts = np.full(rows, INT_MAX, dtype=np.int64)
    for r in range(rows):
        valid = min(n, int(limits[r]) - offset)
        units = (valid + 15) // 16 if valid > 0 else 0
        for bx in range(grid_x):
            for tid in range(threads):
                count, first = 0, INT_MAX
                for u in range(bx * threads + tid, units, grid_x * threads):
                    col = u * 16
                    x = np.zeros(16, dtype=np.uint8)
                    y = np.zeros(16, dtype=np.uint8)
                    take = 16 if vec and col + 16 <= n else min(16, n - col)
                    x[:take] = a[r, col:col + take]
                    y[:take] = b[r, col:col + take]
                    xw, yw = x.view("<u4"), y.view("<u4")
                    left = valid - col
                    for k in range(4):
                        ne = 0
                        for j in range(4):
                            if (int(xw[k]) >> 8 * j) & 0xFF != \
                                    (int(yw[k]) >> 8 * j) & 0xFF:
                                ne |= 0xFF << 8 * j
                        lk = left - 4 * k
                        mask = 0xFFFFFFFF if lk >= 4 else \
                            0 if lk <= 0 else (1 << 8 * lk) - 1
                        m = ne & mask
                        if m:
                            count += bin(m).count("1") >> 3
                            if first == INT_MAX:
                                low = (m & -m).bit_length() - 1
                                first = offset + col + 4 * k + (low >> 3)
                if count:
                    counts[r] += count
                    firsts[r] = min(firsts[r], first)
    return counts, np.where(firsts == INT_MAX, 0, firsts)


@pytest.mark.parametrize("offset", [0, 5, 100])
@pytest.mark.parametrize("n", [1, 15, 16, 33, 100, 256])
@pytest.mark.parametrize("pattern", ["random", "dense", "last", "at_limit"])
def test_kernel_model_matches_plain(n, offset, pattern):
    a, b, limits = _case((2, 3, n), pattern, n + offset)
    limits = (limits + offset).astype(np.int32)   # global positions
    a2, b2 = a.reshape(6, n), b.reshape(6, n)
    want = gf_compare.gf_compare_plain(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(limits),
        lane_offset=offset)
    for vec in ((False, True) if n % 16 == 0 else (False,)):
        counts, firsts = _kernel_model(a2, b2, limits.reshape(-1), offset,
                                       vec)
        np.testing.assert_array_equal(counts, want[0].numpy().reshape(-1))
        np.testing.assert_array_equal(firsts, want[1].numpy().reshape(-1))


# -- on the card -----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(1, 4, 3_355_443), (1, 4, 0)])
@pytest.mark.parametrize("offset", [0, 1 << 20])
def test_cuda_kernel_matches_plain(shape, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for pattern in PATTERNS:
        a, b, limits = _case(shape, pattern, 17)
        a, b = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        lim = torch.from_numpy(limits + offset).cuda()
        before = gf_compare.LAUNCHES
        got = gf_compare.gf_compare(a, b, lim, offset)
        torch.cuda.synchronize()
        assert gf_compare.LAUNCHES == before + 1
        want = gf_compare.gf_compare_plain(a, b, lim, offset)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_kernel_refused_launch_raises(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")

    class _Refusing:
        def gf_compare_launch(self, *args):
            return 1   # cudaErrorInvalidValue

    monkeypatch.setattr(gf_compare, "load", lambda: _Refusing())
    a = torch.zeros((1, 4, 16), dtype=torch.uint8, device="cuda")
    with pytest.raises(KernelLaunchError):
        gf_compare.gf_compare(a, a, torch.zeros((1, 4), dtype=torch.int32,
                                                device="cuda"))
