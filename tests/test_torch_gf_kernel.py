"""The port's GF(2^8) kernel module held against the JAX package.

``seaweedfs_tpu_torch.ops.gf_kernel.gf_linear_plain`` (what a CPU tensor
runs, and what the CUDA kernel is compared with on the card) must equal,
byte for byte, the TPU kernel K1 (``rs_pallas.apply_matrix``, interpret
mode off-TPU), the XLA map X1 (``rs_kernel.apply_matrix``) and the numpy
ground truth. GF arithmetic has no rounding: the tolerance is exact bytes.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as jax_gf256
from seaweedfs_tpu.ops import rs_kernel, rs_pallas
from seaweedfs_tpu.ops import rs_code as jax_rs_code
from seaweedfs_tpu.native import rs_native

import seaweedfs_tpu_torch
from seaweedfs_tpu_torch.native import crc
from seaweedfs_tpu_torch.ops import gf256, gf_kernel

LANES = (0, 1, 127, 128, 32768 + 257)
SHAPES = ((4, 10), (1, 10), (3, 7), (14, 14))


def _rand(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _plain(matrix, data):
    gm = gf_kernel.prepare_matrix(matrix, "cpu")
    return gf_kernel.gf_linear_plain(gm.m2, torch.from_numpy(data)).numpy()


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_numpy_and_xla(shape, lanes):
    rng = np.random.default_rng(100 + lanes + 7 * shape[0])
    m = _rand(rng, shape)
    data = _rand(rng, (shape[1], lanes))
    want = jax_gf256.gf_linear_numpy(m, data)
    np.testing.assert_array_equal(_plain(m, data), want)
    if lanes:
        np.testing.assert_array_equal(rs_kernel.apply_matrix(m, data), want)


@pytest.mark.parametrize("lanes", LANES)
def test_plain_matches_pallas_kernel(lanes):
    """K1 is plane-major, X1 shard-major: the plain version (shard-major
    bit-matrix) equals both."""
    rng = np.random.default_rng(200 + lanes)
    m = _rand(rng, (4, 10))
    data = _rand(rng, (10, lanes))
    np.testing.assert_array_equal(_plain(m, data),
                                  rs_pallas.apply_matrix(m, data))


def test_gf_linear_batched_cpu_equals_rows():
    rng = np.random.default_rng(3)
    m = _rand(rng, (4, 10))
    data = _rand(rng, (3, 2, 10, 200))
    out = gf_kernel.gf_linear(m, torch.from_numpy(data)).numpy()
    assert out.shape == (3, 2, 4, 200)
    np.testing.assert_array_equal(out, jax_gf256.gf_linear_numpy(m, data))


def test_plain_slabs_lanes_exactly():
    rng = np.random.default_rng(4)
    m = _rand(rng, (2, 10))
    data = _rand(rng, (3, 10, 1000))
    gm = gf_kernel.prepare_matrix(m, "cpu")
    out = gf_kernel.gf_linear_plain(gm.m2, torch.from_numpy(data),
                                    max_lanes=700)
    np.testing.assert_array_equal(out.numpy(),
                                  jax_gf256.gf_linear_numpy(m, data))


def test_cpu_tensor_runs_plain_version_without_launch():
    rng = np.random.default_rng(5)
    m = _rand(rng, (4, 10))
    data = torch.from_numpy(_rand(rng, (10, 64)))
    before = gf_kernel.LAUNCHES
    gf_kernel.gf_linear(m, data)
    assert gf_kernel.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "rows", "noncontig", "matrix"])
def test_wrapper_rejects_bad_inputs(bad):
    m = np.ones((4, 10), dtype=np.uint8)
    data = torch.zeros((10, 32), dtype=torch.uint8)
    if bad == "dtype":
        data = data.to(torch.int16)
    elif bad == "rows":
        data = torch.zeros((9, 32), dtype=torch.uint8)
    elif bad == "noncontig":
        data = torch.zeros((32, 10), dtype=torch.uint8).t()
    else:
        m = np.ones((15, 10), dtype=np.uint8)
    with pytest.raises(ValueError):
        gf_kernel.gf_linear(m, data)


def test_prepare_matrix_takes_jax_package_matrices():
    """Carrying state across: the JAX package's own encode and decode
    matrices, fed through prepare_matrix, give the same tables, bit-matrix
    and results as the JAX codec."""
    jrs = jax_rs_code.ReedSolomon(backend="jax")
    rng = np.random.default_rng(6)
    data = _rand(rng, (10, 300))
    full = jrs.encode_all(data)
    present = [0, 2, 3, 4, 6, 7, 8, 9, 10, 12]
    cases = [
        (jax_rs_code.coding_matrix()[10:], data, full[10:]),
        (jrs.decode_matrix(present, [1, 5, 11, 13]), full[present],
         full[[1, 5, 11, 13]]),
        (jrs.decode_matrix(list(range(1, 11)), [0]), full[1:11], full[:1]),
    ]
    for m, src, want in cases:
        gm = gf_kernel.prepare_matrix(m, "cpu")
        np.testing.assert_array_equal(gm.matrix, m)
        np.testing.assert_array_equal(gm.tables.numpy(),
                                      jax_gf256.GF_MUL_TABLE[m])
        np.testing.assert_array_equal(gm.m2.numpy().astype(np.uint8),
                                      jax_gf256.gf256_matrix_to_gf2(m))
        np.testing.assert_array_equal(
            gf_kernel.gf_linear(gm, torch.from_numpy(src)).numpy(), want)


def test_prepare_matrix_cache_keyed_by_bytes():
    a = np.arange(40, dtype=np.uint8).reshape(4, 10)
    b = a.copy()
    b[3, 9] ^= 1
    ga, gb = (gf_kernel.prepare_matrix(x, "cpu") for x in (a, b))
    assert ga is gf_kernel.prepare_matrix(a.copy(), "cpu")
    assert ga is not gb
    assert not torch.equal(ga.tables, gb.tables)


def test_gf256_copy_matches_jax_package():
    np.testing.assert_array_equal(gf256.GF_MUL_TABLE, jax_gf256.GF_MUL_TABLE)
    np.testing.assert_array_equal(gf256.rs_coding_matrix(10, 14),
                                  jax_gf256.rs_coding_matrix(10, 14))
    rng = np.random.default_rng(8)
    m = _rand(rng, (5, 5))
    np.testing.assert_array_equal(gf256.gf256_matrix_to_gf2(m),
                                  jax_gf256.gf256_matrix_to_gf2(m))
    sub = gf256.rs_coding_matrix(10, 14)[[0, 1, 2, 3, 4, 5, 10, 11, 12, 13]]
    np.testing.assert_array_equal(gf256.mat_inv(sub),
                                  jax_gf256.mat_inv(sub))


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 1000, 4099])
def test_crc_library_matches_plain_and_jax_package(size):
    data = _rand(np.random.default_rng(size), size).tobytes()
    want = crc.crc32c_plain(data)
    assert crc.crc32c(data) == want
    assert rs_native.crc32c(data) == want
    assert crc.crc32c(data, 0x1234) == crc.crc32c_plain(data, 0x1234)


def test_crc_known_vector():
    # RFC 3720 B.4: CRC32C of 32 zero bytes
    assert crc.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert crc.crc32c_plain(b"\x00" * 32) == 0x8A9136AA


def test_port_imports_neither_jax_nor_jax_package():
    root = pathlib.Path(seaweedfs_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py"))
    assert len(files) > 15
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "seaweedfs_tpu"), \
                    f"{path.relative_to(root)} imports {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", LANES + (1 << 20,))
def test_cuda_kernel_matches_plain(lanes):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(9 + lanes)
    for shape in SHAPES:
        m = _rand(rng, shape)
        data = torch.from_numpy(_rand(rng, (2, shape[1], lanes))).cuda()
        gm = gf_kernel.prepare_matrix(m, data.device)
        before = gf_kernel.LAUNCHES
        got = gf_kernel.gf_linear(gm, data)
        torch.cuda.synchronize()
        assert gf_kernel.LAUNCHES == before + (1 if lanes else 0)
        assert torch.equal(got, gf_kernel.gf_linear_plain(gm.m2, data))
