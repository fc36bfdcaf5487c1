"""The port's RS codec on the host (backend="cpu") held against the JAX
package's codec (backend="jax", the XLA path) on the same numpy inputs:
every case of test_rs_kernel.py, exact bytes."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as jax_gf256
from seaweedfs_tpu.ops.rs_code import ReedSolomon as JaxReedSolomon

from seaweedfs_tpu_torch.ops import rs_code
from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon


def rand_shards(rng, shape):
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.fixture(scope="module")
def rs():
    return ReedSolomon(backend="cpu")


@pytest.fixture(scope="module")
def jrs():
    return JaxReedSolomon(backend="jax")


def test_coding_matrix_matches_jax_package(rs, jrs):
    np.testing.assert_array_equal(rs.matrix, jrs.matrix)


def test_encode_matches_reference_backend(rs, jrs):
    rng = np.random.default_rng(10)
    data = rand_shards(rng, (10, 256))
    parity = rs.encode(data)
    assert parity.shape == (4, 256)
    np.testing.assert_array_equal(
        parity, jax_gf256.gf_linear_numpy(rs.matrix[10:], data))
    np.testing.assert_array_equal(parity, jrs.encode(data))


def test_encode_batched(rs, jrs):
    rng = np.random.default_rng(11)
    data = rand_shards(rng, (5, 10, 128))
    parity = rs.encode(data)
    assert parity.shape == (5, 4, 128)
    for b in range(5):
        np.testing.assert_array_equal(parity[b], rs.encode(data[b]))
    np.testing.assert_array_equal(parity, jrs.encode(data))


def test_encode_async_takes_host_tensor(rs):
    rng = np.random.default_rng(19)
    data = rand_shards(rng, (3, 10, 96))
    staged = rs.host_buffer(data.shape)
    staged.numpy()[...] = data
    np.testing.assert_array_equal(rs.encode_async(staged).result(),
                                  rs.encode(data))


def test_verify(rs):
    rng = np.random.default_rng(12)
    data = rand_shards(rng, (10, 64))
    shards = rs.encode_all(data)
    assert rs.verify(shards)
    shards[3, 7] ^= 0xFF
    assert not rs.verify(shards)


@pytest.mark.parametrize("kill", [(0,), (13,), (0, 13), (2, 5, 9, 12),
                                  (10, 11, 12, 13)])
def test_reconstruct_any_4_losses(rs, jrs, kill):
    rng = np.random.default_rng(13)
    data = rand_shards(rng, (10, 96))
    full = rs.encode_all(data)
    shards = [full[i].copy() if i not in kill else None for i in range(14)]
    rs.reconstruct(shards)
    for i in range(14):
        np.testing.assert_array_equal(shards[i], full[i])
    present = [i for i in range(14) if i not in kill]
    np.testing.assert_array_equal(rs.decode_matrix(present, list(kill)),
                                  jrs.decode_matrix(present, list(kill)))


def test_reconstruct_data_only(rs):
    rng = np.random.default_rng(14)
    data = rand_shards(rng, (10, 50))
    full = rs.encode_all(data)
    shards = [full[i].copy() for i in range(14)]
    shards[1] = None
    shards[12] = None
    rs.reconstruct(shards, data_only=True)
    np.testing.assert_array_equal(shards[1], full[1])
    assert shards[12] is None  # parity not requested


def test_reconstruct_unrecoverable_raises(rs):
    rng = np.random.default_rng(15)
    data = rand_shards(rng, (10, 8))
    full = rs.encode_all(data)
    shards = [full[i].copy() for i in range(14)]
    for i in (0, 1, 2, 3, 4):
        shards[i] = None
    with pytest.raises(ValueError):
        rs.reconstruct(shards)


def test_reconstruct_from_parity_heavy_subset(rs, jrs):
    rng = np.random.default_rng(16)
    data = rand_shards(rng, (10, 40))
    full = rs.encode_all(data)
    present = [0, 1, 2, 3, 4, 5, 10, 11, 12, 13]
    out = rs.reconstruct_some(present, [6, 7, 8, 9], full[present])
    np.testing.assert_array_equal(out, full[6:10])
    np.testing.assert_array_equal(
        out, jrs.reconstruct_some(present, [6, 7, 8, 9], full[present]))


def test_decode_cache_never_stale_across_maps(rs):
    """Distinct (present, wanted) pairs get distinct matrices and device
    tables, even when solved back to back."""
    rng = np.random.default_rng(17)
    data = rand_shards(rng, (10, 64))
    full = rs.encode_all(data)
    for kill in ((0,), (1,), (0,), (13,), (1,)):
        present = [i for i in range(14) if i not in kill]
        out = rs.reconstruct_some(present, list(kill), full[present])
        np.testing.assert_array_equal(out, full[list(kill)])


def test_default_backend_is_the_card():
    """ReedSolomon() targets CUDA; without a card it raises instead of
    returning host results."""
    if torch.cuda.is_available():
        assert ReedSolomon().device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        ReedSolomon()
    with pytest.raises(RuntimeError):
        ReedSolomon(backend="cuda")


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        ReedSolomon(backend="numpy")
    assert rs_code.BACKENDS == ("cuda", "cpu")
