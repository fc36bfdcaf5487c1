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


@pytest.mark.parametrize("stack", [False, True])
def test_pack_fills_one_host_buffer(rs, stack):
    """pack() concatenates (or stacks) numpy spans into one host tensor,
    the fused batch the fleets dispatch, and encodes like the parts."""
    rng = np.random.default_rng(20)
    if stack:
        parts = [rand_shards(rng, (10, 33)) for _ in range(3)]
        want = np.stack(parts)
    else:
        parts = [rand_shards(rng, (r, 10, 33)) for r in (2, 1, 4)]
        want = np.concatenate(parts)
    buf = rs.pack(parts, stack=stack)
    assert isinstance(buf, torch.Tensor) and buf.dtype == torch.uint8
    np.testing.assert_array_equal(buf.numpy(), want)
    np.testing.assert_array_equal(rs.encode_async(buf).result(),
                                  rs.encode(want))


def test_concurrent_submits_from_many_threads(rs, jrs):
    """More threads than cores hammer one codec with encodes and decodes
    of distinct maps (the decode fleet's two batch workers share one
    codec), with a shortened GIL switch interval: every output is right
    and the decode cache holds one matrix per map."""
    import os
    import sys
    import threading
    rng = np.random.default_rng(21)
    data = rand_shards(rng, (4, 10, 64))
    full = np.concatenate([data, jrs.encode(data)], axis=1)
    losses = [(0,), (13,), (2, 5), (1, 7, 11), (3, 4, 10, 12)]
    errors = []

    def hammer(seed):
        try:
            order = np.random.default_rng(seed)
            for _ in range(10):
                kill = losses[int(order.integers(len(losses)))]
                present = [i for i in range(14) if i not in kill]
                out = rs.reconstruct_some_async(
                    present, list(kill), full[:, present]).result()
                np.testing.assert_array_equal(out, full[:, list(kill)])
                np.testing.assert_array_equal(
                    rs.encode_async(rs.pack([data])).result(), full[:, 10:])
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(s,))
               for s in range(2 * (os.cpu_count() or 2))]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:1]
    for kill in losses:
        present = tuple(i for i in range(14) if i not in kill)[:10]
        assert rs.decode_matrix(present, kill) is \
            rs._decode_cache[(present, kill)]


@pytest.mark.cuda
def test_one_side_stream_per_codec_under_threads():
    """On the card a codec makes its side stream once, in the
    constructor; submits from two threads all queue on it and retire
    with the right bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import threading
    card = ReedSolomon()
    stream = card._stream
    assert stream is not None
    rng = np.random.default_rng(22)
    data = rand_shards(rng, (3, 10, 4096))
    want = ReedSolomon(backend="cpu").encode(data)
    errors = []

    def hammer():
        try:
            for _ in range(50):
                handle = card.encode_async(card.pack([data]))
                np.testing.assert_array_equal(handle.result(), want)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:1]
    assert card._stream is stream
    assert ReedSolomon()._stream is not stream
