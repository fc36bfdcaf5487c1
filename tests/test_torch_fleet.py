"""The port's fleet schedulers (``seaweedfs_tpu_torch.ec.fleet``) held
against the JAX package's (``seaweedfs_tpu.ec.fleet``) and its
per-volume encoder.

The port runs ``backend="cpu"`` (the kernel's plain version on the
"cpu" encode pool) and, through a codec that reports ``"cuda"`` but
computes on the host, the card's fused path: one async dispatch per
batch, of the buffer its readers filled in place. The JAX package runs
``backend="numpy"``; the in-place staging is also held to the plain
numpy codec (``gf256.gf_linear_numpy``). The tolerance is
exact byte equality, and ``VerifyResult`` fields must be equal. Small
geometry (LARGE=2048, SMALL=256) keeps volumes a few KB while still
covering multi-row packing, tail padding, the oversized-volume fallback
and pipeline depth > 1.
"""

import dataclasses
import filecmp
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu import ec as jax_ec
from seaweedfs_tpu.ec import fleet as jax_fleet
from seaweedfs_tpu.ec import store_ec as jax_store_ec
from seaweedfs_tpu.storage.store import Store as JaxStore

from seaweedfs_tpu_torch.ec import encoder, fleet, store_ec
from seaweedfs_tpu_torch.ec.encoder import shard_file_name
from seaweedfs_tpu_torch.ops import gf256
from seaweedfs_tpu_torch.ops.rs_code import (
    DATA_SHARDS, TOTAL_SHARDS, ReedSolomon, coding_matrix)
from seaweedfs_tpu_torch.resilience import failpoint
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.stats.metrics import FleetDispatchBatchHistogram
from seaweedfs_tpu_torch.storage.needle import Needle, NeedleError
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.util.throttler import Throttler

LARGE = 2048
SMALL = 256
ROW = DATA_SHARDS * SMALL

# empty, sub-row, exact row, multi-row with a ragged tail, and (30 KiB >
# 10 * LARGE) the per-volume large-row fallback
SIZES = [0, 1, 700, ROW, 3 * ROW + 123, 30 << 10]


def _make_volumes(root, sizes, seed=0):
    rng = np.random.default_rng(seed)
    bases = []
    for i, size in enumerate(sizes):
        base = os.path.join(str(root), f"{i}")
        with open(base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        bases.append(base)
    return bases


def _twins(bases, tag):
    """Hard-link each .dat under a sibling name for another encoder."""
    out = []
    for base in bases:
        twin = f"{base}.{tag}"
        os.link(base + ".dat", twin + ".dat")
        out.append(twin)
    return out


def _copy_shards(bases, tag):
    out = []
    for base in bases:
        twin = f"{base}.{tag}"
        for sid in range(TOTAL_SHARDS):
            p = shard_file_name(base, sid)
            if os.path.exists(p):
                shutil.copy(p, shard_file_name(twin, sid))
        out.append(twin)
    return out


def _assert_shards_equal(got_bases, want_bases):
    for g, w in zip(got_bases, want_bases):
        for sid in range(TOTAL_SHARDS):
            gp, wp = shard_file_name(g, sid), shard_file_name(w, sid)
            assert os.path.exists(gp) == os.path.exists(wp), gp
            if os.path.exists(gp):
                assert filecmp.cmp(gp, wp, shallow=False), \
                    f"shard {sid} of {os.path.basename(g)} differs"


def _port_encode(bases, **kw):
    fleet.fleet_write_ec_files(bases, backend="cpu", large_block=LARGE,
                               small_block=SMALL, **kw)


def _jax_encode(bases, chunk=512):
    jax_fleet.fleet_write_ec_files(bases, backend="numpy",
                                   large_block=LARGE, small_block=SMALL,
                                   chunk=chunk)


def _base_tensor(arr):
    """The torch tensor at the end of a numpy view's .base chain."""
    while arr is not None and not isinstance(arr, torch.Tensor):
        arr = arr.base
    return arr


class _CardShapedCodec:
    """Stands in for ``ReedSolomon("cuda")`` on a host without a card: it
    reports backend "cuda", so the fleet takes its fused async path (the
    readers fill one ``host_buffer`` per batch, one async dispatch per
    batch), and computes on the port's CPU codec. It records every
    dispatch and refuses the synchronous calls the card path must not
    make."""

    backend = "cuda"
    made = []

    def __init__(self, backend="cuda", device=None):
        self._rs = ReedSolomon(backend="cpu")
        self.dispatches = []
        self.outputs = []
        _CardShapedCodec.made.append(self)

    def host_buffer(self, shape):
        return self._rs.host_buffer(shape)

    def _record(self, kind, data, handle):
        assert isinstance(data, torch.Tensor), "batch was not staged"
        self.dispatches.append((kind, tuple(data.shape)))
        outer = self

        class _Handle:
            def result(self):
                out = handle.result()
                outer.outputs.append(out)
                return out

        return _Handle()

    def encode_async(self, data):
        return self._record("encode", data, self._rs.encode_async(data))

    def reconstruct_some_async(self, present, missing, data):
        return self._record("reconstruct", data,
                            self._rs.reconstruct_some_async(
                                present, missing, data))

    def encode(self, data):
        raise AssertionError("the card path dispatches async only")

    reconstruct_some = encode


@pytest.fixture
def card_shaped(monkeypatch):
    """The fleet's codec becomes _CardShapedCodec; records the thread
    pools the fleet makes, by name."""
    _CardShapedCodec.made = []
    pools = []
    real_pool = fleet.ThreadPoolExecutor

    def pool(*a, **kw):
        pools.append(kw.get("thread_name_prefix"))
        return real_pool(*a, **kw)

    monkeypatch.setattr(fleet, "ReedSolomon", _CardShapedCodec)
    monkeypatch.setattr(fleet, "ThreadPoolExecutor", pool)
    return pools


def _batches():
    return FleetDispatchBatchHistogram.labels().count


# --- encode ------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [512, 3 * ROW, 1 << 20])
def test_fleet_encode_matches_jax_fleet_and_serial(tmp_path, chunk):
    bases = _make_volumes(tmp_path, SIZES)
    jax_bases = _twins(bases, "jax")
    serial = _twins(bases, "serial")
    _port_encode(bases, chunk=chunk)
    _jax_encode(jax_bases)
    for t in serial:
        jax_ec.write_ec_files(t, backend="numpy", large_block=LARGE,
                              small_block=SMALL, chunk=512)
    _assert_shards_equal(bases, jax_bases)
    _assert_shards_equal(bases, serial)


def test_fleet_encode_single_volume_matches_port_serial(tmp_path):
    """A fleet of one is the port's serial path (``write_ec_files``):
    held to the JAX package's per-volume encoder."""
    bases = _make_volumes(tmp_path, [3 * ROW + 5])
    serial = _twins(bases, "serial")
    jax_ec.write_ec_files(serial[0], backend="numpy", large_block=LARGE,
                          small_block=SMALL, chunk=512)
    encoder.write_ec_files(bases[0], backend="cpu", large_block=LARGE,
                           small_block=SMALL, chunk=512)
    _assert_shards_equal(bases, serial)


def test_fleet_encode_parity_rows_verify(tmp_path):
    """Several dispatches in flight per volume (chunk < one row, the
    default depth of 2): every row's parity must verify against that same
    row's data, which an out-of-order retire would break."""
    bases = _make_volumes(tmp_path, [5 * ROW + 7, 2 * ROW, 7 * ROW + 1111],
                          seed=5)
    _port_encode(bases, chunk=512)
    rs = ReedSolomon(backend="cpu")
    for base in bases:
        shards = [open(shard_file_name(base, i), "rb").read()
                  for i in range(TOTAL_SHARDS)]
        n_rows = len(shards[0]) // SMALL
        assert n_rows > 1
        for r in range(n_rows):
            row = np.stack([np.frombuffer(s[r * SMALL:(r + 1) * SMALL],
                                          dtype=np.uint8) for s in shards])
            assert rs.verify(row), f"row {r} of {base} fails verify"


@pytest.mark.parametrize("chunk", [3 * ROW, 1 << 20])
def test_card_path_one_fused_dispatch_per_batch(tmp_path, card_shaped, chunk):
    """The "cuda" dispatcher issues ONE async encode for each batch's
    one host buffer; no host encode pool exists; and the
    per-span outputs the writer lanes hold are views that keep the
    codec's output tensor alive."""
    bases = _make_volumes(tmp_path, SIZES[:5] + [2 * ROW + 9], seed=3)
    jax_bases = _twins(bases, "jax")
    before = _batches()
    fleet.fleet_write_ec_files(bases, large_block=LARGE, small_block=SMALL,
                               chunk=chunk)
    _jax_encode(jax_bases)
    _assert_shards_equal(bases, jax_bases)
    (codec,) = _CardShapedCodec.made
    assert "fleet-encode" not in card_shaped
    assert len(codec.dispatches) == _batches() - before > 0
    assert all(kind == "encode" and shape[1:] == (DATA_SHARDS, SMALL)
               for kind, shape in codec.dispatches)
    # a batch fuses spans of several volumes into one dispatch
    alive = sum(1 for s in SIZES[:5] + [1] if s)
    rows = sum(-(-s // ROW) for s in SIZES[:5] + [2 * ROW + 9])
    assert max(shape[0] for _, shape in codec.dispatches) > 1
    assert sum(shape[0] for _, shape in codec.dispatches) == rows
    assert len(codec.dispatches) < alive * 3
    staged = codec.host_buffer((3, DATA_SHARDS, 8))
    staged.numpy()[:2], staged.numpy()[2:] = 0, 1
    handle = fleet._SplitHandle(codec.encode_async(staged), [2, 1])
    parts = handle.result()
    assert [p.shape for p in parts] == [(2, 4, 8), (1, 4, 8)]
    assert all(_base_tensor(p) is _base_tensor(parts[0]) is not None
               for p in parts)


@pytest.mark.parametrize("chunk", [512, 3 * ROW])
def test_large_row_volume_in_a_fleet_matches_jax(tmp_path, card_shaped,
                                                 chunk):
    """Volumes over 10 * LARGE (one and two large rows, then a small-row
    tail) ride one fleet with small volumes: the card gets each large
    row as [1, 10, min(chunk, LARGE)] spans and the tails as small rows,
    and every shard is the JAX per-volume encoder's."""
    sizes = [2 * ROW + 7, 10 * LARGE + 5 * ROW, 700, 20 * LARGE + 999]
    bases = _make_volumes(tmp_path, sizes, seed=15)
    serial = _twins(bases, "serial")
    fleet.fleet_write_ec_files(bases, large_block=LARGE, small_block=SMALL,
                               chunk=chunk)
    for t in serial:
        jax_ec.write_ec_files(t, backend="numpy", large_block=LARGE,
                              small_block=SMALL, chunk=512)
    _assert_shards_equal(bases, serial)
    (codec,) = _CardShapedCodec.made
    width = min(chunk, LARGE)
    large = [shape for _, shape in codec.dispatches if shape[2] != SMALL]
    assert large == [(1, DATA_SHARDS, width)] * (3 * LARGE // width)
    small = [shape for _, shape in codec.dispatches if shape[2] == SMALL]
    assert sum(rows for rows, _, _ in small) == 3 + 5 + 1 + 1


def test_cpu_path_uses_the_host_encode_pool(tmp_path, monkeypatch):
    pools = []
    real_pool = fleet.ThreadPoolExecutor

    def pool(*a, **kw):
        pools.append(kw.get("thread_name_prefix"))
        return real_pool(*a, **kw)

    monkeypatch.setattr(fleet, "ThreadPoolExecutor", pool)
    bases = _make_volumes(tmp_path, [2 * ROW, ROW + 3], seed=4)
    _port_encode(bases, chunk=512)
    assert sorted(pools) == ["fleet-encode", "fleet-read"]
    assert fleet._Dispatcher(ReedSolomon(backend="cpu"))._pool is not None


def test_fleet_encode_byte_identical_under_tracing(tmp_path):
    bases = _make_volumes(tmp_path, [2 * ROW + 1, 3 * ROW], seed=6)
    jax_bases = _twins(bases, "jax")
    trace.enable()
    trace.clear()
    try:
        _port_encode(bases, chunk=ROW)
        names = {s.name for s in trace.spans()}
    finally:
        trace.disable()
        trace.clear()
    _jax_encode(jax_bases)
    _assert_shards_equal(bases, jax_bases)
    assert {"fleet.encode", "fleet.read", "fleet.dispatch", "fleet.retire",
            "fleet.write", "fleet.rs"} <= names


# --- rebuild -----------------------------------------------------------------

DROPS = ([0, 13], [0, 13], [3], [1, 2, 11, 12])  # the first two share a group


def _encoded(tmp_path, sizes, seed):
    bases = _make_volumes(tmp_path, sizes, seed=seed)
    _port_encode(bases, chunk=512)
    originals = {(b, sid): open(shard_file_name(b, sid), "rb").read()
                 for b in bases for sid in range(TOTAL_SHARDS)}
    return bases, originals


@pytest.mark.parametrize("chunk", [512, 1 << 20])
def test_fleet_rebuild_matches_jax(tmp_path, chunk):
    bases, originals = _encoded(tmp_path, [2 * ROW + 17, 2 * ROW + 17, ROW,
                                           4 * ROW], seed=2)
    for base, drop in zip(bases, DROPS):
        for sid in drop:
            os.remove(shard_file_name(base, sid))
    jax_bases = _copy_shards(bases, "jax")
    got = fleet.fleet_rebuild_ec_files(bases, backend="cpu", chunk=chunk)
    want = jax_fleet.fleet_rebuild_ec_files(jax_bases, backend="numpy",
                                            chunk=chunk)
    assert [got[b] for b in bases] == [want[b] for b in jax_bases] == \
        [list(d) for d in DROPS]
    _assert_shards_equal(bases, jax_bases)
    for b in bases:
        for sid in range(TOTAL_SHARDS):
            assert open(shard_file_name(b, sid), "rb").read() == \
                originals[(b, sid)]


def test_fleet_rebuild_wanted_partial_matches_jax(tmp_path):
    bases, originals = _encoded(tmp_path, [3 * ROW + 200, 3 * ROW + 200],
                                seed=3)
    for base in bases:
        for sid in (0, 7, 11, 13):
            os.remove(shard_file_name(base, sid))
    jax_bases = _copy_shards(bases, "jax")
    wanted = list(range(DATA_SHARDS))
    got = fleet.fleet_rebuild_ec_files(bases, backend="cpu", chunk=512,
                                       wanted=wanted)
    want = jax_fleet.fleet_rebuild_ec_files(jax_bases, backend="numpy",
                                            chunk=512, wanted=wanted)
    assert [got[b] for b in bases] == [want[b] for b in jax_bases] == \
        [[0, 7], [0, 7]]
    _assert_shards_equal(bases, jax_bases)
    for b in bases:
        for sid in (0, 7):
            assert open(shard_file_name(b, sid), "rb").read() == \
                originals[(b, sid)]
        for sid in (11, 13):
            assert not os.path.exists(shard_file_name(b, sid))


def test_fleet_rebuild_too_few_shards_raises(tmp_path):
    bases, _ = _encoded(tmp_path, [2 * ROW], seed=4)
    for sid in range(5):
        os.remove(shard_file_name(bases[0], sid))
    jax_bases = _copy_shards(bases, "jax")
    with pytest.raises(ValueError):
        fleet.fleet_rebuild_ec_files(bases, backend="cpu", chunk=512)
    with pytest.raises(ValueError):
        jax_fleet.fleet_rebuild_ec_files(jax_bases, backend="numpy",
                                         chunk=512)


def test_card_path_rebuild_stacks_one_dispatch_per_batch(tmp_path,
                                                         card_shaped):
    bases, originals = _encoded(tmp_path, [2 * ROW + 17, 2 * ROW + 17, ROW,
                                           4 * ROW], seed=2)
    for base, drop in zip(bases, DROPS):
        for sid in drop:
            os.remove(shard_file_name(base, sid))
    _CardShapedCodec.made.clear()
    card_shaped.clear()
    fleet.fleet_rebuild_ec_files(bases, chunk=2 * SMALL)
    for b in bases:
        for sid in range(TOTAL_SHARDS):
            assert open(shard_file_name(b, sid), "rb").read() == \
                originals[(b, sid)]
    assert "fleet-encode" not in card_shaped
    # one codec per (present, missing) group; each batch [B, 10, span]
    assert len(_CardShapedCodec.made) == 3
    spans = {(2 * SMALL) // 2, 2 * SMALL}
    for codec in _CardShapedCodec.made:
        assert codec.dispatches
        for kind, shape in codec.dispatches:
            assert kind == "reconstruct" and shape[1] == DATA_SHARDS
            assert shape[2] in spans
    fused = _CardShapedCodec.made[0]
    assert all(shape[0] == 2 for _, shape in fused.dispatches[:-1])


# --- verify ------------------------------------------------------------------

def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x5A]))


DAMAGE = {
    "clean": lambda base: None,
    "parity_byte": lambda base: _flip(base + ".ec11", 777),
    "data_byte": lambda base: _flip(base + ".ec04", 1234),
    "truncated_parity": lambda base: os.truncate(
        base + ".ec10", os.path.getsize(base + ".ec10") // 2),
    "missing_data": lambda base: os.remove(base + ".ec03"),
    "missing_parity": lambda base: os.remove(base + ".ec12"),
}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
@pytest.mark.parametrize("chunk", [3 * SMALL, 1 << 20])
def test_fleet_verify_matches_jax(tmp_path, damage, chunk):
    """Verify reads and never writes, so both packages verify the same
    files; every VerifyResult field must agree."""
    bases, _ = _encoded(tmp_path, [6 * ROW + 40, 2 * ROW, 3 * ROW + 5, 1],
                        seed=8)
    DAMAGE[damage](bases[0])
    got = fleet.fleet_verify_ec_files(bases, backend="cpu", chunk=chunk)
    want = jax_fleet.fleet_verify_ec_files(bases, backend="numpy",
                                           chunk=chunk)
    assert {b: dataclasses.asdict(r) for b, r in got.items()} == \
        {b: dataclasses.asdict(r) for b, r in want.items()}
    for b in bases[1:]:
        assert got[b].clean and got[b].spans > 0 and \
            got[b].bytes_verified >= os.path.getsize(b + ".dat")
    r = got[bases[0]]
    shard = os.path.getsize(shard_file_name(bases[0], 0))
    if damage == "clean":
        assert r.clean and r.parity_checked == [10, 11, 12, 13]
    elif damage == "parity_byte":
        assert r.parity_mismatch == {11: 1} and r.first_mismatch == {11: 777}
    elif damage == "data_byte":
        # a corrupt data shard shows as all four parity shards at once
        assert r.parity_mismatch == {10: 1, 11: 1, 12: 1, 13: 1}
        assert r.first_mismatch == dict.fromkeys((10, 11, 12, 13), 1234)
    elif damage == "truncated_parity":
        assert r.parity_mismatch == {10: shard - shard // 2}
        assert r.first_mismatch == {10: shard // 2}
    elif damage == "missing_data":
        assert not r.verified and r.missing == [3] and r.spans == 0
    else:
        assert r.missing == [12] and r.parity_checked == [10, 11, 13]
        assert not r.parity_mismatch and not r.clean


def test_card_path_verify_matches_host(tmp_path, card_shaped):
    bases, _ = _encoded(tmp_path, [6 * ROW + 40, 2 * ROW, 3 * ROW + 5],
                        seed=9)
    _flip(bases[1] + ".ec13", 5)
    _flip(bases[2] + ".ec00", 2 * SMALL + 3)
    _CardShapedCodec.made.clear()
    card_shaped.clear()
    got = fleet.fleet_verify_ec_files(bases, chunk=3 * SMALL)
    want = jax_fleet.fleet_verify_ec_files(bases, backend="numpy",
                                           chunk=3 * SMALL)
    assert {b: dataclasses.asdict(r) for b, r in got.items()} == \
        {b: dataclasses.asdict(r) for b, r in want.items()}
    assert got[bases[1]].parity_mismatch == {13: 1}
    assert sorted(got[bases[2]].parity_mismatch) == [10, 11, 12, 13]
    (codec,) = _CardShapedCodec.made
    assert "fleet-encode" not in card_shaped
    assert all(shape[0] == 3 for _, shape in codec.dispatches[:-1])


def test_fleet_verify_throttled_reads(tmp_path):
    bases, _ = _encoded(tmp_path, [4 * ROW, ROW], seed=10)
    paced = Throttler(limit_mbps=1024)
    got = fleet.fleet_verify_ec_files(bases, backend="cpu", chunk=2 * SMALL,
                                      throttler=paced)
    assert all(r.clean for r in got.values())
    assert Throttler(0).disabled and Throttler(0).tokens() == float("inf")


# --- in-place staging --------------------------------------------------------

# unequal shards (6, 2, 4 and 1 rows of SMALL); the chunks leave a short
# last batch: encode 13 rows in batches of 4, verify and rebuild ten
# 384-byte spans (ragged against every shard) in batches of 4
STAGED = [5 * ROW + 40, 2 * ROW, 3 * ROW + 5, 700]
STAGED_CHUNK = {"encode": 4 * ROW, "verify": 4 * 384, "rebuild": 4 * 384}


def _numpy_shards(base):
    """A small-row volume's 14 shards from its .dat by the plain numpy
    codec: rows of 10 x SMALL, zero-padded, parity by gf_linear_numpy."""
    dat = np.fromfile(base + ".dat", dtype=np.uint8)
    rows = np.zeros(-(-len(dat) // ROW) * ROW, dtype=np.uint8)
    rows[:len(dat)] = dat
    data = rows.reshape(-1, DATA_SHARDS, SMALL).transpose(1, 0, 2) \
        .reshape(DATA_SHARDS, -1)
    return np.concatenate(
        [data, gf256.gf_linear_numpy(coding_matrix()[DATA_SHARDS:], data)])


def _shard(base, sid):
    return np.fromfile(shard_file_name(base, sid), dtype=np.uint8)


@pytest.fixture
def staging(monkeypatch):
    """Host buffers come back filled with 0xA5, as reused pinned memory
    does; every slot a reader filled is kept as (base, the shards read
    or None for the .dat, offset, bytes), and every dispatched batch as (buffer rows, filled rows,
    slots)."""
    real_buffer = ReedSolomon.host_buffer
    monkeypatch.setattr(ReedSolomon, "host_buffer",
                        lambda self, shape: real_buffer(self, shape)
                        .fill_(0xA5))
    got = {"reads": [], "batches": []}
    real_span, real_present = fleet._read_span, fleet._read_present_span
    real_dispatch = fleet._Dispatcher._dispatch

    def read_span(base, offset, dest, parent):
        real_span(base, offset, dest, parent)
        got["reads"].append((base, None, offset, dest.reshape(-1).copy()))

    def read_present(base, present, shard_size, offset, dest, parent=None):
        real_present(base, present, shard_size, offset, dest, parent)
        got["reads"].append((base, present, offset, dest.copy()))

    def dispatch(self, batch, *a):
        got["batches"].append((batch.buf.shape[0], batch.rows,
                               len(batch.slots)))
        return real_dispatch(self, batch, *a)

    monkeypatch.setattr(fleet, "_read_span", read_span)
    monkeypatch.setattr(fleet, "_read_present_span", read_present)
    monkeypatch.setattr(fleet._Dispatcher, "_dispatch", dispatch)
    return got


@pytest.mark.parametrize("op", ["encode", "rebuild", "verify"])
def test_staged_batches_match_numpy_and_jax(tmp_path, staging, op):
    """Each pass reads straight into its batch's buffer: shards and
    verdicts equal the JAX package's and the numpy codec's; every slot
    holds exactly its volume's bytes, zero past the .dat's or shard's
    end however the buffer came; each buffer is sized to its batch, and
    the last batch is short."""
    chunk = STAGED_CHUNK[op]
    if op == "encode":
        bases = _make_volumes(tmp_path, STAGED, seed=13)
        jax_bases = _twins(bases, "jax")
        _port_encode(bases, chunk=chunk)
        _jax_encode(jax_bases)
        _assert_shards_equal(bases, jax_bases)
        for b in bases:
            want = _numpy_shards(b)
            for sid in range(TOTAL_SHARDS):
                assert np.array_equal(_shard(b, sid), want[sid])
    else:
        bases, _ = _encoded(tmp_path, STAGED, seed=13)
        # the staging fixture also saw set-up's encode: count from here
        staging["reads"].clear()
        staging["batches"].clear()
    if op == "rebuild":
        for b in bases:
            for sid in (2, 11):
                os.remove(shard_file_name(b, sid))
        jax_bases = _copy_shards(bases, "jax")
        got = fleet.fleet_rebuild_ec_files(bases, backend="cpu", chunk=chunk)
        jax_fleet.fleet_rebuild_ec_files(jax_bases, backend="numpy",
                                         chunk=chunk)
        assert all(got[b] == [2, 11] for b in bases)
        _assert_shards_equal(bases, jax_bases)
        for b in bases:
            want = _numpy_shards(b)
            for sid in range(TOTAL_SHARDS):
                assert np.array_equal(_shard(b, sid), want[sid])
    if op == "verify":
        _flip(bases[0] + ".ec12", 1000)
        _flip(bases[2] + ".ec05", 900)
        got = fleet.fleet_verify_ec_files(bases, backend="cpu", chunk=chunk)
        want = jax_fleet.fleet_verify_ec_files(bases, backend="numpy",
                                               chunk=chunk)
        assert {b: dataclasses.asdict(r) for b, r in got.items()} == \
            {b: dataclasses.asdict(r) for b, r in want.items()}
        for b in bases:
            disk = np.stack([_shard(b, sid) for sid in range(TOTAL_SHARDS)])
            parity = gf256.gf_linear_numpy(coding_matrix()[DATA_SHARDS:],
                                           disk[:DATA_SHARDS])
            counts, firsts = {}, {}
            for p in range(parity.shape[0]):
                diff = np.nonzero(parity[p] != disk[DATA_SHARDS + p])[0]
                if len(diff):
                    counts[DATA_SHARDS + p] = len(diff)
                    firsts[DATA_SHARDS + p] = int(diff[0])
            assert (got[b].parity_mismatch, got[b].first_mismatch) == \
                (counts, firsts)
        assert sorted(got[bases[2]].parity_mismatch) == [10, 11, 12, 13]
    # every slot: its volume's bytes, then zeros to the slot's end
    assert staging["reads"]
    for base, present, offset, slot in staging["reads"]:
        if present is None:  # an encode's span of the .dat
            src = [np.fromfile(base + ".dat", dtype=np.uint8)[offset:]]
            slot = [slot]
        else:
            src = [_shard(base, sid)[offset:]
                   for sid in present[:DATA_SHARDS]]
        for want, row in zip(src, slot):
            valid = min(len(want), len(row))
            assert np.array_equal(row[:valid], want[:valid])
            assert not row[valid:].any()
    # one exactly-sized buffer per batch; the last batch is short
    batches = staging["batches"]
    assert all(cap == rows for cap, rows, _ in batches)
    assert sum(n for *_, n in batches) == len(staging["reads"])
    assert batches[-1][2] < batches[0][2]


@pytest.mark.parametrize("path", ["cpu", "card_shaped"])
def test_one_volume_rebuild_stages_no_wider_than_its_shard(
        tmp_path, monkeypatch, request, path):
    """A lone volume's rebuild submits [1, 10, shard size], not a
    chunk-wide batch of zeros."""
    bases, originals = _encoded(tmp_path, [3 * ROW + 5], seed=14)
    shard = os.path.getsize(shard_file_name(bases[0], 0))
    for sid in (4, 12):
        os.remove(shard_file_name(bases[0], sid))
    shapes = []
    real_submit = ReedSolomon._submit

    def submit(self, matrix, shards):
        shapes.append(tuple(shards.shape))
        return real_submit(self, matrix, shards)

    monkeypatch.setattr(ReedSolomon, "_submit", submit)
    if path == "card_shaped":
        request.getfixturevalue("card_shaped")
    chunk = 1 << 20
    fleet.fleet_rebuild_ec_files(bases, backend="cpu", chunk=chunk)
    assert shard < chunk and shapes == [(1, DATA_SHARDS, shard)]
    for sid in (4, 12):
        assert open(shard_file_name(bases[0], sid), "rb").read() == \
            originals[(bases[0], sid)]


# --- store level --------------------------------------------------------------

def _fill(store, vids, seed=9):
    rng = np.random.default_rng(seed)
    for vid in vids:
        store.add_volume(vid)
        v = store.find_volume(vid)
        for i in range(1, 6):
            v.write_needle(Needle(
                id=i, cookie=0x20 + i,
                data=rng.integers(0, 256, int(rng.integers(100, 4000)),
                                  dtype=np.uint8).tobytes()))


def test_generate_ec_shards_batch_matches_jax(tmp_path):
    store = Store([str(tmp_path / "port")])
    jstore = JaxStore([str(tmp_path / "jax")], ip="127.0.0.1", port=8080)
    try:
        _fill(store, (1, 2, 3))
        jdir = jstore.locations[0].directory
        for vid in (1, 2, 3):
            base = store.find_volume(vid).file_name()
            store.find_volume(vid).sync()
            for ext in (".dat", ".idx"):
                shutil.copy(base + ext, os.path.join(jdir, f"{vid}{ext}"))
        jstore.locations[0].load_existing_volumes()
        bases = store_ec.generate_ec_shards_batch(store, [1, 2, 3],
                                                  backend="cpu")
        jbases = jax_store_ec.generate_ec_shards_batch(jstore, [1, 2, 3],
                                                       backend="numpy")
        assert sorted(bases) == sorted(jbases) == [1, 2, 3]
        for vid in (1, 2, 3):
            _assert_shards_equal([bases[vid]], [jbases[vid]])
            assert filecmp.cmp(bases[vid] + ".ecx", jbases[vid] + ".ecx",
                               shallow=False)
            assert store.find_volume(vid).read_only
        # and equal to the port's per-volume generate on the same files
        twin = os.path.join(str(tmp_path), "twin")
        for ext in (".dat", ".idx"):
            os.link(bases[2] + ext, twin + ext)
        encoder.write_ec_files(twin, backend="cpu")
        encoder.write_sorted_file_from_idx(twin)
        _assert_shards_equal([bases[2]], [twin])
    finally:
        store.close()
        jstore.close()


def test_generate_ec_shards_batch_unknown_vid_freezes_nothing(tmp_path):
    store = Store([str(tmp_path)])
    try:
        _fill(store, (1, 2))
        with pytest.raises(NeedleError):
            store_ec.generate_ec_shards_batch(store, [1, 99, 2],
                                              backend="cpu")
        for vid in (1, 2):
            assert not store.find_volume(vid).read_only
            assert not os.path.exists(store.find_volume(vid).file_name()
                                      + ".ec00")
    finally:
        store.close()


def _ec_files_of(base):
    exts = [f".ec{i:02d}" for i in range(TOTAL_SHARDS)] + \
        [".ecx", ".dat", ".idx"]
    return {ext: open(base + ext, "rb").read() for ext in exts
            if os.path.exists(base + ext)}


@pytest.mark.parametrize("entry", ["generate_ec_shards", "rebuild_ec_shards",
                                   "ec_shards_to_volume"])
def test_single_volume_entry_points_run_the_fleet(tmp_path, entry):
    """Each one-volume store entry runs the fleet, under its root span,
    and leaves the files the JAX package's same call leaves."""
    store = Store([str(tmp_path / "port")])
    jstore = JaxStore([str(tmp_path / "jax")], ip="127.0.0.1", port=8080)
    try:
        _fill(store, (1,))
        base = store.find_volume(1).file_name()
        store.find_volume(1).sync()
        jdir = jstore.locations[0].directory
        for ext in (".dat", ".idx"):
            shutil.copy(base + ext, os.path.join(jdir, "1" + ext))
        jstore.locations[0].load_existing_volumes()
        jbase = os.path.join(jdir, "1")
        if entry != "generate_ec_shards":
            store_ec.generate_ec_shards(store, 1, backend="cpu")
            jax_store_ec.generate_ec_shards(jstore, 1, backend="numpy")
            if entry == "ec_shards_to_volume":
                store.location_of(1).delete_volume(1)
                jstore.location_of(1).delete_volume(1)
            for b in (base, jbase):
                for sid in (2, 11):
                    os.remove(shard_file_name(b, sid))
        trace.enable()
        trace.clear()
        try:
            getattr(store_ec, entry)(store, 1, backend="cpu")
            names = {s.name for s in trace.spans()}
        finally:
            trace.disable()
            trace.clear()
        getattr(jax_store_ec, entry)(jstore, 1, backend="numpy")
        assert ("fleet.encode" if entry == "generate_ec_shards"
                else "fleet.rebuild") in names
        got, want = _ec_files_of(base), _ec_files_of(jbase)
        assert sorted(got) == sorted(want)
        assert all(got[ext] == want[ext] for ext in got), entry
    finally:
        store.close()
        jstore.close()


def test_generate_ec_shards_batch_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    store = Store([str(tmp_path)])
    try:
        _fill(store, (1,))
        with pytest.raises(RuntimeError):
            store_ec.generate_ec_shards_batch(store, [1])
    finally:
        store.close()


# --- failure handling ------------------------------------------------------

def test_fleet_dispatch_failpoint_fails_the_pass(tmp_path):
    bases = _make_volumes(tmp_path, [3 * ROW, 2 * ROW], seed=11)
    failpoint.arm("fleet.dispatch", "error", count=1, match={"op": "encode"})
    try:
        with pytest.raises(failpoint.FailpointError):
            _port_encode(bases, chunk=512)
        assert failpoint.active()[0]["count"] == 0
    finally:
        failpoint.disarm()
    assert not failpoint._armed
    # disarmed, the same pass succeeds
    jax_bases = _twins(bases, "jax")
    _port_encode(bases, chunk=512)
    _jax_encode(jax_bases)
    _assert_shards_equal(bases, jax_bases)


def test_failpoint_grammar_matches_jax_package():
    from seaweedfs_tpu.resilience import failpoint as jax_failpoint
    conf = ("fleet.dispatch{op=rebuild}=delay(0.5)@0.25*3;"
            "fleet.dispatch=error*1")
    try:
        failpoint.arm_from_string(conf)
        jax_failpoint.arm_from_string(conf)
        assert failpoint.active() == jax_failpoint.active()
    finally:
        failpoint.disarm()
        jax_failpoint.disarm()


class _Failing:
    def result(self):
        raise OSError("dispatch failed")


class _Ready:
    def __init__(self, outs):
        self.outs = outs

    def result(self):
        return self.outs


def test_tagged_pipeline_latches_the_first_error():
    """A handle that fails latches the pipeline: nothing after it is
    written (lanes also drop writes still queued when it latches),
    submit() raises, and drain() re-raises."""
    done = []
    pipe = fleet.TaggedPipeline(depth=1, writers=2)
    pipe.submit(_Ready([1, 2]), [(0, done.append), (1, done.append)])
    pipe.submit(_Failing(), [(0, done.append)])
    with pytest.raises(OSError):
        for _ in range(1000):   # until the retire thread latches
            pipe.submit(_Ready([3]), [(0, done.append)])
    with pytest.raises(OSError, match="dispatch failed"):
        pipe.drain()
    assert set(done) <= {1, 2}


def test_tagged_pipeline_handoff_explored():
    """The retire -> writer-lane handoff under 20 seeded schedules of
    the port's schedule explorer: per-tag writes stay FIFO and
    every output lands on its own tag."""
    from seaweedfs_tpu_torch.util import scheduler

    def one_pass():
        got = {0: [], 1: [], 2: []}
        lock = threading.Lock()

        def put(tag, value):
            with lock:
                got[tag].append(value)

        pipe = fleet.TaggedPipeline(depth=2, writers=2)
        for i in range(4):
            pipe.write(i % 3, lambda i=i: put(i % 3, ("data", i)))
            pipe.submit(_Ready([i, i + 10]),
                        [(i % 3, lambda v, i=i: put(i % 3, ("par", v))),
                         ((i + 1) % 3,
                          lambda v, i=i: put((i + 1) % 3, ("par", v)))])
        pipe.drain()
        for tag in range(3):
            pars = [v for k, v in got[tag] if k == "par"]
            assert pars == sorted(pars, key=lambda v: v % 10), got
        assert sum(len(v) for v in got.values()) == 12

    res = scheduler.explore(one_pass, schedules=20, seed=0)
    assert res.schedules == 20 and not res.failures


@pytest.mark.cuda
def test_card_fleet_encode_rebuild_verify_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bases = _make_volumes(tmp_path, SIZES, seed=12)
    jax_bases = _twins(bases, "jax")
    fleet.fleet_write_ec_files(bases, large_block=LARGE, small_block=SMALL,
                               chunk=3 * ROW)
    _jax_encode(jax_bases)
    _assert_shards_equal(bases, jax_bases)
    assert all(r.clean for r in fleet.fleet_verify_ec_files(
        bases[1:], chunk=3 * SMALL).values())
    for base in bases[1:]:
        for sid in (3, 12):
            os.remove(shard_file_name(base, sid))
    fleet.fleet_rebuild_ec_files(bases[1:], chunk=3 * SMALL)
    _assert_shards_equal(bases, jax_bases)
