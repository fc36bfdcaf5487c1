"""The port's mesh data plane (``seaweedfs_tpu_torch.parallel``) held
against the JAX package's (``seaweedfs_tpu.parallel``).

The port's mesh here is 8 ``torch.device("cpu")`` entries in one process
(dp = 4, sp = 2), so the dp/sp split, the per-card lane offsets and the
combining of per-card results all run, on the kernels' plain versions;
the JAX package runs on its 8 virtual CPU devices (tests/conftest.py).
Shard files must be byte-identical and ``VerifyResult`` fields equal; the
ladder must count its fallbacks and let kernel and card faults through.
Small geometry (64 KiB small blocks, 1-2 MiB buckets, set through the
module constants) keeps volumes small while spans still cross buckets and
sp blocks.
"""

import os
import threading

import numpy as np
import pytest
import torch

import jax

from seaweedfs_tpu.ec.encoder import write_ec_files as jax_write_ec_files
from seaweedfs_tpu import parallel as jax_parallel
from seaweedfs_tpu.parallel import mesh_fleet as jax_mesh_fleet

from seaweedfs_tpu_torch import parallel
from seaweedfs_tpu_torch.ec import fleet, store_ec
from seaweedfs_tpu_torch.ec.encoder import shard_file_name, write_ec_files
from seaweedfs_tpu_torch.native.builder import BuildError, KernelLaunchError
from seaweedfs_tpu_torch.ops.rs_code import DATA_SHARDS, ReedSolomon
from seaweedfs_tpu_torch.parallel import mesh_fleet
from seaweedfs_tpu_torch.reads import DegradedReadFleet
from seaweedfs_tpu_torch.stats.metrics import FleetMeshFallbacksCounter
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store

SMALL = 64 << 10
ROW = DATA_SHARDS * SMALL
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def mesh():
    return parallel.make_mesh(devices=CPU8)


@pytest.fixture(scope="module")
def mesh2():
    """dp = 2, sp = 1: the mesh of the two-volume ladder cases."""
    return parallel.make_mesh(devices=CPU8[:2])


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) == 8, "conftest gives 8 virtual devices"
    return jax_parallel.make_mesh(8)


def _write_vols(root, sizes, seed=0, prefix=""):
    rng = np.random.default_rng(seed)
    bases = []
    for v, size in enumerate(sizes):
        base = os.path.join(str(root), f"{prefix}{v + 1}")
        with open(base + ".dat", "wb") as f:
            f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        bases.append(base)
    return bases


def _twins(bases, tag):
    out = []
    for base in bases:
        twin = f"{base}_{tag}"
        os.link(base + ".dat", twin + ".dat")
        out.append(twin)
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_shards_equal(bases, refs, sids=range(14)):
    for base, ref in zip(bases, refs):
        for i in sids:
            assert _read(shard_file_name(base, i)) == \
                _read(shard_file_name(ref, i)), f"{base} shard {i}"


def _fallbacks():
    return {r: FleetMeshFallbacksCounter.labels(r).value
            for r in ("unavailable", "timeout", "error")}


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


# -- the mesh ---------------------------------------------------------------------

def test_make_mesh_factoring_matches_jax():
    for n in range(1, 9):
        m = parallel.make_mesh(devices=CPU8[:n])
        j = jax_parallel.make_mesh(devices=jax.devices()[:n])
        assert m.shape == {"dp": j.shape["dp"], "sp": j.shape["sp"]}
        assert len(m.flat) == n
    assert parallel.make_mesh(n_devices=3, devices=CPU8).shape == \
        {"dp": 3, "sp": 1}
    with pytest.raises(ValueError):
        parallel.make_mesh(devices=[])


def test_explicit_one_card_mesh_and_no_default_mesh_here():
    one = parallel.make_mesh(devices=[torch.device("cpu")])
    assert one.shape == {"dp": 1, "sp": 1}
    if torch.cuda.device_count() < 2:
        with pytest.raises(mesh_fleet.MeshUnavailable):
            mesh_fleet._resolve_mesh(None)


@pytest.mark.parametrize("n", [8, 6, 4, 1])
def test_sharded_encode_matches_jax(n):
    m = parallel.make_mesh(devices=CPU8[:n])
    jm = jax_parallel.make_mesh(devices=jax.devices()[:n])
    dp, sp = m.shape["dp"], m.shape["sp"]
    data = np.random.default_rng(n).integers(
        0, 256, (2 * dp, DATA_SHARDS, sp * 96), dtype=np.uint8)
    got = np.asarray(parallel.sharded_encode(m, data))
    np.testing.assert_array_equal(
        got, np.asarray(jax_parallel.sharded_encode(jm, data)))
    np.testing.assert_array_equal(got, ReedSolomon(backend="cpu").encode(data))
    with pytest.raises(ValueError):   # B or N that does not split
        parallel.shard_batch(parallel.make_mesh(devices=CPU8[:2]), data[:1])
    if sp > 1:
        with pytest.raises(ValueError):
            parallel.shard_batch(m, data[..., :-1])


@pytest.mark.parametrize("drop", [(3, 11), (0, 13), (12, 13)])
def test_pipeline_step_matches_jax(mesh, jax_mesh, drop):
    data = np.random.default_rng(sum(drop)).integers(
        0, 256, (4, DATA_SHARDS, 2 * 128), dtype=np.uint8)
    parity, rebuilt, mism = parallel.ec_pipeline_step(mesh, data, drop=drop)
    jparity, jrebuilt, jmism = jax_parallel.ec_pipeline_step(
        jax_mesh, data, drop=drop)
    assert mism == int(jmism) == 0
    np.testing.assert_array_equal(np.asarray(parity), np.asarray(jparity))
    np.testing.assert_array_equal(np.asarray(rebuilt), np.asarray(jrebuilt))


@pytest.mark.parametrize("shift", [1, 2, 4, 5])
def test_rotate_shards_matches_jax(mesh, jax_mesh, shift):
    b, n = 4, 2 * 16
    data = np.arange(b * 14 * n, dtype=np.uint8).reshape(b, 14, n)
    got = np.asarray(parallel.rotate_shards(mesh, data, shift=shift))
    want = np.asarray(jax_parallel.rotate_shards(
        jax_mesh, jax.numpy.asarray(data), shift=shift))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.roll(data, shift, axis=0))
    one = parallel.make_mesh(devices=CPU8[:1])
    np.testing.assert_array_equal(
        np.asarray(parallel.rotate_shards(one, data, shift=shift)), data)


def test_sharded_write_ec_files_matches_jax(mesh, jax_mesh, tmp_path,
                                            monkeypatch):
    from seaweedfs_tpu_torch.ec.encoder import LARGE_BLOCK_SIZE
    small = 16 << 10
    monkeypatch.setattr(mesh_fleet, "DEFAULT_BUCKET_MB", 1)
    sizes = [0, 1, DATA_SHARDS * small, 9 * 160 * 1024 + 5, 17,
             2 * DATA_SHARDS * small + 1]
    bases = _write_vols(tmp_path, sizes, seed=3)
    jbases = _twins(bases, "jax")
    parallel.sharded_write_ec_files(mesh, bases, small_block=small)
    jax_parallel.sharded_write_ec_files(jax_mesh, jbases, small_block=small)
    _assert_shards_equal(bases, jbases)
    parallel.sharded_write_ec_files(mesh, [])
    big = str(tmp_path / "big")
    with open(big + ".dat", "wb") as f:
        f.truncate(DATA_SHARDS * LARGE_BLOCK_SIZE + 1)
    with pytest.raises(ValueError, match="large-row"):
        parallel.sharded_write_ec_files(mesh, [big])


@pytest.mark.parametrize("size", [0, 1, ROW, 2 * ROW + 5])
def test_volume_shard_matrix_matches_jax(tmp_path, size):
    base = _write_vols(tmp_path, [size], seed=size % 97)[0]
    got = parallel.volume_shard_matrix(base + ".dat", SMALL)
    np.testing.assert_array_equal(
        got, jax_parallel.volume_shard_matrix(base + ".dat", SMALL))
    assert got.shape == (DATA_SHARDS, -(-size // ROW) * SMALL)


def test_round_robin_and_sharded_fleets(tmp_path):
    bases = _write_vols(tmp_path, [50, 40, 30, 20, 10, 0])
    assert parallel.round_robin_by_size(bases, 3) == \
        jax_parallel.round_robin_by_size(bases, 3)
    assert parallel.round_robin_by_size(bases, 8) == \
        jax_parallel.round_robin_by_size(bases, 8)
    vols = _write_vols(tmp_path, [3 * ROW + 5, ROW, 7, 2 * ROW], seed=4,
                       prefix="f")
    refs = _twins(vols, "ref")
    parallel.fleet_write_ec_files_sharded(vols, backend="cpu",
                                          small_block=SMALL)
    for ref in refs:
        jax_write_ec_files(ref, backend="numpy", small_block=SMALL)
    _assert_shards_equal(vols, refs)


# -- the unified scheduler ------------------------------------------------------------

def test_mesh_encode_matches_jax(mesh, jax_mesh, tmp_path, monkeypatch):
    sizes = [0, 1, ROW, ROW + 1, 3 * ROW + 13, ROW - 7, 2 * ROW + 1]
    bases = _write_vols(tmp_path, sizes)
    jbases = _twins(bases, "jax")
    monkeypatch.setattr(mesh_fleet, "DEFAULT_BUCKET_MB", 2)
    stats = parallel.mesh_write_ec_files(bases, mesh=mesh, small_block=SMALL)
    jstats = jax_parallel.mesh_write_ec_files(
        jbases, mesh=jax_mesh, small_block=SMALL, bucket_mb=2)
    _assert_shards_equal(bases, jbases)
    assert (stats.buckets, stats.spans, stats.slots) == \
        (jstats.buckets, jstats.spans, jstats.slots)
    assert 0.0 < stats.occupancy <= 1.0


def _damaged_encoded(tmp_path, mesh, seed=1):
    """Four encoded volumes (port and JAX copies), with one flipped parity
    byte in the SECOND sp block of a span, one truncated parity tail and
    one missing parity shard."""
    bases = _write_vols(tmp_path, [3 * ROW + 13, ROW, 2 * ROW + 1,
                                   ROW - 7], seed=seed)
    parallel.mesh_write_ec_files(bases, mesh=mesh, small_block=SMALL)
    jbases = []
    for base in bases:
        twin = f"{base}_jax"
        for i in range(14):
            os.link(shard_file_name(base, i), shard_file_name(twin, i))
        jbases.append(twin)
    return bases, jbases


@pytest.mark.parametrize("bucket_mb", [1, 2])
def test_mesh_verify_matches_jax_and_fleet(mesh, jax_mesh, tmp_path,
                                          monkeypatch, bucket_mb):
    bases, jbases = _damaged_encoded(tmp_path, mesh)
    monkeypatch.setattr(mesh_fleet, "DEFAULT_BUCKET_MB", bucket_mb)
    # spans are bucket_mb MiB / (dp * 10) lanes, padded to a multiple of
    # 16 * sp and split in two sp blocks: these offsets land in the second
    # block and in a later span
    span = (bucket_mb << 20) // (4 * DATA_SHARDS)
    for off in (span // 2 + 77, 3 * span + span // 2 + 5):
        _flip(shard_file_name(bases[0], 11), off)
    _flip(shard_file_name(bases[3], 10), span - 1)
    _flip(shard_file_name(bases[3], 4), 5)
    p2 = shard_file_name(bases[2], 12)
    os.truncate(p2, os.path.getsize(p2) - 5000)
    for b in (bases[1], jbases[1]):
        os.remove(shard_file_name(b, 13))
    got = parallel.mesh_verify_ec_files(bases, mesh=mesh)
    want = jax_parallel.mesh_verify_ec_files(jbases, mesh=jax_mesh,
                                             bucket_mb=bucket_mb)
    ref = fleet.fleet_verify_ec_files(bases, backend="cpu")
    for base, jbase in zip(bases, jbases):
        g, w, r = got[base], want[jbase], ref[base]
        for field in ("parity_mismatch", "first_mismatch", "missing",
                      "parity_checked", "bytes_verified", "verified",
                      "clean"):
            assert getattr(g, field) == getattr(w, field) == \
                getattr(r, field), (base, field)
        assert g.spans == w.spans
    assert got[bases[0]].first_mismatch == {11: span // 2 + 77}
    assert got[bases[3]].parity_mismatch[10] >= 1


def test_mesh_verify_unverifiable_empty_and_one_card(tmp_path):
    bases = _write_vols(tmp_path, [ROW, 0], seed=2)
    one = parallel.make_mesh(devices=[torch.device("cpu")])
    parallel.mesh_write_ec_files(bases, mesh=one, small_block=SMALL)
    res = parallel.mesh_verify_ec_files(bases, mesh=one)
    assert res[bases[0]].clean and res[bases[0]].spans == 1
    assert res[bases[1]].clean and res[bases[1]].spans == 0
    os.remove(shard_file_name(bases[0], 4))
    res = parallel.mesh_verify_ec_files(bases, mesh=one)
    assert not res[bases[0]].verified and res[bases[0]].missing == [4]


def test_mesh_rebuild_matches_jax(mesh, jax_mesh, tmp_path):
    bases = _write_vols(tmp_path, [2 * ROW + 9, ROW - 3, 5 * ROW], seed=3)
    parallel.mesh_write_ec_files(bases, mesh=mesh, small_block=SMALL)
    pristine = {(b, s): _read(shard_file_name(b, s))
                for b in bases for s in range(14)}
    for check in (False, True):
        for base in bases:   # the same signature: one group
            for sid in (2, 12):
                os.remove(shard_file_name(base, sid))
        out = parallel.mesh_rebuild_ec_files(bases, mesh=mesh, check=check)
        assert out == {b: [2, 12] for b in bases}
        for base in bases:
            for sid in (2, 12):
                assert _read(shard_file_name(base, sid)) == \
                    pristine[(base, sid)]
    # and on the JAX mesh from the same survivors
    jbases = _twins(bases, "jax")
    for base, jbase in zip(bases, jbases):
        for sid in range(14):
            if sid not in (2, 12):
                os.link(shard_file_name(base, sid),
                        shard_file_name(jbase, sid))
    jax_parallel.mesh_rebuild_ec_files(jbases, mesh=jax_mesh, check=True)
    _assert_shards_equal(bases, jbases, (2, 12))


def test_checked_rebuild_of_wanted_subset(mesh, tmp_path):
    bases = _write_vols(tmp_path, [DATA_SHARDS * SMALL * 2], seed=7)
    parallel.mesh_write_ec_files(bases, mesh=mesh, small_block=SMALL)
    ref = {sid: _read(shard_file_name(bases[0], sid)) for sid in (3, 11)}
    for sid in (3, 11):
        os.remove(shard_file_name(bases[0], sid))
    out = parallel.mesh_rebuild_ec_files(bases, mesh=mesh, wanted=[3],
                                         check=True)
    assert out[bases[0]] == [3]
    assert _read(shard_file_name(bases[0], 3)) == ref[3]
    assert not os.path.exists(shard_file_name(bases[0], 11))


@pytest.mark.parametrize("survivor", [5, 13])
def test_checked_rebuild_trips_and_unlinks(mesh, tmp_path, survivor):
    bases = _write_vols(tmp_path, [DATA_SHARDS * SMALL * 2, ROW], seed=4)
    parallel.mesh_write_ec_files(bases, mesh=mesh, small_block=SMALL)
    _flip(shard_file_name(bases[0], survivor), 100)
    for base in bases:
        os.remove(shard_file_name(base, 2))
    with pytest.raises(parallel.MeshVerifyMismatch, match=bases[0]):
        parallel.mesh_rebuild_ec_files(bases, mesh=mesh, check=True)
    # the corrupt reconstruction is gone; the clean volume's is kept
    assert not os.path.exists(shard_file_name(bases[0], 2))
    assert os.path.exists(shard_file_name(bases[1], 2))
    parallel.mesh_rebuild_ec_files(bases[:1], mesh=mesh)  # no check: done
    assert os.path.exists(shard_file_name(bases[0], 2))


@pytest.mark.parametrize("b,span", [(5, 1000), (8, 64), (1, 3), (3, 4097)])
def test_sharded_reconstruct_matches_jax(mesh, jax_mesh, b, span):
    data = np.random.default_rng(b).integers(
        0, 256, (b, DATA_SHARDS, span), dtype=np.uint8)
    present = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10]
    got = parallel.sharded_reconstruct(mesh, present, [9], data)
    np.testing.assert_array_equal(got, jax_parallel.sharded_reconstruct(
        jax_mesh, present, [9], data))
    np.testing.assert_array_equal(got, ReedSolomon(backend="cpu")
                                  .reconstruct_some(present, [9], data))


# -- the ladder -----------------------------------------------------------------

def test_pod_small_batch_and_no_mesh_take_the_fleet(mesh, tmp_path):
    """Two volumes cannot fill the dp = 4 slots of the 8-device mesh."""
    bases = _write_vols(tmp_path, [ROW, 2 * ROW], seed=6)
    refs = _twins(bases, "ref")
    before = _fallbacks()
    assert parallel.pod_write_ec_files(bases, backend="cpu", mesh=mesh,
                                       small_block=SMALL) == "fleet"
    for ref in refs:
        write_ec_files(ref, backend="cpu", small_block=SMALL)
    _assert_shards_equal(bases, refs)
    res = parallel.pod_verify_ec_files(bases, backend="cpu", mesh=mesh)
    assert all(r.clean for r in res.values())
    if torch.cuda.device_count() < 2:   # mesh=None: no default mesh here
        assert parallel.pod_verify_ec_files(bases, backend="cpu")
    after = _fallbacks()
    assert after["unavailable"] >= before["unavailable"] + 2
    assert after["error"] == before["error"]


@pytest.mark.parametrize("op", ["encode", "verify"])
def test_pod_scheduler_failure_falls_back_counted(mesh2, tmp_path,
                                                  monkeypatch, op):
    bases = _write_vols(tmp_path, [ROW + 1, 2 * ROW], seed=7)
    if op == "verify":
        parallel.mesh_write_ec_files(bases, mesh=mesh2, small_block=SMALL)

    def boom(*a, **kw):
        raise RuntimeError("injected scheduler failure")

    monkeypatch.setattr(mesh_fleet, f"mesh_{'write' if op == 'encode' else op}"
                        "_ec_files", boom)
    before = _fallbacks()
    if op == "encode":
        assert parallel.pod_write_ec_files(
            bases, backend="cpu", mesh=mesh2, small_block=SMALL) == "fleet"
        refs = _twins(bases, "ref")
        for ref in refs:
            write_ec_files(ref, backend="cpu", small_block=SMALL)
        _assert_shards_equal(bases, refs)
    else:
        res = parallel.pod_verify_ec_files(bases, backend="cpu", mesh=mesh2)
        assert all(r.clean for r in res.values())
    assert _fallbacks()["error"] == before["error"] + 1


@pytest.mark.parametrize("op", ["encode", "verify"])
@pytest.mark.parametrize("exc", [BuildError, KernelLaunchError])
def test_pod_lets_kernel_failures_through(mesh2, tmp_path, monkeypatch, op,
                                          exc):
    """A kernel that does not build or launch is no scheduler failure:
    it propagates through the ladder, and nothing is counted."""
    bases = _write_vols(tmp_path, [ROW, ROW + 3], seed=8)
    parallel.mesh_write_ec_files(bases, mesh=mesh2, small_block=SMALL)

    def broken(*a, **kw):
        raise exc("injected")

    from seaweedfs_tpu_torch.ops import gf_compare, gf_kernel
    target = gf_kernel if op == "encode" else gf_compare
    monkeypatch.setattr(target, "gf_linear" if op == "encode"
                        else "gf_compare", broken)
    before = _fallbacks()
    with pytest.raises(exc):
        if op == "encode":
            parallel.pod_write_ec_files(bases, backend="cpu", mesh=mesh2,
                                        small_block=SMALL)
        else:
            parallel.pod_verify_ec_files(bases, backend="cpu", mesh=mesh2)
    assert _fallbacks() == before


CARD_FAULTS = [
    lambda: RuntimeError("CUDA error: an illegal memory access was "
                         "encountered"),
    lambda: torch.cuda.OutOfMemoryError("CUDA out of memory."),
] + ([lambda: torch.AcceleratorError("CUDA error: unspecified launch "
                                     "failure")]
     if hasattr(torch, "AcceleratorError") else [])


class _FaultAtResult:
    """A bucket whose card work fails when it is waited for, as an
    asynchronous kernel fault surfaces at event.synchronize()."""

    def __init__(self, exc):
        self._exc = exc

    def result(self):
        raise self._exc


def _fail_at_result(monkeypatch, make_exc):
    def call(self, bucket, aux=None):
        return _FaultAtResult(make_exc())

    monkeypatch.setattr(mesh_fleet._TorchDispatch, "__call__", call)


def test_is_kernel_fault():
    for make in CARD_FAULTS:
        assert mesh_fleet.is_kernel_fault(make())
    assert mesh_fleet.is_kernel_fault(BuildError("nvcc"))
    assert mesh_fleet.is_kernel_fault(KernelLaunchError("refused"))
    for e in (RuntimeError("injected scheduler failure"), ValueError("x"),
              parallel.MeshDispatchTimeout("slow"),
              parallel.MeshUnavailable("one card")):
        assert not mesh_fleet.is_kernel_fault(e)


@pytest.mark.parametrize("op", ["encode", "verify"])
@pytest.mark.parametrize("fault", range(len(CARD_FAULTS)))
def test_pod_lets_card_faults_at_result_through(mesh2, tmp_path, monkeypatch,
                                                op, fault):
    """A fault the card reports when the bucket is waited for (not at
    launch) propagates too: the fleet would redo the compare on the
    host."""
    bases = _write_vols(tmp_path, [ROW, ROW + 3], seed=8)
    parallel.mesh_write_ec_files(bases, mesh=mesh2, small_block=SMALL)
    _fail_at_result(monkeypatch, CARD_FAULTS[fault])
    want = type(CARD_FAULTS[fault]())
    before = _fallbacks()
    with pytest.raises(want):
        if op == "encode":
            parallel.pod_write_ec_files(bases, backend="cpu", mesh=mesh2,
                                        small_block=SMALL)
        else:
            parallel.pod_verify_ec_files(bases, backend="cpu", mesh=mesh2)
    assert _fallbacks() == before


def test_pod_timeout_is_counted(tmp_path, monkeypatch):
    bases = _write_vols(tmp_path, [ROW, ROW], seed=9)

    def slow(*a, **kw):
        raise parallel.MeshDispatchTimeout("injected")

    monkeypatch.setattr(mesh_fleet, "mesh_write_ec_files", slow)
    before = _fallbacks()
    parallel.pod_write_ec_files(bases, backend="cpu",
                                mesh=parallel.make_mesh(devices=CPU8[:2]),
                                small_block=SMALL)
    assert _fallbacks()["timeout"] == before["timeout"] + 1


@pytest.mark.parametrize("op", ["encode", "verify"])
def test_pod_chunks_under_the_fd_budget(mesh, tmp_path, monkeypatch, op):
    monkeypatch.setattr(mesh_fleet, "MAX_VOLUMES_PER_PASS", 2)
    bases = _write_vols(tmp_path, [ROW] * 5, seed=10)
    if op == "verify":
        for b in bases:
            write_ec_files(b, backend="cpu", small_block=SMALL)
    passes = []
    name = "mesh_write_ec_files" if op == "encode" \
        else "mesh_verify_ec_files"
    real = getattr(mesh_fleet, name)

    def spy(names, **kw):
        passes.append(list(names))
        return real(names, **kw)

    monkeypatch.setattr(mesh_fleet, name, spy)
    if op == "encode":
        assert parallel.pod_write_ec_files(
            bases, backend="cpu", mesh=mesh, small_block=SMALL) == "mesh"
    else:
        res = parallel.pod_verify_ec_files(bases, mesh=mesh)
        assert set(res) == set(bases)
        assert all(r.clean for r in res.values())
    assert sorted(len(p) for p in passes) == [1, 2, 2]


def test_pod_large_row_volume_takes_the_serial_path(mesh2, tmp_path,
                                                    monkeypatch):
    serial = []
    orig = mesh_fleet._encoder.write_ec_files

    def spy(base, **kw):
        serial.append(base)
        return orig(base, **kw)

    monkeypatch.setattr(mesh_fleet._encoder, "write_ec_files", spy)
    monkeypatch.setattr(mesh_fleet, "LARGE_BLOCK_SIZE", SMALL)
    bases = _write_vols(tmp_path, [ROW * 3, ROW // 2, ROW // 4], seed=11)
    assert parallel.pod_write_ec_files(bases, backend="cpu", mesh=mesh2,
                                       small_block=SMALL) == "mesh"
    assert serial == [bases[0]]


# -- hooks --------------------------------------------------------------------------

def test_generate_ec_shards_batch_rides_the_mesh(mesh2, tmp_path):
    store = Store([str(tmp_path)])
    try:
        blob = bytes(range(256)) * 16
        for vid in (1, 2):
            v = store.add_volume(vid)
            for i in range(1, 30 + vid):
                v.write_needle(Needle(id=i, cookie=9, data=blob))
        before = mesh_fleet.FleetMeshBucketsCounter.labels("encode").value
        bases = store_ec.generate_ec_shards_batch(
            store, [1, 2], backend="cpu",
            mesh_cfg={"mesh": mesh2})
        assert mesh_fleet.FleetMeshBucketsCounter.labels(
            "encode").value > before
        refs = _twins(bases.values(), "ref")
        for ref in refs:
            jax_write_ec_files(ref, backend="numpy")
        _assert_shards_equal(bases.values(), refs)
        assert os.path.exists(bases[1] + ".ecx")
    finally:
        store.close()


def _degraded_store(tmp_path):
    store = Store([str(tmp_path)])
    blob = bytes(range(256)) * 16
    v = store.add_volume(1)
    for i in range(1, 33):
        v.write_needle(Needle(id=i, cookie=9, data=blob))
    store_ec.generate_ec_shards(store, 1, backend="cpu")
    store.location_of(1).delete_volume(1)
    store_ec.mount_ec_shards(store, 1, "",
                             [i for i in range(14) if i not in (0, 3)])
    return store, blob


def _read_concurrently(store, decoder, ids):
    got, errs = {}, []

    def read(k):
        try:
            got[k] = store_ec.read_ec_needle(
                store, 1, Needle(id=k, cookie=9), decoder=decoder)
        except Exception as e:  # noqa: BLE001 - asserted by the caller
            errs.append(e)

    ts = [threading.Thread(target=read, args=(k,)) for k in ids]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    return got, errs


@pytest.mark.parametrize("mode", ["mesh", "no_mesh", "scheduler_error"])
def test_decode_fleet_use_mesh(mesh, tmp_path, monkeypatch, mode):
    if mode != "no_mesh":
        monkeypatch.setattr(mesh_fleet, "_default_mesh", lambda: mesh)
    if mode == "scheduler_error":
        def boom(*a, **kw):
            raise RuntimeError("injected scheduler failure")
        monkeypatch.setattr(mesh_fleet, "sharded_reconstruct", boom)
    calls = []
    real = mesh_fleet.sharded_reconstruct
    if mode == "mesh":
        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)
        monkeypatch.setattr(mesh_fleet, "sharded_reconstruct", spy)
    store, blob = _degraded_store(tmp_path)
    decoder = DegradedReadFleet(backend="cpu", use_mesh=True,
                                batch_window_s=0.05)
    before = _fallbacks()
    try:
        got, errs = _read_concurrently(store, decoder, range(1, 17))
        assert not errs, errs[:1]
        assert all(n.data == blob for n in got.values()) and len(got) == 16
        assert (decoder._mesh is not None) == (mode != "no_mesh")
        assert decoder.dispatches >= 1
        if mode == "mesh":
            assert calls, "no fused decode went over the mesh"
        if mode == "scheduler_error":
            assert _fallbacks()["error"] > before["error"]
    finally:
        decoder.stop()
        store.close()


@pytest.mark.parametrize("exc", [BuildError, KernelLaunchError])
def test_decode_fleet_use_mesh_lets_kernel_failures_through(
        mesh, tmp_path, monkeypatch, exc):
    monkeypatch.setattr(mesh_fleet, "_default_mesh", lambda: mesh)

    def broken(*a, **kw):
        raise exc("injected")

    monkeypatch.setattr(mesh_fleet, "sharded_reconstruct", broken)
    store, _ = _degraded_store(tmp_path)
    decoder = DegradedReadFleet(backend="cpu", use_mesh=True,
                                batch_window_s=0.2)
    before = _fallbacks()
    try:
        got, errs = _read_concurrently(store, decoder, range(1, 17))
        # every request that rode a fused (>= 2 span) mesh decode failed
        # with the kernel's error; none was re-solved behind its back
        assert errs and all(isinstance(e, exc) for e in errs)
        assert _fallbacks() == before
    finally:
        decoder.stop()
        store.close()


@pytest.mark.parametrize("fault", range(len(CARD_FAULTS)))
def test_decode_fleet_use_mesh_lets_card_faults_through(
        mesh, tmp_path, monkeypatch, fault):
    monkeypatch.setattr(mesh_fleet, "_default_mesh", lambda: mesh)
    _fail_at_result(monkeypatch, CARD_FAULTS[fault])
    want = type(CARD_FAULTS[fault]())
    store, _ = _degraded_store(tmp_path)
    decoder = DegradedReadFleet(backend="cpu", use_mesh=True,
                                batch_window_s=0.2)
    before = _fallbacks()
    try:
        got, errs = _read_concurrently(store, decoder, range(1, 17))
        assert errs and all(isinstance(e, want) for e in errs)
        assert _fallbacks() == before
    finally:
        decoder.stop()
        store.close()


# -- the handoff, staging, timeouts ---------------------------------------------------------

def test_bucket_handoff_explored(tmp_path, monkeypatch):
    """The bucket handoff (read -> pack -> dispatch -> FIFO retire ->
    per-volume writer lanes) under 20 seeded schedules of the JAX
    package's schedule explorer, byte-identical every time. The dispatch
    is the port's host codec, so the explorer drives the machinery."""
    from seaweedfs_tpu.util import scheduler

    rs = ReedSolomon(backend="cpu")
    bases = _write_vols(tmp_path, [2 * ROW + 11, ROW, ROW - 3], seed=12)
    refs = _twins(bases, "ref")
    for ref in refs:
        write_ec_files(ref, backend="cpu", small_block=SMALL)

    monkeypatch.setattr(mesh_fleet, "DEFAULT_BUCKET_MB", 1)
    monkeypatch.setattr(fleet, "FLEET_READERS", 0)

    def one_pass():
        parallel.mesh_write_ec_files(
            bases, mesh=(2, 2), small_block=SMALL,
            _dispatch=lambda bucket, aux=None: rs.encode(bucket))
        _assert_shards_equal(bases, refs)

    res = scheduler.explore(one_pass, schedules=20, seed=0)
    assert res.schedules == 20 and not res.failures


def test_dispatch_timeout_raises(tmp_path, monkeypatch):
    release = threading.Event()

    class _Stuck:
        def result(self):
            release.wait(timeout=60.0)
            return np.zeros((2, 4, SMALL), dtype=np.uint8)

    bases = _write_vols(tmp_path, [ROW * 4, ROW * 4], seed=10)
    monkeypatch.setattr(mesh_fleet, "DEFAULT_BUCKET_MB", 1)
    monkeypatch.setattr(mesh_fleet, "DEFAULT_TIMEOUT_S", 0.2)
    monkeypatch.setattr(fleet, "FLEET_DEPTH", 1)
    try:
        with pytest.raises(parallel.MeshDispatchTimeout):
            parallel.mesh_write_ec_files(
                bases, mesh=(2, 1), small_block=SMALL,
                _dispatch=lambda bucket, aux=None: _Stuck())
    finally:
        release.set()  # unwedge the abandoned retire thread


def test_verify_dispatch_contract_matches_jax_compare(tmp_path,
                                                      monkeypatch):
    """An injected verify dispatch gets (bucket, (stored, limits)) and
    returns (counts, firsts) per slot: the JAX program on its
    1-device mesh plugged in gives the fleet verifier's result."""
    jm = jax_parallel.make_mesh(devices=jax.devices()[:1])
    compare = jax_mesh_fleet._mesh_compare_fn(jm)
    rs = ReedSolomon(backend="cpu")
    bases = _write_vols(tmp_path, [2 * ROW + 1, ROW], seed=13)
    for b in bases:
        write_ec_files(b, backend="cpu", small_block=SMALL)
    _flip(shard_file_name(bases[1], 12), 321)

    def dispatch(bucket, aux):
        stored, limits = aux
        return tuple(np.asarray(o) for o in compare(
            rs.encode(bucket), stored, limits))

    want = fleet.fleet_verify_ec_files(bases, backend="cpu")
    monkeypatch.setattr(mesh_fleet, "DEFAULT_BUCKET_MB", 1)
    monkeypatch.setattr(fleet, "FLEET_READERS", 0)
    got = parallel.mesh_verify_ec_files(bases, mesh=(2, 1),
                                        _dispatch=dispatch)
    for b in bases:
        assert (got[b].parity_mismatch, got[b].first_mismatch) == \
            (want[b].parity_mismatch, want[b].first_mismatch)
    assert got[bases[1]].parity_mismatch == {12: 1}


def test_buckets_are_lane_aligned_for_the_uint4_path(mesh, tmp_path,
                                                     monkeypatch):
    """Every card's block of every bucket has a lane count that is a
    multiple of 16, so the kernels take their uint4 path; spans stay the
    JAX package's (their count is checked against it above)."""
    shapes = []
    real = mesh_fleet._TorchDispatch.__call__

    def spy(self, bucket, aux=None):
        shapes.append((self._op, bucket.shape))
        return real(self, bucket, aux)

    monkeypatch.setattr(mesh_fleet._TorchDispatch, "__call__", spy)
    monkeypatch.setattr(mesh_fleet, "DEFAULT_BUCKET_MB", 1)
    bases = _write_vols(tmp_path, [3 * ROW + 13, ROW - 7], seed=14)
    parallel.mesh_write_ec_files(bases, mesh=mesh, small_block=SMALL)
    parallel.mesh_verify_ec_files(bases, mesh=mesh)
    for base in bases:
        os.remove(shard_file_name(base, 4))
    parallel.mesh_rebuild_ec_files(bases, mesh=mesh, check=True)
    sp = mesh.shape["sp"]
    assert {op for op, _ in shapes} == {"encode", "verify", "rebuild"}
    for op, shape in shapes:
        assert shape[-1] % (16 * sp) == 0, (op, shape)
    # the verify span of this geometry is not a multiple of 16 itself
    assert ((1 << 20) // (4 * DATA_SHARDS)) % 16 != 0
    assert parallel.sharded_reconstruct(
        mesh, list(range(10)), [12],
        np.ones((3, DATA_SHARDS, 33), np.uint8)).shape == (3, 1, 33)


def test_buckets_filled_in_place_ignore_stale_memory(mesh, tmp_path,
                                                     monkeypatch):
    """Bucket memory is reused (pinned blocks on the card), so readers
    zero what they do not fill: with every new bucket full of junk,
    encode, verify (with a short data shard) and checked rebuild give
    the same bytes and counts as before."""
    monkeypatch.setattr(mesh_fleet, "DEFAULT_BUCKET_MB", 1)
    bases = _write_vols(tmp_path, [3 * ROW + 13, ROW - 7, 2 * ROW + 1],
                        seed=15)
    refs = _twins(bases, "ref")
    for ref in refs:
        write_ec_files(ref, backend="cpu", small_block=SMALL)
    monkeypatch.setattr(
        mesh_fleet._TorchDispatch, "empty",
        lambda self, shape, dtype: np.full(shape, 0x5A, dtype=dtype))
    parallel.mesh_write_ec_files(bases, mesh=mesh, small_block=SMALL)
    _assert_shards_equal(bases, refs)
    assert all(r.clean for r in
               parallel.mesh_verify_ec_files(bases, mesh=mesh).values())
    p = shard_file_name(bases[0], 7)
    os.truncate(p, os.path.getsize(p) - 999)
    for got, want in zip(
            parallel.mesh_verify_ec_files(bases, mesh=mesh).values(),
            fleet.fleet_verify_ec_files(bases, backend="cpu").values()):
        assert (got.parity_mismatch, got.first_mismatch) == \
            (want.parity_mismatch, want.first_mismatch)
    os.remove(p)
    for base in bases:
        os.remove(shard_file_name(base, 12))
    parallel.mesh_rebuild_ec_files(bases, mesh=mesh, check=True)
    _assert_shards_equal(bases, refs)


def test_contiguous_slab_goes_to_the_card_as_it_lies():
    """A contiguous block of a bucket is handed to the H2D without a
    host copy; a lane-split block (sp > 1) is gathered first."""
    bucket = np.arange(2 * 10 * 64, dtype=np.uint8).reshape(2, 10, 64)
    cuda = torch.device("cuda", 0)
    t = mesh_fleet._TorchDispatch._host(bucket[1:2], cuda)
    assert np.shares_memory(t.numpy(), bucket)
    cpu = mesh_fleet._TorchDispatch._host(bucket[:, :, 32:],
                                          torch.device("cpu"))
    np.testing.assert_array_equal(cpu.numpy(), bucket[:, :, 32:])
