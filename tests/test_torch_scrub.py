"""The port's scrub path (``seaweedfs_tpu_torch.scrub``) held against the
JAX package's (``seaweedfs_tpu.scrub``) on the fixtures of
``tests/test_scrub.py``.

Each fixture is written once through the port's Store (``backend="cpu"``,
the kernels' plain versions) and copied byte for byte into a second
directory that the JAX package's Store opens; the same bytes are then
damaged in both, and both scrubbers run. Scanner results, verdicts,
``PassResult`` fields and the repaired shard bytes must be equal: the
tolerance is exact integers and exact bytes.
"""

import dataclasses
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu.scrub import ScrubDaemon as JaxScrubDaemon
from seaweedfs_tpu.scrub import planner as jax_planner
from seaweedfs_tpu.scrub import scanner as jax_scanner
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.store import Store as JaxStore

from seaweedfs_tpu_torch.ec import encoder, fleet, store_ec
from seaweedfs_tpu_torch.parallel import make_mesh
from seaweedfs_tpu_torch.scrub import daemon as daemon_mod
from seaweedfs_tpu_torch.scrub import planner, scanner
from seaweedfs_tpu_torch.scrub import ScrubDaemon
from seaweedfs_tpu_torch.stats.metrics import REGISTRY
from seaweedfs_tpu_torch.storage import volume as volume_mod
from seaweedfs_tpu_torch.storage.needle import (
    DataCorruptionError, Needle, masked_crc)
from seaweedfs_tpu_torch.storage.store import Store

PASS_FIELDS = [f.name for f in dataclasses.fields(daemon_mod.PassResult)]


def _flip(path, offset, mask=0xFF):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


class Twin:
    """One store written through the port, and the JAX package's Store
    over a byte copy of its directory (opened by ``jax()``)."""

    def __init__(self, root):
        self.root = str(root)
        self.port_dir = os.path.join(self.root, "port")
        self.jax_dir = os.path.join(self.root, "jax")
        self.port = Store([self.port_dir])
        self.jax_store = None
        self.rng = np.random.default_rng(42)

    def fill(self, vid, n=20, size=2048):
        self.port.add_volume(vid)
        v = self.port.find_volume(vid)
        for i in range(1, n + 1):
            data = self.rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            v.write_needle(Needle(id=i, cookie=7, data=data))
        return v

    def make_ec(self, vid, n=25, size=4096):
        self.fill(vid, n=n, size=size)
        base = store_ec.generate_ec_shards(self.port, vid, backend="cpu")
        store_ec.mount_ec_shards(self.port, vid, "", range(14))
        assert self.port.delete_volume(vid)
        return os.path.basename(base)

    def jax(self):
        shutil.copytree(self.port_dir, self.jax_dir)
        self.jax_store = JaxStore([self.jax_dir])
        return self.jax_store

    def paths(self, name):
        """The file in the port's directory, and in the JAX package's
        once it is open."""
        return [os.path.join(d, name) for d in (self.port_dir, self.jax_dir)
                if d == self.port_dir or self.jax_store is not None]

    def flip(self, name, offset, mask=0xFF):
        for p in self.paths(name):
            _flip(p, offset, mask)

    def flip_needle(self, vid, nid, skew=3):
        """Flip one byte inside needle nid's data in both copies."""
        nv = self.port.find_volume(vid).nm.get(nid)
        self.flip(f"{vid}.dat", nv.offset + 16 + 4 + skew)

    def close(self):
        self.port.close()
        if self.jax_store is not None:
            self.jax_store.close()


@pytest.fixture
def twin(tmp_path):
    t = Twin(tmp_path)
    yield t
    t.close()


def _pass_fields(res):
    return {f: getattr(res, f) for f in PASS_FIELDS}


def _needle_scan(res):
    return (res.bytes_scanned, res.needles_verified,
            [(off, n.id, n.cookie, n.checksum) for off, n in res.corrupt])


def _ec_scan(res):
    return (res.bytes_scanned, res.needles_verified, sorted(res.corrupt),
            sorted(res.bad_data_shards), res.skipped_remote)


# -- storage support ------------------------------------------------------------

def test_scan_needles_matches_jax(twin):
    v = twin.fill(1, n=12)
    v.delete_needle(Needle(id=4, cookie=7))
    js = twin.jax()
    jv = js.find_volume(1)
    for deleted in (False, True):
        got = [(off, n.id, n.size, n.checksum)
               for off, n in v.scan_needles(include_deleted=deleted)]
        want = [(off, n.id, n.size, n.checksum)
                for off, n in jv.scan_needles(include_deleted=deleted)]
        assert got == want and len(got) == 12 + deleted
    assert v.is_remote is False


def test_verify_reads_gate(twin):
    v = twin.fill(1, n=3)
    assert not volume_mod.verify_reads_enabled()
    twin.flip_needle(1, 1)
    volume_mod.set_verify_reads(True)
    try:
        assert volume_mod.verify_reads_enabled()
        with pytest.raises(DataCorruptionError):
            v.read_needle(Needle(id=1, cookie=7))
        assert v.read_needle(Needle(id=2, cookie=7)).data
    finally:
        volume_mod.set_verify_reads(False)
    with pytest.raises(DataCorruptionError):
        v.read_needle(Needle(id=1, cookie=7))


def test_store_delete_volume(twin):
    v = twin.fill(3, n=2)
    dat = v.dat_path
    assert twin.port.delete_volume(3)
    assert not os.path.exists(dat) and twin.port.find_volume(3) is None
    assert not twin.port.delete_volume(3)


# -- scanner --------------------------------------------------------------------

@pytest.mark.parametrize("case", ["clean", "flipped", "dead_copy"])
def test_scan_volume_matches_jax(twin, case):
    v = twin.fill(1, n=5 if case == "dead_copy" else 20)
    if case == "dead_copy":
        old = v.nm.get(3)
        v.write_needle(Needle(id=3, cookie=7, data=b"x" * 2048))
        twin.flip("1.dat", old.offset + 16 + 4 + 1)
    js = twin.jax()
    if case == "flipped":
        twin.flip_needle(1, 5)
    got = scanner.scan_volume(v)
    want = jax_scanner.scan_volume(js.find_volume(1))
    assert _needle_scan(got) == _needle_scan(want)
    assert [n.id for _, n in got.corrupt] == ([5] if case == "flipped"
                                             else [])


@pytest.mark.parametrize("nid,skew", [(7, 30), (1, 100), (13, 2000),
                                      (25, 4000)])
def test_ec_scan_localizes_bad_data_shard(twin, nid, skew):
    name = twin.make_ec(2)
    ecv = twin.port.find_ec_volume(2)
    _, _, ivs = ecv.locate_needle(nid)
    at = 0
    for iv in ivs:  # the interval holding byte `skew` of the record
        if skew < at + iv.size:
            sid, soff = iv.to_shard_and_offset(ecv.large_block,
                                               ecv.small_block)
            soff += skew - at
            break
        at += iv.size
    js = twin.jax()
    twin.flip(f"{name}.ec{sid:02d}", soff)
    got = scanner.scan_ec_volume_needles(
        ecv, rs=store_ec.ReedSolomon(backend="cpu"))
    want = jax_scanner.scan_ec_volume_needles(js.find_ec_volume(2))
    assert _ec_scan(got) == _ec_scan(want)
    assert got.corrupt == [nid] and got.bad_data_shards == {sid}


def test_ec_scan_clean_truncated_and_remote(twin):
    name = twin.make_ec(2)
    ecv = twin.port.find_ec_volume(2)
    js = twin.jax()
    jecv = js.find_ec_volume(2)
    rs = store_ec.ReedSolomon(backend="cpu")
    got = scanner.scan_ec_volume_needles(ecv, rs=rs)
    assert _ec_scan(got) == _ec_scan(
        jax_scanner.scan_ec_volume_needles(jecv))
    assert got.corrupt == [] and got.needles_verified == 25
    # a shard held elsewhere: its needles are skipped, not failed
    ecv.unmount_shard(0)
    jecv.unmount_shard(0)
    got = scanner.scan_ec_volume_needles(ecv, rs=rs)
    assert _ec_scan(got) == _ec_scan(
        jax_scanner.scan_ec_volume_needles(jecv))
    assert got.skipped_remote == 25
    ecv.mount_shard(0)
    jecv.mount_shard(0)
    # a truncated data shard makes short blobs: evidence, not an abort
    for p in twin.paths(f"{name}.ec00"):
        with open(p, "r+b") as f:
            f.truncate(64)
    got = scanner.scan_ec_volume_needles(ecv, rs=rs)
    assert _ec_scan(got) == _ec_scan(
        jax_scanner.scan_ec_volume_needles(jecv))
    assert got.corrupt


# -- planner --------------------------------------------------------------------

CLASSIFY_CASES = [
    dict(),
    dict(parity_mismatch={11: 3}),
    dict(bad_data={2}, parity_mismatch={10: 1, 11: 1, 12: 1, 13: 1}),
    dict(missing=[12]),
    dict(missing=[3]),
    dict(missing=[3, 12]),
    dict(bad_data={0, 1, 2}, missing=[10, 11]),
    dict(bad_data={0, 1}, missing=[10, 11]),
    dict(parity_mismatch={10: 1, 11: 1, 12: 1, 13: 1}, missing=[4]),
    dict(bad_data={9}, missing=[13]),
]


@pytest.mark.parametrize("case", range(len(CLASSIFY_CASES)))
def test_classify_matches_jax(case):
    kw = CLASSIFY_CASES[case]
    assert planner.classify_ec_damage(planner.EcDamage(base="b", **kw)) == \
        jax_planner.classify_ec_damage(jax_planner.EcDamage(base="b", **kw))


def _raw_ec(tmp_path, size, seed=0):
    """A bare .dat and its shards, in two directories (port, JAX)."""
    rng = np.random.default_rng(seed)
    blob = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    out = []
    for tag in ("port", "jax"):
        os.makedirs(tmp_path / tag, exist_ok=True)
        base = str(tmp_path / tag / "v")
        with open(base + ".dat", "wb") as f:
            f.write(blob)
        encoder.write_ec_files(base, backend="cpu")
        out.append(base)
    return out


def test_repair_quarantines_and_rebuilds_byte_identical(tmp_path):
    base, jbase = _raw_ec(tmp_path, 1 << 19)
    pristine = _read(base + ".ec02")
    for b in (base, jbase):
        _flip(b + ".ec02", 99)
    assert planner.repair_ec_volume(base, [2], backend="cpu") == \
        jax_planner.repair_ec_volume(jbase, [2], backend="numpy") == [2]
    assert _read(base + ".ec02") == _read(jbase + ".ec02") == pristine
    assert _read(base + ".ec02.corrupt") == _read(jbase + ".ec02.corrupt")
    assert planner.verify_ec_repair(base, backend="cpu").clean
    # a second quarantine of the same shard keeps the first as .old
    _flip(base + ".ec02", 5)
    planner.repair_ec_volume(base, [2], backend="cpu")
    assert os.path.exists(base + ".ec02.corrupt.old")
    assert _read(base + ".ec02") == pristine
    assert not planner.quarantine_shard(base, 77)


@pytest.mark.parametrize("data_shard", [0, 6, 9])
def test_syndrome_probe_names_the_data_shard(tmp_path, data_shard):
    base, jbase = _raw_ec(tmp_path, 1 << 19, seed=data_shard)
    for b in (base, jbase):   # dead space: past the ~512 KB of live data
        _flip(b + f".ec{data_shard:02d}", 900_000, mask=0x3C)
    r = fleet.fleet_verify_ec_files([base], backend="cpu")[base]
    assert sorted(r.parity_mismatch) == [10, 11, 12, 13]
    offsets = sorted(set(r.first_mismatch.values()))
    got = planner.localize_from_parity_deltas(base, offsets)
    assert got == jax_planner.localize_from_parity_deltas(jbase, offsets) \
        == {data_shard}
    # three parity rows still discriminate; one never does
    assert planner.localize_from_parity_deltas(
        base, offsets, parity_ids=[10, 11, 13]) == {data_shard}
    assert planner.localize_from_parity_deltas(
        base, offsets, parity_ids=[12]) == set()


@pytest.mark.parametrize("parity_shard", [10, 11, 12, 13])
def test_parity_flip_is_not_misattributed(tmp_path, parity_shard):
    base, jbase = _raw_ec(tmp_path, 1 << 18, seed=parity_shard)
    for b in (base, jbase):
        _flip(b + f".ec{parity_shard}", 5000)
    r = fleet.fleet_verify_ec_files([base], backend="cpu")[base]
    assert r.parity_mismatch == {parity_shard: 1}
    offsets = sorted(set(r.first_mismatch.values()))
    assert planner.localize_from_parity_deltas(base, offsets) == \
        jax_planner.localize_from_parity_deltas(jbase, offsets) == set()


def test_repair_needle_from_replica(twin):
    v = twin.fill(1)
    good = v.read_needle(Needle(id=9, cookie=7)).data
    js = twin.jax()
    jv = js.find_volume(1)
    twin.flip_needle(1, 9)
    corrupt = next(n for _, n in scanner.scan_volume(v).corrupt)
    jcorrupt = next(n for _, n in jax_scanner.scan_volume(jv).corrupt)
    # a replica serving WRONG bytes is rejected by the CRC pin
    assert planner.repair_needle(v, corrupt, lambda vid, n: b"wrong") is \
        jax_planner.repair_needle(jv, jcorrupt, lambda vid, n: b"wrong") \
        is False
    assert planner.repair_needle(v, corrupt, lambda vid, n: None) is False
    # the right bytes land, even on a sealed volume, and the seal stays
    v.read_only = jv.read_only = True
    assert planner.repair_needle(v, corrupt, lambda vid, n: good)
    assert jax_planner.repair_needle(jv, jcorrupt, lambda vid, n: good)
    assert v.read_only and jv.read_only
    assert v.read_needle(Needle(id=9, cookie=7)).data == good == \
        jv.read_needle(JaxNeedle(id=9, cookie=7)).data
    assert scanner.scan_volume(v).corrupt == []


# -- daemon ---------------------------------------------------------------------

def _both_passes(twin, port_kw=None, jax_kw=None, passes=1):
    js = twin.jax() if twin.jax_store is None else twin.jax_store
    d = ScrubDaemon(twin.port, backend="cpu", **(port_kw or {}))
    jd = JaxScrubDaemon(js, backend="numpy", **(jax_kw or {}))
    out = []
    for _ in range(passes):
        got, want = d.run_pass(), jd.run_pass()
        assert _pass_fields(got) == _pass_fields(want)
        out.append(got)
    assert d.status()["passes_completed"] == passes
    return out


def test_daemon_clean_pass(twin):
    twin.fill(1)
    twin.make_ec(2)
    (res,) = _both_passes(twin)
    assert res.corruptions_found == 0 and res.needles_verified == 45
    assert res.stripes_verified > 0


def test_daemon_repairs_parity_and_data_shards(twin):
    name = twin.make_ec(2)
    ecv = twin.port.find_ec_volume(2)
    _, _, ivs = ecv.locate_needle(4)
    sid, soff = ivs[0].to_shard_and_offset(ecv.large_block,
                                           ecv.small_block)
    pristine = _read(os.path.join(twin.port_dir, f"{name}.ec{sid:02d}"))
    twin.jax()
    twin.flip(f"{name}.ec13", 123)
    twin.flip(f"{name}.ec{sid:02d}", soff + 40)
    first, second = _both_passes(twin, passes=2)
    assert (first.corruptions_found, first.corruptions_repaired,
            first.unrecoverable) == (2, 2, 0)
    assert second.corruptions_found == 0
    for p in twin.paths(f"{name}.ec{sid:02d}"):
        assert _read(p) == pristine and os.path.exists(p + ".corrupt")
    got = ecv.read_needle(Needle(id=4, cookie=7))
    assert masked_crc(got.data) == got.checksum


@pytest.mark.parametrize("partial", [False, True])
def test_daemon_dead_space_flip_repaired(twin, partial):
    """Damage outside any live needle leaves no CRC evidence: the
    syndrome probe pins the data shard (also with only 3 parity shards
    local), so it comes back byte-identical."""
    name = twin.make_ec(2)
    shard = 7 if partial else 5
    if partial:
        twin.port.find_ec_volume(2).unmount_shard(13)
        os.remove(os.path.join(twin.port_dir, f"{name}.ec13"))
    twin.jax()
    path = os.path.join(twin.port_dir, f"{name}.ec{shard:02d}")
    pristine = _read(path)
    twin.flip(f"{name}.ec{shard:02d}", len(pristine) - 100)
    first, second = _both_passes(twin, passes=2)
    assert first.corruptions_repaired >= 1 and second.corruptions_found == 0
    for p in twin.paths(f"{name}.ec{shard:02d}"):
        assert _read(p) == pristine and os.path.exists(p + ".corrupt")


@pytest.mark.parametrize("with_replica", [True, False])
def test_daemon_needle_repair(twin, with_replica):
    v = twin.fill(1)
    good = v.read_needle(Needle(id=2, cookie=7)).data
    twin.jax()
    twin.flip_needle(1, 2)
    kw = {"replica_fetch": lambda vid, n: good} if with_replica else {}
    (res,) = _both_passes(twin, kw, kw)
    assert res.corruptions_found == 1
    assert res.corruptions_repaired == int(with_replica)
    assert res.unrecoverable == int(not with_replica)
    if with_replica:
        assert v.read_needle(Needle(id=2, cookie=7)).data == good


def test_daemon_volume_ids_filter(twin):
    twin.fill(1)
    twin.fill(2)
    js = twin.jax()
    twin.flip_needle(2, 1)
    d = ScrubDaemon(twin.port, backend="cpu")
    jd = JaxScrubDaemon(js, backend="numpy")
    for vids, found in (([1], 0), ([2], 1)):
        got, want = d.run_pass(volume_ids=vids), jd.run_pass(volume_ids=vids)
        assert _pass_fields(got) == _pass_fields(want)
        assert got.corruptions_found == found


def test_daemon_mesh_verify_matches_jax_mesh(twin, monkeypatch):
    """mesh_cfg: the fused verify rides pod_verify_ec_files over a
    4-CPU-device port mesh (dp=2, sp=2: the two volumes fill its slots),
    the JAX daemon over its 8-device mesh; detection, repair and every
    count agree. Half the JAX bucket over half its dp gives the same
    spans, so the stripe counts agree too."""
    names = [twin.make_ec(vid) for vid in (2, 3)]
    twin.jax()
    twin.flip(f"{names[0]}.ec11", 123)
    twin.flip(f"{names[1]}.ec12", 4321)
    mesh = make_mesh(devices=[torch.device("cpu")] * 4)
    from seaweedfs_tpu_torch.parallel import mesh_fleet
    monkeypatch.setattr(mesh_fleet, "DEFAULT_BUCKET_MB", 1)
    before = mesh_fleet.FleetMeshBucketsCounter.labels("verify").value
    first, second = _both_passes(
        twin, {"mesh_cfg": {"mesh": mesh}},
        {"mesh_cfg": {"min_volumes": 1, "bucket_mb": 2}}, passes=2)
    assert mesh_fleet.FleetMeshBucketsCounter.labels("verify").value > before
    assert first.corruptions_found == first.corruptions_repaired == 2
    assert second.corruptions_found == 0


def test_daemon_on_the_card_never_falls_back_to_the_host(twin):
    """backend="cuda" (the default) on a host without a card: the pass
    raises instead of running on the CPU."""
    twin.make_ec(2)
    d = ScrubDaemon(twin.port)
    assert d.backend == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        d.run_pass()


def test_construction_starts_no_thread_and_no_codec(twin, monkeypatch):
    twin.make_ec(2)
    made = []
    monkeypatch.setattr(daemon_mod, "ReedSolomon",
                        lambda *a, **kw: made.append(kw))
    monkeypatch.setattr(fleet, "ReedSolomon",
                        lambda *a, **kw: made.append(kw))
    before = threading.active_count()
    ScrubDaemon(twin.port, mesh_cfg={})
    assert threading.active_count() == before
    assert made == []
    assert not torch.cuda.is_initialized()


def test_start_pause_resume_stop(twin):
    twin.fill(1, n=5)
    d = ScrubDaemon(twin.port, backend="cpu", interval_s=0.05)
    assert d.status()["state"] == "idle"
    assert d.pause() is False          # nothing to pause
    assert d.start()
    try:
        for _ in range(200):
            if d.status()["passes_completed"]:
                break
            time.sleep(0.02)
        assert d.status()["passes_completed"] >= 1
        assert d.pause() is True
        assert d.status()["state"] == "paused"
        assert d.start() is True       # resumes the paused thread
        assert d.status()["state"] == "running"
        assert d.start() is False      # already running, un-paused
    finally:
        d.stop()
    assert d.status()["state"] == "idle"
    assert d.start() is False          # stopped for good
    assert d._thread is None or not d._thread.is_alive()


def test_targeted_start_does_not_narrow_periodic_passes(twin):
    v1 = twin.fill(1, n=3)
    twin.fill(2, n=3)
    nv = v1.nm.get(1)
    _flip(v1.dat_path, nv.offset + 16 + 4 + 3)
    d = ScrubDaemon(twin.port, backend="cpu", interval_s=0.05)
    assert d.start(volume_ids=[2], throttle_mbps=999.0)
    try:
        for _ in range(200):
            if d.totals.corruptions_found:
                break
            time.sleep(0.05)
        assert d.totals.corruptions_found >= 1
        assert d.mbps == 0.0  # the one-off budget did not stick
    finally:
        d.stop()


def test_scan_lag_gauge_moves_between_scrapes(twin):
    def scrape() -> float:
        for line in REGISTRY.render().splitlines():
            if line.startswith("SeaweedFS_scrub_scan_lag_seconds "):
                return float(line.rsplit(" ", 1)[1])
        raise AssertionError("gauge not exported")

    twin.fill(1, n=2)
    d = ScrubDaemon(twin.port, backend="cpu")
    d.run_pass()
    first = scrape()
    time.sleep(0.2)
    assert scrape() >= first + 0.15
    del d
    assert scrape() == 0.0   # a dead daemon is not reported
