"""The port's volume maintenance held against the JAX package's, on the CPU.

Vacuum (compact, commit, crash recovery), incremental backup and tail,
the tiers (a sealed .dat, and EC shards, moved to a memory backend and
back), the JSON query engine, the scrub stagger plan and the targeted EC
scrub. Every storage case writes its volume from seeded needles through
one package, copies the directory byte for byte, runs the same steps
through ``seaweedfs_tpu.storage`` on one copy and
``seaweedfs_tpu_torch.storage`` on the other, and compares the files
they leave and the needles they serve. The wall clock that stamps each
needle's append time is replaced by a counter, so .dat bytes compare.
Mirrors ``tests/test_vacuum.py``, ``tests/test_backup_tier.py``,
``tests/test_query_images.py`` and ``tests/test_scrub.py``.

The cluster cases run port servers in process with ``ec_encoder="cpu"``
(``tests/test_torch_cluster.py``'s ``Cluster``): the maintenance RPCs,
the ``volume.*``, collection and lock commands, the master's vacuum
vacuum pass, cron and scrub scheduler, the commands that stay out, and the
stale shard-location fault (ROADMAP Queue 3). They mirror
``tests/test_cluster.py:136-180``, ``tests/test_shell.py:283-508`` and
``tests/test_maintenance.py:44``.
"""

import hashlib
import json
import os
import shutil
import threading
import time
import urllib.error
from types import SimpleNamespace

import numpy as np
import pytest

import seaweedfs_tpu.ec.ec_volume as jax_ec_volume
import seaweedfs_tpu.query as jax_query
import seaweedfs_tpu.storage.backend as jax_bk
import seaweedfs_tpu.storage.needle_map as jax_nm
import seaweedfs_tpu.storage.store as jax_store
import seaweedfs_tpu.storage.vacuum as jax_vacuum
import seaweedfs_tpu.storage.volume as jax_volume
import seaweedfs_tpu.storage.volume_backup as jax_backup
import seaweedfs_tpu.storage.volume_tier as jax_tier
from seaweedfs_tpu.ec import encoder as jax_encoder
from seaweedfs_tpu.server.master import \
    plan_scrub_stagger as jax_plan_scrub_stagger
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
import seaweedfs_tpu_torch.ec.ec_volume as port_ec_volume
import seaweedfs_tpu_torch.query as port_query
import seaweedfs_tpu_torch.storage.backend as port_bk
import seaweedfs_tpu_torch.storage.needle_map as port_nm
import seaweedfs_tpu_torch.storage.store as port_store
import seaweedfs_tpu_torch.storage.vacuum as port_vacuum
import seaweedfs_tpu_torch.storage.volume as port_volume
import seaweedfs_tpu_torch.storage.volume_backup as port_backup
import seaweedfs_tpu_torch.storage.volume_tier as port_tier
from seaweedfs_tpu_torch.ec import fleet, store_ec
from seaweedfs_tpu_torch.server.master import plan_scrub_stagger
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.superblock import (ReplicaPlacement,
                                                    SuperBlock)
from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.ec.encoder import shard_file_name
from seaweedfs_tpu_torch.operation.file_id import parse_fid
from seaweedfs_tpu_torch.pb import (master_pb2, master_stub,
                                    volume_server_pb2, volume_stub)
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.shell import CommandError, Shell
from tests.test_torch_cluster import (Cluster, _assert_shards_are_the_snapshots,
                                      _fill_volume, _jax_encoded_snapshot,
                                      _sha, free_port_pair, holder, wait_for)

JAX = SimpleNamespace(
    name="jax", Volume=jax_volume.Volume, Needle=JaxNeedle,
    vacuum=jax_vacuum, backup=jax_backup, tier=jax_tier, bk=jax_bk,
    EcVolume=jax_ec_volume.EcVolume, Store=jax_store.Store,
    NeedleMap=jax_nm.NeedleMap, query=jax_query)
PORT = SimpleNamespace(
    name="port", Volume=port_volume.Volume, Needle=Needle,
    vacuum=port_vacuum, backup=port_backup, tier=port_tier, bk=port_bk,
    EcVolume=port_ec_volume.EcVolume, Store=port_store.Store,
    NeedleMap=port_nm.NeedleMap, query=port_query)
PKGS = {"jax": JAX, "port": PORT}


@pytest.fixture
def clock(monkeypatch):
    """time.time_ns as a counter that restart() sets back, so both
    packages stamp the same append times."""
    state = {"ns": 0}

    def fake():
        state["ns"] += 1000
        return 1_700_000_000_000_000_000 + state["ns"]

    monkeypatch.setattr(time, "time_ns", fake)
    return SimpleNamespace(restart=lambda: state.update(ns=0))


@pytest.fixture(autouse=True)
def _clean_backends():
    for pkg in PKGS.values():
        pkg.bk.clear_backends()
    yield
    for pkg in PKGS.values():
        pkg.bk.clear_backends()


def files_of(d) -> dict:
    """{relative path: bytes} of every file under d."""
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def needle(pkg, i: int, size: int = 100, cookie=None):
    rng = np.random.default_rng(i)
    return pkg.Needle(id=i + 1, cookie=0x1000 + i if cookie is None
                      else cookie,
                      data=rng.integers(0, 256, size,
                                        dtype=np.uint8).tobytes())


def write_history(pkg, d, vid: int, seed: int, n: int = 80,
                  ids: int = 24, kind: str = "memory"):
    """A volume with overwrites and deletes, from a seeded generator;
    returns (volume, {id: (cookie, data)} of the live needles)."""
    rng = np.random.default_rng(seed)
    v = pkg.Volume(str(d), "", vid, needle_map_kind=kind)
    cookies = {i: int(rng.integers(1, 1 << 32)) for i in range(1, ids + 1)}
    live = {}
    for _ in range(n):
        nid = int(rng.integers(1, ids + 1))
        if rng.random() < 0.72:
            data = rng.integers(0, 256, int(rng.integers(1, 3000)),
                                dtype=np.uint8).tobytes()
            v.write_needle(pkg.Needle(id=nid, cookie=cookies[nid],
                                      data=data))
            live[nid] = (cookies[nid], data)
        elif nid in live:
            v.delete_needle(pkg.Needle(id=nid, cookie=cookies[nid]))
            live.pop(nid)
    return v, live


def served(pkg, v, ids) -> dict:
    """{id: data or the error's class name} for needle ids 1..ids."""
    out = {}
    for i in range(1, ids + 1):
        try:
            out[i] = bytes(v.read_needle(pkg.Needle(id=i, cookie=0)).data)
        except Exception as e:  # noqa: BLE001 - compared, not swallowed
            out[i] = type(e).__name__
    return out


def twin_dirs(tmp_path, src):
    """Two byte copies of directory src: (the JAX one, the port one)."""
    out = []
    for name in ("jax", "port"):
        d = tmp_path / name
        shutil.copytree(src, d)
        out.append(d)
    return out


# -- vacuum ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["memory", "kv"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vacuum_of_a_jax_volume_equals_the_jax_vacuum(tmp_path, clock,
                                                      kind, seed):
    src = tmp_path / "src"
    src.mkdir()
    v, live = write_history(JAX, src, 7, seed)
    ratio = v.garbage_ratio()
    v.close()
    jd, pd = twin_dirs(tmp_path, src)
    jv = JAX.Volume(str(jd), "", 7)
    pv = PORT.Volume(str(pd), "", 7, needle_map_kind=kind)
    assert pv.garbage_ratio() == jv.garbage_ratio() == ratio > 0
    assert jax_vacuum.vacuum_volume(jv, 0.0)
    assert port_vacuum.vacuum_volume(pv, 0.0)
    for ext in (".dat", ".idx"):
        with open(jd / f"7{ext}", "rb") as a, open(pd / f"7{ext}", "rb") as b:
            assert a.read() == b.read(), ext
    assert pv.super_block.compaction_revision == 1
    assert pv.garbage_ratio() == jv.garbage_ratio() == 0.0
    assert served(PORT, pv, 24) == served(JAX, jv, 24)
    assert {i: d for i, d in served(PORT, pv, 24).items()
            if isinstance(d, bytes)} == {i: d for i, (_, d) in live.items()}
    jv.close()
    pv.close()


def test_vacuum_below_the_threshold_does_nothing(tmp_path):
    v = PORT.Volume(str(tmp_path), "", 3)
    for i in range(5):
        v.write_needle(needle(PORT, i))
    assert not port_vacuum.vacuum_volume(v)
    assert v.super_block.compaction_revision == 0
    v.close()


def _mid_compaction(pkg, d):
    """tests/test_vacuum.py:54: writes, a delete and an overwrite that
    land between the compact scan and the commit."""
    d.mkdir()
    v = pkg.Volume(str(d), "", 7)
    base = [needle(pkg, i) for i in range(10)]
    for n in base:
        v.write_needle(n)
    v.delete_needle(pkg.Needle(id=base[0].id, cookie=base[0].cookie))
    state = pkg.vacuum.compact(v)
    late = needle(pkg, 50)
    v.write_needle(late)
    v.delete_needle(pkg.Needle(id=base[1].id, cookie=base[1].cookie))
    over = needle(pkg, 51, cookie=base[2].cookie)
    over.id = base[2].id
    v.write_needle(over)
    pkg.vacuum.commit_compact(v, state)
    got = served(pkg, v, 60)
    v.close()
    return got


def test_commit_catches_up_mid_compaction_writes(tmp_path, clock):
    want = _mid_compaction(JAX, tmp_path / "jax")
    clock.restart()
    got = _mid_compaction(PORT, tmp_path / "port")
    assert got == want
    assert got[51] == needle(PORT, 50).data
    assert got[3] == needle(PORT, 51).data
    assert got[1] == got[2] == "NeedleError"
    assert files_of(tmp_path / "port") == files_of(tmp_path / "jax")


def test_commit_keeps_a_replication_changed_mid_compaction(tmp_path):
    v = PORT.Volume(str(tmp_path), "", 8)
    for i in range(10):
        v.write_needle(needle(PORT, i))
    for i in range(5):
        v.delete_needle(needle(PORT, i))
    state = port_vacuum.compact(v)
    v.configure_replication(ReplicaPlacement.parse("010"))
    port_vacuum.commit_compact(v, state)
    assert str(v.replica_placement) == "010"
    assert v.super_block.compaction_revision == 1
    v.close()
    v2 = PORT.Volume(str(tmp_path), "", 8, create_if_missing=False)
    assert str(v2.replica_placement) == "010"
    v2.close()


def _crash_state(pkg, d, state: str):
    """Leave a volume directory in one of the states a crash mid-vacuum
    can leave (tests/test_vacuum.py:106-231)."""
    v = pkg.Volume(str(d), "", 11)
    needles = [needle(pkg, i) for i in range(6)]
    for n in needles:
        v.write_needle(n)
    for n in needles[:3]:
        v.delete_needle(pkg.Needle(id=n.id, cookie=n.cookie))
    if state == "clean":
        v.close()
        return
    cs = pkg.vacuum.compact(v)
    if state == "acked_after_scan":
        for i in range(10, 14):
            v.write_needle(needle(pkg, i, size=64))
    v.close()
    if state == "between_renames":
        os.replace(cs.cpd_path, str(d / "11.dat"))
    elif state == "cpd_only":
        os.remove(cs.cpx_path)


CRASH_STATES = ["clean", "shadows_left", "acked_after_scan",
                "between_renames", "cpd_only"]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("state", CRASH_STATES)
def test_crash_states_recover_alike(tmp_path, clock, writer, state):
    """Shadow files left by either package are recovered by both the
    same way: the same files, the same needles, no shadow left."""
    src = tmp_path / "src"
    src.mkdir()
    _crash_state(PKGS[writer], src, state)
    jd, pd = twin_dirs(tmp_path, src)
    jv = JAX.Volume(str(jd), "", 11, create_if_missing=False)
    pv = PORT.Volume(str(pd), "", 11, create_if_missing=False)
    try:
        assert served(PORT, pv, 16) == served(JAX, jv, 16)
        assert pv.file_count == jv.file_count
        assert pv.garbage_ratio() == jv.garbage_ratio()
        for d in (jd, pd):
            assert not (d / "11.cpd").exists()
            assert not (d / "11.cpx").exists()
    finally:
        jv.close()
        pv.close()
    assert files_of(pd) == files_of(jd)
    # a second reload is stable: recovery leaves nothing to redo
    pv = PORT.Volume(str(pd), "", 11, create_if_missing=False)
    pv.close()
    assert files_of(pd) == files_of(jd)


def test_port_vacuumed_volume_opens_in_the_jax_store(tmp_path, clock):
    d = tmp_path / "v"
    d.mkdir()
    v, live = write_history(PORT, d, 5, seed=9)
    assert port_vacuum.vacuum_volume(v, 0.0)
    v.close()
    js = JAX.Store([str(d)], [10])
    try:
        for nid, (cookie, data) in live.items():
            got = js.read_needle(5, JaxNeedle(id=nid, cookie=cookie))
            assert got.data == data
        assert js.find_volume(5).super_block.compaction_revision == 1
    finally:
        js.close()


def test_vacuum_under_eight_group_commit_writers(tmp_path):
    """Eight threads write with fsync (so every write rides the
    group-commit writer) while the volume is vacuumed again and again:
    every acknowledged write reads back, and no record is doubled."""
    v = PORT.Volume(str(tmp_path), "", 4)
    for i in range(40):
        v.write_needle(needle(PORT, i, size=500))
    acked = {}
    lock = threading.Lock()
    stop = threading.Event()
    errors = []

    def writer(t):
        rng = np.random.default_rng(t)
        k = 0
        try:
            while not stop.is_set() and k < 120:
                nid = 1000 + t * 1000 + int(rng.integers(0, 40))
                data = rng.integers(0, 256, int(rng.integers(1, 900)),
                                    dtype=np.uint8).tobytes()
                v.write_needle(Needle(id=nid, cookie=7, data=data),
                               fsync=True)
                with lock:
                    acked[nid] = data
                k += 1
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(8)]
    for th in threads:
        th.start()
    for i in range(40):
        v.delete_needle(needle(PORT, i))
    rounds = 0
    while any(th.is_alive() for th in threads):
        port_vacuum.commit_compact(v, port_vacuum.compact(v))
        rounds += 1
    stop.set()
    for th in threads:
        th.join()
    port_vacuum.commit_compact(v, port_vacuum.compact(v))
    assert not errors and rounds >= 1
    assert v.commit_stats()[2] > 0   # the writer thread committed batches
    for nid, data in acked.items():
        assert v.read_needle(Needle(id=nid, cookie=7)).data == data
    assert v.file_count == len(acked)
    assert v.garbage_ratio() == 0.0
    v.close()
    v2 = PORT.Volume(str(tmp_path), "", 4, create_if_missing=False)
    for nid, data in acked.items():
        assert v2.read_needle(Needle(id=nid, cookie=7)).data == data
    v2.close()


def _map_items(nm) -> dict:
    return {k: (nv.offset, nv.size) for k, nv in nm.items()}


@pytest.mark.parametrize("garbage", [True, False])
def test_vacuum_on_the_kv_map_keeps_offsets_right(tmp_path, clock, garbage):
    """After a vacuum on -index kv every needle's (offset, size) equals
    the memory map's over the same .idx, also after a reopen; with no
    garbage the compacted .idx has as many entries as the old one."""
    v = PORT.Volume(str(tmp_path), "", 6, needle_map_kind="kv")
    for i in range(30):
        v.write_needle(needle(PORT, i, size=200 + 37 * i))
    if garbage:
        for i in range(0, 30, 3):
            v.delete_needle(needle(PORT, i))
    entries = os.path.getsize(v.idx_path) // 16
    state = port_vacuum.compact(v)
    v.write_needle(needle(PORT, 77, size=333))   # a makeup-diff record
    port_vacuum.commit_compact(v, state)
    if not garbage:
        assert os.path.getsize(v.idx_path) // 16 == entries + 1
    want = _map_items(PORT.NeedleMap(v.idx_path))
    assert _map_items(v.nm) == want
    for k in want:
        assert v.read_needle(Needle(id=k, cookie=0)).id == k
    v.close()
    v2 = PORT.Volume(str(tmp_path), "", 6, create_if_missing=False,
                     needle_map_kind="kv")
    assert _map_items(v2.nm) == want
    v2.close()


# -- backup and tail ------------------------------------------------------------


def _fill(pkg, d, vid=1, n=20):
    v = pkg.Volume(str(d), "", vid)
    for i in range(1, n + 1):
        v.write_needle(pkg.Needle(id=i, cookie=0x10 + i,
                                  data=b"payload-%d" % i))
    return v


def _ship(pkg, src, dst) -> int:
    since = pkg.backup.last_append_at_ns(dst)
    off, is_last = pkg.backup.binary_search_by_append_at_ns(src, since)
    chunks = [] if is_last else pkg.backup.read_dat_range(src, off)
    return pkg.backup.apply_incremental(dst, chunks)


def _backup_run(pkg, root):
    (root / "src").mkdir(parents=True)
    (root / "dst").mkdir()
    src = _fill(pkg, root / "src", vid=4, n=6)
    dst = pkg.Volume(str(root / "dst"), "", 4)
    out = [pkg.backup.sync_status(src), _ship(pkg, src, dst)]
    src.write_needle(pkg.Needle(id=7, cookie=0x17, data=b"payload-7"))
    src.delete_needle(pkg.Needle(id=2, cookie=0x12))
    out += [_ship(pkg, src, dst), _ship(pkg, src, dst),
            pkg.backup.binary_search_by_append_at_ns(src, 0),
            pkg.backup.last_append_at_ns(dst), served(pkg, dst, 8)]
    src.close()
    dst.close()
    return out


def test_incremental_backup_equals_jax(tmp_path, clock):
    want = _backup_run(JAX, tmp_path / "jax")
    clock.restart()
    got = _backup_run(PORT, tmp_path / "port")
    assert got == want
    assert got[1] > 0 and got[2] > 0 and got[3] == 0
    assert got[-1][7] == b"payload-7" and got[-1][2] == "NeedleError"
    assert files_of(tmp_path / "port") == files_of(tmp_path / "jax")


def test_binary_search_by_append_at_ns(tmp_path, clock):
    v = PORT.Volume(str(tmp_path), "", 3)
    offsets, stamps = [], []
    for i in range(1, 11):
        off, _ = v.write_needle(Needle(id=i, cookie=i, data=b"d%d" % i))
        offsets.append(off)
        stamps.append(v.last_append_at_ns)
    assert port_backup.binary_search_by_append_at_ns(v, 0) == \
        (offsets[0], False)
    assert port_backup.binary_search_by_append_at_ns(v, stamps[4]) == \
        (offsets[5], False)
    assert port_backup.binary_search_by_append_at_ns(v, stamps[-1])[1]
    v.close()
    # the newest append time survives a reopen
    v2 = PORT.Volume(str(tmp_path), "", 3, create_if_missing=False)
    assert v2.last_append_at_ns == stamps[-1]
    v2.close()


# -- tiers ----------------------------------------------------------------------


def _tier_run(pkg, d):
    d.mkdir()
    be = pkg.bk.register_backend(pkg.bk.MemoryBackendStorage("memory.t"))
    v = _fill(pkg, d, vid=1)
    out = []
    try:
        pkg.tier.move_dat_to_remote(v, "memory.t")
    except pkg.volume_error as e:
        out.append(type(e).__name__)
    v.read_only = True
    out.append(pkg.tier.move_dat_to_remote(v, "memory.t", owner="h:1"))
    out.append(os.path.exists(v.dat_path))
    out.append(v.read_needle(pkg.Needle(id=7, cookie=0x17)).data)
    with open(str(d / "1.tier"), "rb") as f:
        out.append(f.read())
    v.close()
    v2 = pkg.Volume(str(d), "", 1, create_if_missing=False)
    out += [v2.is_remote, v2.read_only, served(pkg, v2, 21)]
    out.append(pkg.tier.move_dat_from_remote(v2))
    out += [v2.is_remote, be.object_size("volumes/h_1/1.dat"),
            served(pkg, v2, 21)]
    v2.close()
    return out


def test_tier_round_trip_equals_jax(tmp_path, clock):
    JAX.volume_error = jax_volume.VolumeError
    PORT.volume_error = port_volume.VolumeError
    want = _tier_run(JAX, tmp_path / "jax")
    clock.restart()
    got = _tier_run(PORT, tmp_path / "port")
    assert got == want
    assert got[0] == "VolumeError" and got[2] is False
    assert json.loads(got[4]) == {"backend": "memory.t",
                                  "key": "volumes/h_1/1.dat",
                                  "size": got[1]}
    assert files_of(tmp_path / "port") == files_of(tmp_path / "jax")


def _ec_dir(tmp_path) -> str:
    """An EC volume written by the JAX package (numpy codec)."""
    d = tmp_path / "ec_src"
    d.mkdir()
    v = JAX.Volume(str(d), "", 3)
    rng = np.random.default_rng(5)
    for i in range(1, 60):
        v.write_needle(JaxNeedle(id=i, cookie=9, data=rng.integers(
            0, 256, int(rng.integers(100, 3000)), dtype=np.uint8).tobytes()))
    v.close()
    base = str(d / "3")
    jax_encoder.write_ec_files(base, backend="numpy")
    jax_encoder.write_sorted_file_from_idx(base)
    for ext in (".dat", ".idx"):
        os.remove(base + ext)
    return d


def _ec_tier_run(pkg, d):
    pkg.bk.register_backend(pkg.bk.MemoryBackendStorage("memory.cold"))
    ecv = pkg.EcVolume(str(d), "", 3)
    for sid in (0, 1, 2, 11):
        ecv.mount_shard(sid)
    before = {sid: open(ecv.shards[sid].path, "rb").read()
              for sid in ecv.shards}
    out = [pkg.tier.move_ec_shards_to_remote(ecv, "memory.cold",
                                             owner="h:2")]
    out.append(sorted(n for n in os.listdir(d) if ".ec" in n))
    with open(str(d / "3.ectier"), "rb") as f:
        out.append(f.read())
    out.append([ecv.shards[s].read_at(100, 50) for s in (0, 1, 2, 11)])
    got = []
    for nid in range(1, 60):
        try:
            got.append(ecv.read_needle(pkg.Needle(id=nid, cookie=9)).data)
        except Exception as e:  # noqa: BLE001 - compared
            got.append(type(e).__name__)
    out.append(got)
    ecv.close()
    return out, before


def test_ec_shard_tier_equals_jax(tmp_path):
    src = _ec_dir(tmp_path)
    jd, pd = twin_dirs(tmp_path, src)
    want, _ = _ec_tier_run(JAX, jd)
    got, before = _ec_tier_run(PORT, pd)
    assert got == want
    assert "3.ec00" not in got[1] and "3.ectier" in got[1]
    assert sum(isinstance(x, bytes) for x in got[4]) > 10
    # a restart mounts the tiered shards from the sidecar, reads them,
    # and the download puts back the same bytes
    st = PORT.Store([str(pd)], [8])
    try:
        ecv = st.find_ec_volume(3)
        assert sorted(ecv.shards) == list(range(14))
        assert sorted(s for s in ecv.shards
                      if ecv.shards[s].is_remote) == [0, 1, 2, 11]
        assert port_tier.move_ec_shards_from_remote(ecv) == \
            sum(len(b) for b in before.values())
        for sid, blob in before.items():
            assert not ecv.shards[sid].is_remote
            with open(ecv.shards[sid].path, "rb") as f:
                assert f.read() == blob
        assert not os.path.exists(str(pd / "3.ectier"))
    finally:
        st.close()


def test_backend_registry_and_refusals(tmp_path):
    port_bk.load_configuration({"memory.alpha": {}})
    assert isinstance(port_bk.get_backend("memory.alpha"),
                      port_bk.MemoryBackendStorage)
    with pytest.raises(port_bk.BackendError, match="not configured"):
        port_bk.get_backend("memory.nope")
    with pytest.raises(port_bk.BackendError, match="unknown storage"):
        port_bk.load_configuration({"bogus.x": {}})
    # the s3 scheme is refused, naming the work it arrives with
    with pytest.raises(port_bk.BackendError, match="Queue 1 item 13"):
        port_bk.load_configuration({"s3.default": {"bucket": "b"}})
    with pytest.raises(port_bk.BackendError, match="Queue 1 item 13"):
        port_bk.get_backend("s3.default")


# -- query ----------------------------------------------------------------------


QUERY_DOCS = [{"age": 30, "name": "alice", "tags": ["x"]},
              {"user": {"id": 7, "name": "n"}, "score": 9},
              {"a": {"b": 2}, "items": [{"name": "x"}, {"name": "y"}]}]
QUERIES = [("age", "=", "30"), ("age", ">", "29"), ("age", "<=", "30"),
           ("age", "<", "30"), ("name", "=", "alice"),
           ("name", "!=", "bob"), ("name", "%", "ali*"), ("tags", "", ""),
           ("absent", "", ""), ("score", ">=", "5"), ("score", "<", "5"),
           ("items.1.name", "=", "y"), ("a.b", "", "")]


@pytest.mark.parametrize("q", QUERIES, ids=["-".join(q) for q in QUERIES])
def test_query_equals_jax(q):
    for doc in QUERY_DOCS:
        assert port_query.filter_json(doc, port_query.Query(*q)) == \
            jax_query.filter_json(doc, jax_query.Query(*q))
    data = b"\n".join(json.dumps(d).encode() for d in QUERY_DOCS) + \
        b"\nnot json\n\n"
    for proj in ([], ["user.id", "score"], ["name", "items.0.name"]):
        assert list(port_query.query_json_lines(
            data, proj, port_query.Query(*q))) == \
            list(jax_query.query_json_lines(data, proj, jax_query.Query(*q)))


def test_query_paths_and_bad_operand():
    doc = QUERY_DOCS[2]
    for path in ("a.b", "items.1.name", "a.missing", "items.9.name", ""):
        got = port_query.get_path(doc, path)
        want = jax_query.get_path(doc, path)
        assert (got is port_query.json_query._MISSING) == \
            (want is jax_query.json_query._MISSING)
        if want is not jax_query.json_query._MISSING:
            assert got == want
    with pytest.raises(ValueError):
        port_query.filter_json(QUERY_DOCS[0], port_query.Query("age", "~",
                                                               "1"))


# -- scrub ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_plan_scrub_stagger_equals_jax(seed):
    rng = np.random.default_rng(seed)
    urls = [f"10.0.0.{int(i)}:8080" for i in
            rng.integers(0, 255, int(rng.integers(0, 9)))]
    interval = float(rng.integers(1, 3600))
    assert plan_scrub_stagger(urls, interval) == \
        jax_plan_scrub_stagger(urls, interval)
    if urls:
        plan = plan_scrub_stagger(urls, interval)
        assert sum(w for _, w in plan) == pytest.approx(
            interval * (len(urls) - 1) / len(urls))


def test_targeted_ec_scrub(tmp_path):
    """tests/test_scrub.py:363-369: a flipped parity byte of one EC
    volume is found and repaired by the targeted pass; an unmounted vid
    is refused."""
    st = PORT.Store([str(tmp_path)], [8])
    try:
        st.add_volume(3)
        v = st.find_volume(3)
        rng = np.random.default_rng(1)
        for i in range(1, 30):
            v.write_needle(Needle(id=i, cookie=7, data=rng.integers(
                0, 256, 4096, dtype=np.uint8).tobytes()))
        base = store_ec.generate_ec_shards(st, 3, backend="cpu")
        store_ec.mount_ec_shards(st, 3, "", range(14))
        assert st.delete_volume(3)
        with open(base + ".ec12", "rb") as f:
            pristine = f.read()
        with open(base + ".ec12", "r+b") as f:
            f.seek(64)
            b = f.read(1)
            f.seek(64)
            f.write(bytes([b[0] ^ 0xFF]))
        repaired = []
        res = store_ec.scrub_ec_volume(st, 3, backend="cpu",
                                       on_repair=repaired.append)
        assert (res.corruptions_found, res.corruptions_repaired) == (1, 1)
        assert repaired == [3]
        with open(base + ".ec12", "rb") as f:
            assert f.read() == pristine
        assert fleet.fleet_verify_ec_files([base], backend="cpu")[base].clean
        with pytest.raises(store_ec.EcShardNotFound):
            store_ec.scrub_ec_volume(st, 99, backend="cpu")
    finally:
        st.close()


def test_scrub_leaves_tiered_shards_alone(tmp_path):
    """A pass over an EC volume whose shards were tiered reports no
    damage and rebuilds nothing: the bytes are the backend's."""
    port_bk.register_backend(port_bk.MemoryBackendStorage("memory.s"))
    d = _ec_dir(tmp_path)
    st = PORT.Store([str(d)], [8])
    try:
        ecv = st.find_ec_volume(3)
        port_tier.move_ec_shards_to_remote(ecv, "memory.s")
        res = store_ec.scrub_ec_volume(st, 3, backend="cpu")
        assert (res.corruptions_found, res.unrecoverable) == (0, 0)
        assert not any(n.endswith(".corrupt") or n.startswith("3.ec0")
                       for n in os.listdir(d))
    finally:
        st.close()


# -- maintenance: vacuum, admin RPCs, volume.* and the master's loops ------------
# (tests/test_cluster.py:136-180, tests/test_shell.py:283-508,
# tests/test_maintenance.py:44, tests/test_backup_tier.py:190-223)


@pytest.fixture(scope="module")
def mcluster(tmp_path_factory):
    """The maintenance tests' own cluster: each of them grows the seven
    volumes of a collection of its own."""
    c = Cluster(tmp_path_factory.mktemp("maintenance"), volumes_per_server=60)
    yield c
    c.stop()


def _holders(c, vid: int, collection: str = "") -> list:
    """The urls the master gives for vid now; empty (not an error) while
    a move's heartbeats are on their way."""
    return sorted(u for u, _ in c.master.lookup_locations(vid, collection))


def _holder_server(c, fid: str) -> VolumeServer:
    f = parse_fid(fid)
    return c.server(holder(c.master, f.volume_id))


def test_batch_delete_rpc(mcluster):
    fid = mcluster.upload(b"bd0")
    f = parse_fid(fid)
    vs = _holder_server(mcluster, fid)
    wrong = f"{f.volume_id},{f.key:x}{f.cookie ^ 1:08x}"
    resp = volume_stub(vs.url).BatchDelete(volume_server_pb2.BatchDeleteRequest(
        file_ids=[wrong, fid, "garbage", fid]))
    assert [r.status for r in resp.results] == [403, 202, 400, 404]
    assert resp.results[1].size > 0
    with pytest.raises(urllib.error.HTTPError) as ei:
        mcluster.fetch(fid)
    assert ei.value.code == 404


def test_vacuum_reclaims_deleted_space(mcluster):
    datas = [os.urandom(2048) for _ in range(8)]
    fids = [mcluster.upload(d, collection="vac") for d in datas]
    by_vid = {}
    for fid, d in zip(fids, datas):
        by_vid.setdefault(parse_fid(fid).volume_id, []).append((fid, d))
    vid, files = max(by_vid.items(), key=lambda kv: len(kv[1]))
    assert len(files) >= 2
    url = holder(mcluster.master, vid, "vac")
    v = mcluster.server(url).store.find_volume(vid)
    size_before = v.content_size
    with mcluster.http(f"{url}/{files[0][0]}", method="DELETE") as r:
        assert r.status == 202
    check = volume_stub(url).VacuumVolumeCheck(
        volume_server_pb2.VacuumVolumeCheckRequest(volume_id=vid))
    assert check.garbage_ratio == pytest.approx(v.garbage_ratio())
    assert check.garbage_ratio > 0
    with mcluster.http(
            f"{mcluster.master.url}/vol/vacuum?garbageThreshold=0.0001") as r:
        assert vid in json.load(r)["compacted"]
    assert v.content_size < size_before
    status = volume_stub(url).ReadVolumeFileStatus(
        volume_server_pb2.ReadVolumeFileStatusRequest(volume_id=vid))
    assert status.compaction_revision == 1
    with pytest.raises(urllib.error.HTTPError):
        mcluster.fetch(files[0][0])
    for fid, d in files[1:]:
        with mcluster.fetch(fid) as r:
            assert r.read() == d


def test_shell_volume_vacuum_and_cleanup(mcluster):
    fids = [mcluster.upload(os.urandom(1500), collection="vac2")
            for _ in range(4)]
    vid = parse_fid(fids[0]).volume_id
    url = holder(mcluster.master, vid, "vac2")
    for fid in fids:
        if parse_fid(fid).volume_id == vid:
            with mcluster.http(f"{url}/{fid}", method="DELETE"):
                pass
            break
    v = mcluster.server(url).store.find_volume(vid)
    rev = v.super_block.compaction_revision
    out = Shell(mcluster.master.url).run_command(
        "volume.vacuum -garbageThreshold=0.0001")
    assert "vacuum triggered" in out
    assert v.super_block.compaction_revision == rev + 1
    # a compaction with no commit is undone by the cleanup
    stub = volume_stub(url)
    stub.VacuumVolumeCompact(volume_server_pb2.VacuumVolumeCompactRequest(
        volume_id=vid))
    assert os.path.exists(v.file_name() + ".cpd")
    stub.VacuumVolumeCleanup(volume_server_pb2.VacuumVolumeCleanupRequest(
        volume_id=vid))
    assert not os.path.exists(v.file_name() + ".cpd")
    with pytest.raises(rpc.RpcError) as ei:
        stub.VacuumVolumeCommit(volume_server_pb2.VacuumVolumeCommitRequest(
            volume_id=vid))
    assert ei.value.code() == rpc.StatusCode.FAILED_PRECONDITION


def test_needle_status_configure_and_query(mcluster):
    docs = b"\n".join(json.dumps({"k": i, "name": f"n{i}"}).encode()
                      for i in range(10))
    fid = mcluster.upload(docs)
    f = parse_fid(fid)
    stub = volume_stub(holder(mcluster.master, f.volume_id))
    st = stub.VolumeNeedleStatus(volume_server_pb2.VolumeNeedleStatusRequest(
        volume_id=f.volume_id, needle_id=f.key))
    assert (st.needle_id, st.cookie, st.size) == \
        (f.key, f.cookie, st.size) and st.size > len(docs)
    with pytest.raises(rpc.RpcError) as ei:
        stub.VolumeNeedleStatus(volume_server_pb2.VolumeNeedleStatusRequest(
            volume_id=f.volume_id, needle_id=0xdeadbeef))
    assert ei.value.code() == rpc.StatusCode.NOT_FOUND
    assert not stub.VolumeConfigure(volume_server_pb2.VolumeConfigureRequest(
        volume_id=f.volume_id, replication="000")).error
    # any placement is taken: the superblock and the heartbeat carry it
    assert not stub.VolumeConfigure(volume_server_pb2.VolumeConfigureRequest(
        volume_id=f.volume_id, replication="001")).error
    v = mcluster.server(holder(mcluster.master, f.volume_id)) \
        .store.find_volume(f.volume_id)
    assert str(v.replica_placement) == "001"
    with open(v.file_name() + ".dat", "rb") as fh:
        assert str(SuperBlock.from_bytes(fh.read(8)).replica_placement) \
            == "001"
    wait_for(lambda: any(
        vi.replica_placement == 1 for vi in
        mcluster.master.topo.find_node(holder(
            mcluster.master, f.volume_id)).volumes.values()
        if vi.id == f.volume_id), what="the placement in the heartbeat")
    assert not stub.VolumeConfigure(volume_server_pb2.VolumeConfigureRequest(
        volume_id=f.volume_id, replication="000")).error
    stripes = list(stub.Query(volume_server_pb2.QueryRequest(
        from_file_ids=[fid], selections=["name"],
        filter=volume_server_pb2.QueryRequest.Filter(
            field="k", operand=">=", value="7"))))
    assert [json.loads(x) for x in stripes[0].records.splitlines()] == \
        [{"name": "n7"}, {"name": "n8"}, {"name": "n9"}]


def test_sync_status_incremental_copy_and_tail(mcluster):
    fid = mcluster.upload(b"tail-me-1", collection="tail")
    f = parse_fid(fid)
    src = holder(mcluster.master, f.volume_id, "tail")
    stub = volume_stub(src)
    st = stub.VolumeSyncStatus(volume_server_pb2.VolumeSyncStatusRequest(
        volume_id=f.volume_id))
    assert st.tail_offset > 8 and st.collection == "tail"
    got = b"".join(r.file_content for r in stub.VolumeIncrementalCopy(
        volume_server_pb2.VolumeIncrementalCopyRequest(
            volume_id=f.volume_id, since_ns=0)))
    assert b"tail-me-1" in got
    recv = next(vs for vs in mcluster.volume_servers if vs.url != src)
    recv.store.add_volume(f.volume_id, "tail")
    try:
        volume_stub(recv.url).VolumeTailReceiver(
            volume_server_pb2.VolumeTailReceiverRequest(
                volume_id=f.volume_id, since_ns=0, idle_timeout_seconds=1,
                source_volume_server=src))
        n = recv.store.read_needle(f.volume_id,
                                   __import__("seaweedfs_tpu_torch.storage."
                                              "needle", fromlist=["Needle"])
                                   .Needle(id=f.key, cookie=f.cookie))
        assert n.data == b"tail-me-1"
    finally:
        recv.store.delete_volume(f.volume_id)


def test_shell_tier_upload_and_download(mcluster):
    from seaweedfs_tpu_torch.storage import backend as bk
    bk.register_backend(bk.MemoryBackendStorage("memory.mcluster"))
    data = os.urandom(3000)
    fid = mcluster.upload(data, collection="tier")
    f = parse_fid(fid)
    vs = mcluster.server(holder(mcluster.master, f.volume_id, "tier"))
    v = vs.store.find_volume(f.volume_id)
    v.sync()
    dat = _sha(v.dat_path)
    sh = Shell(mcluster.master.url)
    out = sh.run_command(f"volume.tier.upload -volumeId={f.volume_id} "
                         "-dest=memory.mcluster")
    assert "-> memory.mcluster (100%)" in out
    assert v.is_remote and not os.path.exists(v.dat_path)
    with mcluster.fetch(fid) as r:
        assert r.read() == data
    out = sh.run_command(f"volume.tier.upload -volumeId={f.volume_id} "
                         "-dest=memory.mcluster")
    assert "already tiered, skipped" in out
    out = sh.run_command(f"volume.tier.download -volumeId={f.volume_id}")
    assert "bytes restored" in out and not v.is_remote
    assert _sha(v.dat_path) == dat
    with pytest.raises(CommandError, match="Queue 1 item 13"):
        sh.run_command(f"volume.tier.upload -volumeId={f.volume_id} "
                       "-dest=s3.default")


def test_shell_volume_commands(mcluster):
    sh = Shell(mcluster.master.url)
    assert "DataNode" in sh.run_command("volume.list")
    fid = mcluster.upload(b"move me", collection="mv")
    vid = parse_fid(fid).volume_id
    src = holder(mcluster.master, vid, "mv")
    dst = next(vs.url for vs in mcluster.volume_servers if vs.url != src)
    sh.run_command(f"volume.move -volumeId={vid} -source={src} "
                   f"-target={dst}")
    wait_for(lambda: _holders(mcluster, vid, "mv") == [dst],
             timeout=60, what="the master sees the move")
    with mcluster.fetch(fid) as r:
        assert r.read() == b"move me"
    assert not mcluster.server(dst).store.find_volume(vid).read_only
    # copy makes a second holder; the source keeps its own
    sh.run_command(f"volume.copy -volumeId={vid} -source={dst} "
                   f"-target={src}")
    wait_for(lambda: _holders(mcluster, vid, "mv") ==
             sorted({src, dst}), timeout=60, what="both holders")
    assert "readonly on" in sh.run_command(
        f"volume.mark -volumeId={vid} -readonly")
    assert all(mcluster.server(u).store.find_volume(vid).read_only
               for u in (src, dst))
    sh.run_command(f"volume.mark -volumeId={vid} -writable")
    sh.run_command(f"volume.unmount -volumeId={vid} -node={src}")
    assert mcluster.server(src).store.find_volume(vid) is None
    sh.run_command(f"volume.mount -volumeId={vid} -node={src}")
    assert mcluster.server(src).store.find_volume(vid) is not None
    sh.run_command(f"volume.delete -volumeId={vid} -node={src}")
    wait_for(lambda: _holders(mcluster, vid, "mv") == [dst],
             timeout=60, what="one holder again")
    with mcluster.fetch(fid) as r:
        assert r.read() == b"move me"


def test_volume_move_preserves_readonly(mcluster):
    fid = mcluster.upload(b"sealed blob", collection="seal")
    vid = parse_fid(fid).volume_id
    src = holder(mcluster.master, vid, "seal")
    dst = next(vs.url for vs in mcluster.volume_servers if vs.url != src)
    sh = Shell(mcluster.master.url)
    sh.run_command(f"volume.mark -volumeId={vid} -readonly")

    def seen_readonly():
        return any(vi.id == vid and vi.read_only
                   for _, _, dn in sh.env.data_nodes(sh.env.topology())
                   for vi in dn.volume_infos)
    wait_for(seen_readonly, timeout=60, what="readonly in the topology")
    sh.run_command(f"volume.move -volumeId={vid} -source={src} "
                   f"-target={dst}")
    assert mcluster.server(dst).store.find_volume(vid).read_only
    wait_for(lambda: _holders(mcluster, vid, "seal") == [dst],
             timeout=60, what="the master sees the move")
    with mcluster.fetch(fid) as r:
        assert r.read() == b"sealed blob"


@pytest.mark.parametrize("seed", range(3))
def test_evacuation_and_balance_plans_equal_jax(seed):
    from seaweedfs_tpu.shell import command_volume as jax_cv
    from seaweedfs_tpu.shell.command_env import EcNode as JaxEcNode
    from seaweedfs_tpu.ec.shard_bits import ShardBits as JaxShardBits
    from seaweedfs_tpu_torch.ec.shard_bits import ShardBits
    from seaweedfs_tpu_torch.shell import command_volume as cv
    from seaweedfs_tpu_torch.shell.command_env import EcNode
    rng = np.random.default_rng(seed)
    urls = [f"n{i}:1" for i in range(int(rng.integers(2, 6)))]
    counts = {u: sorted({int(x) for x in rng.integers(1, 30, int(
        rng.integers(0, 8)))}) for u in urls}
    maxes = {u: int(rng.integers(4, 12)) for u in urls}
    assert cv.plan_volume_balance(counts, maxes) == \
        jax_cv.plan_volume_balance(counts, maxes)
    assert cv.plan_server_evacuation(counts, maxes, urls[0]) == \
        jax_cv.plan_server_evacuation(counts, maxes, urls[0])
    shards = {u: {int(v): int(rng.integers(0, 1 << 14))
                  for v in rng.integers(1, 5, 2)} for u in urls}
    free = {u: int(rng.integers(0, 10)) for u in urls}
    port_nodes = [EcNode(u, free[u], {v: ShardBits(b) for v, b in
                                      shards[u].items()}) for u in urls]
    jax_nodes = [JaxEcNode(u, free[u], {v: JaxShardBits(b) for v, b in
                                        shards[u].items()}) for u in urls]
    got = cv.plan_ec_evacuation(port_nodes, urls[0])
    want = jax_cv.plan_ec_evacuation(jax_nodes, urls[0])
    assert [tuple(m) for m in got[0]] == [tuple(m) for m in want[0]]
    assert got[1] == want[1]


def test_volume_server_evacuate_and_leave(tmp_path):
    c = Cluster(tmp_path, n_volume_servers=3)
    try:
        sh = Shell(c.master.url)
        fids = [c.upload(os.urandom(512)) for _ in range(6)]
        victim = holder(c.master, parse_fid(fids[0]).volume_id)
        assert "dry run" in sh.run_command(
            f"volumeServer.evacuate -node={victim}")
        sh.run_command(f"volumeServer.evacuate -node={victim} "
                       "-skipNonMoveable -force")
        vs = c.server(victim)
        wait_for(lambda: not vs.store.collect_heartbeat()["volumes"],
                 what="the victim drained", timeout=60)
        for fid in fids:
            wait_for(lambda: _holders(c, parse_fid(fid).volume_id),
                     timeout=60, what="a location")
            with c.fetch(fid) as r:
                assert r.read()
        sh.run_command(f"volumeServer.leave -node={victim}")
        wait_for(lambda: victim not in {n.url for n in c.master.topo.nodes()},
                 timeout=60, what="the master forgets the node")
    finally:
        c.stop()


def test_collections_and_cluster_status(tmp_path):
    c = Cluster(tmp_path, n_volume_servers=2)
    try:
        sh = Shell(c.master.url)
        fids = [c.upload(os.urandom(700), collection="keep")
                for _ in range(3)]
        gone = [c.upload(os.urandom(900), collection="drop")
                for _ in range(3)]
        out = sh.run_command("collection.list")
        assert "collection: keep" in out and "collection: drop" in out
        stats = master_stub(c.master.url).Statistics(
            master_pb2.StatisticsRequest())

        def held() -> int:
            return sum(v.content_size for vs in c.volume_servers
                       for loc in vs.store.locations
                       for v in list(loc.volumes.values()))

        def reported():
            # a grown volume is registered at allocation with size 0; its
            # superblock's bytes arrive with a later heartbeat, which can
            # land after the six files are counted, so wait until the
            # master's sum is the servers' own
            st = master_stub(c.master.url).Statistics(
                master_pb2.StatisticsRequest())
            return st if st.file_count == 6 and \
                st.used_size == held() else None
        stats = wait_for(reported, timeout=60,
                         what="the servers' six files and bytes in the "
                              "statistics")
        out = sh.run_command("cluster.status")
        assert f"used bytes: {stats.used_size}" in out
        assert "files: 6" in out
        # every volume grown for "drop", not only those holding its
        # files: collection.list names a collection while any of its
        # layouts holds a vid
        drop = {parse_fid(f).volume_id for f in gone} | {
            vid for (col, _, _), vl in list(c.master.topo.layouts.items())
            if col == "drop" for vid in vl.volume_ids()}
        sh.run_command("collection.delete -collection=drop")
        for vs in c.volume_servers:
            assert not [n for n in os.listdir(vs.store.locations[0].directory)
                        if n.startswith("drop_")]
        wait_for(lambda: not any(c.master.topo.lookup(v, "drop")
                                 for v in drop), what="drop gone", timeout=60)
        assert "collection: drop" not in sh.run_command("collection.list")
        for fid in fids:
            with c.fetch(fid) as r:
                assert r.read()
    finally:
        c.stop()


def test_cron_ec_encodes_a_vacuumed_volume_unattended(tmp_path):
    """The master's cron (tests/test_maintenance.py:44) encodes a full
    volume with no operator; the shards equal the JAX numpy encode of
    the volume's .dat as the vacuum left it."""
    scripts = ["lock",
               "ec.encode -collection=cron -fullPercent=40 -quietFor=0",
               "ec.rebuild -collection=cron", "unlock"]
    c = Cluster(tmp_path, n_volume_servers=3, volume_size_limit_mb=1,
                master_kwargs=dict(maintenance_scripts=scripts,
                                   maintenance_interval_s=3600))
    try:
        a = c.assign(collection="cron")
        vid = parse_fid(a["fid"]).volume_id
        blobs = {}
        for key in range(101, 106):
            fid = f"{vid},{key:x}00000042"
            data = os.urandom(120 << 10)
            with c.http(f"{a['url']}/{fid}", data=data, method="POST"):
                pass
            blobs[fid] = data
        victim = next(iter(blobs))
        with c.http(f"{a['url']}/{victim}", method="DELETE"):
            pass
        blobs.pop(victim)
        assert "vacuum triggered" in Shell(c.master.url).run_command(
            "volume.vacuum -garbageThreshold=0.1")
        v = c.server(a["url"]).store.find_volume(vid)
        assert v.super_block.compaction_revision == 1
        wait_for(lambda: any(
            n.volumes.get(vid) and n.volumes[vid].size == v.content_size
            for n in c.master.topo.nodes()), timeout=60,
            what="the size via heartbeat")
        snap = tmp_path / "snap"
        _jax_encoded_snapshot(c, "cron", [vid], snap)
        c.master.run_maintenance_now()
        wait_for(lambda: c.master.maintenance_passes, timeout=60,
                 what="one cron pass")
        assert c.master.maintenance_failures == 0
        wait_for(lambda: c.master.topo.lookup_ec(vid) and
                 not c.master.topo.lookup(vid), timeout=60,
                 what="the volume as EC")
        _assert_shards_are_the_snapshots(c, "cron", [vid], snap)
        for fid, data in blobs.items():
            with c.fetch(fid) as r:
                assert r.read() == data
    finally:
        c.stop()


def test_cron_counts_a_failing_script_and_goes_on(tmp_path):
    c = Cluster(tmp_path, n_volume_servers=1, master_kwargs=dict(
        maintenance_scripts=["lock", "volume.fsck", "no.such.command",
                             "unlock"], maintenance_interval_s=3600))
    try:
        c.master.run_maintenance_now()
        wait_for(lambda: c.master.maintenance_passes, timeout=60,
                 what="one cron pass")
        assert c.master.maintenance_failures == 2
        # unlock ran: another client can take the lock
        Shell(c.master.url).run_command("lock")
    finally:
        c.stop()


def test_no_loop_thread_unless_configured(tmp_path):
    m = MasterServer(port=free_port_pair())
    m.start()
    try:
        assert m._maint_thread is None and m._scrub_thread is None
        names = {t.name for t in __import__("threading").enumerate()}
        assert "master-maintenance" not in names
        assert "master-scrub" not in names
    finally:
        m.stop()


def test_scrub_loop_starts_each_server_once_per_interval(tmp_path,
                                                         monkeypatch):
    calls = []
    monkeypatch.setattr(MasterServer, "_start_scrub_on",
                        lambda self, url: calls.append(
                            (url, time.monotonic())) or True)
    interval = 1.5
    c = Cluster(tmp_path, n_volume_servers=3, master_kwargs=dict(
        scrub_interval_s=interval))
    try:
        urls = sorted(vs.url for vs in c.volume_servers)
        wait_for(lambda: len(calls) >= 3 * 3, timeout=60,
                 what="three scrub windows")
        # each window starts every server once, in url order
        cycles = [[u for u, _ in calls[i:i + 3]]
                  for i in range(len(calls) - len(calls) % 3 - 3, -1, -3)]
        assert urls in cycles
        got = [u for u, _ in calls[-6:]]
        assert sorted(got[:3]) == urls or sorted(got[3:]) == urls
        # one window lasts one interval
        first = {}
        for u, ts in calls:
            first.setdefault(u, []).append(ts)
        gaps = [b - a for ts in first.values() for a, b in zip(ts, ts[1:])]
        assert min(gaps) > interval * 0.6
    finally:
        c.stop()


def test_scrub_all_now_and_targeted_ec_scrub(tmp_path):
    """master.scrub_all_now() opens a pass on every server; on a server
    holding every shard of an EC volume, volume.scrub -volumeId=N finds
    and repairs a flipped parity byte."""
    c = Cluster(tmp_path, n_volume_servers=1)
    try:
        vid, _, _ = _fill_volume(c, "scr", n=8, size=30000)
        sh = Shell(c.master.url)
        sh.run_command(f"ec.encode -collection=scr -volumeId={vid}")
        wait_for(lambda: c.master.topo.lookup_ec(vid), timeout=60,
                 what="EC volume")
        vs = c.volume_servers[0]
        assert c.master.scrub_all_now() == [vs.url]
        wait_for(lambda: vs.scrub.status()["passes_completed"] == 1 and
                 vs.scrub.status()["state"] != "running",
                 what="the scrub pass", timeout=60)
        assert vs.scrub.status()["corruptions_found"] == 0
        shard = shard_file_name(vs.store.find_ec_volume(vid).base_name, 11)
        with open(shard, "rb") as f:
            pristine = f.read()
        with open(shard, "r+b") as f:
            f.seek(10)
            b = f.read(1)
            f.seek(10)
            f.write(bytes([b[0] ^ 1]))
        out = sh.run_command(f"volume.scrub -node={vs.url} -volumeId={vid}")
        assert "scrub started" in out
        wait_for(lambda: vs.scrub.status()["passes_completed"] == 2 and
                 vs.scrub.status()["state"] != "running",
                 what="the targeted pass", timeout=60)
        st = vs.scrub.status()
        assert (st["corruptions_found"], st["corruptions_repaired"]) == (1, 1)
        assert _sha(shard) == hashlib.sha256(pristine).hexdigest()
        assert "passes:2" in sh.run_command(
            f"volume.scrub -node={vs.url} -status")
    finally:
        c.stop()


@pytest.mark.parametrize("name,item", [
    ("volume.fsck", "item 13"), ("volume.lifecycle", "item 11"),
    ("cluster.trace -traceId=1", "item 11"),
    ("cluster.requests", "item 11"), ("cluster.heat", "item 11"),
    ("cluster.qos", "item 11")])
def test_commands_left_out_name_their_queue_item(mcluster, name, item):
    """A command the port leaves out answers with an error naming its
    ROADMAP item. The item-11 commands (cluster tracing, heat, QoS and
    the lifecycle engine) are carried now and answer without one:
    volume.lifecycle on a master started without -lifecycle says so.
    volume.fsck arrived with the filer (item 13's filer core): without a
    filer it says it needs one, and names no queue item."""
    sh = Shell(mcluster.master.url)
    if name == "volume.fsck":
        with pytest.raises(CommandError, match="no filer configured") as ei:
            sh.run_command(name)
        assert "Queue 1" not in str(ei.value)
        return
    if item != "item 11":
        with pytest.raises(CommandError, match=f"Queue 1 {item}"):
            sh.run_command(name)
        return
    try:
        out = sh.run_command(name)
    except CommandError as e:
        assert "Queue 1" not in str(e) and "not carried" not in str(e)
        assert name == "volume.lifecycle" and \
            "start the master with -lifecycle" in str(e)
    else:
        assert "not carried" not in out and out


def test_cli_flags_and_master_toml(tmp_path, monkeypatch):
    from seaweedfs_tpu_torch.command import servers
    (tmp_path / "master.toml").write_text(
        '[master.maintenance]\n'
        'scripts = ["lock", "ec.encode -fullPercent=95 -quietFor=1h", '
        '"unlock"]\nsleep_minutes = 3\n'
        '[storage.backend.memory.cold]\nenabled = true\n')
    monkeypatch.chdir(tmp_path)
    built = []
    monkeypatch.setattr(servers, "_serve_until_signalled",
                        lambda server: built.append(server) or 0)
    assert servers.run_master(["-port", "9444", "-garbageThreshold", "0.2",
                               "-scrub.intervalSeconds", "60",
                               "-scrubMBps", "5"]) == 0
    m = built[0]
    assert (m.garbage_threshold, m.scrub_interval_s,
            m.scrub_throttle_mbps) == (0.2, 60.0, 5.0)
    assert m.maintenance_scripts == [
        "lock", "ec.encode -fullPercent=95 -quietFor=1h", "unlock"]
    assert m.maintenance_interval_s == 180.0
    from seaweedfs_tpu_torch.storage import backend as bk
    assert servers.run_volume(["-dir", str(tmp_path / "v"), "-ec.encoder",
                               "cpu", "-compactionMBps", "7"]) == 0
    vs = built[1]
    try:
        assert vs.compaction_mbps == 7.0
        assert isinstance(bk.get_backend("memory.cold"),
                          bk.MemoryBackendStorage)
    finally:
        vs.store.close()
        bk.clear_backends()


def _place_shards(c, vid: int, collection: str, src, layout) -> None:
    """Move the shards generated on ``src`` to ``layout`` ({server:
    shard ids}); src keeps the rest."""
    stub = volume_stub(src.url)
    moved = []
    for vs, sids in layout.items():
        dst = volume_stub(vs.url)
        dst.VolumeEcShardsCopy(volume_server_pb2.VolumeEcShardsCopyRequest(
            volume_id=vid, collection=collection, shard_ids=sids,
            copy_ecx_file=True, copy_ecj_file=True,
            source_data_node=src.url))
        dst.VolumeEcShardsMount(volume_server_pb2.VolumeEcShardsMountRequest(
            volume_id=vid, collection=collection, shard_ids=sids))
        moved += sids
    keep = [i for i in range(14) if i not in moved]
    stub.VolumeEcShardsMount(volume_server_pb2.VolumeEcShardsMountRequest(
        volume_id=vid, collection=collection, shard_ids=keep))
    stub.VolumeEcShardsDelete(volume_server_pb2.VolumeEcShardsDeleteRequest(
        volume_id=vid, collection=collection, shard_ids=moved))


def test_shard_locations_do_not_outlive_an_ec_incarnation(tmp_path):
    """A server that read a needle's shard from a peer keeps the shard
    locations it looked up. After a decode and an encode with another
    layout they name holders that lost those shards: the mount of the new
    incarnation must drop them (the JAX server never does, so its read
    fails with 'only 7 shards reachable' until the map ages out)."""
    c = Cluster(tmp_path, n_volume_servers=3)
    try:
        vid, keep, owner = _fill_volume(c, "inc", n=4, size=900)
        a = c.server(owner)
        b, d = [vs for vs in c.volume_servers if vs is not a]
        stub = volume_stub(a.url)

        def encode(layout):
            stub.VolumeMarkReadonly(volume_server_pb2.VolumeMarkReadonlyRequest(
                volume_id=vid))
            stub.VolumeEcShardsGenerate(
                volume_server_pb2.VolumeEcShardsGenerateRequest(
                    volume_id=vid, collection="inc", encoder="cpu"))
            _place_shards(c, vid, "inc", a, layout)
            stub.VolumeDelete(volume_server_pb2.VolumeDeleteRequest(
                volume_id=vid))
            wait_for(lambda: sum(bits.count for bits in
                                 c.master.topo.lookup_ec(vid).values()) == 14
                     and not c.master.topo.lookup(vid, "inc"),
                     what="the EC layout in the topology", timeout=60)

        def read_all_through_a():
            for fid, data in keep:
                with c.http(f"{a.url}/{fid}") as r:
                    assert r.read() == data

        # a volume under 1 MiB lies in shard 0, which a never holds
        encode({b: [0], d: [1, 2, 3, 4, 5, 6]})
        read_all_through_a()
        assert vid in a._ec_locations
        assert f"volume {vid}: decoded back" in Shell(
            c.master.url).run_command(f"ec.decode -collection=inc "
                                      f"-volumeId={vid}")
        wait_for(lambda: c.master.topo.lookup(vid, "inc") and
                 not c.master.topo.lookup_ec(vid), what="decoded", timeout=60)
        owner = holder(c.master, vid, "inc")
        if owner != a.url:   # the decode gathered on another server
            Shell(c.master.url).run_command(
                f"volume.move -volumeId={vid} -source={owner} "
                f"-target={a.url}")
            wait_for(lambda: [u for u, _ in c.master.lookup_locations(
                vid, "inc")] == [a.url], what="the volume back on a", timeout=60)
        encode({d: [0], b: [1, 2, 3, 4, 5, 6]})
        assert vid not in a._ec_locations
        read_all_through_a()
    finally:
        c.stop()
