"""The port's storage engine held against the JAX package's, on the CPU.

Group-commit writes, the kv needle map (``-index kv``) with its crash
replay, LogKV, the ``backend.write_at`` failpoint, the storage gauges and
``fix``/``export``: every case runs the same operations, made from a
seeded numpy generator, through ``seaweedfs_tpu.storage`` and
``seaweedfs_tpu_torch.storage`` and compares what they return, the
counters they keep, and the bytes of the files they leave (``.dat``,
``.idx``, LogKV segments, tar archives). The wall clock that stamps each
needle's append time is replaced by a counter, so the ``.dat`` bytes are
comparable. Mirrors ``tests/test_volume.py`` and ``tests/test_kv_store.py``.
"""

import os
import shutil
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import seaweedfs_tpu.filer.stores.kv_store as jax_kv
import seaweedfs_tpu.resilience.failpoint as jax_failpoint
import seaweedfs_tpu.storage.fix as jax_fix
import seaweedfs_tpu.storage.needle_map as jax_nm
import seaweedfs_tpu.storage.store as jax_store
import seaweedfs_tpu.storage.volume as jax_volume
from seaweedfs_tpu.stats import metrics as jax_metrics
from seaweedfs_tpu.storage import idx as idx_codec
from seaweedfs_tpu.storage import types as t
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
import seaweedfs_tpu_torch.filer.stores.kv_store as port_kv
import seaweedfs_tpu_torch.resilience.failpoint as port_failpoint
import seaweedfs_tpu_torch.storage.fix as port_fix
import seaweedfs_tpu_torch.storage.needle_map as port_nm
import seaweedfs_tpu_torch.storage.store as port_store
import seaweedfs_tpu_torch.storage.volume as port_volume
from seaweedfs_tpu_torch.stats import metrics as port_metrics
from seaweedfs_tpu_torch.storage.needle import Needle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = SimpleNamespace(
    name="jax", Volume=jax_volume.Volume, VolumeError=jax_volume.VolumeError,
    WriteRequest=jax_volume._WriteRequest, Needle=JaxNeedle,
    NeedleMap=jax_nm.NeedleMap, KvNeedleMap=jax_nm.KvNeedleMap,
    SortedIndex=jax_nm.SortedIndex, make_needle_map=jax_nm.make_needle_map,
    Store=jax_store.Store, LogKV=jax_kv.LogKV, fix=jax_fix,
    failpoint=jax_failpoint, metrics=jax_metrics)
PORT = SimpleNamespace(
    name="port", Volume=port_volume.Volume,
    VolumeError=port_volume.VolumeError,
    WriteRequest=port_volume._WriteRequest, Needle=Needle,
    NeedleMap=port_nm.NeedleMap, KvNeedleMap=port_nm.KvNeedleMap,
    SortedIndex=port_nm.SortedIndex, make_needle_map=port_nm.make_needle_map,
    Store=port_store.Store, LogKV=port_kv.LogKV, fix=port_fix,
    failpoint=port_failpoint, metrics=port_metrics)
KINDS = ["memory", "kv"]


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


def files_of(d) -> dict:
    """{relative path: bytes} of every file under d."""
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def outcome(fn):
    """fn()'s result, or the error's kind (both packages' errors have
    the same class names)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared, not swallowed
        return ("error", type(e).__name__)


def random_ops(seed: int, n: int = 60, ids: int = 12):
    """Writes, overwrites (right and wrong cookie) and deletes of a few
    needle ids, from a seeded generator."""
    rng = np.random.default_rng(seed)
    cookies = {i: int(rng.integers(1, 1 << 32)) for i in range(1, ids + 1)}
    ops = []
    for _ in range(n):
        nid = int(rng.integers(1, ids + 1))
        r = rng.random()
        cookie = cookies[nid] if rng.random() > 0.1 else cookies[nid] ^ 1
        if r < 0.7:
            data = rng.integers(0, 256, int(rng.integers(1, 3000)),
                                dtype=np.uint8).tobytes()
            ops.append(("write", nid, cookie, data))
        else:
            ops.append(("delete", nid, cookie, b""))
    return ops


def apply_ops(pkg, v, ops) -> list:
    out = []
    for kind, nid, cookie, data in ops:
        if kind == "write":
            out.append(outcome(lambda: v.write_needle(
                pkg.Needle(id=nid, cookie=cookie, data=data))))
        else:
            out.append(outcome(lambda: v.delete_needle(
                pkg.Needle(id=nid, cookie=cookie))))
    return out


def reads_of(pkg, v, ids) -> list:
    return [outcome(lambda: bytes(v.read_needle(
        pkg.Needle(id=i)).data)) for i in ids]


def volume_stats(v) -> tuple:
    nm = v.nm
    return (v.file_count, nm.file_count, nm.deleted_count, nm.deleted_size,
            nm.content_size, nm.max_key, v.content_size)


# -- the volume engine (tests/test_volume.py:22-151) ---------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_ops_match_byte_for_byte(tmp_path, clock, kind, seed):
    """The same writes/overwrites/deletes give the same results, reads,
    stats and .dat/.idx (and LogKV segment) bytes, and the same after a
    reopen."""
    ops = random_ops(seed)
    got = {}
    for pkg in (JAX, PORT):
        clock.restart()
        d = tmp_path / pkg.name
        d.mkdir()
        v = pkg.Volume(str(d), "c", 5, needle_map_kind=kind)
        res = apply_ops(pkg, v, ops)
        reads = reads_of(pkg, v, range(1, 13))
        stats = volume_stats(v)
        v.close()
        v2 = pkg.Volume(str(d), "c", 5, create_if_missing=False,
                        needle_map_kind=kind)
        reopened = (reads_of(pkg, v2, range(1, 13)), volume_stats(v2),
                    len(v2.nm), sorted(v2.nm.keys()))
        v2.close()
        got[pkg.name] = (res, reads, stats, reopened, files_of(d))
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("kind", KINDS)
def test_write_read_roundtrip_and_cookies(tmp_path, kind):
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        d.mkdir()
        v = pkg.Volume(str(d), "", 1, needle_map_kind=kind)
        offset, _ = v.write_needle(pkg.Needle(id=1, cookie=0x11,
                                              data=b"alpha", name=b"a.txt"))
        assert offset == 8
        got = v.read_needle(pkg.Needle(id=1, cookie=0x11))
        assert (got.data, got.name) == (b"alpha", b"a.txt")
        with pytest.raises(Exception, match="cookie") as ei:
            v.read_needle(pkg.Needle(id=1, cookie=0x99))
        assert type(ei.value).__name__ == "CookieMismatch"
        with pytest.raises(Exception) as ei:
            v.write_needle(pkg.Needle(id=1, cookie=0x22, data=b"v2"))
        assert type(ei.value).__name__ == "CookieMismatch"
        with pytest.raises(Exception) as ei:
            v.write_needle(pkg.Needle(id=2, cookie=0x22, data=b""))
        assert type(ei.value).__name__ == "VolumeError"
        assert v.delete_needle(pkg.Needle(id=1, cookie=0x11)) > 0
        assert v.delete_needle(pkg.Needle(id=1, cookie=0x11)) == 0
        v.close()


@pytest.mark.parametrize("kind", KINDS)
def test_reload_replays_index_and_scan(tmp_path, clock, kind):
    got = {}
    for pkg in (JAX, PORT):
        clock.restart()
        d = tmp_path / pkg.name
        d.mkdir()
        v = pkg.Volume(str(d), "", 2, needle_map_kind=kind)
        for i in range(10):
            v.write_needle(pkg.Needle(id=i + 1, cookie=7,
                                      data=f"data{i}".encode()))
        v.delete_needle(pkg.Needle(id=3, cookie=7))
        scan = [(o, n.id, bytes(n.data)) for o, n in
                v.scan_needles(include_deleted=True)]
        v.close()
        v2 = pkg.Volume(str(d), "", 2, create_if_missing=False,
                        needle_map_kind=kind)
        assert v2.file_count == 9
        got[pkg.name] = (scan, reads_of(pkg, v2, range(1, 11)),
                         volume_stats(v2))
        v2.close()
    assert got["port"] == got["jax"]


def test_torn_dat_and_idx_tails(tmp_path):
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        d.mkdir()
        v = pkg.Volume(str(d), "", 3)
        v.write_needle(pkg.Needle(id=1, cookie=1, data=b"keep me"))
        v.close()
        good = os.path.getsize(v.dat_path)
        with open(v.dat_path, "ab") as f:
            f.write(b"torn garbage bytes")
        with open(v.idx_path, "ab") as f:
            f.write(b"\x00" * 7)
        v2 = pkg.Volume(str(d), "", 3, create_if_missing=False)
        assert os.path.getsize(v2.dat_path) == good
        v2.write_needle(pkg.Needle(id=2, cookie=1, data=b"bbb"))
        v2.close()
        v3 = pkg.Volume(str(d), "", 3, create_if_missing=False)
        assert v3.read_needle(pkg.Needle(id=1, cookie=1)).data == b"keep me"
        assert v3.read_needle(pkg.Needle(id=2, cookie=1)).data == b"bbb"
        assert os.path.getsize(v3.idx_path) % 16 == 0
        v3.close()


# -- needle maps (tests/test_volume.py:153-306) --------------------------------


@pytest.mark.parametrize("cls", ["NeedleMap", "KvNeedleMap"])
def test_needle_map_metrics_and_reopen(tmp_path, cls):
    got = {}
    for pkg in (JAX, PORT):
        p = str(tmp_path / f"{pkg.name}.idx")
        nm = getattr(pkg, cls)(p)
        nm.put(1, 8, 100)
        nm.put(2, 128, 200)
        nm.put(1, 256, 150)  # overwrite
        first = (nm.file_count, nm.deleted_count, nm.deleted_size, len(nm))
        nm.delete(2, 512)
        assert nm.get(2) is None
        nm.close()
        nm2 = getattr(pkg, cls)(p)
        got[pkg.name] = (first, nm2.get(1).size, nm2.get(2), nm2.max_key,
                         nm2.file_count, nm2.deleted_count,
                         nm2.deleted_size, len(nm2),
                         [(k, v.offset, v.size) for k, v in nm2.items()],
                         open(p, "rb").read())
        nm2.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == (3, 1, 100, 2)


def test_sorted_index_binary_search():
    entries = b"".join(idx_codec.entry_to_bytes(k, k * 8, 10 + k)
                       for k in [2, 5, 9, 100])
    for pkg in (JAX, PORT):
        si = pkg.SortedIndex(entries)
        assert len(si) == 4
        assert si.find(5) == (1, 40, 15)
        assert si.find(4) is None
        assert si.find(100)[2] == 110
    with pytest.raises(ValueError):
        PORT.SortedIndex(idx_codec.entry_to_bytes(9, 8, 1) +
                         idx_codec.entry_to_bytes(2, 16, 1))


def _kv_case(pkg, tmp_path, case: str):
    """One crash-replay case of the kv map; returns what it observed."""
    p = str(tmp_path / f"{pkg.name}.idx")
    nm = pkg.KvNeedleMap(p)
    nm.put(1, 8, 100)
    nm.put(2, 128, 200)
    if case == "ahead":
        nm.put(3, 512, 300)
    nm.sync()
    nm.close()
    if case == "lagging":
        # acked entries that reached the .idx, their KV puts lost
        with open(p, "ab") as f:
            f.write(idx_codec.entry_to_bytes(3, 512, 300))
            f.write(idx_codec.entry_to_bytes(1, 1024, t.TOMBSTONE_SIZE))
    elif case == "ahead":
        # the last .idx entry never reached the disk
        with open(p, "r+b") as f:
            f.truncate(2 * t.NEEDLE_MAP_ENTRY_SIZE)
    elif case == "phantom":
        os.remove(p)
    seen = []
    for _ in range(2):  # the second open needs no replay
        nm2 = pkg.KvNeedleMap(p)
        seen.append(([(k, nm2.get(k) and (nm2.get(k).offset,
                                          nm2.get(k).size))
                      for k in (1, 2, 3)],
                     nm2.file_count, nm2.deleted_count, nm2.deleted_size,
                     len(nm2)))
        nm2.close()
    return seen


@pytest.mark.parametrize("case", ["lagging", "ahead", "phantom"])
def test_kv_needle_map_crash_replay(tmp_path, case):
    got = {pkg.name: _kv_case(pkg, tmp_path, case) for pkg in (JAX, PORT)}
    assert got["port"] == got["jax"]
    first = got["port"][0]
    if case == "lagging":
        assert first[0] == [(1, None), (2, (128, 200)), (3, (512, 300))]
    elif case == "ahead":
        assert first[0] == [(1, (8, 100)), (2, (128, 200)), (3, None)]
    else:
        assert first == ([(1, None), (2, None), (3, None)], 0, 0, 0, 0)


def test_kv_kind_delete_heavy_reload_and_destroy(tmp_path):
    got = {}
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        d.mkdir()
        v = pkg.Volume(str(d), "", 11, needle_map_kind="kv")
        for i in range(60):
            v.write_needle(pkg.Needle(id=i + 1, cookie=5, data=b"z" * 64))
        for i in range(50):
            v.delete_needle(pkg.Needle(id=i + 1, cookie=5))
        v.close()
        v2 = pkg.Volume(str(d), "", 11, create_if_missing=False,
                        needle_map_kind="kv")
        got[pkg.name] = (len(v2.nm), v2.file_count, v2.nm.file_count,
                         v2.nm.deleted_count,
                         reads_of(pkg, v2, [5, 55]))
        kv_dir = v2.idx_path + ".nmkv"
        assert os.path.isdir(kv_dir)
        v2.destroy()
        assert not any(os.path.exists(p) for p in
                       (kv_dir, v2.idx_path, v2.dat_path))
    assert got["port"] == got["jax"]
    assert got["port"][:4] == (10, 10, 60, 50)


def test_make_needle_map_kinds(tmp_path):
    for kind in ("kv", "leveldb", "large"):
        nm = PORT.make_needle_map(str(tmp_path / f"{kind}.idx"), kind)
        assert isinstance(nm, PORT.KvNeedleMap)
        nm.close()
    for kind in ("memory", ""):
        nm = PORT.make_needle_map(None, kind)
        assert type(nm) is PORT.NeedleMap
    for pkg in (JAX, PORT):
        with pytest.raises(ValueError):
            pkg.make_needle_map(None, "kv")
        with pytest.raises(ValueError):
            pkg.make_needle_map(None, "bogus")


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_kv_volume_directory_opens_in_the_other_package(tmp_path, clock,
                                                        writer, reader):
    """A kv volume directory (.dat, .idx and the .nmkv LogKV) written by
    one package opens in the other with equal lookups, and a write made
    there reads back in the first."""
    ops = random_ops(7, n=80)
    v = writer.Volume(str(tmp_path), "k", 4, needle_map_kind="kv")
    apply_ops(writer, v, ops)
    want = reads_of(writer, v, range(1, 13))
    want_stats = volume_stats(v)
    v.close()
    v2 = reader.Volume(str(tmp_path), "k", 4, create_if_missing=False,
                       needle_map_kind="kv")
    assert reads_of(reader, v2, range(1, 13)) == want
    assert volume_stats(v2) == want_stats
    v2.write_needle(reader.Needle(id=99, cookie=3, data=b"cross"))
    v2.close()
    v3 = writer.Volume(str(tmp_path), "k", 4, create_if_missing=False,
                       needle_map_kind="kv")
    assert v3.read_needle(writer.Needle(id=99, cookie=3)).data == b"cross"
    assert reads_of(writer, v3, range(1, 13)) == want
    v3.close()


# -- LogKV (tests/test_kv_store.py:20-82) -------------------------------------


def test_logkv_put_get_delete_persist_same_segments(tmp_path):
    rng = np.random.default_rng(3)
    got = {}
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        kv = pkg.LogKV(str(d))
        for _ in range(300):
            k = b"k%d" % int(rng.integers(0, 40))
            if rng.random() < 0.8:
                kv.put(k, rng.bytes(int(rng.integers(0, 64))))
            else:
                kv.delete(k)
        snap = [(k, kv.get(k)) for k in (b"k%d" % i for i in range(40))]
        kv.close()
        kv2 = pkg.LogKV(str(d))
        assert [(k, kv2.get(k)) for k, _ in snap] == snap
        got[pkg.name] = (snap, len(kv2), list(kv2.scan(b"k")),
                         files_of(d))
        kv2.close()
        rng = np.random.default_rng(3)
    assert got["port"] == got["jax"]


def test_logkv_ordered_prefix_scan(tmp_path):
    for pkg in (JAX, PORT):
        kv = pkg.LogKV(str(tmp_path / pkg.name))
        for k in (b"p/c", b"p/a", b"q/x", b"p/b", b"pp"):
            kv.put(k, b"v" + k)
        assert [k for k, _ in kv.scan(b"p/")] == [b"p/a", b"p/b", b"p/c"]
        assert [k for k, _ in kv.scan(b"p/", start=b"p/a",
                                      inclusive=False)] == [b"p/b", b"p/c"]
        assert kv.delete_prefix(b"p/") == 3
        assert [k for k, _ in kv.scan(b"")] == [b"pp", b"q/x"]
        kv.close()


def test_logkv_compaction_reclaims_garbage(tmp_path):
    got = {}
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        kv = pkg.LogKV(str(d))
        kv.COMPACT_MIN_BYTES = 1  # compact aggressively
        for i in range(200):
            kv.put(b"key", b"v" * 100)
        assert kv.get(b"key") == b"v" * 100
        assert kv._total_bytes < 3 * kv._live_bytes
        kv.close()
        kv2 = pkg.LogKV(str(d))
        assert kv2.get(b"key") == b"v" * 100
        kv2.close()
        got[pkg.name] = files_of(d)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_logkv_torn_tail_tolerated(tmp_path, writer, reader):
    kv = writer.LogKV(str(tmp_path))
    kv.put(b"good", b"data")
    kv.close()
    seg = sorted(p for p in os.listdir(tmp_path) if p.endswith(".wlog"))[-1]
    with open(tmp_path / seg, "ab") as f:
        f.write(b"\x01\x00\x00")  # a torn header
    kv2 = reader.LogKV(str(tmp_path))
    assert kv2.get(b"good") == b"data"
    kv2.put(b"after", b"crash")
    kv2.close()
    kv3 = writer.LogKV(str(tmp_path))
    assert kv3.get(b"after") == b"crash"
    kv3.close()


# -- group commit (tests/test_volume.py:309-380) ------------------------------


def test_group_commit_concurrent_writers(tmp_path):
    """16 threads on one volume, half of them fsync'd (the writer), half
    not (inline or riding the backlog): every write lands, reads back,
    and survives a reopen in both packages; the port's writer batched."""
    n_threads, per_thread = 16, 25
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        d.mkdir()
        v = pkg.Volume(str(d), "", 7)
        errors = []

        def writer(tid):
            try:
                for i in range(per_thread):
                    v.write_needle(pkg.Needle(
                        id=tid * 1000 + i, cookie=0xC0 + tid,
                        data=f"t{tid}i{i}".encode()), fsync=(tid % 2 == 0))
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors
        assert v.file_count == n_threads * per_thread
        if pkg is PORT:
            batches, requests, by_writer = v.commit_stats()
            assert requests == n_threads * per_thread
            assert 0 < by_writer <= batches <= requests
        v.close()
        v2 = pkg.Volume(str(d), "", 7)
        assert v2.file_count == n_threads * per_thread
        assert v2.read_needle(pkg.Needle(
            id=15 * 1000 + 24, cookie=0xC0 + 15)).data == b"t15i24"
        v2.close()


def test_group_commit_intra_batch_overwrite_and_delete(tmp_path, clock):
    """Write, overwrite and delete of one needle staged in one batch
    resolve through the batch's pending view; a wrong cookie against an
    entry staged earlier in the batch fails that request only."""
    got = {}
    for pkg in (JAX, PORT):
        clock.restart()
        d = tmp_path / pkg.name
        d.mkdir()
        v = pkg.Volume(str(d), "", 8)
        reqs = [
            pkg.WriteRequest("write", pkg.Needle(id=1, cookie=0xAA,
                                                 data=b"one")),
            pkg.WriteRequest("write", pkg.Needle(id=1, cookie=0xAA,
                                                 data=b"two")),
            pkg.WriteRequest("write", pkg.Needle(id=2, cookie=0xBB,
                                                 data=b"keep")),
            pkg.WriteRequest("delete", pkg.Needle(id=1, cookie=0xAA)),
            pkg.WriteRequest("write", pkg.Needle(id=3, cookie=0x11,
                                                 data=b"x")),
            pkg.WriteRequest("write", pkg.Needle(id=3, cookie=0x22,
                                                 data=b"y")),
        ]
        v._apply_batch(reqs)
        res = [outcome(r.wait) for r in reqs]
        reads = reads_of(pkg, v, [1, 2, 3])
        v.close()
        got[pkg.name] = (res, reads, files_of(d))
    assert got["port"] == got["jax"]
    assert got["port"][0][5] == ("error", "CookieMismatch")
    assert got["port"][1][0][0] == "error"


def test_group_commit_batched_fsync_and_limits(tmp_path):
    v = PORT.Volume(str(tmp_path), "", 9)
    assert v._writer is None
    for i in range(8):
        v.write_needle(PORT.Needle(id=i + 1, cookie=1, data=b"d%d" % i),
                       fsync=True)
    assert v.file_count == 8
    assert v.commit_stats() == (8, 8, 8)  # one uncontended request a batch
    w = v._writer
    assert (w.MAX_BATCH_REQS, w.MAX_BATCH_BYTES) == \
        (jax_volume._GroupCommitWriter.MAX_BATCH_REQS,
         jax_volume._GroupCommitWriter.MAX_BATCH_BYTES) == (128, 4 << 20)
    v.close()
    assert v._writer is None and not w._thread.is_alive()


def test_group_commit_drain_takes_at_most_the_limits(tmp_path):
    """A backlog of 300 small requests drains in batches of 128, and one
    of 4 MiB-sized needles stops at the byte limit."""
    v = PORT.Volume(str(tmp_path), "", 10)
    w = port_volume._GroupCommitWriter.__new__(port_volume._GroupCommitWriter)
    w.volume = v
    w._queue = __import__("collections").deque(
        PORT.WriteRequest("write", PORT.Needle(id=i + 1, cookie=1,
                                               data=b"x"))
        for i in range(300))
    w._cond = threading.Condition()
    w._stopped = False
    assert [len(w._drain()) for _ in range(3)] == [128, 128, 44]
    w._queue.extend(PORT.WriteRequest("write", PORT.Needle(
        id=i + 1, cookie=1, data=b"y" * (1 << 20))) for i in range(6))
    assert len(w._drain()) == 4
    v.close()


def test_no_writer_thread_before_a_contended_write(tmp_path):
    """The house rule: a volume makes no thread until a write needs the
    writer (an fsync'd one here); uncontended plain writes stay inline."""
    def writers():
        return [th for th in threading.enumerate()
                if th.name.startswith("vol-31-writer")]

    v = PORT.Volume(str(tmp_path), "", 31)
    for i in range(20):
        v.write_needle(PORT.Needle(id=i + 1, cookie=1, data=b"inline"))
    v.delete_needle(PORT.Needle(id=1, cookie=1))
    assert v._writer is None and not writers()
    v.write_needle(PORT.Needle(id=99, cookie=1, data=b"durable"), fsync=True)
    assert v._writer is not None and len(writers()) == 1
    v.close()
    assert not writers()
    # a write that finds the volume lock taken is contended: it joins
    # the writer's next batch, made for it
    v = PORT.Volume(str(tmp_path), "", 33)
    held, release = threading.Event(), threading.Event()

    def holder():
        with v._lock:
            held.set()
            release.wait(5)

    th = threading.Thread(target=holder)
    th.start()
    held.wait(5)
    done = []
    w = threading.Thread(target=lambda: done.append(v.write_needle(
        PORT.Needle(id=1, cookie=1, data=b"contended"))))
    w.start()
    deadline_t = time.monotonic() + 5
    while v._writer is None and time.monotonic() < deadline_t:
        time.sleep(0.005)
    assert v._writer is not None and not done
    release.set()
    th.join(5)
    w.join(5)
    assert done == [(8, v.read_needle(PORT.Needle(id=1)).size)]
    assert v.commit_stats() == (1, 1, 1)
    v.close()
    sync = PORT.Volume(str(tmp_path), "", 32, async_write=False)
    sync.write_needle(PORT.Needle(id=1, cookie=1, data=b"x"), fsync=True)
    assert sync._writer is None
    sync.close()


@pytest.mark.parametrize("kind", KINDS)
def test_group_commit_write_error_truncates_and_fails_batch(tmp_path, clock,
                                                            kind):
    """A failed physical write (the backend.write_at failpoint) truncates
    the .dat back to the batch start and fails every request of the
    batch; the volume stays writable and readable, as in the JAX
    package."""
    got = {}
    for pkg in (JAX, PORT):
        clock.restart()
        d = tmp_path / pkg.name
        d.mkdir()
        v = pkg.Volume(str(d), "", 12, needle_map_kind=kind)
        v.write_needle(pkg.Needle(id=1, cookie=1, data=b"before"))
        size0 = os.path.getsize(v.dat_path)
        pkg.failpoint.arm("backend.write_at", "error", count=1)
        try:
            reqs = [pkg.WriteRequest("write", pkg.Needle(
                id=i, cookie=1, data=b"batch%d" % i)) for i in (2, 3, 4)]
            v._apply_batch(reqs)
            res = [outcome(r.wait) for r in reqs]
        finally:
            pkg.failpoint.disarm()
        assert os.path.getsize(v.dat_path) == size0
        after = outcome(lambda: v.write_needle(
            pkg.Needle(id=5, cookie=1, data=b"after")))
        reads = reads_of(pkg, v, [1, 2, 3, 4, 5])
        v.close()
        got[pkg.name] = (res, after, reads, files_of(d))
    assert got["port"] == got["jax"]
    assert all(r == ("error", "VolumeError") for r in got["port"][0])


def test_failpoint_site_through_fsync_route(tmp_path):
    """The error path through the writer thread: an fsync'd write whose
    append fails raises VolumeError to its caller."""
    v = PORT.Volume(str(tmp_path), "", 13)
    PORT.failpoint.arm("backend.write_at", "error", count=1)
    try:
        with pytest.raises(PORT.VolumeError, match="batch write failed"):
            v.write_needle(PORT.Needle(id=1, cookie=1, data=b"x"),
                           fsync=True)
    finally:
        PORT.failpoint.disarm()
    assert os.path.getsize(v.dat_path) == 8
    v.write_needle(PORT.Needle(id=1, cookie=1, data=b"x"), fsync=True)
    assert v.read_needle(PORT.Needle(id=1, cookie=1)).data == b"x"
    v.close()


def test_sync_and_scan_see_a_drained_writer(tmp_path):
    """The freeze before ec.encode (read_only, then sync) and a scan
    both wait for a batch in flight: with the batch's write stalled by
    the failpoint, sync returns only after its needles are published."""
    v = PORT.Volume(str(tmp_path), "", 14)
    PORT.failpoint.arm("backend.write_at", "delay", arg=0.3, count=1)
    try:
        th = threading.Thread(target=lambda: v.write_needle(
            PORT.Needle(id=1, cookie=1, data=b"stalled"), fsync=True))
        th.start()
        time.sleep(0.05)
        v.read_only = True
        v.sync()
        assert v.file_count == 1
        assert [n.id for _, n in v.scan_needles()] == [1]
        th.join()
    finally:
        PORT.failpoint.disarm()
    with pytest.raises(PORT.VolumeError, match="read-only"):
        v.write_needle(PORT.Needle(id=2, cookie=1, data=b"late"),
                       fsync=True)
    v.close()


def test_repair_needle_bypasses_the_writer(tmp_path):
    """Scrub's repair_needle lifts the seal inside the volume lock and
    commits directly, even with the writer made and the volume sealed."""
    from seaweedfs_tpu_torch.scrub import planner
    v = PORT.Volume(str(tmp_path), "", 15)
    v.write_needle(PORT.Needle(id=1, cookie=9, data=b"good bytes"),
                   fsync=True)
    assert v._writer is not None
    n = v.read_needle(PORT.Needle(id=1, cookie=9))
    v.read_only = True
    assert planner.repair_needle(v, n, lambda vid, c: b"good bytes")
    assert v.read_only
    assert v.file_count == 1 and v.nm.deleted_count == 1
    assert not planner.repair_needle(v, n, lambda vid, c: b"bad bytes")
    v.close()


# -- the storage gauges (JAX storage/store.py:168-199) -------------------------


def test_heartbeat_sets_and_zeroes_storage_gauges(tmp_path):
    got = {}
    for pkg in (JAX, PORT):
        m = pkg.metrics
        s = pkg.Store([str(tmp_path / pkg.name / "d1"),
                       str(tmp_path / pkg.name / "d2")],
                      ip="127.0.0.1", port=8080)
        s.add_volume(1, collection="gauge_a")
        s.add_volume(2, collection="gauge_a")
        s.add_volume(3, collection="gauge_b")
        s.write_needle(1, pkg.Needle(id=1, cookie=1, data=b"x" * 100))
        hb = s.collect_heartbeat()
        seen = [(col, m.VolumeServerVolumeCounter.labels(col, "volume")
                 .value, m.VolumeServerDiskSizeGauge.labels(col, "normal")
                 .value) for col in ("gauge_a", "gauge_b")]
        s.delete_volume(3)
        s.collect_heartbeat()
        seen.append(("gauge_b gone",
                     m.VolumeServerVolumeCounter.labels("gauge_b", "volume")
                     .value,
                     m.VolumeServerDiskSizeGauge.labels("gauge_b", "normal")
                     .value))
        got[pkg.name] = (seen, sorted(v["id"] for v in hb["volumes"]),
                         hb["max_volume_count"], hb["max_file_key"])
        s.close()
    assert got["port"] == got["jax"]
    assert got["port"][0][2][1:] == (0, 0)
    for name in ("VolumeServerVolumeCounter", "VolumeServerDiskSizeGauge"):
        jm, pm = getattr(jax_metrics, name), getattr(port_metrics, name)
        assert (pm.name, pm.label_names, pm.kind) == \
            (jm.name, jm.label_names, jm.kind)


@pytest.mark.parametrize("kind", KINDS)
def test_store_takes_the_needle_map_kind(tmp_path, kind):
    s = PORT.Store([str(tmp_path)], needle_map_kind=kind)
    v = s.add_volume(1)
    assert v.needle_map_kind == kind
    s.write_needle(1, PORT.Needle(id=1, cookie=1, data=b"k"))
    s.close()
    s2 = PORT.Store([str(tmp_path)], needle_map_kind=kind)
    v2 = s2.find_volume(1)
    assert isinstance(v2.nm, PORT.KvNeedleMap) == (kind == "kv")
    assert s2.read_needle(1, PORT.Needle(id=1, cookie=1)).data == b"k"
    s2.close()


# -- fix and export (JAX storage/fix.py) ---------------------------------------


@pytest.mark.parametrize("seed", [0, 5])
def test_fix_rebuilds_the_jax_idx(tmp_path, clock, seed):
    """rebuild_idx writes the JAX package's .idx bytes for the same .dat,
    and the rebuilt index serves the same needles."""
    v = PORT.Volume(str(tmp_path), "f", 3)
    apply_ops(PORT, v, random_ops(seed))
    want = reads_of(PORT, v, range(1, 13))
    v.close()
    base = os.path.join(str(tmp_path), "f_3")
    jdir = tmp_path / "jax"
    jdir.mkdir()
    shutil.copy(base + ".dat", jdir / "f_3.dat")
    n_jax = jax_fix.rebuild_idx(str(jdir / "f_3"))
    os.remove(base + ".idx")
    assert port_fix.rebuild_idx(base) == n_jax
    assert open(base + ".idx", "rb").read() == \
        open(jdir / "f_3.idx", "rb").read()
    v2 = PORT.Volume(str(tmp_path), "f", 3, create_if_missing=False)
    assert reads_of(PORT, v2, range(1, 13)) == want
    v2.close()


def test_fix_of_an_append_only_volume_is_its_idx(tmp_path):
    v = PORT.Volume(str(tmp_path), "", 6)
    for i in range(50):
        v.write_needle(PORT.Needle(id=i + 1, cookie=2, data=b"n%d" % i))
    v.close()
    base = os.path.join(str(tmp_path), "6")
    original = open(base + ".idx", "rb").read()
    assert port_fix.rebuild_idx(base) == 50
    assert open(base + ".idx", "rb").read() == original


def test_export_tar_matches_the_jax_archive(tmp_path, clock):
    v = PORT.Volume(str(tmp_path), "", 4)
    apply_ops(PORT, v, random_ops(9))
    v.write_needle(PORT.Needle(id=77, cookie=1, data=b"named",
                               name=b"hello.txt"))
    v.close()
    base = os.path.join(str(tmp_path), "4")
    n_port = port_fix.export_tar(base, 4, str(tmp_path / "port.tar"))
    n_jax = jax_fix.export_tar(base, 4, str(tmp_path / "jax.tar"))
    assert n_port == n_jax > 0
    assert open(tmp_path / "port.tar", "rb").read() == \
        open(tmp_path / "jax.tar", "rb").read()


def test_scan_dat_stops_at_a_torn_record(tmp_path):
    v = PORT.Volume(str(tmp_path), "", 5)
    for i in range(3):
        v.write_needle(PORT.Needle(id=i + 1, cookie=1, data=b"r%d" % i))
    v.close()
    with open(v.dat_path, "ab") as f:
        f.write(b"\x00" * 5)
    assert [n.id for _, n in port_fix.scan_dat(v.dat_path)] == \
        [n.id for _, n in jax_fix.scan_dat(v.dat_path)] == [1, 2, 3]


def test_fix_and_export_subcommands(tmp_path, clock):
    v = PORT.Volume(str(tmp_path), "cli", 8)
    for i in range(5):
        v.write_needle(PORT.Needle(id=i + 1, cookie=3, data=b"c%d" % i))
    v.delete_needle(PORT.Needle(id=2, cookie=3))
    v.close()
    base = os.path.join(str(tmp_path), "cli_8")
    original = open(base + ".idx", "rb").read()
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "fix", "-dir",
         str(tmp_path), "-volumeId", "8", "-collection", "cli"],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert f"rebuilt {base}.idx with 5 entries" in r.stdout
    rebuilt = open(base + ".idx", "rb").read()
    jdir = tmp_path / "j"
    jdir.mkdir()
    shutil.copy(base + ".dat", jdir / "cli_8.dat")
    jax_fix.rebuild_idx(str(jdir / "cli_8"))
    assert rebuilt == open(jdir / "cli_8.idx", "rb").read()
    assert len(rebuilt) == 5 * 16 and len(original) == 6 * 16
    out = tmp_path / "e.tar"
    r = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "export", "-dir",
         str(tmp_path), "-volumeId", "8", "-collection", "cli", "-o",
         str(out)], capture_output=True, text=True, env=env, timeout=120,
        cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert f"exported 4 files to {out}" in r.stdout
    import tarfile
    with tarfile.open(out) as tar:
        assert sorted(m.name for m in tar.getmembers()) == \
            ["8/1", "8/3", "8/4", "8/5"]
