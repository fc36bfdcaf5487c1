"""The port's read cache, hedger and fan-out pool held against the JAX
package's, on the CPU.

Every case of ``tests/test_read_cache.py`` runs the same operations on
``seaweedfs_tpu.cache`` and ``seaweedfs_tpu_torch.cache`` and compares
what they return and count (the disk tier's file names and bytes too).
The cache cases of ``tests/test_degraded_reads.py`` read one EC volume's
shard files through both packages' ``store_ec.read_ec_needle(cache=)``.
The Hedger cases of ``tests/test_resilience.py`` compare both packages'
ledgers. A fault of a kernel or of the card raised inside the decoder
reaches the caller and every single-flight follower, and nothing of it
is cached. The disabled-overhead gates: no cache and no hedger unless
asked for, no thread before first use.
"""

import contextvars
import os
import random
import threading
import time
from types import SimpleNamespace

import pytest

import seaweedfs_tpu.cache as jax_cache
import seaweedfs_tpu.ec.store_ec as jax_store_ec
import seaweedfs_tpu.resilience.hedge as jax_hedge
from seaweedfs_tpu.ec.ec_volume import EcVolume as JaxEcVolume
from seaweedfs_tpu.reads import DegradedReadFleet as JaxDegradedReadFleet
from seaweedfs_tpu.resilience import deadline as jax_deadline
from seaweedfs_tpu.stats import metrics as jax_metrics
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle

import seaweedfs_tpu_torch.cache as port_cache
import seaweedfs_tpu_torch.resilience.hedge as port_hedge
from seaweedfs_tpu_torch.ec import encoder, store_ec
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
from seaweedfs_tpu_torch.native.builder import BuildError, KernelLaunchError
from seaweedfs_tpu_torch.reads import DegradedReadFleet
from seaweedfs_tpu_torch.resilience import deadline
from seaweedfs_tpu_torch.stats import metrics as port_metrics
from seaweedfs_tpu_torch.storage.needle import Needle, NeedleError
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util.fanout import FanOutPool

JAX = SimpleNamespace(name="jax", cache=jax_cache, Hedger=jax_hedge.Hedger,
                      deadline=jax_deadline)
PORT = SimpleNamespace(name="port", cache=port_cache,
                       Hedger=port_hedge.Hedger, deadline=deadline)
LARGE = 2048
SMALL = 256


def both(fn, tmp_path=None):
    """fn(pkg, directory) on both packages; asserts the results equal
    and returns the port's."""
    got = {}
    for pkg in (JAX, PORT):
        d = None
        if tmp_path is not None:
            d = str(tmp_path / pkg.name)
            os.makedirs(d)
        got[pkg.name] = fn(pkg, d)
    assert got["port"] == got["jax"]
    return got["port"]


def files_of(d) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


# -- SegmentedLRU (tests/test_read_cache.py:11-82) ----------------------------


def test_slru_put_get_roundtrip():
    def run(pkg, _):
        c = pkg.cache.SegmentedLRU(1 << 10)
        return (c.set("k", b"value"), c.get("k"), c.get("absent"), c.bytes)
    assert both(run) == (True, b"value", None, 5)


def test_slru_second_touch_promotes_and_scan_cannot_flush_hot_set():
    def run(pkg, _):
        c = pkg.cache.SegmentedLRU(1000, protected_fraction=0.8)
        for i in range(4):
            c.set(f"hot{i}", b"x" * 100)
            c.get(f"hot{i}")
        for i in range(50):  # one-touch scan traffic, 5x the budget
            c.set(f"scan{i}", b"y" * 100)
        return [c.get(f"hot{i}") for i in range(4)], c.evictions, c.bytes
    hot, _, _ = both(run)
    assert hot == [b"x" * 100] * 4


def test_slru_eviction_drains_probation_first():
    def run(pkg, _):
        evicted = []
        c = pkg.cache.SegmentedLRU(
            300, max_item_bytes=100,
            on_evict=lambda k, v, p: evicted.append((k, p)))
        c.set("hot", b"a" * 100)
        c.get("hot")
        for i in (1, 2, 3):
            c.set(f"cold{i}", bytes([i]) * 100)
        return evicted
    evicted = both(run)
    assert ("cold1", False) in evicted
    assert all(k != "hot" for k, _ in evicted)


def test_slru_protected_eviction_flagged_for_demotion():
    def run(pkg, _):
        evicted = []
        c = pkg.cache.SegmentedLRU(
            200, protected_fraction=0.5, max_item_bytes=90,
            on_evict=lambda k, v, p: evicted.append((k, p)))
        c.set("a", b"x" * 90)
        c.get("a")
        c.set("b", b"y" * 90)
        c.get("b")
        c.set("c", b"z" * 90)
        return evicted
    evicted = both(run)
    assert evicted and all(isinstance(p, bool) for _, p in evicted)


def test_slru_oversized_item_rejected():
    def run(pkg, _):
        c = pkg.cache.SegmentedLRU(800)
        return c.set("big", b"x" * 500), c.get("big"), c.bytes
    assert both(run) == (False, None, 0)


def test_slru_update_in_place_adjusts_bytes():
    def run(pkg, _):
        c = pkg.cache.SegmentedLRU(1 << 10)
        c.set("k", b"12345")
        c.set("k", b"123")
        first = (c.bytes, c.get("k"))
        c.get("k")
        c.set("k", b"7" * 8)
        return first, c.get("k"), c.bytes
    assert both(run) == ((3, b"123"), b"7" * 8, 8)


def test_slru_pop_removes_without_evict_callback():
    def run(pkg, _):
        fired = []
        c = pkg.cache.SegmentedLRU(1 << 10,
                                   on_evict=lambda *a: fired.append(a))
        c.set("k", b"v")
        return c.pop("k"), c.pop("k"), fired
    assert both(run) == (b"v", None, [])


# -- DiskCacheTier (tests/test_read_cache.py:85-111) --------------------------


def test_disk_tier_round_trip_reload_and_same_files(tmp_path):
    def run(pkg, d):
        t = pkg.cache.DiskCacheTier(os.path.join(d, "c"), 1 << 20)
        t.set("v3/n/1a", b"needle bytes")
        t.set("v3/s/2/4096/12", b"span bytes..")
        t.set("v12/n/ff", bytes(range(256)))
        t2 = pkg.cache.DiskCacheTier(os.path.join(d, "c"), 1 << 20)
        return (t.get("v3/n/1a"), t2.get("v3/n/1a"), t2.bytes,
                files_of(os.path.join(d, "c")))
    got, again, nbytes, files = both(run, tmp_path)
    assert got == again == b"needle bytes"
    assert len(files) == 3 and nbytes == 12 + 12 + 256


def test_disk_tier_budget_eviction(tmp_path):
    def run(pkg, d):
        t = pkg.cache.DiskCacheTier(d, 10)
        t.set("v1/n/1", b"123456")
        t.set("v1/n/2", b"7890123")
        return t.get("v1/n/1"), t.get("v1/n/2"), t.evictions, files_of(d)
    got = both(run, tmp_path)
    assert got[:3] == (None, b"7890123", 1)


def test_disk_tier_drop_volume_only_hits_that_volume(tmp_path):
    def run(pkg, d):
        t = pkg.cache.DiskCacheTier(d, 1 << 20)
        t.set("v1/n/1", b"a")
        t.set("v1/s/2/0/100", b"b")
        t.set("v2/n/1", b"c")
        return t.drop_volume(1), t.get("v1/n/1"), t.get("v2/n/1"), \
            files_of(d)
    assert both(run, tmp_path)[:3] == (2, None, b"c")


# -- TieredReadCache (tests/test_read_cache.py:114-245) -----------------------


def test_needle_and_span_keys():
    for pkg in (JAX, PORT):
        c = pkg.cache.TieredReadCache
        assert c.needle_key(3, 0x1a) == "v3/n/1a"
        assert c.span_key(3, 7, 4096, 256) == "v3/s/7/4096/256"


def test_get_set_hit_miss_accounting():
    def run(pkg, _):
        c = pkg.cache.TieredReadCache(1 << 20)
        k = c.needle_key(1, 5)
        first = c.get(k)
        c.set(k, b"blob")
        return first, c.get(k), c.hits, c.misses
    assert both(run) == (None, b"blob", 1, 1)


def test_invalidate_needle_keeps_spans_and_other_needles():
    def run(pkg, _):
        c = pkg.cache.TieredReadCache(1 << 20)
        c.set(c.needle_key(1, 5), b"n5")
        c.set(c.needle_key(1, 6), b"n6")
        c.set(c.span_key(1, 2, 0, 100), b"s" * 100)
        dropped = c.invalidate(1, 5, reason="delete")
        return (dropped, c.get(c.needle_key(1, 5)),
                c.get(c.needle_key(1, 6)), c.get(c.span_key(1, 2, 0, 100)))
    assert both(run) == (1, None, b"n6", b"s" * 100)


def test_invalidate_volume_is_scoped():
    def run(pkg, _):
        c = pkg.cache.TieredReadCache(1 << 20)
        c.set(c.needle_key(1, 5), b"a")
        c.set(c.span_key(1, 0, 0, 10), b"b")
        c.set(c.needle_key(2, 5), b"c")
        return c.invalidate_volume(1, "rebuild"), \
            c.get(c.needle_key(2, 5)), c.invalidations
    assert both(run) == (2, b"c", 2)


def test_invalidate_reaches_disk_tier(tmp_path):
    def run(pkg, d):
        c = pkg.cache.TieredReadCache(256, disk_dir=d)
        big = b"x" * 200           # > the RAM tier's max item: disk only
        c.set(c.needle_key(1, 9), big)
        hit = c.get(c.needle_key(1, 9))
        files = files_of(d)
        c.invalidate_volume(1)
        return hit, files, c.get(c.needle_key(1, 9)), files_of(d)
    hit, files, after, left = both(run, tmp_path)
    assert hit == b"x" * 200 and len(files) == 1
    assert after is None and left == {}


def test_protected_eviction_spills_to_disk(tmp_path):
    def run(pkg, d):
        c = pkg.cache.TieredReadCache(300, disk_dir=d)
        k = c.needle_key(1, 1)
        c.set(k, b"h" * 30)
        c.get(k)
        for i in range(2, 40):
            c.set(c.needle_key(1, i), b"c" * 30)
        return c.get(k), files_of(d), c.stats()["disk_bytes"]
    assert both(run, tmp_path)[0] == b"h" * 30


def test_single_flight_one_leader():
    def run(pkg, _):
        c = pkg.cache.TieredReadCache(1 << 20)
        key = c.needle_key(1, 1)
        computes = []
        barrier = threading.Barrier(8)

        def reader():
            barrier.wait()
            v = c.get(key)
            if v is None:
                with c.single_flight(key) as leader:
                    if not leader:
                        v = c.get(key)
                    if v is None:
                        computes.append(1)
                        time.sleep(0.05)
                        c.set(key, b"computed")

        ts = [threading.Thread(target=reader) for _ in range(8)]
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        return len(computes), c.get(key)
    assert both(run) == (1, b"computed")


def test_single_flight_follower_recovers_from_leader_error():
    def run(pkg, _):
        c = pkg.cache.TieredReadCache(1 << 20)
        key = c.needle_key(1, 2)
        with pytest.raises(RuntimeError):
            with c.single_flight(key) as leader:
                assert leader
                raise RuntimeError("leader failed")
        with c.single_flight(key) as leader:
            return leader
    assert both(run) is True


def test_generation_refuses_stale_set_after_invalidate():
    def run(pkg, _):
        c = pkg.cache.TieredReadCache(1 << 20)
        key = c.needle_key(1, 5)
        gen = c.generation(key)
        c.invalidate(1, 5, reason="delete")
        c.set(key, b"stale", gen=gen)
        out = [c.get(key)]
        c.set(key, b"fresh", gen=c.generation(key))
        out.append(c.get(key))
        other = c.needle_key(1, 6)
        g_other = c.generation(other)
        c.invalidate(1, 5, reason="delete")
        c.set(other, b"ok", gen=g_other)
        out.append(c.get(other))
        g3 = c.generation(other)
        c.invalidate_volume(1, "rebuild")
        c.set(other, b"stale2", gen=g3)
        out.append(c.get(other))
        return out
    assert both(run) == [None, b"fresh", b"ok", None]


def test_invalidate_reaches_restart_resident_disk_entries(tmp_path):
    """A cache directory written by one package, reopened by the other:
    the warm entry serves, and a volume invalidation drops it."""
    for writer, reader in ((JAX, PORT), (PORT, JAX)):
        d = str(tmp_path / f"{writer.name}_{reader.name}")
        c1 = writer.cache.TieredReadCache(256, disk_dir=d)
        c1.set(c1.needle_key(7, 1), b"x" * 200)
        c2 = reader.cache.TieredReadCache(256, disk_dir=d)
        assert c2.get(c2.needle_key(7, 1)) == b"x" * 200
        c2.invalidate_volume(7, "scrub_repair")
        assert c2.get(c2.needle_key(7, 1)) is None
        c3 = writer.cache.TieredReadCache(256, disk_dir=d)
        assert c3.get(c3.needle_key(7, 1)) is None


def test_drop_evicts_single_key_from_all_tiers(tmp_path):
    def run(pkg, d):
        c = pkg.cache.TieredReadCache(1 << 20, disk_dir=d)
        k = c.needle_key(1, 1)
        c.set(k, b"v")
        c.disk.set(k, b"v")
        c.drop(k)
        return c.get(k), files_of(d)
    assert both(run, tmp_path) == (None, {})


def test_stats_block(tmp_path):
    def run(pkg, d):
        c = pkg.cache.TieredReadCache(1 << 20,
                                      disk_dir=os.path.join(d, "c"))
        c.set(c.needle_key(1, 1), b"x")
        c.get(c.needle_key(1, 1))
        c.get(c.needle_key(1, 2))
        st = c.stats()
        st["disk_dir"] = os.path.basename(st["disk_dir"])
        return st
    st = both(run, tmp_path)
    assert st["enabled"] and st["mem_entries"] == 1 and st["volumes"] == 1


def test_cache_metric_families_match():
    for name in ("CacheHitCounter", "CacheMissCounter", "CacheAdmitCounter",
                 "CacheEvictCounter", "CacheInvalidateCounter",
                 "CacheBytesGauge", "ReadsSingleFlightWaitCounter",
                 "HedgeRequestsCounter", "HedgeIssuedCounter",
                 "HedgeWinsCounter", "HedgeDeniedCounter"):
        jm, pm = getattr(jax_metrics, name), getattr(port_metrics, name)
        assert (pm.name, pm.label_names, pm.kind) == \
            (jm.name, jm.label_names, jm.kind), name


# -- the cache on the EC read path (tests/test_degraded_reads.py:320-420) ------


@pytest.fixture
def ec_dir(tmp_path):
    """An EC volume of 30 needles of 10-3000 B (random.Random(11)),
    written and encoded by the port; yields (directory, payloads)."""
    d = str(tmp_path / "ec")
    os.makedirs(d)
    v = Volume(d, "", 1)
    rng = random.Random(11)
    payloads = {}
    for i in range(1, 31):
        data = bytes(rng.getrandbits(8) for _ in range(rng.randint(10, 3000)))
        v.write_needle(Needle(id=i, cookie=0xC0 + i, data=data))
        payloads[i] = data
    v.close()
    base = os.path.join(d, "1")
    encoder.write_ec_files(base, backend="cpu", large_block=LARGE,
                           small_block=SMALL, chunk=512)
    encoder.write_sorted_file_from_idx(base)
    return d, payloads


class _Store:
    def __init__(self, ecv):
        self.ecv = ecv

    def find_ec_volume(self, vid):
        return self.ecv


def _mount(cls, d, lost):
    ecv = cls(d, "", 1, large_block=LARGE, small_block=SMALL)
    for i in range(14):
        if i not in lost:
            ecv.mount_shard(i)
    return ecv


@pytest.fixture
def sides(ec_dir):
    """Both packages' read path over the same shard files with shards
    {0, 3} lost: (port, jax), each (store, fleet, read_ec_needle,
    delete_ec_needle, Needle, cache class)."""
    d, payloads = ec_dir
    port = SimpleNamespace(
        name="port", ecv=_mount(EcVolume, d, (0, 3)), fleet=DegradedReadFleet("cpu"),
        store_ec=store_ec, Needle=Needle, cache=port_cache)
    jax = SimpleNamespace(
        name="jax", ecv=_mount(JaxEcVolume, d, (0, 3)),
        fleet=JaxDegradedReadFleet(backend="numpy"), store_ec=jax_store_ec,
        Needle=JaxNeedle, cache=jax_cache)
    yield port, jax, payloads
    for side in (port, jax):
        side.fleet.stop()
        side.ecv.close()


def _read(side, cache, key, cookie=True):
    return side.store_ec.read_ec_needle(
        _Store(side.ecv), 1,
        side.Needle(id=key, cookie=0xC0 + key if cookie else 0),
        cache=cache, decoder=side.fleet)


def test_span_cache_serves_repeat_degraded_reads(sides):
    port, jax, payloads = sides
    seen = {}
    for side in (port, jax):
        cache = side.cache.TieredReadCache(4 << 20)
        for key in payloads:
            _read(side, cache, key)
        d0 = side.fleet.dispatches
        for key, want in payloads.items():
            assert _read(side, cache, key).data == want
        assert side.fleet.dispatches == d0, \
            "repeat reads made new RS dispatches past the cache"
        seen[side.name] = (cache.hits, cache.misses, cache.stats()["mem_entries"],
                      sorted(k for ks in cache._by_vid.values() for k in ks))
    assert seen['port'] == seen['jax']
    assert seen['port'][0] == len(payloads)


def test_poisoned_cache_entry_dropped_and_reread(sides):
    port, jax, payloads = sides
    seen = {}
    for side in (port, jax):
        cache = side.cache.TieredReadCache(4 << 20)
        cache.set(cache.needle_key(1, 7),
                  b"\x00garbage that is not a needle record")
        assert _read(side, cache, 7).data == payloads[7]
        h0 = cache.hits
        assert _read(side, cache, 7).data == payloads[7]
        assert cache.hits > h0
        seen[side.name] = (cache.hits, cache.misses,
                      cache.get(cache.needle_key(1, 7)))
    assert seen['port'] == seen['jax']


def test_poisoned_span_entry_dropped_and_reread(sides):
    port, jax, payloads = sides
    key = next(k for k in payloads if any(
        iv.to_shard_and_offset(LARGE, SMALL)[0] == 0
        for iv in port.ecv.locate_needle(k)[2]))
    seen = {}
    for side in (port, jax):
        cache = side.cache.TieredReadCache(4 << 20)
        poisoned = 0
        for iv in side.ecv.locate_needle(key)[2]:
            sid, off = iv.to_shard_and_offset(LARGE, SMALL)
            if sid == 0:
                cache.set(cache.span_key(1, 0, off, iv.size), b"\x01\x02")
                poisoned += 1
        assert poisoned
        assert _read(side, cache, key).data == payloads[key]
        assert _read(side, cache, key).data == payloads[key]
        seen[side.name] = (poisoned, cache.hits, cache.misses)
    assert seen['port'] == seen['jax']


def test_corrupt_span_entry_is_data_corruption_and_retried(sides):
    """A span of the right length but wrong bytes makes the assembled
    record fail its CRC: the retry drops the needle and the volume's
    spans and reads from the shards, as in the JAX package."""
    port, jax, payloads = sides
    key = next(k for k in payloads if any(
        iv.to_shard_and_offset(LARGE, SMALL)[0] in (0, 3)
        for iv in port.ecv.locate_needle(k)[2]))
    seen = {}
    for side in (port, jax):
        cache = side.cache.TieredReadCache(4 << 20)
        for iv in side.ecv.locate_needle(key)[2]:
            sid, off = iv.to_shard_and_offset(LARGE, SMALL)
            if sid in (0, 3):
                cache.set(cache.span_key(1, sid, off, iv.size),
                          b"\xaa" * iv.size)
        assert _read(side, cache, key).data == payloads[key]
        seen[side.name] = (cache.hits, cache.misses,
                      [k for ks in cache._by_vid.values() for k in ks
                       if "/s/" in k] == [])
    assert seen['port'] == seen['jax']


def test_delete_invalidates_cached_needle(sides):
    port, jax, _ = sides
    for side in (port, jax):
        cache = side.cache.TieredReadCache(4 << 20)
        _read(side, cache, 9)
        assert cache.get(cache.needle_key(1, 9)) is not None
        side.store_ec.delete_ec_needle(_Store(side.ecv), 1,
                                       side.Needle(id=9), cache=cache)
        assert cache.get(cache.needle_key(1, 9)) is None
        with pytest.raises(Exception) as ei:
            _read(side, cache, 9)
        assert isinstance(ei.value, (NeedleError,
                                     jax_store_ec.NeedleError))


def test_cookie_mismatch_through_the_cache(sides):
    port, _, payloads = sides
    cache = port_cache.TieredReadCache(4 << 20)
    _read(port, cache, 4)
    with pytest.raises(NeedleError, match="cookie"):
        store_ec.read_ec_needle(_Store(port.ecv), 1,
                                Needle(id=4, cookie=0x1), cache=cache,
                                decoder=port.fleet)
    assert _read(port, cache, 4, cookie=False).data == payloads[4]


# -- no fallback hides the card ------------------------------------------------


class _FaultyDecoder:
    """A decoder whose every decode waits for the others to queue, then
    raises the card fault it was given."""

    def __init__(self, fault, gate):
        self.fault = fault
        self.gate = gate
        self.calls = 0

    def decode(self, ecv, shard, off, length, remote_reader):
        self.calls += 1
        self.gate.wait(5)
        raise self.fault


@pytest.mark.parametrize("fault", [
    KernelLaunchError("gf_linear launch failed: cudaError 719"),
    BuildError("nvcc failed"),
    RuntimeError("CUDA error: an illegal memory access was encountered")])
def test_card_fault_reaches_every_follower_and_is_never_cached(ec_dir,
                                                               fault):
    d, _ = ec_dir
    ecv = _mount(EcVolume, d, (0, 3))
    cache = port_cache.TieredReadCache(4 << 20)
    gate = threading.Event()
    dec = _FaultyDecoder(fault, gate)
    key = next(k for k in range(1, 31) if any(
        iv.to_shard_and_offset(LARGE, SMALL)[0] in (0, 3)
        for iv in ecv.locate_needle(k)[2]))
    errors = []

    def reader():
        try:
            store_ec.read_ec_needle(_Store(ecv), 1,
                                    Needle(id=key, cookie=0xC0 + key),
                                    cache=cache, decoder=dec)
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(6)]
    try:
        for th in threads:
            th.start()
        deadline_t = time.monotonic() + 5
        while len(cache._sf) == 0 and time.monotonic() < deadline_t:
            time.sleep(0.005)
        time.sleep(0.1)  # the followers queue behind the leader
        gate.set()
        for th in threads:
            th.join(10)
    finally:
        ecv.close()
    assert len(errors) == 6
    assert all(e is fault for e in errors), errors
    assert dec.calls == 1, "a follower reran the work on the card"
    assert cache.stats()["mem_entries"] == 0 and not cache._by_vid
    assert cache.get(cache.needle_key(1, key)) is None


def test_card_fault_is_not_the_poisoned_entry_retry(ec_dir):
    """The poisoned-entry retry catches data corruption only: a kernel
    fault on the retry's read of the shards reaches the caller."""
    d, _ = ec_dir
    ecv = _mount(EcVolume, d, (0,))
    cache = port_cache.TieredReadCache(4 << 20)
    key = next(k for k in range(1, 31) if any(
        iv.to_shard_and_offset(LARGE, SMALL)[0] == 0
        for iv in ecv.locate_needle(k)[2]))
    cache.set(cache.needle_key(1, key), b"\x00garbage")
    gate = threading.Event()
    gate.set()
    dec = _FaultyDecoder(KernelLaunchError("launch refused"), gate)
    try:
        with pytest.raises(KernelLaunchError):
            store_ec.read_ec_needle(_Store(ecv), 1,
                                    Needle(id=key, cookie=0xC0 + key),
                                    cache=cache, decoder=dec)
    finally:
        ecv.close()
    assert cache.get(cache.needle_key(1, key)) is None


def test_hedger_passes_a_card_fault_through_without_failover():
    h = port_hedge.Hedger(delay_floor_s=5.0)
    tried = []

    def faulty():
        tried.append("primary")
        raise KernelLaunchError("launch refused")

    def other():
        tried.append("other")
        return b"x"

    with pytest.raises(KernelLaunchError):
        h.fetch([faulty, other])
    assert tried == ["primary"]
    h2 = port_hedge.Hedger(delay_floor_s=5.0, max_inflight=2)
    h2._inflight = 1  # every lane taken: the inline path
    with pytest.raises(KernelLaunchError):
        h2.fetch([faulty, other])
    assert tried == ["primary", "primary"]
    h.stop()
    h2.stop()


# -- the Hedger (tests/test_resilience.py:329-432) ----------------------------


def _ledger(h):
    return h.requests, h.hedges, h.wins, h.denied


def test_hedger_fast_primary_never_hedges():
    def run(pkg, _):
        h = pkg.Hedger(delay_floor_s=0.2)
        out = [h.fetch([lambda: "a", lambda: "b"]) for _ in range(5)]
        return out, _ledger(h)
    assert both(run) == (["a"] * 5, (5, 0, 0, 0))


def test_hedger_slow_primary_hedges_and_loser_is_abandoned():
    def run(pkg, _):
        h = pkg.Hedger(delay_floor_s=0.01)
        release = threading.Event()

        def slow():
            release.wait(timeout=5)
            return "slow"

        t0 = time.monotonic()
        got = h.fetch([slow, lambda: "fast"])
        fast = time.monotonic() - t0 < 1.0
        release.set()
        return got, fast, _ledger(h)
    assert both(run) == ("fast", True, (1, 1, 1, 0))


def test_hedger_budget_denies_excess_hedges():
    def run(pkg, _):
        h = pkg.Hedger(delay_floor_s=0.005, budget_pct=0.0)

        def slowish():
            time.sleep(0.03)
            return "primary"

        return h.fetch([slowish, lambda: "never"]), _ledger(h)
    assert both(run) == ("primary", (1, 0, 0, 1))


def test_hedger_failover_on_error_is_not_budgeted():
    def run(pkg, _):
        h = pkg.Hedger(delay_floor_s=5.0, budget_pct=0.0)

        def bad():
            raise OSError("down")

        return h.fetch([bad, lambda: "b"]), _ledger(h)
    assert both(run) == ("b", (1, 0, 0, 0))


def test_hedger_all_candidates_fail_raises_first_error():
    def run(pkg, _):
        h = pkg.Hedger(delay_floor_s=0.001)

        def bad1():
            raise OSError("first")

        def bad2():
            raise OSError("second")

        with pytest.raises(OSError, match="first"):
            h.fetch([bad1, bad2])
        return _ledger(h)
    both(run)


def test_hedger_p95_tracking_moves_delay():
    def run(pkg, _):
        h = pkg.Hedger(delay_floor_s=0.001)
        delays = []
        for i in range(40):
            h.observe(0.001 * i)
            delays.append(h.hedge_delay())
        return delays
    assert both(run)[-1] >= 0.02


def test_hedger_spent_deadline_refuses():
    for pkg in (JAX, PORT):
        h = pkg.Hedger()
        with pkg.deadline.budget(0.0):
            with pytest.raises(pkg.deadline.DeadlineExceeded):
                h.fetch([lambda: "a", lambda: "b"])


def test_hedger_mid_flight_deadline_keeps_its_type():
    for pkg in (JAX, PORT):
        h = pkg.Hedger(delay_floor_s=0.01)

        def slow_then_timeout():
            time.sleep(0.2)
            raise TimeoutError("budget-sized timeout")

        with pkg.deadline.budget(0.15):
            with pytest.raises(pkg.deadline.DeadlineExceeded):
                h.fetch([slow_then_timeout, slow_then_timeout])


def test_hedger_saturated_lanes_keep_failover():
    def run(pkg, _):
        h = pkg.Hedger(delay_floor_s=0.01, max_inflight=2)
        gate = threading.Event()
        results = []
        t = threading.Thread(target=lambda: results.append(
            h.fetch([lambda: (gate.wait(5), "slow")[1], lambda: "hedge"])))
        t.start()
        time.sleep(0.05)   # the blocked primary pins the only lane

        def bad():
            raise OSError("down")

        out = [h.fetch([bad, lambda: "fallback"]),
               h.fetch([bad, bad, lambda: "third"])]
        with pytest.raises(OSError, match="down"):
            h.fetch([bad, bad, bad])
        gate.set()
        t.join(timeout=5)
        return out, t.is_alive(), h._inflight
    assert both(run) == (["fallback", "third"], False, 0)


def test_volume_server_remote_read_keeps_the_deadline_type(tmp_path):
    """The volume server's hedged shard read surfaces a spent budget as
    DeadlineExceeded and keeps the shard's locations (the JAX filer's
    hedged chunk fetch keeps the same contract,
    tests/test_resilience.py:567)."""
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    vs = VolumeServer("127.0.0.1:1", [str(tmp_path)], port=1,
                      ec_encoder="cpu", hedge_reads=True)
    try:
        vs._ec_locations[5] = (time.monotonic(),
                               {2: ["127.0.0.1:2", "127.0.0.1:3"]})
        reader = vs._make_remote_reader(5)
        with deadline.budget(0.0):
            with pytest.raises(deadline.DeadlineExceeded):
                reader(2, 0, 10)
        assert vs._ec_locations[5][1][2] == ["127.0.0.1:2", "127.0.0.1:3"]
        assert vs.hedger.requests == 1
    finally:
        vs.hedger.stop()
        vs.store.close()


# -- disabled-overhead gates (tests/test_perf_gates.py:291, 507) ---------------


def _threads(word):
    return [th.name for th in threading.enumerate()
            if word in th.name.lower()]


def test_no_cache_and_no_hedger_by_default(tmp_path):
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    before = set(_threads("hedge")) | set(_threads("cache"))
    vs = VolumeServer("127.0.0.1:1", [str(tmp_path / "a")], port=1,
                      ec_encoder="cpu")
    assert vs.read_cache is None and vs.hedger is None
    vs.store.close()
    vs = VolumeServer("127.0.0.1:1", [str(tmp_path / "b")], port=2,
                      ec_encoder="cpu", cache_size_mb=4,
                      cache_dir=str(tmp_path / "cd"), hedge_reads=True,
                      hedge_delay_ms=25.0)
    assert vs.read_cache is not None and vs.hedger is not None
    assert vs.read_cache.disk.dir == str(tmp_path / "cd" / "rc2")
    assert vs.hedger.delay_floor_s == 0.025
    # constructed, neither makes a thread
    assert set(_threads("hedge")) | set(_threads("cache")) == before
    vs.hedger.stop()
    vs.store.close()


def test_hedger_spawns_nothing_before_a_multi_candidate_fetch():
    h = port_hedge.Hedger(name="gate-hedge")
    assert h._pool.thread_count() == 0
    assert h.fetch([lambda: 1]) == 1
    assert h._pool.thread_count() == 0 and not _threads("gate-hedge")
    assert h.fetch([lambda: 1, lambda: 2]) == 1
    assert h._pool.thread_count() == 1
    h.stop()


def test_fanout_pool_lazy_drain_inline_and_context():
    pool = FanOutPool(3, name="gate-fan")
    assert pool.thread_count() == 0 and not _threads("gate-fan")
    var = contextvars.ContextVar("v", default="unset")
    token = var.set("caller")
    try:
        futs = [pool.submit(lambda i=i: (i, var.get())) for i in range(6)]
        assert [f.wait(5)[0] for f in futs] == \
            [(i, "caller") for i in range(6)]
    finally:
        var.reset(token)
    assert pool.thread_count() == 3
    gate = threading.Event()
    queued = [pool.submit(gate.wait, 5) for _ in range(5)]
    gate.set()
    pool.stop()
    assert all(f.done() for f in queued)
    late = pool.submit(threading.get_ident)
    assert late.done() and late.wait()[0] == threading.get_ident()
    failed = pool.submit(lambda: 1 / 0)
    assert isinstance(failed.wait()[1], ZeroDivisionError)
