"""The port's degraded reads (``seaweedfs_tpu_torch.reads.DegradedReadFleet``
and ``EcVolume``'s in-place recovery) held against the JAX package's
(``seaweedfs_tpu.reads.DegradedReadFleet("numpy")``) on the same shard
files: multi-shard loss, unrecoverable loss, remote readers that fail or
return short bytes, per-request error latching, stop(), the deadline cap
and fusion. The port runs ``backend="cpu"``; the tolerance is exact
bytes. Fusion is asserted without a timing window: requests are queued
before the fleet's dispatcher starts.
"""

import os
import random
import threading

import pytest
import torch

from seaweedfs_tpu.ec.ec_volume import EcShardNotFound as JaxEcShardNotFound
from seaweedfs_tpu.ec.ec_volume import EcVolume as JaxEcVolume
from seaweedfs_tpu.ops import ReedSolomon as JaxReedSolomon
from seaweedfs_tpu.reads import DegradedReadFleet as JaxDegradedReadFleet
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle

from seaweedfs_tpu_torch.ec import ec_volume, encoder, store_ec
from seaweedfs_tpu_torch.ec.ec_volume import EcShardNotFound, EcVolume
from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon
from seaweedfs_tpu_torch.reads import DegradedReadFleet
from seaweedfs_tpu_torch.reads.decode_fleet import _Request
from seaweedfs_tpu_torch.resilience import deadline
from seaweedfs_tpu_torch.stats.metrics import (
    ReadsDegradedCounter, ReadsShortShardCounter)
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

LARGE = 2048
SMALL = 256


@pytest.fixture
def ec_dir(tmp_path):
    """An EC volume of 30 needles of 10-3000 B (random.Random(11)),
    written and encoded by the port; yields (directory, payloads, base)."""
    d = str(tmp_path)
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
    return d, payloads, base


def _mount(cls, d, lost):
    ecv = cls(d, "", 1, large_block=LARGE, small_block=SMALL)
    for i in range(14):
        if i not in lost:
            ecv.mount_shard(i)
    return ecv


@pytest.fixture
def fleets():
    port = DegradedReadFleet(backend="cpu")
    ref = JaxDegradedReadFleet(backend="numpy")
    yield port, ref
    port.stop()
    ref.stop()


def _intervals_on(ecv, shard, limit=64):
    """(offset, length) of needle intervals that lie on ``shard``."""
    out = []
    for key in range(1, 31):
        for iv in ecv.locate_needle(key)[2]:
            sid, off = iv.to_shard_and_offset(LARGE, SMALL)
            if sid == shard:
                out.append((off, iv.size))
    return out[:limit]


@pytest.mark.parametrize("lost", [(0, 5), (10, 13), (1, 7, 11),
                                  (2, 4, 6, 12), (0, 3, 11, 13)])
def test_reads_match_jax_fleet_and_in_place(ec_dir, fleets, lost):
    d, payloads, _ = ec_dir
    port, ref = fleets
    ecv = _mount(EcVolume, d, lost)
    jecv = _mount(JaxEcVolume, d, lost)
    rs = ReedSolomon(backend="cpu")
    try:
        for key, want in payloads.items():
            via_fleet = ecv.read_needle_blob(key, decoder=port)
            in_place = ecv.read_needle_blob(key, rs=rs)
            jax_blob = jecv.read_needle_blob(key, decoder=ref)
            assert via_fleet == in_place == jax_blob, f"key {key}"
            assert ecv.read_needle(Needle(id=key, cookie=0xC0 + key),
                                   decoder=port).data == want
    finally:
        ecv.close()
        jecv.close()


def test_in_place_without_remote_reads_ten_rows_inline(ec_dir, monkeypatch):
    """With no remote reader the in-place path reads local rows on the
    caller's thread, in shard-id order, and stops at the tenth: no
    reader pool, and the bytes are the JAX package's."""
    d, payloads, _ = ec_dir
    lost = (0,)
    ecv = _mount(EcVolume, d, lost)
    jecv = _mount(JaxEcVolume, d, lost)

    def no_pool():
        raise AssertionError("the reader pool was used")

    monkeypatch.setattr(ec_volume, "_get_recover_pool", no_pool)
    reads = []
    for sid, shard in ecv.shards.items():
        real = shard.read_at

        def counted(off, n, sid=sid, real=real):
            reads.append((sid, threading.get_ident()))
            return real(off, n)

        shard.read_at = counted
    rs = ReedSolomon(backend="cpu")
    try:
        off, n = _intervals_on(ecv, 0, limit=1)[0]
        got = ecv._recover_in_place(0, off, n, None, rs)
        assert got == jecv._recover_in_place(
            0, off, n, None, JaxReedSolomon(backend="numpy"))
        assert [sid for sid, _ in reads] == list(range(1, 11))
        assert {tid for _, tid in reads} == {threading.get_ident()}
        for key, want in payloads.items():
            assert ecv.read_needle(Needle(id=key, cookie=0xC0 + key),
                                   rs=rs).data == want
    finally:
        ecv.close()
        jecv.close()


def test_store_read_ec_needle_with_decoder(ec_dir, fleets):
    d, payloads, _ = ec_dir
    port, _ = fleets
    ecv = _mount(EcVolume, d, (0, 5, 11, 13))

    class _Store:
        def find_ec_volume(self, vid):
            return ecv

    try:
        for key, want in payloads.items():
            got = store_ec.read_ec_needle(
                _Store(), 1, Needle(id=key, cookie=0xC0 + key),
                decoder=port)
            assert got.data == want
        assert port.dispatches > 0 and port.spans_decoded >= port.dispatches
    finally:
        ecv.close()


def test_five_lost_shards_is_unrecoverable(ec_dir, fleets):
    d, _, _ = ec_dir
    port, ref = fleets
    lost = (0, 1, 2, 3, 4)
    ecv = _mount(EcVolume, d, lost)
    jecv = _mount(JaxEcVolume, d, lost)
    try:
        with pytest.raises(EcShardNotFound):
            ecv.read_needle(Needle(id=1, cookie=0xC1), decoder=port)
        with pytest.raises(EcShardNotFound):
            ecv.read_needle(Needle(id=1, cookie=0xC1),
                            rs=ReedSolomon(backend="cpu"))
        with pytest.raises(JaxEcShardNotFound):
            jecv.read_needle(JaxNeedle(id=1, cookie=0xC1), decoder=ref)
    finally:
        ecv.close()
        jecv.close()


class _FlakyRemote:
    """remote_reader stand-in serving shard files from disk, with failures
    per shard id: raise, short bytes, or None."""

    def __init__(self, base, fail=(), short=(), silent=()):
        self.base = base
        self.fail = set(fail)
        self.short = set(short)
        self.silent = set(silent)
        self.calls = []
        self._lock = threading.Lock()

    def __call__(self, sid, offset, length):
        with self._lock:
            self.calls.append(sid)
        if sid in self.fail:
            raise OSError(f"shard {sid} peer unreachable")
        if sid in self.silent:
            return None
        with open(encoder.shard_file_name(self.base, sid), "rb") as f:
            f.seek(offset)
            b = f.read(length)
        if sid in self.short:
            return b[:max(0, len(b) - 1)]
        return b + b"\x00" * (length - len(b))


@pytest.mark.parametrize("use_fleet", [True, False])
def test_remote_errors_and_short_bytes(ec_dir, fleets, use_fleet):
    """Eight shards local, the rest remote only, where one peer raises,
    one returns short bytes and one returns None: reads top up from the
    healthy remotes and match the JAX package's."""
    d, payloads, base = ec_dir
    port, ref = fleets
    lost = (0, 1, 10, 11, 12, 13)
    ecv = _mount(EcVolume, d, lost)
    jecv = _mount(JaxEcVolume, d, lost)
    remote = _FlakyRemote(base, fail=(10,), short=(11,), silent=(12,))
    jremote = _FlakyRemote(base, fail=(10,), short=(11,), silent=(12,))
    try:
        for key, want in list(payloads.items())[:12]:
            got = ecv.read_needle(
                Needle(id=key, cookie=0xC0 + key), remote_reader=remote,
                decoder=port if use_fleet else None,
                rs=ReedSolomon(backend="cpu"))
            assert got.data == want
            assert got.data == jecv.read_needle(
                JaxNeedle(id=key, cookie=0xC0 + key), remote_reader=jremote,
                decoder=ref if use_fleet else None).data
        assert remote.calls, "remote reader never consulted"
    finally:
        ecv.close()
        jecv.close()


def test_failing_request_latches_only_itself(ec_dir):
    """One batch holding a request whose volume has only 7 reachable
    shards and healthy requests: the bad one fails alone."""
    d, payloads, base = ec_dir
    bad = _mount(EcVolume, d, (0, 1, 2, 10, 11, 12, 13))
    good = _mount(EcVolume, d, (0, 5))
    f = DegradedReadFleet(backend="cpu")
    try:
        dead = _FlakyRemote(base, fail=range(14))
        reqs = [_Request(bad, 0, 0, 100, dead)] + \
            [_Request(good, 0, off, n, None)
             for off, n in _intervals_on(good, 0, limit=5)]
        for r in reqs:
            f._q.put(r)
        f._ensure_started()
        for r in reqs:
            assert r.done.wait(30)
        assert isinstance(reqs[0].error, EcShardNotFound)
        with open(encoder.shard_file_name(base, 0), "rb") as sf:
            shard0 = sf.read()
        for r in reqs[1:]:
            assert r.error is None
            assert r.result == shard0[r.offset:r.offset + r.length]
    finally:
        f.stop()
        bad.close()
        good.close()


def test_queued_requests_fuse_into_one_dispatch(ec_dir):
    """Requests queued before the dispatcher starts are all drained into
    the first batch: fewer dispatches than requests, and every span is
    the shard's bytes."""
    d, _, base = ec_dir
    ecv = _mount(EcVolume, d, (0,))
    f = DegradedReadFleet(backend="cpu", batch_window_s=0.0)
    degraded_before = ReadsDegradedCounter.labels().value
    try:
        reqs = [_Request(ecv, 0, off, n, None)
                for off, n in _intervals_on(ecv, 0, limit=12)]
        assert len(reqs) >= 4
        for r in reqs:
            f._q.put(r)
        f._ensure_started()
        for r in reqs:
            assert r.done.wait(30)
        with open(encoder.shard_file_name(base, 0), "rb") as sf:
            shard0 = sf.read()
        for r in reqs:
            assert r.error is None
            assert r.result == shard0[r.offset:r.offset + r.length]
        assert f.spans_decoded == len(reqs)
        assert f.dispatches < len(reqs)
        assert ReadsDegradedCounter.labels().value - degraded_before \
            == len(reqs)
    finally:
        f.stop()
        ecv.close()


def test_concurrent_reads_from_many_threads(ec_dir, fleets):
    d, payloads, _ = ec_dir
    port, _ = fleets
    ecv = _mount(EcVolume, d, (0, 5, 11, 13))
    errors = []

    def reader(keys):
        try:
            for key in keys:
                got = ecv.read_needle(Needle(id=key, cookie=0xC0 + key),
                                      decoder=port)
                assert got.data == payloads[key]
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    keys = list(payloads)
    threads = [threading.Thread(target=reader, args=(keys[i::8],))
               for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:2]
        assert port.spans_decoded >= port.dispatches > 0
    finally:
        ecv.close()


def test_construction_starts_nothing():
    before = threading.active_count()
    f = DegradedReadFleet()          # the card's backend: no card needed yet
    assert threading.active_count() == before
    assert f._rs is None and f._dispatcher is None and f._pool is None
    f.stop()                          # stop before any use is a no-op
    assert f._dispatcher is None


def test_first_decode_needs_the_card(ec_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    d, _, _ = ec_dir
    ecv = _mount(EcVolume, d, (0,))
    f = DegradedReadFleet()
    try:
        with pytest.raises(RuntimeError):
            f.decode(ecv, 0, 0, 16)
        assert f._dispatcher is None
    finally:
        f.stop()
        ecv.close()


def test_stop_fails_pending_requests(ec_dir):
    d, _, _ = ec_dir
    ecv = _mount(EcVolume, d, (0,))
    f = DegradedReadFleet(backend="cpu")
    try:
        # the dispatcher fails whatever is queued behind the stop sentinel
        late = [_Request(ecv, 0, 0, 16, None) for _ in range(3)]
        f._q.put(None)
        for r in late:
            f._q.put(r)
        f._run()
        assert all(r.done.is_set() and isinstance(r.error, EcShardNotFound)
                   for r in late)
        # stop() fails requests that slipped in after the dispatcher left
        f._ensure_started()
        f.stop()
        orphan = _Request(ecv, 0, 0, 16, None)
        f._q.put(orphan)
        f.stop()
        assert orphan.done.is_set() and \
            isinstance(orphan.error, EcShardNotFound)
        with pytest.raises(EcShardNotFound, match="stopped"):
            f.decode(ecv, 0, 0, 16)
    finally:
        f.stop()
        ecv.close()


def test_spent_deadline_caps_the_wait(ec_dir, fleets):
    d, _, _ = ec_dir
    port, _ = fleets
    ecv = _mount(EcVolume, d, (0,))
    try:
        with deadline.budget(0.0):
            with pytest.raises(deadline.DeadlineExceeded):
                port.decode(ecv, 0, 0, 16)
        assert deadline.remaining() is None
    finally:
        ecv.close()


def test_short_local_shard_counted_and_recovered(ec_dir, fleets):
    d, payloads, base = ec_dir
    port, _ = fleets
    p = encoder.shard_file_name(base, 2)
    os.truncate(p, os.path.getsize(p) // 2)
    ecv = _mount(EcVolume, d, ())
    try:
        child = ReadsShortShardCounter.labels("1", "2")
        before = child.value
        for key, want in payloads.items():
            got = ecv.read_needle(Needle(id=key, cookie=0xC0 + key),
                                  decoder=port)
            assert got.data == want
        assert child.value > before
        assert ecv._short_logged == {2}
    finally:
        ecv.close()


@pytest.mark.cuda
def test_decode_fleet_on_the_card(ec_dir):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d, payloads, _ = ec_dir
    ecv = _mount(EcVolume, d, (0, 5, 11, 13))
    f = DegradedReadFleet()
    try:
        for key, want in payloads.items():
            assert ecv.read_needle(Needle(id=key, cookie=0xC0 + key),
                                   decoder=f).data == want
        assert f.dispatches > 0
    finally:
        f.stop()
        ecv.close()
