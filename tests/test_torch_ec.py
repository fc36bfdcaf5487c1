"""The port's EC slice as a whole, held against the JAX package.

The on-disk formats are the state the two packages share, so every file
one writes must be byte-identical to the other's and readable by it:
shards and .ecx from encode, rebuilt shards, degraded reads, the .ecx
after journal replay, and the .dat/.idx decoded back. The port runs
``backend="cpu"`` (the kernel's plain version); the JAX package runs its
XLA codec (``backend="jax"``) or its numpy one, as its own tests do.
Tiny geometry (LARGE=2048, SMALL=256) puts large rows, the large->small
rollover and the zero-padded tail in a few-KB volume.
"""

import hashlib
import os
import random
import shutil

import numpy as np
import pytest

from seaweedfs_tpu import ec as jax_ec
from seaweedfs_tpu.ec import store_ec as jax_store_ec
from seaweedfs_tpu.ops.rs_code import ReedSolomon as JaxReedSolomon
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.store import Store as JaxStore
from seaweedfs_tpu.storage.volume import Volume as JaxVolume

from seaweedfs_tpu_torch.ec import encoder, store_ec
from seaweedfs_tpu_torch.ec.ec_volume import EcShardNotFound, EcVolume
from seaweedfs_tpu_torch.ec.locate import Interval, locate_data
from seaweedfs_tpu_torch.ec.shard_bits import ShardBits
from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon
from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage.needle import (
    CookieMismatch, Needle, NeedleError, actual_size)
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import Volume

LARGE = 2048
SMALL = 256
ROW = SMALL * 10
# 512: sub-block chunks; 3 rows: a [3, 10, SMALL] batch (the batch
# dimension must not be transposed into lanes); 1 MiB: everything at once
CHUNKS = (512, 3 * ROW, 1 << 20)


@pytest.fixture(scope="module")
def rs():
    return ReedSolomon(backend="cpu")


def _fill(volume_cls, needle_cls, directory):
    """tests/test_ec.py's fixture volume: 40 needles of 10-3000 bytes
    from random.Random(7), needles 5 and 17 deleted."""
    v = volume_cls(directory, "", 1)
    rng = random.Random(7)
    payloads = {}
    for i in range(1, 41):
        data = bytes(rng.getrandbits(8) for _ in range(rng.randint(10, 3000)))
        v.write_needle(needle_cls(id=i, cookie=0xC0 + i, data=data,
                                  name=b"f%d" % i))
        payloads[i] = data
    for i in (5, 17):
        v.delete_needle(needle_cls(id=i, cookie=0xC0 + i))
        del payloads[i]
    v.close()
    return os.path.join(directory, "1"), payloads


@pytest.fixture
def jax_volume(tmp_path):
    """The fixture volume written by the JAX package's Volume."""
    d = tmp_path / "jax"
    d.mkdir()
    return _fill(JaxVolume, JaxNeedle, str(d))


@pytest.fixture
def port_volume(tmp_path):
    """The fixture volume written by the port's Volume."""
    d = tmp_path / "port"
    d.mkdir()
    return _fill(Volume, Needle, str(d))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _ec_files(base):
    return {i: _read(encoder.shard_file_name(base, i)) for i in range(14)}


def _port_encode(base, chunk=512):
    encoder.write_ec_files(base, backend="cpu", large_block=LARGE,
                           small_block=SMALL, chunk=chunk)
    encoder.write_sorted_file_from_idx(base)


def _jax_encode(base, backend="jax"):
    jax_ec.write_ec_files(base, backend=backend, large_block=LARGE,
                          small_block=SMALL, chunk=1024)
    jax_ec.write_sorted_file_from_idx(base)


def _copy_volume(base, directory):
    os.makedirs(directory, exist_ok=True)
    for ext in (".dat", ".idx"):
        shutil.copy(base + ext, os.path.join(directory, "1" + ext))
    return os.path.join(directory, "1")


@pytest.mark.parametrize("chunk", CHUNKS)
def test_encode_matches_jax_package(jax_volume, tmp_path, chunk):
    base, _ = jax_volume
    other = _copy_volume(base, str(tmp_path / "ref"))
    _jax_encode(other)
    _port_encode(base, chunk)
    sizes = {os.path.getsize(encoder.shard_file_name(base, i))
             for i in range(14)}
    assert len(sizes) == 1
    # 1 large row (20480 B) + small rows for the rest
    assert os.path.getsize(base + ".dat") > LARGE * 10
    assert _ec_files(base) == _ec_files(other)
    assert _read(base + ".ecx") == _read(other + ".ecx")


@pytest.mark.parametrize("entries", [0, 1, 300])
def test_sorted_ecx_and_dat_size_match_jax(tmp_path, entries):
    """An .idx log with re-puts, deletes, re-puts after a delete and keys
    only ever deleted: the port's .ecx and .dat size equal the JAX
    package's, and entries_to_bytes equals entry_to_bytes per entry."""
    rng = np.random.default_rng(entries)
    keys = rng.integers(1, 40, entries, dtype=np.uint64)
    offsets = rng.integers(1, 1 << 20, entries) * 8
    sizes = np.where(rng.random(entries) < 0.3, -1,
                     rng.integers(0, 5000, entries)).astype(np.int32)
    blob = idx_codec.entries_to_bytes(keys, offsets, sizes)
    assert blob == b"".join(
        idx_codec.entry_to_bytes(int(k), int(o), int(s))
        for k, o, s in zip(keys, offsets, sizes))
    bases = []
    for name in ("port", "jax"):
        base = str(tmp_path / name)
        with open(base + ".idx", "wb") as f:
            f.write(blob)
        with open(base + ".ec00", "wb") as f:
            f.write(bytes([3]) + bytes(7))  # superblock version 3
        bases.append(base)
    encoder.write_sorted_file_from_idx(bases[0])
    jax_ec.write_sorted_file_from_idx(bases[1])
    assert _read(bases[0] + ".ecx") == _read(bases[1] + ".ecx")
    assert encoder.find_dat_file_size(bases[0]) == \
        jax_ec.find_dat_file_size(bases[1])


def test_port_volume_file_is_jax_volume_file(port_volume):
    """A port-written .dat/.idx opens in the JAX Volume and reads back."""
    base, payloads = port_volume
    v = JaxVolume(os.path.dirname(base), "", 1, create_if_missing=False)
    for key, data in payloads.items():
        assert v.read_needle(JaxNeedle(id=key, cookie=0xC0 + key)).data == data
    with pytest.raises(Exception):
        v.read_needle(JaxNeedle(id=5, cookie=0xC5))
    v.close()


def test_port_volume_reopen_truncates_torn_tail(port_volume):
    """Bytes past the last indexed record (a torn append) are cut at
    load, as the JAX Volume cuts them."""
    base, payloads = port_volume
    size = os.path.getsize(base + ".dat")
    with open(base + ".dat", "ab") as f:
        f.write(b"\x07" * 13)
    v = Volume(os.path.dirname(base), "", 1, create_if_missing=False)
    assert os.path.getsize(base + ".dat") == size
    for key, data in payloads.items():
        assert v.read_needle(Needle(id=key, cookie=0xC0 + key)).data == data
    v.close()


def test_port_shards_open_in_jax_ec_volume(port_volume):
    """Port-written volume + port-written shards -> JAX EcVolume reads,
    healthy and degraded, byte-identical to the port's own reads."""
    base, payloads = port_volume
    _port_encode(base)
    d = os.path.dirname(base)
    jecv = jax_ec.EcVolume(d, "", 1, large_block=LARGE, small_block=SMALL)
    pecv = EcVolume(d, "", 1, large_block=LARGE, small_block=SMALL)
    for i in range(14):
        if i not in (1, 4, 10, 12):
            jecv.mount_shard(i)
            pecv.mount_shard(i)
    jrs = JaxReedSolomon(backend="numpy")
    prs = ReedSolomon(backend="cpu")
    for key, data in payloads.items():
        got = jecv.read_needle(JaxNeedle(id=key, cookie=0xC0 + key), rs=jrs)
        assert got.data == data
        assert pecv.read_needle_blob(key, rs=prs) == \
            jecv.read_needle_blob(key, rs=jrs)
    jecv.close()
    pecv.close()


def test_jax_shards_open_in_port_ec_volume(jax_volume, rs):
    """JAX-written volume + shards -> the port's EcVolume reads them,
    with four shards lost."""
    base, payloads = jax_volume
    _jax_encode(base)
    ecv = EcVolume(os.path.dirname(base), "", 1, large_block=LARGE,
                   small_block=SMALL)
    for i in range(14):
        if i not in (0, 5, 11, 13):
            ecv.mount_shard(i)
    for key, data in payloads.items():
        assert ecv.read_needle(Needle(id=key, cookie=0xC0 + key),
                               rs=rs).data == data
    with pytest.raises(CookieMismatch):
        ecv.read_needle(Needle(id=1, cookie=0xBAD), rs=rs)
    ecv.close()


def test_every_needle_readable_with_random_kills(jax_volume, rs):
    base, payloads = jax_volume
    _port_encode(base)
    dat = _read(base + ".dat")
    ecv = EcVolume(os.path.dirname(base), "", 1, large_block=LARGE,
                   small_block=SMALL)
    rng = random.Random(3)
    for key in payloads:
        kill = set(rng.sample(range(14), 4))
        for i in range(14):
            if i in kill:
                ecv.unmount_shard(i)
            else:
                ecv.mount_shard(i)
        offset, size = ecv.find_needle(key)
        assert ecv.read_needle_blob(key, rs=rs) == \
            dat[offset:offset + actual_size(size)]
    ecv.close()


@pytest.mark.parametrize("kill", [(3,), (0, 13), (1, 7, 11), (0, 7, 11, 13)])
def test_rebuild_missing_shards_matches_jax(jax_volume, tmp_path, kill):
    base, _ = jax_volume
    _port_encode(base)
    want = _ec_files(base)
    other = _copy_volume(base, str(tmp_path / "ref"))
    for i in range(14):
        shutil.copy(encoder.shard_file_name(base, i),
                    encoder.shard_file_name(other, i))
    for i in kill:
        os.remove(encoder.shard_file_name(base, i))
        os.remove(encoder.shard_file_name(other, i))
    assert sorted(encoder.rebuild_ec_files(base, backend="cpu",
                                           chunk=512)) == sorted(kill)
    jax_ec.rebuild_ec_files(other, backend="jax", chunk=1024)
    assert _ec_files(base) == want
    assert _ec_files(other) == want


def test_rebuild_too_few_shards_raises(jax_volume):
    base, _ = jax_volume
    _port_encode(base)
    for i in range(5):
        os.remove(encoder.shard_file_name(base, i))
    with pytest.raises(ValueError):
        encoder.rebuild_ec_files(base, backend="cpu", chunk=512)


def test_delete_journal_and_ecx_replay_match_jax(jax_volume, tmp_path):
    base, _ = jax_volume
    _port_encode(base)
    d = os.path.dirname(base)
    other = _copy_volume(base, str(tmp_path / "ref"))
    shutil.copy(base + ".ecx", other + ".ecx")
    ecv = EcVolume(d, "", 1, large_block=LARGE, small_block=SMALL)
    jecv = jax_ec.EcVolume(os.path.dirname(other), "", 1,
                           large_block=LARGE, small_block=SMALL)
    for i in range(14):
        ecv.mount_shard(i)
    before = ecv.file_count()
    for key in (3, 9, 3, 99):
        ecv.delete_needle(key)
        jecv.delete_needle(key)
    assert ecv.file_count() == before - 2 == jecv.file_count()
    with pytest.raises(NeedleError):
        ecv.read_needle(Needle(id=3, cookie=0xC3),
                        rs=ReedSolomon(backend="cpu"))
    ecv.close()
    jecv.close()
    assert _read(base + ".ecx") == _read(other + ".ecx")
    assert _read(base + ".ecj") == _read(other + ".ecj")
    reopened = EcVolume(d, "", 1, large_block=LARGE, small_block=SMALL)
    with pytest.raises(NeedleError):
        reopened.find_needle(9)
    reopened.close()
    # the JAX package replays the port's journal and vice versa
    encoder.write_idx_file_from_ec_index(base)
    jax_ec.write_idx_file_from_ec_index(other)
    assert _read(base + ".idx") == _read(other + ".idx")
    encoder.rebuild_ecx_file(base)
    jax_ec.rebuild_ecx_file(other)
    assert not os.path.exists(base + ".ecj")
    assert _read(base + ".ecx") == _read(other + ".ecx")


def test_decode_to_volume_with_deletes_matches_jax(jax_volume, tmp_path):
    base, payloads = jax_volume
    original = _read(base + ".dat")
    _port_encode(base)
    assert encoder.find_dat_file_size(base) == \
        jax_ec.find_dat_file_size(base) <= len(original)
    other = _copy_volume(base, str(tmp_path / "ref"))
    for ext in (".ecx",) + tuple(f".ec{i:02d}" for i in range(14)):
        shutil.copy(base + ext, other + ext)
    for b, mod in ((base, encoder), (other, jax_ec)):
        e = (EcVolume if mod is encoder else jax_ec.EcVolume)(
            os.path.dirname(b), "", 1, large_block=LARGE, small_block=SMALL)
        e.delete_needle(7)
        e.close()
        dat_size = mod.find_dat_file_size(b)
        os.remove(b + ".dat")
        os.remove(b + ".idx")
        mod.write_dat_file(b, dat_size, large_block=LARGE,
                           small_block=SMALL, chunk=512)
        mod.write_idx_file_from_ec_index(b)
    assert _read(base + ".dat") == _read(other + ".dat")
    assert _read(base + ".idx") == _read(other + ".idx")
    assert original.startswith(_read(base + ".dat"))
    v = Volume(os.path.dirname(base), "", 1, create_if_missing=False)
    for key, data in payloads.items():
        if key == 7:
            with pytest.raises(NeedleError):
                v.read_needle(Needle(id=key, cookie=0xC0 + key))
        else:
            assert v.read_needle(Needle(id=key, cookie=0xC0 + key)).data \
                == data
    v.close()


# --- store level: the volume server's EC surface ----------------------------

STORE_SMALL = 1 << 12


@pytest.fixture
def store(tmp_path):
    s = Store([str(tmp_path / "d1"), str(tmp_path / "d2")])
    yield s
    s.close()


def _fill_store(store, vid, count=12, size=700, collection=""):
    store.add_volume(vid, collection=collection)
    needles = []
    for i in range(count):
        rng = np.random.default_rng(i)
        n = Needle(id=i + 1, cookie=0x2000 + i,
                   data=rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        store.write_needle(vid, n)
        needles.append(n)
    return needles


def _generate_and_mount(store, vid, collection=""):
    """generate_ec_shards with the store geometry, drop the volume,
    mount all 14 shards."""
    v = store.find_volume(vid)
    v.read_only = True
    v.sync()
    base = v.file_name()
    encoder.write_ec_files(base, backend="cpu", small_block=STORE_SMALL,
                           large_block=STORE_SMALL << 8)
    encoder.write_sorted_file_from_idx(base)
    store.location_of(vid).delete_volume(vid)
    ecv = store_ec.mount_ec_shards(store, vid, collection, range(14))
    ecv.small_block, ecv.large_block = STORE_SMALL, STORE_SMALL << 8
    return base, ecv


def test_generate_ec_shards_matches_jax_store(store, tmp_path):
    _fill_store(store, 1)
    base = store_ec.generate_ec_shards(store, 1, backend="cpu")
    assert store.find_volume(1).read_only
    jstore = JaxStore([str(tmp_path / "j")], ip="127.0.0.1", port=8080)
    try:
        jdir = jstore.locations[0].directory
        for ext in (".dat", ".idx"):
            shutil.copy(base + ext, os.path.join(jdir, "1" + ext))
        jstore.locations[0].load_existing_volumes()
        jbase = jax_store_ec.generate_ec_shards(jstore, 1, backend="jax")
        assert _ec_files(base) == _ec_files(jbase)
        assert _read(base + ".ecx") == _read(jbase + ".ecx")
    finally:
        jstore.close()


def test_store_degraded_read_ec_needle(store, rs):
    needles = _fill_store(store, 2)
    base, ecv = _generate_and_mount(store, 2)
    assert store.find_volume(2) is None
    assert store.find_ec_volume(2) is ecv
    for sid in (0, 3, 7, 12):
        ecv.unmount_shard(sid)
        os.remove(encoder.shard_file_name(base, sid))
    assert ecv.shard_bits.count == 10
    for n in needles:
        got = store_ec.read_ec_needle(store, 2, Needle(id=n.id,
                                                       cookie=n.cookie), rs=rs)
        assert got.data == n.data
    ecv.unmount_shard(1)
    with pytest.raises(EcShardNotFound):
        for n in needles:
            store_ec.read_ec_needle(store, 2, Needle(id=n.id), rs=rs)


def test_store_rebuild_restores_shard_files(store):
    _fill_store(store, 3)
    base, ecv = _generate_and_mount(store, 3)
    want = {sid: hashlib.sha256(_read(encoder.shard_file_name(base, sid)))
            .hexdigest() for sid in range(14)}
    for sid in (1, 5, 10, 13):
        ecv.unmount_shard(sid)
        os.remove(encoder.shard_file_name(base, sid))
    assert sorted(store_ec.rebuild_ec_shards(store, 3, backend="cpu")) == \
        [1, 5, 10, 13]
    for sid in range(14):
        assert hashlib.sha256(_read(encoder.shard_file_name(base, sid))) \
            .hexdigest() == want[sid]


def test_store_delete_needle_then_read_fails(store, rs):
    needles = _fill_store(store, 4)
    _generate_and_mount(store, 4)
    store_ec.delete_ec_needle(store, 4, Needle(id=needles[0].id))
    with pytest.raises(NeedleError):
        store_ec.read_ec_needle(
            store, 4, Needle(id=needles[0].id, cookie=needles[0].cookie),
            rs=rs)
    got = store_ec.read_ec_needle(
        store, 4, Needle(id=needles[1].id, cookie=needles[1].cookie), rs=rs)
    assert got.data == needles[1].data


def test_store_decode_back_to_volume(store):
    needles = _fill_store(store, 5, collection="photos")
    base, ecv = _generate_and_mount(store, 5, collection="photos")
    with open(base + ".ec00", "rb") as f:
        assert f.read(1) == b"\x03"
    store_ec.delete_ec_needle(store, 5, Needle(id=needles[3].id))
    with pytest.raises(EcShardNotFound):  # refuses while mounted
        store_ec.ec_shards_to_volume(store, 5, backend="cpu",
                                     small_block=STORE_SMALL,
                                     large_block=STORE_SMALL << 8)
    store_ec.unmount_ec_shards(store, 5, range(14))
    assert store.find_ec_volume(5) is None
    for sid in (0, 9, 12):  # lost data shards are rebuilt on the way
        os.remove(encoder.shard_file_name(base, sid))
    v = store_ec.ec_shards_to_volume(store, 5, backend="cpu",
                                     small_block=STORE_SMALL,
                                     large_block=STORE_SMALL << 8)
    assert store.find_volume(5) is v and v.collection == "photos"
    assert not os.path.exists(encoder.shard_file_name(base, 12))
    for n in needles:
        if n.id == needles[3].id:
            with pytest.raises(NeedleError):
                v.read_needle(Needle(id=n.id, cookie=n.cookie))
        else:
            assert v.read_needle(Needle(id=n.id, cookie=n.cookie)).data \
                == n.data


def test_store_reopen_discovers_ec_shards(tmp_path):
    s = Store([str(tmp_path / "d")])
    needles = _fill_store(s, 6)
    _generate_and_mount(s, 6)
    s.close()
    s2 = Store([str(tmp_path / "d")])
    try:
        ecv = s2.find_ec_volume(6)
        assert ecv is not None and ecv.shard_bits.shard_ids == list(range(14))
        ecv.small_block, ecv.large_block = STORE_SMALL, STORE_SMALL << 8
        assert store_ec.read_ec_needle(
            s2, 6, Needle(id=needles[2].id, cookie=needles[2].cookie),
            rs=ReedSolomon(backend="cpu")).data == needles[2].data
    finally:
        s2.close()


def test_store_ec_defaults_to_the_card(store):
    """generate with no backend targets CUDA: here, with no card, it
    raises rather than encoding on the host."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _fill_store(store, 7)
    with pytest.raises(RuntimeError):
        store_ec.generate_ec_shards(store, 7)


# --- geometry helpers, mirrored from test_ec.py -----------------------------

def test_locate_data_small_only():
    ivs = locate_data(LARGE, SMALL, 1000, 0, 1000)
    assert all(not iv.is_large_block for iv in ivs)
    assert sum(iv.size for iv in ivs) == 1000
    assert ivs[0].block_index == 0 and ivs[0].inner_offset == 0
    assert len(ivs) == 4


def test_locate_data_large_to_small_rollover():
    dat_size = LARGE * 10 + 700
    ivs = locate_data(LARGE, SMALL, dat_size, LARGE * 10 - 100, 300)
    assert ivs[0].is_large_block and ivs[0].size == 100
    assert not ivs[1].is_large_block
    assert ivs[1].block_index == 0 and ivs[1].inner_offset == 0
    assert sum(iv.size for iv in ivs) == 300


def test_interval_shard_mapping():
    iv = Interval(block_index=23, inner_offset=5, size=10,
                  is_large_block=False, large_block_rows=2)
    assert iv.to_shard_and_offset(LARGE, SMALL) == \
        (3, 2 * LARGE + 2 * SMALL + 5)


def test_shard_bits():
    b = ShardBits.of(0, 3, 13)
    assert b.count == 3
    assert b.shard_ids == [0, 3, 13]
    assert b.has(3) and not b.has(4)
    assert b.remove(3).shard_ids == [0, 13]
    assert b.plus(ShardBits.of(4)).count == 4
    assert b.minus(ShardBits.of(0)).shard_ids == [3, 13]
    assert ShardBits.of(*range(14)).minus_parity().shard_ids == list(range(10))
