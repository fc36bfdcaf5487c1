"""The reference against known vectors and against the program's own
formats (the tests may import the program; the reference may not)."""

import numpy as np
import pytest
import torch

from ecbench import data
from ecbench.reference import crc32c, gf256, layout, needle


def test_gf_known_products():
    assert gf256.mul(2, 0x80) == 0x1D          # x^8 = x^4 + x^3 + x^2 + 1
    assert gf256.mul(0x53, gf256.inv(0x53)) == 1
    assert all(gf256.mul(a, gf256.inv(a)) == 1 for a in range(1, 256))
    assert gf256.power(2, 255) == 1


def test_coding_matrix_is_systematic_and_mds():
    m = gf256.CODING
    assert (m[:10] == np.eye(10, dtype=np.uint8)).all()
    rng = np.random.default_rng(0)
    for _ in range(20):
        rows = sorted(rng.choice(14, 10, replace=False))
        gf256.invert(m[rows])                 # any ten rows decode


def test_parity_and_decode_match_the_program():
    from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon
    d = np.random.default_rng(1).integers(0, 256, (10, 3000), dtype=np.uint8)
    parity = gf256.encode_parity(torch.from_numpy(d)).numpy()
    assert np.array_equal(ReedSolomon(backend="cpu").encode(d)[-4:], parity)
    full = np.concatenate([d, parity])
    present = [1, 2, 3, 4, 6, 7, 8, 9, 10, 11]
    got = gf256.apply(gf256.decode_matrix(present, [0, 5, 12, 13]),
                      torch.from_numpy(full[present])).numpy()
    assert np.array_equal(got, full[[0, 5, 12, 13]])


def test_crc32c_known_vector_and_batch():
    assert crc32c.crc32c_bytes(b"123456789") == 0xE3069283
    buf = np.random.default_rng(2).integers(0, 256, 9000, dtype=np.uint8)
    offs, lens = [0, 7, 100, 5000], [0, 1, 4096, 4000]
    got = crc32c.crc32c_many(buf, offs, lens)
    assert [int(x) for x in got] == [
        crc32c.crc32c_bytes(buf[o:o + n].tobytes())
        for o, n in zip(offs, lens)]
    with pytest.raises(ValueError):
        crc32c.crc32c_many(buf, [8999], [2])


def test_needle_records_match_the_program():
    from seaweedfs_tpu_torch.storage.needle import Needle
    vols = data.bench1k(3, dict(n=20, size=1024, volumes=7))
    v = vols[2]
    dat = v.dat()
    assert bytes(dat[:8]) == needle.SUPERBLOCK
    for i in range(len(v.ids)):
        off = int(v.offsets[i])
        n = Needle(id=int(v.ids[i]), cookie=int(v.cookies[i]),
                   data=v.data(i).tobytes(), append_at_ns=v.append_ns)
        rec = n.to_bytes()
        assert bytes(dat[off:off + len(rec)]) == rec
        assert len(rec) == needle.record_size(1024)


def test_warm_fleet_fills_every_volume_exactly():
    cfg = dict(volumes=3, volume_bytes=4 << 20, chunk_bytes=1 << 20,
               file_bytes_min=64 << 10, file_bytes_max=8 << 20,
               min_needle_bytes=1024)
    for seed in (1, 2 ** 31 + 5):
        vols = data.warm_fleet(seed, cfg)
        assert [v.dat_size for v in vols] == [4 << 20] * 3
        assert max(int(v.lengths.max()) for v in vols) <= 1 << 20


def test_layout_matches_the_program():
    from seaweedfs_tpu_torch.ec.locate import locate_data
    large, small = 1 << 12, 1 << 8
    for dat_size in (100, 10 * large + 5, 25 * large + 3 * small + 7):
        for off, size in ((0, 10), (large - 3, 700), (dat_size - 9, 9)):
            want = [iv.to_shard_and_offset(large, small) + (iv.size,)
                    for iv in locate_data(large, small, dat_size, off, size)]
            got = layout.locate(dat_size, off, size, large, small)
            assert got == [(s, o, n) for (s, o), n in
                           [((a, b), c) for a, b, c in want]]


def test_data_shards_match_the_program_encoder(tmp_path):
    from seaweedfs_tpu_torch.ec.encoder import write_ec_files
    vols = data.bench1k(4, dict(n=30000, size=1024, volumes=2))
    base = vols[0].write(str(tmp_path))
    write_ec_files(base, backend="cpu")
    want = layout.data_shards(vols[0].dat())
    for s in range(10):
        got = np.fromfile(f"{base}.ec{s:02d}", dtype=np.uint8)
        assert np.array_equal(got, want[s])
