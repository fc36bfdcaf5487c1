"""The port's GF(2^8) kernel module held against the JAX package.

``seaweedfs_tpu_torch.ops.gf_kernel.gf_linear_plain`` (what a CPU tensor
runs, and what the CUDA kernel is compared with on the card) must equal,
byte for byte, the TPU kernel K1 (``rs_pallas.apply_matrix``, interpret
mode off-TPU), the XLA map X1 (``rs_kernel.apply_matrix``) and the numpy
ground truth. The CUDA kernel's table layout is held the same way through
a numpy model of its lookups. GF arithmetic has no rounding: the tolerance
is exact bytes.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as jax_gf256
from seaweedfs_tpu.ops import rs_kernel, rs_pallas
from seaweedfs_tpu.ops import rs_code as jax_rs_code
from seaweedfs_tpu.native import rs_native

import seaweedfs_tpu_torch
from seaweedfs_tpu_torch.native import crc
from seaweedfs_tpu_torch.ops import gf256, gf_kernel

LANES = (0, 1, 127, 128, 32768 + 257)
SHAPES = ((4, 10), (1, 10), (3, 7), (14, 14))
KERNEL_LANES = (0, 1, 15, 16, 17, 127, 128, 32768 + 257)
LOSS_SETS = ((0,), (13,), (2, 5, 9, 12), (10, 11, 12, 13))


def _kernel_matrices():
    """The maps the main path gives the kernel: the encode matrix, the
    decode maps of LOSS_SETS, a degraded read's one-row map
    (shard 5 from the first ten others with {0, 5, 11, 13} lost), and one
    map with O > 4 (every shard from the data shards, O = 14)."""
    jrs = jax_rs_code.ReedSolomon(backend="jax")
    coding = jax_rs_code.coding_matrix()
    mats = {"encode": coding[10:], "all_shards": coding}
    for lost in LOSS_SETS:
        present = [i for i in range(14) if i not in lost]
        mats[f"decode{lost}"] = jrs.decode_matrix(present, list(lost))
    mats["read"] = jrs.decode_matrix([1, 2, 3, 4, 6, 7, 8, 9, 10, 12], [5])
    return mats


KERNEL_MATRICES = _kernel_matrices()


def _rand(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _plain(matrix, data):
    gm = gf_kernel.prepare_matrix(matrix, "cpu")
    return gf_kernel.gf_linear_plain(gm.m2, torch.from_numpy(data)).numpy()


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_numpy_and_xla(shape, lanes):
    rng = np.random.default_rng(100 + lanes + 7 * shape[0])
    m = _rand(rng, shape)
    data = _rand(rng, (shape[1], lanes))
    want = jax_gf256.gf_linear_numpy(m, data)
    np.testing.assert_array_equal(_plain(m, data), want)
    if lanes:
        np.testing.assert_array_equal(rs_kernel.apply_matrix(m, data), want)


@pytest.mark.parametrize("lanes", LANES)
def test_plain_matches_pallas_kernel(lanes):
    """K1 is plane-major, X1 shard-major: the plain version (shard-major
    bit-matrix) equals both."""
    rng = np.random.default_rng(200 + lanes)
    m = _rand(rng, (4, 10))
    data = _rand(rng, (10, lanes))
    np.testing.assert_array_equal(_plain(m, data),
                                  rs_pallas.apply_matrix(m, data))


def test_gf_linear_batched_cpu_equals_rows():
    rng = np.random.default_rng(3)
    m = _rand(rng, (4, 10))
    data = _rand(rng, (3, 2, 10, 200))
    out = gf_kernel.gf_linear(m, torch.from_numpy(data)).numpy()
    assert out.shape == (3, 2, 4, 200)
    np.testing.assert_array_equal(out, jax_gf256.gf_linear_numpy(m, data))


def test_plain_slabs_lanes_exactly():
    rng = np.random.default_rng(4)
    m = _rand(rng, (2, 10))
    data = _rand(rng, (3, 10, 1000))
    gm = gf_kernel.prepare_matrix(m, "cpu")
    out = gf_kernel.gf_linear_plain(gm.m2, torch.from_numpy(data),
                                    max_lanes=700)
    np.testing.assert_array_equal(out.numpy(),
                                  jax_gf256.gf_linear_numpy(m, data))


def test_cpu_tensor_runs_plain_version_without_launch():
    rng = np.random.default_rng(5)
    m = _rand(rng, (4, 10))
    data = torch.from_numpy(_rand(rng, (10, 64)))
    before = gf_kernel.LAUNCHES
    gf_kernel.gf_linear(m, data)
    assert gf_kernel.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "rows", "noncontig", "matrix"])
def test_wrapper_rejects_bad_inputs(bad):
    m = np.ones((4, 10), dtype=np.uint8)
    data = torch.zeros((10, 32), dtype=torch.uint8)
    if bad == "dtype":
        data = data.to(torch.int16)
    elif bad == "rows":
        data = torch.zeros((9, 32), dtype=torch.uint8)
    elif bad == "noncontig":
        data = torch.zeros((32, 10), dtype=torch.uint8).t()
    else:
        m = np.ones((15, 10), dtype=np.uint8)
    with pytest.raises(ValueError):
        gf_kernel.gf_linear(m, data)


def test_prepare_matrix_takes_jax_package_matrices():
    """Carrying state across: the JAX package's own encode and decode
    matrices, fed through prepare_matrix, give the same tables, bit-matrix
    and results as the JAX codec."""
    jrs = jax_rs_code.ReedSolomon(backend="jax")
    rng = np.random.default_rng(6)
    data = _rand(rng, (10, 300))
    full = jrs.encode_all(data)
    present = [0, 2, 3, 4, 6, 7, 8, 9, 10, 12]
    cases = [
        (jax_rs_code.coding_matrix()[10:], data, full[10:]),
        (jrs.decode_matrix(present, [1, 5, 11, 13]), full[present],
         full[[1, 5, 11, 13]]),
        (jrs.decode_matrix(list(range(1, 11)), [0]), full[1:11], full[:1]),
    ]
    for m, src, want in cases:
        gm = gf_kernel.prepare_matrix(m, "cpu")
        np.testing.assert_array_equal(gm.matrix, m)
        _check_tables(gm, jax_gf256.GF_MUL_TABLE)
        np.testing.assert_array_equal(gm.m2.numpy().astype(np.uint8),
                                      jax_gf256.gf256_matrix_to_gf2(m))
        np.testing.assert_array_equal(
            gf_kernel.gf_linear(gm, torch.from_numpy(src)).numpy(), want)


def test_prepare_matrix_cache_keyed_by_bytes():
    a = np.arange(40, dtype=np.uint8).reshape(4, 10)
    b = a.copy()
    b[3, 9] ^= 1
    ga, gb = (gf_kernel.prepare_matrix(x, "cpu") for x in (a, b))
    assert ga is gf_kernel.prepare_matrix(a.copy(), "cpu")
    assert ga is not gb
    assert not torch.equal(ga.tables, gb.tables)


def test_gf256_copy_matches_jax_package():
    np.testing.assert_array_equal(gf256.GF_MUL_TABLE, jax_gf256.GF_MUL_TABLE)
    np.testing.assert_array_equal(gf256.rs_coding_matrix(10, 14),
                                  jax_gf256.rs_coding_matrix(10, 14))
    rng = np.random.default_rng(8)
    m = _rand(rng, (5, 5))
    np.testing.assert_array_equal(gf256.gf256_matrix_to_gf2(m),
                                  jax_gf256.gf256_matrix_to_gf2(m))
    sub = gf256.rs_coding_matrix(10, 14)[[0, 1, 2, 3, 4, 5, 10, 11, 12, 13]]
    np.testing.assert_array_equal(gf256.mat_inv(sub),
                                  jax_gf256.mat_inv(sub))


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 1000, 4099])
def test_crc_library_matches_plain_and_jax_package(size):
    data = _rand(np.random.default_rng(size), size).tobytes()
    want = crc.crc32c_plain(data)
    assert crc.crc32c(data) == want
    assert rs_native.crc32c(data) == want
    assert crc.crc32c(data, 0x1234) == crc.crc32c_plain(data, 0x1234)


def test_crc_known_vector():
    # RFC 3720 B.4: CRC32C of 32 zero bytes
    assert crc.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert crc.crc32c_plain(b"\x00" * 32) == 0x8A9136AA


def test_port_imports_neither_jax_nor_jax_package():
    """Every module of the port, and chip_smoke.py (its imports sit inside
    functions, which ast.walk reaches too): no JAX, no JAX package, and no
    grpcio or protobuf, which the card's machine does not have."""
    root = pathlib.Path(seaweedfs_tpu_torch.__file__).parent
    smoke = root.parent / "chip_smoke.py"
    files = sorted(root.rglob("*.py")) + [smoke]
    assert len(files) > 15 and smoke.is_file()
    assert {"cache/read_cache.py", "resilience/hedge.py", "util/fanout.py",
            "storage/fix.py", "storage/needle_map.py",
            "filer/stores/kv_store.py", "util/async_server.py",
            "images/resizing.py", "images/orientation.py"} <= \
        {str(p.relative_to(root)) for p in files[:-1]}
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "seaweedfs_tpu", "grpc",
                                   "google"), \
                    f"{path.relative_to(root.parent)} imports {name}"


def _check_tables(gm, mul_table):
    """Byte o of word [g, s, h, v] is m[4g + o, s] * (v << 4h), 0 past O."""
    m = gm.matrix
    words = gm.tables.numpy().view(np.uint32)
    groups = -(-m.shape[0] // 4)
    assert words.shape == (groups, m.shape[1], 2, 16)
    v = np.arange(16)
    for g in range(groups):
        for o in range(4):
            got = (words[g] >> np.uint32(8 * o)) & 0xFF     # [S, 2, 16]
            if 4 * g + o >= m.shape[0]:
                assert not got.any()
                continue
            c = m[4 * g + o][:, None, None]
            np.testing.assert_array_equal(
                got, mul_table[c, np.stack([v, v << 4])[None]])


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte n of the result is byte
    (sel >> 4n) & 7 of the pair (x, y)."""
    src = [(a >> np.uint32(8 * i)) & np.uint32(0xFF)
           for a in (x, y) for i in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(sel >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def _one_wavefront(words):
    """True when every warp (32 consecutive units) reads at most one
    distinct word from each of the 32 banks: a single wavefront."""
    pad = -len(words) % 32
    w = np.sort(np.concatenate([words, np.repeat(words[-1:], pad)])
                .reshape(-1, 32), axis=1)
    new = np.ones(w.shape, dtype=bool)
    new[:, 1:] = w[:, 1:] != w[:, :-1]
    key = np.nonzero(new)[0] * 32 + w[new] % 32   # (warp, bank) per word
    return len(np.unique(key)) == len(key)


def _kernel_model(gm, data):
    """numpy model of csrc/gf_linear.cu on ``[B, S, N]`` uint8 data. It
    reads ``gm.tables`` as the kernel does: the ``[G][S][2][16]`` words as
    they lie in shared memory, two lookups per input byte at byte address
    ``((g*S + s)*2 + h)*64`` plus the nibble pre-scaled by 4, XOR into one
    packed word per lane, and the 4x4 byte transpose of ``transpose4``
    back to output rows. It also holds every warp's lookup to one
    shared-memory wavefront."""
    smem = gm.tables.numpy().view(np.uint32).reshape(-1)
    o_rows, s_rows = gm.rows, gm.cols
    b, _, n = data.shape
    nvec = -(-n // 16)
    out = np.zeros((b, o_rows, n), dtype=np.uint8)
    if n == 0:
        return out
    padded = np.zeros((b, s_rows, nvec * 16), dtype=np.uint8)
    padded[..., :n] = data
    x = padded.view("<u4").reshape(b, s_rows, nvec, 4)
    mask = np.uint32(0x3C3C3C3C)

    def lookup(table_byte, v4):
        word = (table_byte + v4) // 4
        assert _one_wavefront(word.reshape(-1))
        return smem[word]

    for g in range(-(-o_rows // 4)):
        acc = np.zeros((b, nvec, 16), dtype=np.uint32)
        for s in range(s_rows):
            lo_tab = (g * s_rows + s) * 2 * 64
            for q in range(4):
                lo4 = (x[:, s, :, q] << np.uint32(2)) & mask
                hi4 = (x[:, s, :, q] >> np.uint32(2)) & mask
                for j in range(4):
                    shift = np.uint32(8 * j)
                    acc[:, :, q * 4 + j] ^= (
                        lookup(lo_tab, (lo4 >> shift) & np.uint32(0xFF))
                        ^ lookup(lo_tab + 64, (hi4 >> shift) & np.uint32(0xFF)))
        rows = np.empty((4, b, nvec, 4), dtype=np.uint32)  # [o, b, unit, j]
        for j in range(4):
            a = [acc[:, :, j * 4 + k] for k in range(4)]
            t0 = _byte_perm(a[0], a[1], 0x5140)
            t1 = _byte_perm(a[0], a[1], 0x7362)
            t2 = _byte_perm(a[2], a[3], 0x5140)
            t3 = _byte_perm(a[2], a[3], 0x7362)
            rows[0, ..., j] = _byte_perm(t0, t2, 0x5410)
            rows[1, ..., j] = _byte_perm(t0, t2, 0x7632)
            rows[2, ..., j] = _byte_perm(t1, t3, 0x5410)
            rows[3, ..., j] = _byte_perm(t1, t3, 0x7632)
        for o in range(min(4, o_rows - 4 * g)):
            row = np.ascontiguousarray(rows[o]).view(np.uint8)
            out[:, 4 * g + o] = row.reshape(b, nvec * 16)[:, :n]
    return out


@pytest.mark.parametrize("lanes", KERNEL_LANES)
@pytest.mark.parametrize("name", sorted(KERNEL_MATRICES))
def test_kernel_table_layout_matches_pallas_and_numpy(name, lanes):
    m = KERNEL_MATRICES[name]
    rng = np.random.default_rng(300 + lanes)
    data = _rand(rng, (2, m.shape[1], lanes))
    gm = gf_kernel.prepare_matrix(m, "cpu")
    _check_tables(gm, jax_gf256.GF_MUL_TABLE)
    got = _kernel_model(gm, data)
    np.testing.assert_array_equal(got, jax_gf256.gf_linear_numpy(m, data))
    np.testing.assert_array_equal(
        got, np.stack([rs_pallas.apply_matrix(m, row) for row in data]))


@pytest.mark.parametrize("rows,nvec,grid", [
    (1, 67, 1), (6, 65536, 396), (3, 5, 2), (7, 300, 11), (2, 1, 3),
    (5, 256, 7), (4, 255, 9)])
def test_kernel_work_split_visits_each_unit_once(rows, nvec, grid):
    """The kernel's even split of B * ceil(N/16) units over the grid and
    its (row, unit) stepping, replayed in Python: every unit once, at the
    row and column a division would give."""
    threads = 256
    total = rows * nvec
    seen = np.zeros(total, dtype=np.int64)
    sizes = []
    for block in range(grid):
        first = total * block // grid
        last = total * (block + 1) // grid
        sizes.append(last - first)
        for t in range(threads):
            u = first + t
            b, c = divmod(u, nvec)
            while u < last:
                assert (b, c) == divmod(u, nvec)
                seen[u] += 1
                c += threads
                if c >= nvec:
                    if nvec >= threads:
                        c -= nvec
                        b += 1
                    else:
                        b += c // nvec
                        c %= nvec
                u += threads
    assert (seen == 1).all()
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", LANES + (1 << 20,))
def test_cuda_kernel_matches_plain(lanes):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(9 + lanes)
    mats = [_rand(rng, shape) for shape in SHAPES]
    for m in mats + list(KERNEL_MATRICES.values()):
        data = torch.from_numpy(_rand(rng, (2, m.shape[1], lanes))).cuda()
        gm = gf_kernel.prepare_matrix(m, data.device)
        before = gf_kernel.LAUNCHES
        got = gf_kernel.gf_linear(gm, data)
        torch.cuda.synchronize()
        assert gf_kernel.LAUNCHES == before + (1 if lanes else 0)
        assert torch.equal(got, gf_kernel.gf_linear_plain(gm.m2, data))


def test_port_passes_the_analysis_gate():
    """The JAX package's house-rules analyzer (lock discipline, threads
    before first use, swallowed errors, dead code) finds nothing in the
    port package."""
    from seaweedfs_tpu.analysis import engine
    root = pathlib.Path(seaweedfs_tpu_torch.__file__).parent
    findings = engine.run_checks(root=root)
    assert not findings, "\n".join(str(f) for f in findings)
