"""GF(2^8) arithmetic on the host (numpy).

Field: GF(2^8) with primitive polynomial x^8+x^4+x^3+x^2+1 (0x11D) and
generator 2 — the field of the reference's RS library
(klauspost/reedsolomon), so coding matrices built here are interoperable
with the reference's shard layout.

Host-side ground truth: table construction, matrix algebra (inverse over
GF(2^8)), the table-gather encoder ``gf_linear_numpy``, and
``gf256_matrix_to_gf2``, which expands a GF(2^8) coding matrix C[out, in]
into a GF(2) bit-matrix M[out*8, in*8] such that for bytes x:
bits(C @gf x) = M @ bits(x) mod 2 (the plain version of the GPU kernel
in ops/gf_kernel.py uses it).
"""

from __future__ import annotations

import numpy as np

PRIM_POLY = 0x11D

# --- log/exp tables ---------------------------------------------------------


def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    exp[255:510] = exp[:255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def _build_mul_table():
    # full 256x256 product table; 64KB, used by the numpy encoder
    a = np.arange(256)
    la = GF_LOG[a][:, None]
    lb = GF_LOG[a][None, :]
    t = GF_EXP[(la + lb) % 255].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


GF_MUL_TABLE = _build_mul_table()


# --- scalar ops -------------------------------------------------------------


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) + int(GF_LOG[b])) % 255])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) - int(GF_LOG[b])) % 255])


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


def gf_inv(a: int) -> int:
    return gf_div(1, a)


# --- matrix algebra over GF(2^8) -------------------------------------------


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8); a: [m,k] uint8, b: [k,n] uint8."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    # products[i,j,l] = a[i,l]*b[l,j]; xor-reduce over l
    prods = GF_MUL_TABLE[a[:, None, :], b.T[None, :, :]]  # [m,n,k]
    return np.bitwise_xor.reduce(prods, axis=2)


def mat_identity(n: int) -> np.ndarray:
    return np.eye(n, dtype=np.uint8)


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2^8). Raises ValueError if singular."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError("matrix must be square")
    work = np.concatenate([m.copy(), mat_identity(n)], axis=1).astype(np.uint8)
    for col in range(n):
        # find pivot
        pivot = -1
        for r in range(col, n):
            if work[r, col] != 0:
                pivot = r
                break
        if pivot < 0:
            raise ValueError("singular matrix over GF(2^8)")
        if pivot != col:
            work[[col, pivot]] = work[[pivot, col]]
        # scale pivot row to 1
        inv_p = gf_inv(int(work[col, col]))
        work[col] = GF_MUL_TABLE[inv_p, work[col]]
        # eliminate other rows
        for r in range(n):
            if r != col and work[r, col] != 0:
                factor = int(work[r, col])
                work[r] ^= GF_MUL_TABLE[factor, work[col]]
    return work[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """v[r, c] = r**c over GF(2^8) — any `cols` rows are linearly independent."""
    v = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            v[r, c] = gf_pow(r, c)
    return v


def rs_coding_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """Systematic RS matrix [total, data]: identity on top, parity rows below.

    Built the same way as the reference's RS library (Vandermonde matrix
    normalized by the inverse of its top square), so parity bytes match the
    reference's .ec shard contents byte-for-byte.
    """
    vm = vandermonde(total_shards, data_shards)
    top_inv = mat_inv(vm[:data_shards])
    return mat_mul(vm, top_inv)


# --- vectorized numpy codec (CPU reference/baseline) ------------------------


def gf_linear_numpy(matrix: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """Apply a GF(2^8) linear map to shard data.

    matrix: [out, k] uint8; shards: [..., k, n] uint8 -> [..., out, n] uint8.
    The host ground truth for the GPU kernel.
    """
    matrix = np.asarray(matrix, dtype=np.uint8)
    shards = np.asarray(shards, dtype=np.uint8)
    out_n, k = matrix.shape
    if shards.shape[-2] != k:
        raise ValueError(f"shard count {shards.shape[-2]} != matrix cols {k}")
    out_shape = shards.shape[:-2] + (out_n, shards.shape[-1])
    out = np.zeros(out_shape, dtype=np.uint8)
    for o in range(out_n):
        acc = None
        for i in range(k):
            c = int(matrix[o, i])
            if c == 0:
                continue
            term = GF_MUL_TABLE[c][shards[..., i, :]]
            acc = term if acc is None else acc ^ term
        if acc is not None:
            out[..., o, :] = acc
    return out


# --- GF(2) bit-matrix expansion --------------------------------------------


def byte_to_bits_matrix(c: int) -> np.ndarray:
    """8x8 GF(2) matrix of multiplication-by-c: bits(c*x) = B @ bits(x) mod 2.

    Column j is bits(c * 2^j); bit order is little-endian (bit 0 = LSB).
    """
    b = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        p = gf_mul(c, 1 << j)
        for k in range(8):
            b[k, j] = (p >> k) & 1
    return b


def gf256_matrix_to_gf2(matrix: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix [out, k] to its GF(2) bit-matrix [out*8, k*8].

    With data bytes unpacked to bits (little-endian along a new axis), the
    GF(2^8) matrix-vector product becomes an ordinary 0/1 integer matmul
    followed by mod 2. Row o*8+k, column i*8+j (shard-major).
    """
    matrix = np.asarray(matrix, dtype=np.uint8)
    out_n, k = matrix.shape
    m2 = np.zeros((out_n * 8, k * 8), dtype=np.uint8)
    for o in range(out_n):
        for i in range(k):
            m2[o * 8:(o + 1) * 8, i * 8:(i + 1) * 8] = byte_to_bits_matrix(int(matrix[o, i]))
    return m2
