"""GF(2^8) arithmetic and the RS(10,4) code, written plainly.

The field is GF(2)[x] / (x^8 + x^4 + x^3 + x^2 + 1) (0x11D) with
generator 2, as upstream SeaweedFS's codec (klauspost/reedsolomon) uses.
The coding matrix is that library's default: the 14 x 10 Vandermonde
matrix ``vm[r][c] = r^c`` times the inverse of its top 10 x 10 block, so
the first ten rows are the identity and the last four make the parity.

Nothing here imports the program under test: this module is the
benchmark's own yardstick. ``apply`` runs on any torch device with plain
table lookups (one ``take`` per coefficient), so the same code checks a
CPU test and a run on the card.
"""

from __future__ import annotations

import numpy as np
import torch

POLY = 0x11D
DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS


def _tables():
    exp = np.zeros(512, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[0:255]
    return exp, log


EXP, LOG = _tables()


def mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(EXP[255 - LOG[a]])


def power(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP[(LOG[a] * n) % 255])


MUL_TABLE = np.array([[mul(a, b) for b in range(256)] for a in range(256)],
                     dtype=np.uint8)


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = 0
            for k in range(a.shape[1]):
                acc ^= mul(int(a[i, k]), int(b[k, j]))
            out[i, j] = acc
    return out


def invert(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a square matrix over GF(2^8)."""
    n = m.shape[0]
    work = [[int(v) for v in row] + [int(i == j) for j in range(n)]
            for i, row in enumerate(m)]
    for col in range(n):
        pivot = next((r for r in range(col, n) if work[r][col]), None)
        if pivot is None:
            raise ValueError("singular matrix")
        work[col], work[pivot] = work[pivot], work[col]
        scale = inv(work[col][col])
        work[col] = [mul(v, scale) for v in work[col]]
        for r in range(n):
            if r != col and work[r][col]:
                f = work[r][col]
                work[r] = [v ^ mul(f, p) for v, p in zip(work[r], work[col])]
    return np.array([row[n:] for row in work], dtype=np.uint8)


def coding_matrix() -> np.ndarray:
    """[14, 10]: identity on top, parity rows below."""
    vm = np.array([[power(r, c) for c in range(DATA_SHARDS)]
                   for r in range(TOTAL_SHARDS)], dtype=np.uint8)
    return matmul(vm, invert(vm[:DATA_SHARDS]))


CODING = coding_matrix()
PARITY = CODING[DATA_SHARDS:]


def decode_matrix(present, wanted) -> np.ndarray:
    """[len(wanted), 10]: rows that rebuild shards ``wanted`` from the
    first ten shards listed in ``present``."""
    rows = list(present)[:DATA_SHARDS]
    if len(rows) < DATA_SHARDS:
        raise ValueError(f"need {DATA_SHARDS} shards, have {len(rows)}")
    dec = invert(CODING[rows])
    return matmul(CODING[list(wanted)], dec)


def apply(matrix: np.ndarray, data: torch.Tensor,
          slab: int = 1 << 24) -> torch.Tensor:
    """``out[o, n] = XOR_s matrix[o, s] * data[s, n]`` for a [S, N] uint8
    tensor, on the tensor's device, in slabs of ``slab`` lanes."""
    s_count, n = data.shape
    if matrix.shape[1] != s_count:
        raise ValueError(f"matrix {matrix.shape} against data {data.shape}")
    table = torch.from_numpy(MUL_TABLE).to(data.device)
    out = torch.zeros((matrix.shape[0], n), dtype=torch.uint8,
                      device=data.device)
    for p in range(0, n, slab):
        idx = data[:, p:p + slab].long()
        for o in range(matrix.shape[0]):
            acc = out[o, p:p + slab]
            for s in range(s_count):
                c = int(matrix[o, s])
                if c:
                    acc ^= torch.take(table[c], idx[s])
    return out


def encode_parity(data: torch.Tensor) -> torch.Tensor:
    """[4, N] parity of [10, N] data shards."""
    return apply(PARITY, data)
