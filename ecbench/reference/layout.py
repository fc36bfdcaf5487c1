"""Upstream's EC striping of a ``.dat`` over ten data shards, plainly.

``ec_encoder.go``: while MORE than ten large blocks remain, one large row
puts ``dat[row*10L + i*L : +L]`` into shard i; the rest goes the same way
in rows of ten small blocks, the last row zero-padded. Each shard file
holds its large blocks first, then its small ones.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ecbench.reference.gf256 import DATA_SHARDS

LARGE_BLOCK = 1 << 30
SMALL_BLOCK = 1 << 20


def rows(dat_size: int, large: int = LARGE_BLOCK,
         small: int = SMALL_BLOCK) -> Tuple[int, int]:
    """(large rows, small rows) of a ``.dat`` of ``dat_size`` bytes."""
    n_large, rest = 0, dat_size
    while rest > large * DATA_SHARDS:
        n_large += 1
        rest -= large * DATA_SHARDS
    return n_large, -(-rest // (small * DATA_SHARDS))


def shard_size(dat_size: int, large: int = LARGE_BLOCK,
               small: int = SMALL_BLOCK) -> int:
    n_large, n_small = rows(dat_size, large, small)
    return n_large * large + n_small * small


def data_shards(dat: np.ndarray, large: int = LARGE_BLOCK,
                small: int = SMALL_BLOCK) -> np.ndarray:
    """[10, shard_size] uint8: the data shards of ``dat`` (uint8)."""
    n_large, n_small = rows(len(dat), large, small)
    out = np.zeros((DATA_SHARDS, n_large * large + n_small * small),
                   dtype=np.uint8)
    big = n_large * large * DATA_SHARDS
    if n_large:
        out[:, :n_large * large] = dat[:big].reshape(
            n_large, DATA_SHARDS, large).transpose(1, 0, 2).reshape(
            DATA_SHARDS, -1)
    tail = np.zeros(n_small * small * DATA_SHARDS, dtype=np.uint8)
    tail[:len(dat) - big] = dat[big:]
    out[:, n_large * large:] = tail.reshape(
        n_small, DATA_SHARDS, small).transpose(1, 0, 2).reshape(
        DATA_SHARDS, -1)
    return out


def locate(dat_size: int, offset: int, size: int,
           large: int = LARGE_BLOCK,
           small: int = SMALL_BLOCK) -> List[Tuple[int, int, int]]:
    """``dat[offset:offset+size]`` as (shard, shard offset, length)."""
    n_large, _ = rows(dat_size, large, small)
    big = n_large * large * DATA_SHARDS
    out = []
    while size > 0:
        if offset < big:
            block, inner, blen = offset // large, offset % large, large
            base = (block // DATA_SHARDS) * large
        else:
            rel = offset - big
            block, inner, blen = rel // small, rel % small, small
            base = n_large * large + (block // DATA_SHARDS) * small
        take = min(size, blen - inner)
        out.append((block % DATA_SHARDS, base + inner, take))
        offset += take
        size -= take
    return out


def dat_offset(dat_size: int, shard: int, shard_offset: int,
               large: int = LARGE_BLOCK, small: int = SMALL_BLOCK) -> int:
    """The ``.dat`` offset that data shard ``shard`` holds at
    ``shard_offset`` (past the end of the ``.dat`` for padding)."""
    n_large, _ = rows(dat_size, large, small)
    if shard_offset < n_large * large:
        row, inner = divmod(shard_offset, large)
        return row * large * DATA_SHARDS + shard * large + inner
    row, inner = divmod(shard_offset - n_large * large, small)
    return n_large * large * DATA_SHARDS + row * small * DATA_SHARDS + \
        shard * small + inner
