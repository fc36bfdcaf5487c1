"""The benchmark's inputs, made from ``--seed``: needles and the volume
files that hold them.

Every stream of random numbers comes from its own ``SeedSequence`` child
of the seed, so the payload does not shift when another stream changes.
The volumes are written with the frozen writer of
``reference/needle.py``; the program under test only reads them.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ecbench.reference import crc32c, needle

STREAMS = {"payload": 1, "cookies": 2, "sizes": 3, "traffic": 4,
           "flips": 5, "append": 6}


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, seed >> 32, STREAMS[stream]]))


def random_bytes(gen: np.random.Generator, n: int) -> np.ndarray:
    words = gen.integers(0, 2 ** 64 - 1, -(-n // 8), dtype=np.uint64,
                         endpoint=True)
    return words.view(np.uint8)[:n]


@dataclass
class VolumeData:
    """One volume's needles: their data lie back to back in ``payload``
    from ``src[i]``; records start at ``offsets[i]`` of the ``.dat``."""
    vid: int
    ids: np.ndarray
    cookies: np.ndarray
    lengths: np.ndarray
    src: np.ndarray
    payload: np.ndarray = field(repr=False)
    append_ns: int = 0
    offsets: np.ndarray = None
    dat_size: int = 0

    def __post_init__(self):
        self.offsets, self.dat_size = needle.layout(self.lengths)

    def data(self, i: int) -> np.ndarray:
        return self.payload[self.src[i]:self.src[i] + self.lengths[i]]

    def dat(self) -> np.ndarray:
        sums = crc32c.crc32c_many(self.payload, self.src, self.lengths)
        return needle.assemble(self.lengths, self.ids, self.cookies,
                               self.payload, self.src,
                               crc32c.masked(sums),
                               self.append_ns)

    def write(self, directory: str, collection: str = "") -> str:
        """Write ``.dat`` and ``.idx``; returns the base path."""
        name = f"{collection}_{self.vid}" if collection else str(self.vid)
        base = os.path.join(directory, name)
        self.dat().tofile(base + ".dat")
        with open(base + ".idx", "wb") as f:
            f.write(needle.index_bytes(self.ids, self.offsets, self.lengths))
        return base


def _append_ns(seed: int) -> int:
    return 1_700_000_000_000_000_000 + int(rng(seed, "append").integers(
        0, 10 ** 15))


def bench1k(seed: int, cfg: dict) -> List[VolumeData]:
    """``weed benchmark -size S -n N``: N needles of S bytes, needle i in
    volume ``i % volumes + 1`` (equal volumes whatever the seed)."""
    n, size, nvol = cfg["n"], cfg["size"], cfg["volumes"]
    payload = random_bytes(rng(seed, "payload"), n * size)
    cookies = rng(seed, "cookies").integers(0, 2 ** 32, n, dtype=np.uint64)
    stamp = _append_ns(seed)
    vols = []
    for v in range(nvol):
        idx = np.arange(v, n, nvol, dtype=np.int64)
        vols.append(VolumeData(
            vid=v + 1, ids=idx + 1, cookies=cookies[idx],
            lengths=np.full(len(idx), size, dtype=np.int64),
            src=idx * size, payload=payload, append_ns=stamp))
    return vols


def warm_fleet(seed: int, cfg: dict) -> List[VolumeData]:
    """Large files of log-uniform size, cut into ``chunk_bytes`` needles
    (the filer's ``-maxMB``), filling ``volumes`` volumes of exactly
    ``volume_bytes``: a needle that does not fit is split, its rest
    opening the next volume, so every seed gives the same bytes."""
    cap, nvol = cfg["volume_bytes"], cfg["volumes"]
    chunk = cfg["chunk_bytes"]
    lo, hi = math.log(cfg["file_bytes_min"]), math.log(cfg["file_bytes_max"])
    # one set of file sizes for every seed (enough to fill the volumes
    # twice over), in an order drawn from the seed: the seed moves the
    # bytes and the order, not the amount of work
    fixed = np.random.default_rng(0)
    files = []
    while sum(files) < 2 * cap * nvol:
        files.append(int(math.exp(fixed.uniform(lo, hi))))
    order = iter(rng(seed, "sizes").permutation(len(files)))
    per_volume: List[List[int]] = [[]]
    remaining = cap - len(needle.SUPERBLOCK)
    pending: List[int] = []
    while True:
        if not pending:
            f = files[int(next(order))]
            pending = [chunk] * (f // chunk) + ([f % chunk] if f % chunk
                                                else [])
        length = pending.pop(0)
        rec = needle.record_size(length)
        if rec > remaining:
            fit = remaining - needle.HEADER - 5 - needle.TAIL - 8
            if fit >= cfg["min_needle_bytes"]:
                per_volume[-1].append(fit)
                pending.insert(0, length - fit)
            else:
                pending.insert(0, length)
            if len(per_volume) == nvol:
                break
            per_volume.append([])
            remaining = cap - len(needle.SUPERBLOCK)
            continue
        per_volume[-1].append(length)
        remaining -= rec
    total = sum(sum(v) for v in per_volume)
    payload = random_bytes(rng(seed, "payload"), total)
    count = sum(len(v) for v in per_volume)
    cookies = rng(seed, "cookies").integers(0, 2 ** 32, count,
                                            dtype=np.uint64)
    stamp = _append_ns(seed)
    vols, start, first = [], 0, 0
    for v, lengths in enumerate(per_volume):
        lengths = np.asarray(lengths, dtype=np.int64)
        src = start + np.concatenate([[0], np.cumsum(lengths)[:-1]])
        ids = np.arange(first, first + len(lengths), dtype=np.int64) + 1
        vols.append(VolumeData(
            vid=v + 1, ids=ids, cookies=cookies[first:first + len(lengths)],
            lengths=lengths, src=src.astype(np.int64), payload=payload,
            append_ns=stamp))
        start += int(lengths.sum())
        first += len(lengths)
    return vols
