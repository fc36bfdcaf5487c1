"""Upstream's volume file format, written plainly: ``.dat`` records and
``.idx`` entries (``weed/storage/needle/needle_read_write.go``, version 3).

A record: cookie(4) id(8) size(4) | dataSize(4) data flags(1) |
checksum(4) appendAtNs(8) padding, big-endian, padded to a multiple of 8
(8 bytes of padding when already aligned, as upstream). ``size`` counts
the body. The ``.dat`` starts with an 8-byte superblock; an ``.idx``
entry is key(8) offset/8(4) size(4).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

SUPERBLOCK = bytes([3, 0, 0, 0, 0, 0, 0, 0])   # version 3, placement 000
HEADER = 16
TAIL = 12                                     # checksum + appendAtNs


def body_size(data_len: int) -> int:
    return 4 + data_len + 1


def record_size(data_len: int) -> int:
    base = HEADER + body_size(data_len) + TAIL
    return base + 8 - base % 8


def layout(lengths: Sequence[int]) -> Tuple[np.ndarray, int]:
    """(record offsets, .dat size) of records laid end to end after the
    superblock."""
    sizes = np.array([record_size(n) for n in lengths], dtype=np.int64)
    offsets = len(SUPERBLOCK) + np.concatenate(
        [[0], np.cumsum(sizes)[:-1]]) if len(sizes) else np.zeros(0)
    return offsets.astype(np.int64), len(SUPERBLOCK) + int(sizes.sum())


def _be(values, width: int) -> np.ndarray:
    dt = {4: ">u4", 8: ">u8"}[width]
    return np.asarray(values, dtype=np.uint64).astype(dt).view(
        np.uint8).reshape(-1, width)


def _rows(payload: np.ndarray, starts: np.ndarray, n: int) -> np.ndarray:
    """[len(starts), n] view of ``payload`` rows at evenly spaced starts,
    or a gathered copy when they are not evenly spaced."""
    steps = np.diff(starts)
    if len(starts) == 1 or (steps == steps[0]).all() and steps[0] >= 0:
        step = int(steps[0]) if len(starts) > 1 else n
        return np.lib.stride_tricks.as_strided(
            payload[starts[0]:], shape=(len(starts), n), strides=(step, 1),
            writeable=False)
    return np.stack([payload[s:s + n] for s in starts])


def assemble(lengths: Sequence[int], ids, cookies, payload: np.ndarray,
             src, checksums, append_ns: int) -> np.ndarray:
    """The ``.dat`` bytes of needles whose data lie back to back in the
    flat uint8 ``payload`` from ``src[0]``; ``checksums`` are the stored
    (masked) CRCs."""
    offsets, dat_size = layout(lengths)
    dat = np.zeros(dat_size, dtype=np.uint8)
    dat[:len(SUPERBLOCK)] = np.frombuffer(SUPERBLOCK, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int64)
    src = np.asarray(src, dtype=np.int64)
    ids, cookies = np.asarray(ids), np.asarray(cookies)
    checksums = np.asarray(checksums)
    i = 0
    while i < len(lengths):
        j = i
        while j < len(lengths) and lengths[j] == lengths[i]:
            j += 1
        n, rec = int(lengths[i]), record_size(int(lengths[i]))
        recs = dat[offsets[i]:offsets[i] + (j - i) * rec].reshape(j - i, rec)
        recs[:, 0:4] = _be(cookies[i:j], 4)
        recs[:, 4:12] = _be(ids[i:j], 8)
        recs[:, 12:16] = _be([body_size(n)] * (j - i), 4)
        recs[:, 16:20] = _be([n] * (j - i), 4)
        recs[:, 20:20 + n] = _rows(payload, src[i:j], n)
        t = 20 + n + 1                        # flags byte stays 0
        recs[:, t:t + 4] = _be(checksums[i:j], 4)
        recs[:, t + 4:t + 12] = _be([append_ns] * (j - i), 8)
        i = j
    return dat


def index_bytes(ids, offsets, lengths) -> bytes:
    n = len(ids)
    out = np.zeros((n, 16), dtype=np.uint8)
    out[:, 0:8] = _be(ids, 8)
    out[:, 8:12] = _be(np.asarray(offsets, dtype=np.int64) // 8, 4)
    out[:, 12:16] = _be([body_size(int(x)) for x in lengths], 4)
    return out.tobytes()


def data_range(offset: int, data_len: int) -> Tuple[int, int]:
    """The ``.dat`` byte range of a record's data."""
    return offset + HEADER + 4, offset + HEADER + 4 + data_len
