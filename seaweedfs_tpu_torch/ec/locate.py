"""Needle-location math over the EC striping layout.

Maps a byte range of the original .dat onto intervals of the 14 shard
files (reference weed/storage/erasure_coding/ec_locate.go:15-87).

Layout: the .dat is consumed row-major. While more than 10*largeBlock
bytes remain, one "large row" assigns dat[row*10L + i*L ..] to shard i;
the tail is striped the same way in small blocks. Shard file i therefore
holds its large blocks first, then its small blocks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from seaweedfs_tpu_torch.ops.rs_code import DATA_SHARDS


@dataclass(frozen=True)
class Interval:
    block_index: int          # index among blocks of this block-size class
    inner_offset: int         # offset within the block
    size: int                 # bytes in this interval
    is_large_block: bool
    large_block_rows: int     # how many large rows the volume has

    def to_shard_and_offset(self, large_block: int,
                            small_block: int) -> Tuple[int, int]:
        """Map to (shard_id, offset within that shard file)."""
        off = self.inner_offset
        row = self.block_index // DATA_SHARDS
        if self.is_large_block:
            off += row * large_block
        else:
            off += self.large_block_rows * large_block + row * small_block
        return self.block_index % DATA_SHARDS, off


def _locate_offset(large_block: int, small_block: int, dat_size: int,
                   offset: int) -> Tuple[int, bool, int]:
    large_row = large_block * DATA_SHARDS
    n_large_rows = dat_size // large_row
    if offset < n_large_rows * large_row:
        return offset // large_block, True, offset % large_block
    offset -= n_large_rows * large_row
    return offset // small_block, False, offset % small_block


def locate_data(large_block: int, small_block: int, dat_size: int,
                offset: int, size: int) -> List[Interval]:
    """Split dat[offset:offset+size] into shard-file intervals."""
    block_index, is_large, inner = _locate_offset(
        large_block, small_block, dat_size, offset)
    # large rows as derivable from a shard file size (+10*small rounds the
    # small-row remainder the way the encoder's strict > loop does;
    # reference ec_locate.go:19)
    n_large_rows = (dat_size + DATA_SHARDS * small_block) // \
        (large_block * DATA_SHARDS)

    intervals: List[Interval] = []
    while size > 0:
        block_len = large_block if is_large else small_block
        take = min(size, block_len - inner)
        intervals.append(Interval(
            block_index=block_index, inner_offset=inner, size=take,
            is_large_block=is_large, large_block_rows=n_large_rows))
        size -= take
        block_index += 1
        if is_large and block_index == n_large_rows * DATA_SHARDS:
            is_large = False
            block_index = 0
        inner = 0
    return intervals
