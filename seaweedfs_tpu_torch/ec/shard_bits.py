"""ShardBits: uint32 bitmask of mounted shard ids per (node, volume).

Reference: weed/storage/erasure_coding/ec_volume_info.go:61-113.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.ops.rs_code import DATA_SHARDS, TOTAL_SHARDS


class ShardBits(int):
    def add(self, shard_id: int) -> "ShardBits":
        return ShardBits(self | (1 << shard_id))

    def remove(self, shard_id: int) -> "ShardBits":
        return ShardBits(self & ~(1 << shard_id))

    def has(self, shard_id: int) -> bool:
        return bool(self & (1 << shard_id))

    @property
    def shard_ids(self) -> list[int]:
        return [i for i in range(TOTAL_SHARDS) if self.has(i)]

    @property
    def count(self) -> int:
        return bin(self & ((1 << TOTAL_SHARDS) - 1)).count("1")

    def plus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self | other)

    def minus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self & ~other)

    def minus_parity(self) -> "ShardBits":
        return ShardBits(self & ((1 << DATA_SHARDS) - 1))

    @classmethod
    def of(cls, *shard_ids: int) -> "ShardBits":
        b = cls(0)
        for s in shard_ids:
            b = b.add(s)
        return b
