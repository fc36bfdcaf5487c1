"""Volume superblock, replica placement grammar, and TTL encoding.

Reference formats: weed/storage/super_block/super_block.go:12-38 (8-byte
header), replica_placement.go:8-31 ("xyz" = DC/rack/server extra copies),
weed/storage/needle/volume_ttl.go (2-byte count+unit TTL).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

SUPER_BLOCK_SIZE = 8

_TTL_UNITS = {0: "", 1: "m", 2: "h", 3: "d", 4: "w", 5: "M", 6: "y"}
_TTL_UNIT_CODES = {v: k for k, v in _TTL_UNITS.items() if v}
_TTL_MINUTES = {0: 0, 1: 1, 2: 60, 3: 60 * 24, 4: 60 * 24 * 7,
                5: 60 * 24 * 30, 6: 60 * 24 * 365}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = 0

    @classmethod
    def empty(cls) -> "TTL":
        return cls(0, 0)

    @property
    def is_empty(self) -> bool:
        return self.count == 0 or self.unit == 0

    @property
    def minutes(self) -> int:
        return self.count * _TTL_MINUTES.get(self.unit, 0)

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        if len(b) < 2 or b[0] == 0:
            return cls.empty()
        return cls(b[0], b[1])

    @classmethod
    def parse(cls, s: str) -> "TTL":
        """"3m", "4h", "5d", "6w", "7M", "8y" — empty string = no TTL."""
        if not s:
            return cls.empty()
        unit = _TTL_UNIT_CODES.get(s[-1])
        if unit is None:
            raise ValueError(f"bad ttl unit in {s!r}")
        count = int(s[:-1])
        if not 0 <= count <= 255:
            raise ValueError(f"ttl count {count} out of range")
        return cls(count, unit)

    def __str__(self) -> str:
        if self.is_empty:
            return ""
        return f"{self.count}{_TTL_UNITS[self.unit]}"


@dataclass(frozen=True)
class ReplicaPlacement:
    """"xyz": x extra copies in other DCs, y in other racks, z on other
    servers in the same rack. Total copies = x+y+z+1."""

    diff_dc: int = 0
    diff_rack: int = 0
    same_rack: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        if len(s) != 3 or not s.isdigit():
            raise ValueError(f"bad replica placement {s!r}")
        x, y, z = (int(c) for c in s)
        if max(x, y, z) > 2:
            raise ValueError(f"replica placement digits must be <= 2: {s!r}")
        return cls(diff_dc=x, diff_rack=y, same_rack=z)

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls.parse(f"{b:03d}")

    def to_byte(self) -> int:
        return self.diff_dc * 100 + self.diff_rack * 10 + self.same_rack

    @property
    def copy_count(self) -> int:
        return self.diff_dc + self.diff_rack + self.same_rack + 1

    def __str__(self) -> str:
        return f"{self.diff_dc}{self.diff_rack}{self.same_rack}"


@dataclass
class SuperBlock:
    version: int = 3
    replica_placement: ReplicaPlacement = ReplicaPlacement()
    ttl: TTL = TTL.empty()
    compaction_revision: int = 0

    def to_bytes(self) -> bytes:
        b = bytearray(SUPER_BLOCK_SIZE)
        b[0] = self.version
        b[1] = self.replica_placement.to_byte()
        b[2:4] = self.ttl.to_bytes()
        struct.pack_into(">H", b, 4, self.compaction_revision)
        return bytes(b)

    @classmethod
    def from_bytes(cls, b: bytes) -> "SuperBlock":
        if len(b) < SUPER_BLOCK_SIZE:
            raise ValueError("superblock too short")
        return cls(
            version=b[0],
            replica_placement=ReplicaPlacement.from_byte(b[1]),
            ttl=TTL.from_bytes(b[2:4]),
            compaction_revision=struct.unpack_from(">H", b, 4)[0],
        )
