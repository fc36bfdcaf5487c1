"""Consistent-hash member picking (reference
weed/messaging/broker/consistent_distribution.go, which wraps
buraksezer/consistent + xxhash): topics hash onto brokers so every
client and every broker independently agrees on placement, and adding
a broker only moves ~1/N of the topics.

Implementation: a classic hash ring with virtual nodes — stdlib
blake2b as the 64-bit hash (stable across processes, no xxhash dep).
The port of ``seaweedfs_tpu.messaging.consistent``: the same ring, so
the two packages place every topic on the same broker.
"""

from __future__ import annotations

import bisect
import functools
import hashlib
from typing import Sequence, Tuple

VNODES = 128  # virtual nodes per member


def _h64(data: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "big")


@functools.lru_cache(maxsize=64)
def _ring(members: Tuple[str, ...]):
    """Sorted (point, owner) ring, built once per member set — the
    lookup path (every FindBroker RPC) only bisects."""
    points = []
    for m in members:
        for v in range(VNODES):
            points.append((_h64(f"{m}#{v}".encode()), m))
    points.sort()
    return [p for p, _ in points], [m for _, m in points]


def pick_member(members: Sequence[str], key: bytes) -> str:
    """The member that owns `key`. Deterministic for a given member
    set; every participant computes placement locally."""
    if not members:
        raise ValueError("no members to pick from")
    ring, owners = _ring(tuple(members))
    i = bisect.bisect(ring, _h64(key)) % len(ring)
    return owners[i]
