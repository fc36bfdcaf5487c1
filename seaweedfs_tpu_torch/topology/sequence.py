"""File-id sequencers (reference weed/sequence).

The port of ``seaweedfs_tpu.topology.sequence``. The memory sequencer
hands out batches; its high-water mark is restored from volume-server
heartbeats (max_file_key), kept in ``sequence.json`` under -mdir at stop,
and raft-watermarked by the master with peers (``server/master.py``).
The snowflake sequencer needs no coordination; the etcd sequencer claims
ranges in an etcd key through its JSON gateway (``util/etcd_client.py``).
"""

from __future__ import annotations

import threading


class MemorySequencer:
    # contiguous ids: the master raft-watermarks and snapshots them
    needs_watermark = True
    persistable = True

    def __init__(self, start: int = 1):
        self._next = max(1, start)
        self._lock = threading.Lock()

    def next_batch(self, count: int = 1) -> int:
        """Reserve `count` ids; returns the first."""
        with self._lock:
            first = self._next
            self._next += count
            return first

    def set_max(self, seen: int) -> None:
        """Raise the floor above any id observed in the wild."""
        with self._lock:
            if seen >= self._next:
                self._next = seen + 1

    @property
    def peek(self) -> int:
        return self._next


class SnowflakeSequencer:
    """Coordination-free unique ids: 41-bit millisecond timestamp,
    10-bit node id, 12-bit per-ms counter (the reference's snowflake
    option in master.toml [master.sequencer]).

    Ids are unique across masters WITHOUT raft/etcd coordination, at
    the cost of non-contiguous key space.
    """

    EPOCH_MS = 1_600_000_000_000  # 2020-09-13, keeps 41 bits ample
    MAX_COUNTER = 0xFFF
    # time-based ids: no raft watermark needed, and snapshotting the
    # huge timestamp ids into sequence.json would poison a later
    # memory-sequencer restart
    needs_watermark = False
    persistable = False

    def __init__(self, node_id: int = 0):
        self.node_id = node_id & 0x3FF
        self._lock = threading.Lock()
        self._last_ms = 0
        self._counter = -1

    def _advance_ms(self) -> None:  # requires(self._lock)
        import time
        now_ms = int(time.time() * 1000) - self.EPOCH_MS
        # logical advance: reserving a near-future millisecond block is
        # cheaper than spinning and ids stay unique either way
        self._last_ms = max(now_ms, self._last_ms + 1)
        self._counter = -1

    def next_batch(self, count: int = 1) -> int:
        """Returns the first of `count` CONSECUTIVE ids. The range must
        fit one millisecond block (4096 ids) or first+count-1 would
        bleed into the node-id bits and collide with another master."""
        if count > self.MAX_COUNTER + 1:
            raise ValueError(
                f"snowflake cannot issue {count} consecutive ids "
                f"(max {self.MAX_COUNTER + 1} per batch)")
        with self._lock:
            import time
            now_ms = int(time.time() * 1000) - self.EPOCH_MS
            if now_ms > self._last_ms:
                self._last_ms = now_ms
                self._counter = -1
            if self._counter + count > self.MAX_COUNTER:
                self._advance_ms()
            first_counter = self._counter + 1
            self._counter += count
            return (self._last_ms << 22) | (self.node_id << 12) | \
                first_counter

    def set_max(self, seen: int) -> None:
        pass  # time-based: never collides with observed ids

    @property
    def peek(self) -> int:
        """Non-consuming: the id the next allocation would start at."""
        with self._lock:
            return (self._last_ms << 22) | (self.node_id << 12) | \
                min(self._counter + 1, self.MAX_COUNTER)


class EtcdSequencer:
    """Externally-coordinated contiguous ids (reference
    weed/sequence/etcd_sequencer.go): the high-water mark lives in one
    etcd key, advanced in CAS-claimed batches so any number of masters
    (even without raft) hand out disjoint ranges. Rides the JSON
    gateway client (util/etcd_client.py), no SDK."""

    KEY = b"weed_master_sequence"
    STEP = 100  # ids claimed per CAS round-trip (reference's batch)
    # etcd IS the watermark; nothing to snapshot locally
    needs_watermark = False
    persistable = False

    def __init__(self, endpoint: str = "127.0.0.1:2379"):
        from seaweedfs_tpu_torch.util.etcd_client import EtcdClient
        self.client = EtcdClient(endpoint)
        self._lock = threading.Lock()
        self._next = 0   # next id to hand out locally
        self._ceiling = 0  # end (exclusive) of the claimed range

    def _claim(self, at_least: int) -> None:  # requires(self._lock)
        """CAS-advance the shared counter until a batch is claimed."""
        while True:
            cur = self.client.get(self.KEY)
            floor = int(cur) if cur else 1
            want = max(floor, at_least)
            new_ceiling = want + self.STEP
            if self.client.cas(self.KEY, cur, str(new_ceiling).encode()):
                self._next = want
                self._ceiling = new_ceiling
                return

    def next_batch(self, count: int = 1) -> int:
        with self._lock:
            if self._next + count > self._ceiling:
                self._claim(self._next)
                while self._next + count > self._ceiling:
                    # huge batch: keep claiming contiguously
                    cur = self.client.get(self.KEY)
                    if cur and int(cur) == self._ceiling and \
                            self.client.cas(
                                self.KEY, cur,
                                str(self._ceiling + self.STEP).encode()):
                        self._ceiling += self.STEP
                    else:
                        # lost contiguity to another master: restart
                        self._claim(self._ceiling)
            first = self._next
            self._next += count
            return first

    def set_max(self, seen: int) -> None:
        with self._lock:
            # ids below our claimed ceiling can only be our own or
            # another master's already-CAS-claimed range — no conflict.
            # Only an id at/above the ceiling means the etcd counter
            # state was lost (wiped cluster) and the floor must be
            # pushed up; re-claiming on every heartbeat would burn a
            # full STEP batch each time (review round 3).
            if seen >= self._ceiling:
                self._claim(seen + 1)

    @property
    def peek(self) -> int:
        with self._lock:
            return self._next
