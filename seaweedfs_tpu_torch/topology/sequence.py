"""Monotonic file-id sequencer (reference weed/sequence).

The memory sequencer hands out batches; its high-water mark is restored
from volume-server heartbeats (max_file_key), and the master keeps it in
its state file under -mdir (``server/master.py``). The JAX package's
snowflake and etcd kinds are not ported.
"""

from __future__ import annotations

import threading


class MemorySequencer:
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
