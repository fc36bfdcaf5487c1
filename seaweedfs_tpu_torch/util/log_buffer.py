"""In-memory buffered event log with periodic flush
(reference: weed/util/log_buffer/log_buffer.go).

Mutation events are appended as (ts_ns, key, payload) records; a
background ticker flushes the buffer to a sink callback every
`flush_seconds` (2s in the reference) or when the buffer fills. Recent
records stay readable in memory so subscribers can catch up without
touching the flushed files; older reads fall back to the flush sink's
storage (handled by the caller, filer_notify).
"""

from __future__ import annotations

import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

BUFFER_LIMIT = 4 << 20   # flush when in-memory bytes exceed this
PREV_BUFFERS = 32        # retained flushed generations for catch-up reads


@dataclass
class LogEntry:
    ts_ns: int
    partition_key_hash: int
    data: bytes

    def pack(self) -> bytes:
        """uint32 length-prefixed wire framing, like the reference's
        flushed log files (filer_notify.go)."""
        body = struct.pack(">qi", self.ts_ns, self.partition_key_hash) + self.data
        return struct.pack(">I", len(body)) + body

    @classmethod
    def unpack_stream(cls, blob: bytes) -> List["LogEntry"]:
        out, pos = [], 0
        while pos + 4 <= len(blob):
            (n,) = struct.unpack_from(">I", blob, pos)
            pos += 4
            if pos + n > len(blob):
                break  # torn tail
            ts_ns, key = struct.unpack_from(">qi", blob, pos)
            out.append(cls(ts_ns, key, blob[pos + 12:pos + n]))
            pos += n
        return out


class LogBuffer:
    """Thread-safe append log with timed flush and in-memory replay."""

    def __init__(self, flush_seconds: float = 2.0,
                 flush_fn: Optional[Callable[[int, int, bytes], None]] = None,
                 notify_fn: Optional[Callable[[], None]] = None):
        self.flush_fn = flush_fn
        self.notify_fn = notify_fn
        self.flush_seconds = flush_seconds
        self._lock = threading.Condition()
        self._entries: List[LogEntry] = []
        self._bytes = 0
        self._prev: List[List[LogEntry]] = []   # flushed, still in memory
        self._last_ts = 0
        self._stopping = False
        # flusher spawns lazily on the first add(): a process that
        # never appends a meta event never grows this thread
        self._flusher: Optional[threading.Thread] = None

    def _ensure_flusher(self) -> None:  # requires(self._lock)
        if self._flusher is None and not self._stopping:
            # lint: thread-ok(periodic flush daemon owns no request context)
            self._flusher = threading.Thread(
                target=self._flush_loop, name="log-buffer-flush",
                daemon=True)
            self._flusher.start()

    def add(self, data: bytes, key_hash: int = 0,
            ts_ns: Optional[int] = None) -> int:
        with self._lock:
            self._ensure_flusher()
            ts = ts_ns if ts_ns is not None else time.time_ns()
            if ts <= self._last_ts:      # strictly monotonic, like the ref
                ts = self._last_ts + 1
            self._last_ts = ts
            self._entries.append(LogEntry(ts, key_hash, data))
            self._bytes += len(data) + 16
            if self._bytes >= BUFFER_LIMIT:
                self._flush_locked()
            self._lock.notify_all()
        if self.notify_fn:
            self.notify_fn()
        return ts

    def _flush_locked(self) -> None:  # requires(self._lock)
        if not self._entries:
            return
        batch = self._entries
        self._entries, self._bytes = [], 0
        self._prev.append(batch)
        del self._prev[:-PREV_BUFFERS]
        if self.flush_fn:
            blob = b"".join(e.pack() for e in batch)
            self.flush_fn(batch[0].ts_ns, batch[-1].ts_ns, blob)

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_loop(self) -> None:
        while not self._stopping:
            time.sleep(self.flush_seconds)
            self.flush()

    def read_since(self, ts_ns: int) -> List[LogEntry]:
        """All in-memory entries with ts > ts_ns (flushed + pending)."""
        with self._lock:
            out = [e for gen in self._prev for e in gen if e.ts_ns > ts_ns]
            out.extend(e for e in self._entries if e.ts_ns > ts_ns)
            return out

    def earliest_in_memory(self) -> Optional[int]:
        with self._lock:
            for gen in self._prev:
                if gen:
                    return gen[0].ts_ns
            return self._entries[0].ts_ns if self._entries else None

    def wait_for_data(self, after_ts_ns: int, timeout: float) -> bool:
        with self._lock:
            if self._last_ts > after_ts_ns:
                return True
            self._lock.wait(timeout)
            return self._last_ts > after_ts_ns

    def close(self) -> None:
        self._stopping = True
        self.flush()
