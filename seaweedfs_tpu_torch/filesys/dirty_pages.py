"""Write-back dirty page intervals (reference:
weed/filesys/dirty_page_interval.go — the interval list that absorbs
random writes and reads back the merged view before flush). The port of
``seaweedfs_tpu.filesys.dirty_pages``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


@dataclass
class WrittenInterval:
    offset: int
    data: bytes

    @property
    def stop(self) -> int:
        return self.offset + len(self.data)


class ContinuousIntervals:
    """Ordered, non-overlapping dirty byte ranges; newer writes shadow
    older ones (same semantics as the reference's ContinuousIntervals)."""

    def __init__(self):
        self.intervals: List[WrittenInterval] = []

    @property
    def total_size(self) -> int:
        return max((iv.stop for iv in self.intervals), default=0)

    def add_interval(self, data: bytes, offset: int) -> None:
        new = WrittenInterval(offset, bytes(data))
        out: List[WrittenInterval] = []
        for iv in self.intervals:
            if iv.stop <= new.offset or iv.offset >= new.stop:
                out.append(iv)
                continue
            if iv.offset < new.offset:   # left remnant
                out.append(WrittenInterval(
                    iv.offset, iv.data[:new.offset - iv.offset]))
            if iv.stop > new.stop:       # right remnant
                out.append(WrittenInterval(
                    new.stop, iv.data[new.stop - iv.offset:]))
        out.append(new)
        out.sort(key=lambda iv: iv.offset)
        # merge adjacent runs so flushes produce few chunks
        merged: List[WrittenInterval] = []
        for iv in out:
            if merged and merged[-1].stop == iv.offset:
                merged[-1] = WrittenInterval(
                    merged[-1].offset, merged[-1].data + iv.data)
            else:
                merged.append(iv)
        self.intervals = merged

    def read_data(self, offset: int, size: int,
                  base: Optional[bytes] = None) -> bytes:
        """The view of [offset, offset+size): dirty bytes over `base`
        (already-flushed content), zeros where neither exists."""
        buf = bytearray(size)
        if base:
            usable = base[offset:offset + size]
            buf[:len(usable)] = usable
        for iv in self.intervals:
            lo = max(offset, iv.offset)
            hi = min(offset + size, iv.stop)
            if lo < hi:
                buf[lo - offset:hi - offset] = \
                    iv.data[lo - iv.offset:hi - iv.offset]
        return bytes(buf)

    def pop_all(self) -> List[WrittenInterval]:
        out, self.intervals = self.intervals, []
        return out

    def __bool__(self) -> bool:
        return bool(self.intervals)
