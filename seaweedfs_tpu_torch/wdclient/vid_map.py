"""vid -> locations map fed by KeepConnected deltas.

The port of ``seaweedfs_tpu.wdclient.vid_map`` (reference
weed/wdclient/vid_map.go:30-150).
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, NamedTuple

from seaweedfs_tpu_torch.operation.file_id import parse_fid


class Location(NamedTuple):
    url: str
    public_url: str


class VidMap:
    def __init__(self):
        self._lock = threading.RLock()
        self._by_vid: Dict[int, List[Location]] = {}  # guarded_by(self._lock)

    def add_location(self, vid: int, loc: Location) -> None:
        with self._lock:
            locs = self._by_vid.setdefault(vid, [])
            if loc not in locs:
                locs.append(loc)

    def delete_location(self, vid: int, url: str) -> None:
        with self._lock:
            locs = self._by_vid.get(vid)
            if not locs:
                return
            self._by_vid[vid] = [l for l in locs if l.url != url]
            if not self._by_vid[vid]:
                del self._by_vid[vid]

    def drop_node(self, url: str) -> None:
        with self._lock:
            for vid in list(self._by_vid):
                self.delete_location(vid, url)

    def lookup(self, vid: int) -> List[Location]:
        with self._lock:
            return list(self._by_vid.get(vid, []))

    def lookup_file_id(self, fid: str) -> str:
        """fid -> "host:port/fid" on a random replica."""
        locs = self.lookup(parse_fid(fid).volume_id)
        if not locs:
            raise KeyError(f"volume of {fid} not in cache")
        return f"{random.choice(locs).url}/{fid}"

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_vid)
