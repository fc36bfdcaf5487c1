"""VolumeLayout: writable/readonly volume sets for one
(collection, replication, ttl) class.

Reference: weed/topology/volume_layout.go:16-140. State machine per vid:
a volume is writable iff it has the full replica count, no replica is
read-only, and it isn't oversized.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, List, Optional

from seaweedfs_tpu_torch.topology.node import DataNode, VolumeInfo


class VolumeLayout:
    def __init__(self, replica_count: int = 1, ttl: str = "",
                 volume_size_limit: int = 30 << 30):
        self.replica_count = max(1, replica_count)
        self.ttl = ttl
        self.volume_size_limit = volume_size_limit
        self.locations: Dict[int, List[DataNode]] = {}  # guarded_by(self._lock)
        self.writable: set[int] = set()  # guarded_by(self._lock)
        self.oversized: set[int] = set()  # guarded_by(self._lock)
        # vid -> node urls whose replica reports read-only (a vid is
        # readonly while ANY replica is; tracked per-node so a flip back
        # to writable on re-heartbeat clears correctly)
        self.readonly_on: Dict[int, set] = {}  # guarded_by(self._lock)
        self._lock = threading.RLock()

    def register(self, info: VolumeInfo, dn: DataNode) -> None:
        """Idempotent per-heartbeat state sync for one replica: location,
        read-only flag, and size class all refresh in both directions."""
        with self._lock:
            locs = self.locations.setdefault(info.id, [])
            if dn not in locs:
                locs.append(dn)
            ro = self.readonly_on.setdefault(info.id, set())
            if info.read_only:
                ro.add(dn.url)
            else:
                ro.discard(dn.url)
            if info.size >= self.volume_size_limit:
                self.oversized.add(info.id)
            else:
                self.oversized.discard(info.id)
            self._recheck(info.id)

    def unregister(self, vid: int, dn: DataNode) -> None:
        with self._lock:
            locs = self.locations.get(vid, [])
            if dn in locs:
                locs.remove(dn)
            self.readonly_on.get(vid, set()).discard(dn.url)
            if not locs:
                self.locations.pop(vid, None)
                self.writable.discard(vid)
                self.readonly_on.pop(vid, None)
                self.oversized.discard(vid)
            else:
                self._recheck(vid)

    def _recheck(self, vid: int) -> None:  # requires(self._lock)
        ok = (len(self.locations.get(vid, [])) >= self.replica_count
              and not self.readonly_on.get(vid)
              and vid not in self.oversized)
        if ok:
            self.writable.add(vid)
        else:
            self.writable.discard(vid)

    def pick_for_write(self) -> Optional[tuple[int, List[DataNode]]]:
        with self._lock:
            if not self.writable:
                return None
            vid = random.choice(tuple(self.writable))
            return vid, list(self.locations[vid])

    def lookup(self, vid: int) -> List[DataNode]:
        with self._lock:
            return list(self.locations.get(vid, []))

    def volume_ids(self) -> List[int]:
        with self._lock:
            return list(self.locations)

    @property
    def writable_count(self) -> int:
        return len(self.writable)
