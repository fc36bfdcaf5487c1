"""Store: all DiskLocations of one volume server; routes ops by volume id.

Reference: weed/storage/store.go (struct :32-48, read/write/delete
:302-330, CollectHeartbeat :203).
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

from seaweedfs_tpu_torch.stats.metrics import (VolumeServerDiskSizeGauge,
                                               VolumeServerVolumeCounter)
from seaweedfs_tpu_torch.storage.disk_location import DiskLocation
from seaweedfs_tpu_torch.storage.needle import Needle, NeedleError
from seaweedfs_tpu_torch.storage.superblock import ReplicaPlacement, TTL
from seaweedfs_tpu_torch.storage.volume import Volume


class Store:
    def __init__(self, directories: List[str],
                 max_volume_counts: Optional[List[int]] = None,
                 ip: str = "", port: int = 0, public_url: str = "",
                 needle_map_kind: str = "memory"):
        if max_volume_counts is None:
            max_volume_counts = [8] * len(directories)
        self.locations = [DiskLocation(d, c, needle_map_kind)
                          for d, c in zip(directories, max_volume_counts)]
        self.ip = ip
        self.port = port
        self.public_url = public_url or (f"{ip}:{port}" if ip else "")
        self._lock = threading.RLock()
        # collections the storage gauges were last set for
        self._metric_collections: set = set()  # guarded_by(self._lock)
        for loc in self.locations:
            loc.load_existing_volumes()

    # -- volume routing ------------------------------------------------------

    def find_volume(self, vid: int) -> Optional[Volume]:
        for loc in self.locations:
            v = loc.get_volume(vid)
            if v is not None:
                return v
        return None

    def find_ec_volume(self, vid: int):
        for loc in self.locations:
            ecv = loc.ec_volumes.get(vid)
            if ecv is not None:
                return ecv
        return None

    def location_of(self, vid: int) -> Optional[DiskLocation]:
        for loc in self.locations:
            if loc.get_volume(vid) is not None or vid in loc.ec_volumes:
                return loc
        return None

    def has_volume(self, vid: int) -> bool:
        return self.find_volume(vid) is not None

    def add_volume(self, vid: int, collection: str = "",
                   replica_placement: str = "000", ttl: str = "") -> Volume:
        with self._lock:
            existing = self.find_volume(vid)
            if existing is not None:
                return existing
            for loc in self.locations:
                if loc.has_free_slot():
                    return loc.add_volume(
                        vid, collection,
                        replica_placement=ReplicaPlacement.parse(
                            replica_placement),
                        ttl=TTL.parse(ttl))
            raise RuntimeError("no free volume slot on any disk location")

    def delete_volume(self, vid: int) -> bool:
        """Close and remove a normal volume's files; False when no
        location holds it."""
        with self._lock:
            return any(loc.delete_volume(vid) for loc in self.locations)

    def mark_volume_readonly(self, vid: int) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        v.read_only = True
        return True

    def mark_volume_writable(self, vid: int) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        v.read_only = False
        return True

    def configure_volume(self, vid: int, replication: str) -> bool:
        """Change a volume's replica placement on disk (reference
        store.go:431); False when the volume is not here."""
        v = self.find_volume(vid)
        if v is None:
            return False
        v.configure_replication(ReplicaPlacement.parse(replication))
        return True

    def delete_collection(self, collection: str) -> List[int]:
        """Remove every volume and EC volume of a collection from every
        location, with every file of theirs: besides the ones a volume
        owns, what vacuum, scrub quarantine, tiering or a copy left
        (``<collection>_<vid>.*``). Returns their ids."""
        gone = []
        with self._lock:
            for loc in self.locations:
                here = []
                for vid, v in list(loc.volumes.items()):
                    if v.collection == collection:
                        loc.delete_volume(vid)
                        here.append(vid)
                for vid, ecv in list(loc.ec_volumes.items()):
                    if ecv.collection == collection:
                        ecv.destroy()
                        loc.ec_volumes.pop(vid, None)
                        here.append(vid)
                prefixes = tuple(f"{collection}_{vid}." if collection
                                 else f"{vid}." for vid in here)
                for name in os.listdir(loc.directory) if here else ():
                    p = os.path.join(loc.directory, name)
                    if name.startswith(prefixes) and os.path.isfile(p):
                        os.remove(p)
                gone += here
        return gone

    # -- data ops ------------------------------------------------------------

    def write_needle(self, vid: int, n: Needle, fsync: bool = False):
        v = self.find_volume(vid)
        if v is None:
            raise NeedleError(f"volume {vid} not found")
        return v.write_needle(n, fsync=fsync)

    def read_needle(self, vid: int, n: Needle) -> Needle:
        v = self.find_volume(vid)
        if v is None:
            raise NeedleError(f"volume {vid} not found")
        return v.read_needle(n)

    def read_needle_span(self, vid: int, n: Needle):
        """The zero-copy variant for the async serving core: (needle
        metadata, payload FileSpan), or None when the volume cannot serve
        spans, and the caller falls back to read_needle."""
        v = self.find_volume(vid)
        if v is None:
            return None
        return v.read_needle_span(n)

    def delete_needle(self, vid: int, n: Needle) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise NeedleError(f"volume {vid} not found")
        return v.delete_needle(n)

    # -- heartbeat -----------------------------------------------------------

    @staticmethod
    def volume_info(v: Volume) -> dict:
        return {
            "id": v.id,
            "collection": v.collection,
            "size": v.content_size,
            "file_count": v.file_count,
            "delete_count": v.deleted_count,
            "deleted_byte_count": v.deleted_size,
            "read_only": v.read_only,
            "replica_placement": v.replica_placement.to_byte(),
            "ttl": str(v.ttl),
            "version": v.version,
            "modified_at_second": v.last_append_at_ns // 1_000_000_000,
        }

    def collect_heartbeat(self) -> dict:
        """The full-state heartbeat: every volume and every mounted EC
        volume's shard bits (reference store.go CollectHeartbeat). It
        also sets the storage gauges per collection, and zeroes those of
        a collection that has disappeared since the last pass, or a
        dashboard would keep showing its last value (JAX
        storage/store.py:168-199)."""
        with self._lock:
            vols = [v for loc in self.locations
                    for v in list(loc.volumes.values())]
            counts: dict = {}
            sizes: dict = {}
            for v in vols:
                counts[v.collection] = counts.get(v.collection, 0) + 1
                sizes[v.collection] = sizes.get(v.collection, 0) + \
                    v.content_size
            for col in self._metric_collections - set(counts):
                VolumeServerVolumeCounter.labels(col, "volume").set(0)
                VolumeServerDiskSizeGauge.labels(col, "normal").set(0)
            self._metric_collections = set(counts)
            for col, n in counts.items():
                VolumeServerVolumeCounter.labels(col, "volume").set(n)
            for col, size in sizes.items():
                VolumeServerDiskSizeGauge.labels(col, "normal").set(size)
            ec_shards = [{"id": vid, "collection": ecv.collection,
                          "ec_index_bits": ecv.shard_bits}
                         for loc in self.locations
                         for vid, ecv in list(loc.ec_volumes.items())]
            return {
                "ip": self.ip,
                "port": self.port,
                "public_url": self.public_url,
                "max_volume_count": sum(loc.max_volume_count
                                        for loc in self.locations),
                "volumes": [self.volume_info(v) for v in vols],
                "ec_shards": ec_shards,
                "max_file_key": max((v.nm.max_key for v in vols),
                                    default=0),
            }

    def close(self) -> None:
        for loc in self.locations:
            loc.close()
