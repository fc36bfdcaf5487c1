"""DiskLocation: one storage directory holding volumes and EC shards.

Reference: weed/storage/disk_location.go (volume discovery/load) and
disk_location_ec.go (EC shard discovery). A volume whose .dat was tiered
is found by its ``.tier`` sidecar, and EC shards moved to a backend by
the ``.ectier`` one.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Dict, Optional

from seaweedfs_tpu_torch.storage.volume import Volume, VolumeError

log = logging.getLogger(__name__)

_DAT_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.(?:dat|tier)$")
_EC_RE = re.compile(r"^(?:(?P<col>.+)_)?(?P<vid>\d+)\.ec(?P<shard>\d\d)$")


def parse_volume_filename(name: str):
    """Return (collection, vid) for a .dat (or .tier) filename, else
    None."""
    m = _DAT_RE.match(name)
    if not m:
        return None
    return (m.group("col") or "", int(m.group("vid")))


def parse_ec_shard_filename(name: str):
    """Return (collection, vid, shard_id) for a .ecNN filename, else None."""
    m = _EC_RE.match(name)
    if not m:
        return None
    return (m.group("col") or "", int(m.group("vid")), int(m.group("shard")))


class DiskLocation:
    def __init__(self, directory: str, max_volume_count: int = 8,
                 needle_map_kind: str = "memory"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_volume_count = max_volume_count
        # the -index kind every volume of this location opens with
        self.needle_map_kind = needle_map_kind
        self.volumes: Dict[int, Volume] = {}
        self.ec_volumes: Dict[int, "object"] = {}  # vid -> ec.EcVolume
        self._lock = threading.RLock()

    def load_existing_volumes(self) -> None:
        with self._lock:
            for name in sorted(os.listdir(self.directory)):
                parsed = parse_volume_filename(name)
                if parsed is None:
                    continue
                col, vid = parsed
                if vid in self.volumes:
                    continue
                try:
                    self.volumes[vid] = Volume(
                        self.directory, col, vid, create_if_missing=False,
                        needle_map_kind=self.needle_map_kind)
                except (OSError, ValueError, VolumeError) as e:
                    log.warning("volume %d in %s unloadable, skipped: %s",
                                vid, self.directory, e)
            self._load_ec_shards()

    def _load_ec_shards(self) -> None:
        # ec imports storage: resolve the EcVolume class at call time
        from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
        found: Dict[int, tuple] = {}
        for name in sorted(os.listdir(self.directory)):
            parsed = parse_ec_shard_filename(name)
            if parsed is None:
                if name.endswith(".ectier"):
                    # tiered shards: their files are gone, the sidecar
                    # names them (EcVolume mounts them remote)
                    self._note_tiered_shards(name, found)
                continue
            col, vid, shard = parsed
            found.setdefault(vid, (col, []))[1].append(shard)
        for vid, (col, shards) in found.items():
            ecv = self.ec_volumes.get(vid)
            if ecv is None:
                try:
                    ecv = EcVolume(self.directory, col, vid)
                except FileNotFoundError:
                    continue  # shards without .ecx are not loadable yet
                self.ec_volumes[vid] = ecv
            for s in shards:
                ecv.mount_shard(s)

    def _note_tiered_shards(self, name: str, found: Dict[int, tuple]) -> None:
        from seaweedfs_tpu_torch.storage.backend import read_ec_tier_info
        stem = name[:-len(".ectier")]
        col, _, tail = stem.rpartition("_")
        if not tail.isdigit():
            return
        info = read_ec_tier_info(os.path.join(self.directory, stem))
        for sid in (info or {}).get("shards", {}):
            found.setdefault(int(tail), (col, []))[1].append(int(sid))

    # -- volume lifecycle ----------------------------------------------------

    def add_volume(self, vid: int, collection: str = "", **kwargs) -> Volume:
        with self._lock:
            if vid in self.volumes:
                return self.volumes[vid]
            kwargs.setdefault("needle_map_kind", self.needle_map_kind)
            v = Volume(self.directory, collection, vid, **kwargs)
            self.volumes[vid] = v
            return v

    def get_volume(self, vid: int) -> Optional[Volume]:
        return self.volumes.get(vid)

    def unload_volume(self, vid: int) -> bool:
        with self._lock:
            v = self.volumes.pop(vid, None)
            if v is None:
                return False
            v.close()
            return True

    def delete_volume(self, vid: int) -> bool:
        with self._lock:
            v = self.volumes.pop(vid, None)
            if v is None:
                return False
            v.destroy()
            return True

    def has_free_slot(self) -> bool:
        return len(self.volumes) < self.max_volume_count

    def close(self) -> None:
        with self._lock:
            for v in self.volumes.values():
                v.close()
            for ecv in self.ec_volumes.values():
                ecv.close()
