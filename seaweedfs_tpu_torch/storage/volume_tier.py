"""Tiers: move a sealed volume's .dat, or a server's EC shards, to an
object store and back.

The port of ``seaweedfs_tpu.storage.volume_tier`` and the reference's
weed/storage/volume_tier.go, volume_grpc_tier_upload.go and
_download.go. Only the bulk bytes move: the .idx (and the needle map
built from it), and an EC volume's .ecx/.ecj, stay local, and reads of
the moved bytes become ranged reads of the backend
(``backend.RemoteFile``, ``EcVolumeShard`` on a remote handle). Uploads
and downloads run without the volume lock (the bytes are immutable once
sealed); only the handle swap takes it, so reads go on throughout.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from seaweedfs_tpu_torch.storage import backend as bk
from seaweedfs_tpu_torch.storage.volume import Volume, VolumeError
from seaweedfs_tpu_torch.util import wlog

_log = wlog.logger("storage.tier")


def _key_stem(collection: str, vid: int, owner: str = "") -> str:
    """The object-key stem of a volume's tiered files. ``owner`` (the
    uploading server's url) keeps the holders of one volume from
    overwriting each other's objects: replicas' .dat files differ in
    their append times, and each EC holder owns different shards."""
    name = f"{collection}_{vid}" if collection else str(vid)
    prefix = f"volumes/{owner.replace(':', '_')}/" if owner else "volumes/"
    return prefix + name


def move_dat_to_remote(v: Volume, backend_name: str,
                       keep_local: bool = False, owner: str = "",
                       progress: Optional[Callable[[int], None]] = None
                       ) -> int:
    """Upload the .dat, record the .tier sidecar, swap reads to the
    backend and, unless keep_local, drop the local copy
    (volume_grpc_tier_upload.go:24-99). The volume must be read-only."""
    if v.is_remote:
        raise VolumeError(f"volume {v.id} is already tiered")
    if not v.read_only:
        raise VolumeError(
            f"volume {v.id} must be read-only before tiering (mark it "
            "readonly first)")
    storage = bk.get_backend(backend_name)
    key = f"{_key_stem(v.collection, v.id, owner)}.dat"
    v.sync()
    size = v.content_size
    total = storage.copy_file(v.dat_path, key, progress=progress)
    if total != size:
        storage.delete_file(key)
        raise VolumeError(
            f"volume {v.id}: uploaded {total} bytes != local {size}")
    with v._lock:
        bk.write_tier_info(v.file_name(), backend_name, key, size)
        old = v._dat
        v._dat = bk.RemoteFile(storage, key, size)
        old.close()
        if not keep_local:
            os.remove(v.dat_path)
    _log.info("volume %d tiered to %s (%d bytes, keep_local=%s)",
              v.id, backend_name, size, keep_local)
    return size


def move_dat_from_remote(v: Volume, keep_remote: bool = False,
                         progress: Optional[Callable[[int], None]] = None
                         ) -> int:
    """Download the .dat next to its .idx and read it locally again
    (volume_grpc_tier_download.go:23-91). The volume stays read-only."""
    info = bk.read_tier_info(v.file_name())
    if info is None or not v.is_remote:
        raise VolumeError(f"volume {v.id} is not cloud-tiered")
    storage = bk.get_backend(info["backend"])
    tmp = v.dat_path + ".tiertmp"
    total = storage.download_file(info["key"], tmp, progress=progress)
    if total != info["size"]:
        os.remove(tmp)
        raise VolumeError(f"volume {v.id}: downloaded {total} bytes != "
                          f"recorded {info['size']}")
    with v._lock:
        os.replace(tmp, v.dat_path)
        bk.remove_tier_info(v.file_name())
        old = v._dat
        v._dat = bk.DiskFile(v.dat_path)
        old.close()
    if not keep_remote:
        storage.delete_file(info["key"])
    _log.info("volume %d un-tiered from %s (%d bytes)",
              v.id, info["backend"], total)
    return total


def _ec_shard_key(ecv, shard_id: int, owner: str = "") -> str:
    return f"{_key_stem(ecv.collection, ecv.volume_id, owner)}" \
           f".ec{shard_id:02d}"


def move_ec_shards_to_remote(ecv, backend_name: str,
                             keep_local: bool = False, owner: str = "",
                             progress: Optional[Callable[[int], None]] = None
                             ) -> int:
    """Upload every local shard of an EC volume, record them in the
    ``<base>.ectier`` sidecar, swap reads to the backend and, unless
    keep_local, drop the local files. Shards already remote are skipped,
    so a re-run finishes what a failed one left. Returns the bytes
    uploaded."""
    local = {sid: s for sid, s in sorted(ecv.shards.items())
             if not s.is_remote}
    if not local:
        raise VolumeError(f"volume {ecv.volume_id} is already tiered")
    storage = bk.get_backend(backend_name)
    prior = bk.read_ec_tier_info(ecv.base_name)
    if prior is not None and prior["backend"] != backend_name:
        raise VolumeError(
            f"volume {ecv.volume_id}: shards already tiered to "
            f"{prior['backend']!r}; download them before re-tiering "
            f"to {backend_name!r}")
    uploaded = {}
    total = 0
    try:
        for sid, shard in local.items():
            key = _ec_shard_key(ecv, sid, owner)
            n = storage.copy_file(shard.path, key, progress=progress)
            if n != shard.size:
                raise VolumeError(
                    f"volume {ecv.volume_id} shard {sid}: uploaded "
                    f"{n} bytes != local {shard.size}")
            uploaded[sid] = {"key": key, "size": n}
            total += n
    except (VolumeError, bk.BackendError):
        for rec in uploaded.values():   # no half-tiered sidecar
            storage.delete_file(rec["key"])
        raise
    merged = dict((prior or {}).get("shards", {}))
    merged.update(uploaded)
    bk.write_ec_tier_info(ecv.base_name, backend_name, merged)
    for sid, rec in uploaded.items():
        shard = ecv.shards[sid]
        shard.swap_to_remote(storage, rec["key"], rec["size"])
        if not keep_local and os.path.exists(shard.path):
            os.remove(shard.path)
    _log.info("ec volume %d: %d shard(s) tiered to %s (%d bytes, "
              "keep_local=%s)", ecv.volume_id, len(uploaded),
              backend_name, total, keep_local)
    return total


def move_ec_shards_from_remote(ecv, keep_remote: bool = False,
                               progress: Optional[Callable[[int], None]]
                               = None) -> int:
    """Download this server's tiered shards next to their .ecx and read
    them locally again. Returns the bytes restored."""
    info = bk.read_ec_tier_info(ecv.base_name)
    if info is None:
        raise VolumeError(f"volume {ecv.volume_id} is not cloud-tiered")
    storage = bk.get_backend(info["backend"])
    total = 0
    for sid, rec in sorted(info["shards"].items()):
        shard = ecv.shards.get(sid)
        if shard is None or not shard.is_remote:
            continue
        tmp = shard.path + ".tiertmp"
        n = storage.download_file(rec["key"], tmp, progress=progress)
        if n != rec["size"]:
            os.remove(tmp)
            raise VolumeError(
                f"volume {ecv.volume_id} shard {sid}: downloaded {n} "
                f"bytes != recorded {rec['size']}")
        os.replace(tmp, shard.path)
        shard.swap_to_local()
        total += n
    bk.remove_ec_tier_info(ecv.base_name)
    if not keep_remote:
        for rec in info["shards"].values():
            storage.delete_file(rec["key"])
    _log.info("ec volume %d: shards un-tiered from %s (%d bytes)",
              ecv.volume_id, info["backend"], total)
    return total
