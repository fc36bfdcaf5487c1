"""Store-level EC operations: the volume server's EC surface.

Counterparts of ``seaweedfs_tpu.ec.store_ec`` and the reference's
store_ec.go / store_ec_delete.go and
server/volume_grpc_erasure_coding.go:38-400: generate (one volume or
many, fused), rebuild, mount/unmount, EC needle reads with live recovery,
delete and decode back to a normal volume. All take
the Store as first argument. The codec runs on the card unless the caller
passes ``backend="cpu"`` (or, for reads, a ``rs=ReedSolomon(backend="cpu")``
or a ``decoder=DegradedReadFleet("cpu")``).
"""

from __future__ import annotations

import os
import struct
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from seaweedfs_tpu_torch.ec import encoder, fleet
from seaweedfs_tpu_torch.ec.ec_volume import EcShardNotFound, EcVolume
from seaweedfs_tpu_torch.ec.shard_bits import TOTAL_SHARDS
from seaweedfs_tpu_torch.ops.rs_code import ReedSolomon
from seaweedfs_tpu_torch.stats import trace
from seaweedfs_tpu_torch.storage.needle import (CookieMismatch,
                                                DataCorruptionError, Needle,
                                                NeedleError)
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import Volume


def _base_name(directory: str, collection: str, vid: int) -> str:
    name = f"{collection}_{vid}" if collection else str(vid)
    return os.path.join(directory, name)


def _find_ec_base(store: Store, vid: int,
                  collection: Optional[str] = None) -> Optional[str]:
    """Locate the <base>.ecx of a volume across disk locations.

    A mounted EcVolume is authoritative; with no collection given the
    directories are scanned for any [collection_]vid.ecx."""
    ecv = store.find_ec_volume(vid)
    if ecv is not None and os.path.exists(ecv.base_name + ".ecx"):
        return ecv.base_name
    for loc in store.locations:
        if collection is not None:
            base = _base_name(loc.directory, collection, vid)
            if os.path.exists(base + ".ecx"):
                return base
            continue
        for name in os.listdir(loc.directory):
            if not name.endswith(".ecx"):
                continue
            stem = name[:-len(".ecx")]
            col, _, tail = stem.rpartition("_")
            if tail == str(vid) or (not col and stem == str(vid)):
                return os.path.join(loc.directory, stem)
    return None


def _location_of_base(store: Store, base: str):
    return next(loc for loc in store.locations
                if os.path.dirname(base) == loc.directory)


def generate_ec_shards(store: Store, vid: int, backend: str = "cuda") -> str:
    """VolumeEcShardsGenerate of one volume: a batch of one. Returns the
    base name the shard files were written under."""
    return generate_ec_shards_batch(store, [vid], backend=backend)[vid]


def generate_ec_shards_batch(store: Store, vids: Sequence[int],
                             backend: str = "cuda",
                             mesh_cfg: Optional[dict] = None
                             ) -> Dict[int, str]:
    """VolumeEcShardsGenerate: .dat/.idx -> .ec00-13 + .ecx for one or
    MANY volumes in one fused pass.

    Every vid is validated before any volume is frozen (a bad vid must
    not strand earlier volumes read-only with no shards); then every
    volume is frozen (read-only + sync) and ONE scheduler packs chunks
    from all of them into shared RS dispatches: with `mesh_cfg` (keywords
    of ``parallel/mesh_fleet.pod_write_ec_files``) and two or more
    volumes the unified mesh scheduler, which falls back to the per-card
    fleets on a scheduler failure; otherwise the fleet scheduler
    (``ec/fleet.py``). Shard bytes are the same either way.
    Returns {vid: base_name}.
    """
    vols = []
    for vid in vids:
        v = store.find_volume(vid)
        if v is None:
            raise NeedleError(f"volume {vid} not found for ec encode")
        vols.append((vid, v))
    bases: Dict[int, str] = {}
    for vid, v in vols:
        v.read_only = True
        v.sync()
        bases[vid] = v.file_name()
    with trace.span("store_ec.generate_batch", volumes=len(bases)):
        # a one-volume request stays on the fleet: it cannot fill the
        # default mesh's dp slots, and the attempt would count as a mesh
        # fallback
        mesh_fleet = fleet.mesh_fleet_or_none() \
            if mesh_cfg is not None and len(bases) > 1 else None
        if mesh_fleet is not None:
            mesh_fleet.pod_write_ec_files(list(bases.values()),
                                          backend=backend, **mesh_cfg)
        else:
            fleet.fleet_write_ec_files(list(bases.values()),
                                       backend=backend)
        with trace.span("store_ec.write_ecx"):
            for base in bases.values():
                encoder.write_sorted_file_from_idx(base)
    return bases


def rebuild_ec_shards(store: Store, vid: int,
                      collection: Optional[str] = None,
                      backend: str = "cuda") -> List[int]:
    """VolumeEcShardsRebuild: regenerate missing .ecNN from >=10 local
    ones. Returns the rebuilt shard ids."""
    base = _find_ec_base(store, vid, collection)
    if base is None:
        raise EcShardNotFound(f"no local ec files for volume {vid}")
    with trace.span("store_ec.rebuild", vid=vid):
        return fleet.fleet_rebuild_ec_files([base], backend=backend)[base]


def mount_ec_shards(store: Store, vid: int, collection: str,
                    shard_ids: Iterable[int]) -> EcVolume:
    """VolumeEcShardsMount: open shard files and register the EcVolume."""
    base = _find_ec_base(store, vid, collection)
    if base is None:
        raise EcShardNotFound(f"volume {vid}: no .ecx on any disk location")
    loc = _location_of_base(store, base)
    ecv = loc.ec_volumes.get(vid)
    if ecv is None:
        ecv = EcVolume(loc.directory, collection, vid)
        loc.ec_volumes[vid] = ecv
    for sid in shard_ids:
        ecv.mount_shard(sid)
    return ecv


def unmount_ec_shards(store: Store, vid: int,
                      shard_ids: Iterable[int]) -> None:
    """VolumeEcShardsUnmount; drops the EcVolume when no shards remain."""
    ecv = store.find_ec_volume(vid)
    if ecv is None:
        return
    for sid in shard_ids:
        ecv.unmount_shard(sid)
    if not ecv.shards:
        loc = store.location_of(vid)
        ecv.close()
        if loc is not None:
            loc.ec_volumes.pop(vid, None)


def delete_ec_shards(store: Store, vid: int,
                     collection: Optional[str] = None,
                     shard_ids: Iterable[int] = ()) -> None:
    """VolumeEcShardsDelete: remove shard files; when none remain, the
    .ecx/.ecj go too (reference volume_grpc_erasure_coding.go:136-210)."""
    base = _find_ec_base(store, vid, collection)
    if base is None:
        return
    ecv = store.find_ec_volume(vid)
    for sid in shard_ids:
        if ecv is not None:
            ecv.unmount_shard(sid)
        p = encoder.shard_file_name(base, sid)
        if os.path.exists(p):
            os.remove(p)
    if not any(os.path.exists(encoder.shard_file_name(base, i))
               for i in range(TOTAL_SHARDS)):
        loc = _location_of_base(store, base)
        if ecv is not None:
            ecv.close()
            loc.ec_volumes.pop(vid, None)
        for ext in (".ecx", ".ecj"):
            if os.path.exists(base + ext):
                os.remove(base + ext)


def read_ec_shard(store: Store, vid: int, shard_id: int, offset: int,
                  length: int) -> bytes:
    """VolumeEcShardRead: raw bytes of one local shard (serves remote
    peers' interval reads)."""
    ecv = store.find_ec_volume(vid)
    if ecv is None:
        raise EcShardNotFound(f"ec volume {vid} not mounted")
    shard = ecv.shards.get(shard_id)
    if shard is None:
        raise EcShardNotFound(f"ec volume {vid} shard {shard_id} not local")
    return shard.read_at(offset, length)


def read_ec_needle(store: Store, vid: int, n: Needle,
                   remote_reader: Optional[Callable] = None,
                   rs: Optional[ReedSolomon] = None, decoder=None,
                   cache=None, version: int = 3) -> Needle:
    """ReadEcShardNeedle: cookie-checked needle read over shards, with
    remote fan-out and on-the-fly RS recovery (store_ec.go:122-262).

    ``remote_reader(shard_id, offset, length) -> bytes | None`` serves
    shards that are not local; ``decoder`` (``reads.DegradedReadFleet``)
    fuses any reconstruction the read needs into batched dispatches,
    else it is solved in place through ``rs``.

    With a ``cache`` (``cache.TieredReadCache``) the whole stored record
    rides the needle-keyed tier: a repeat read costs one hit and a
    CRC-checked parse, and concurrent misses of one needle single-flight,
    so one reconstruction serves them all. A cached blob that fails its
    parse is data corruption (a torn cache file, or a torn span in the
    blob): the needle's entry and the volume's spans are dropped and the
    read is made once more from the shards. Nothing else is caught: a
    fault of a kernel or of the card reaches the caller, and every
    single-flight follower, and is never cached."""
    ecv = store.find_ec_volume(vid)
    if ecv is None:
        raise EcShardNotFound(f"ec volume {vid} not mounted")
    if cache is None:
        return ecv.read_needle(n, version, remote_reader=remote_reader,
                               rs=rs, decoder=decoder)
    sp = trace.span("reads.ec_needle", vid=vid) \
        if trace.is_enabled() else trace.NOOP
    with sp:
        key = cache.needle_key(vid, n.id)
        blob = cache.get(key)
        if blob is None:
            with cache.single_flight(key) as leader:
                if not leader:
                    blob = cache.get(key)  # the leader's result
                if blob is None:
                    # snapshot BEFORE the read: a delete or scrub repair
                    # that lands while we reconstruct makes set() refuse
                    gen = cache.generation(key)
                    blob = ecv.read_needle_blob(
                        n.id, version, remote_reader, rs, decoder,
                        span_cache=cache)
                    cache.set(key, blob, gen=gen)
        try:
            got = _parse_record(blob, version)
        except DataCorruptionError:
            cache.drop(key)
            cache.drop_spans(vid)
            gen = cache.generation(key)
            blob = ecv.read_needle_blob(n.id, version, remote_reader, rs,
                                        decoder, span_cache=None)
            got = Needle.from_bytes(blob, version)
            cache.set(key, blob, gen=gen)
    if n.cookie and got.cookie != n.cookie:
        raise CookieMismatch(
            f"needle {n.id:x}: cookie {n.cookie:08x} != {got.cookie:08x}")
    return got


def _parse_record(blob: bytes, version: int) -> Needle:
    """Needle.from_bytes, with a record that does not parse at all (a
    torn or garbled blob) reported as the data corruption it is."""
    try:
        return Needle.from_bytes(blob, version)
    except DataCorruptionError:
        raise
    except (NeedleError, ValueError, IndexError, struct.error) as e:
        raise DataCorruptionError(f"unparsable needle record: {e}") from e


def delete_ec_needle(store: Store, vid: int, n: Needle,
                     cache=None) -> None:
    """Tombstone in .ecx + journal to .ecj (store_ec_delete.go); drops
    the needle's cached entry, so a delete is never masked."""
    ecv = store.find_ec_volume(vid)
    if ecv is None:
        raise EcShardNotFound(f"ec volume {vid} not mounted")
    ecv.delete_needle(n.id)
    if cache is not None:
        cache.invalidate(vid, n.id, reason="delete")


def scrub_ec_volume(store: Store, vid: int, backend: str = "cuda",
                    mbps: float = 0.0, on_repair=None):
    """Targeted scrub of ONE mounted EC volume: needle sweep, stripe
    verify on the card (``backend="cuda"``) and, where damaged,
    quarantine and reconstruction; the store-level form of the daemon's
    whole-store pass. Returns the scrub PassResult."""
    from seaweedfs_tpu_torch.scrub import ScrubDaemon
    if store.find_ec_volume(vid) is None:
        raise EcShardNotFound(f"ec volume {vid} not mounted")
    # export_lag=False: a one-off pass must not take the process-wide
    # scan-lag gauge from the server's own daemon
    daemon = ScrubDaemon(store, backend=backend, mbps=mbps,
                         export_lag=False, on_repair=on_repair)
    return daemon.run_pass(volume_ids=[vid])


def ec_shards_to_volume(store: Store, vid: int, collection: str = "",
                        backend: str = "cuda",
                        large_block: int = encoder.LARGE_BLOCK_SIZE,
                        small_block: int = encoder.SMALL_BLOCK_SIZE) -> Volume:
    """VolumeEcShardsToVolume: decode .ec00-09 (+.ecx/.ecj) back into a
    loadable .dat/.idx volume (reference
    volume_grpc_erasure_coding.go:360-400 + ec_decoder.go). Missing data
    shards are rebuilt first; missing parity is left alone."""
    if store.find_ec_volume(vid) is not None:
        raise EcShardNotFound(
            f"volume {vid}: unmount ec shards before decoding back "
            "(a mounted EcVolume would serve stale reads)")
    base = _find_ec_base(store, vid, collection or None)
    if base is None:
        raise EcShardNotFound(f"volume {vid}: no .ecx to decode from")
    loc = _location_of_base(store, base)
    stem = os.path.basename(base)
    collection = stem.rsplit("_", 1)[0] if "_" in stem else ""
    fleet.fleet_rebuild_ec_files([base], backend=backend,
                                 wanted=list(range(encoder.DATA_SHARDS)))
    encoder.write_dat_file(base, encoder.find_dat_file_size(base),
                           backend=backend, large_block=large_block,
                           small_block=small_block)
    encoder.write_idx_file_from_ec_index(base)
    with loc._lock:
        v = Volume(loc.directory, collection, vid, create_if_missing=False,
                   needle_map_kind=loc.needle_map_kind)
        loc.volumes[vid] = v
    return v
