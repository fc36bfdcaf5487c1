"""Tiered read cache: scan-resistant RAM tier over an optional disk
tier, keyed for the volume server's serving path.

The counterpart of ``seaweedfs_tpu.cache.read_cache``; its disk tier
names and writes files exactly as that one does, so a cache directory one
package wrote, the other reads.

The RAM tier is a segmented LRU (SLRU) with admission: new keys enter a
bounded *probation* segment and only a second touch promotes them to the
*protected* segment, so a single sequential scan churns probation and
never flushes the hot set. Eviction drains probation first; protected
entries evicted under pressure demote to the disk tier (they were hot
once), probation evictions are simply dropped.

`TieredReadCache` adds what the serving path needs on top:

  keys          needle entries `v{vid}/n/{nid:x}` (the whole stored
                record, CRC-checked on parse, so a torn cache file can
                never serve bytes) and reconstructed-span entries
                `v{vid}/s/{shard}/{off}/{len}` (the unit the degraded
                decode fleet produces on the card);
  invalidation  per needle or per volume, with a reason label (delete /
                overwrite / rebuild / scrub_repair); a per-vid key index
                makes invalidate_volume O(entries of that volume);
  generations   a reconstruction snapshots generation() first and its
                set(gen=) is refused when an invalidation came between;
  single-flight concurrent misses of one key elect one leader to
                reconstruct while the rest wait and re-read the cache.

A hit replaces a reconstruction on the card, so a fault of the card
never lands in the cache: only a value is ever set, and a leader's card
fault reaches its followers as it is.

Nothing here makes a thread or touches disk until a cache is built with
a directory, and a server started without `-cache.sizeMB` builds none.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Set, Tuple

from seaweedfs_tpu_torch.stats.metrics import (
    CacheAdmitCounter, CacheBytesGauge, CacheEvictCounter, CacheHitCounter,
    CacheInvalidateCounter, CacheMissCounter, ReadsSingleFlightWaitCounter)

# Entries bigger than limit/MAX_ITEM_FRACTION are refused by the RAM
# tier (one huge blob must not evict the whole hot set) and go straight
# to disk when a disk tier exists.
MAX_ITEM_FRACTION = 8

# Fraction of the RAM budget reserved for the protected segment; the
# rest is probation — the scan-absorbing front porch.
PROTECTED_FRACTION = 0.8


def _card_fault(e: BaseException) -> bool:
    from seaweedfs_tpu_torch.parallel.mesh_fleet import is_kernel_fault
    return is_kernel_fault(e)


class _Flight:
    """One single-flight reconstruction: its end, and the leader's error."""

    __slots__ = ("event", "error")

    def __init__(self):
        self.event = threading.Event()
        self.error: Optional[BaseException] = None


class SegmentedLRU:
    """Byte-bounded SLRU: probation -> (second touch) -> protected.

    `on_evict(key, value, protected: bool)` fires for every eviction
    (not for explicit pops), letting a caller demote hot entries to a
    slower tier. The callback runs under the segment lock — keep it
    cheap or re-entrant-safe.
    """

    def __init__(self, limit_bytes: int,
                 protected_fraction: float = PROTECTED_FRACTION,
                 on_evict: Optional[Callable[[str, bytes, bool], None]]
                 = None, max_item_bytes: Optional[int] = None):
        self.limit = max(1, int(limit_bytes))
        self.protected_limit = int(self.limit * protected_fraction)
        self.max_item = max_item_bytes if max_item_bytes is not None \
            else max(1, self.limit // MAX_ITEM_FRACTION)
        self._on_evict = on_evict
        self._lock = threading.Lock()
        # __len__ peeks lock-free (stats); every mutation is locked
        self._probation: "OrderedDict[str, bytes]" = OrderedDict()  # guarded_by(self._lock, writes)
        self._protected: "OrderedDict[str, bytes]" = OrderedDict()  # guarded_by(self._lock, writes)
        self._probation_bytes = 0
        self._protected_bytes = 0
        self.evictions = 0

    @property
    def bytes(self) -> int:
        return self._probation_bytes + self._protected_bytes

    def __len__(self) -> int:
        return len(self._probation) + len(self._protected)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._probation or key in self._protected

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            v = self._protected.get(key)
            if v is not None:
                self._protected.move_to_end(key)
                return v
            v = self._probation.pop(key, None)
            if v is None:
                return None
            # second touch: promote — the admission gate into the
            # protected (hot) segment
            self._probation_bytes -= len(v)
            self._protected[key] = v
            self._protected_bytes += len(v)
            self._shrink_protected()
            self._shrink_total()
            return v

    def set(self, key: str, value: bytes) -> bool:
        """Admit `value`; False when it is too large for this tier."""
        if len(value) > self.max_item:
            return False
        with self._lock:
            old = self._protected.pop(key, None)
            if old is not None:
                # update in place, stay protected (still hot)
                self._protected_bytes += len(value) - len(old)
                self._protected[key] = value
                self._shrink_protected()
            else:
                old = self._probation.pop(key, None)
                if old is not None:
                    self._probation_bytes -= len(old)
                self._probation[key] = value
                self._probation_bytes += len(value)
            self._shrink_total()
            return True

    def pop(self, key: str) -> Optional[bytes]:
        """Remove without firing on_evict (invalidation, not pressure)."""
        with self._lock:
            v = self._protected.pop(key, None)
            if v is not None:
                self._protected_bytes -= len(v)
                return v
            v = self._probation.pop(key, None)
            if v is not None:
                self._probation_bytes -= len(v)
            return v

    def _shrink_protected(self) -> None:  # requires(self._lock)
        # protected overflow demotes its LRU back to probation MRU —
        # it gets one more lap to prove it is still hot
        while self._protected_bytes > self.protected_limit \
                and self._protected:
            k, v = self._protected.popitem(last=False)
            self._protected_bytes -= len(v)
            self._probation[k] = v
            self._probation_bytes += len(v)

    def _shrink_total(self) -> None:  # requires(self._lock)
        while self.bytes > self.limit:
            if self._probation:
                k, v = self._probation.popitem(last=False)
                self._probation_bytes -= len(v)
                protected = False
            elif self._protected:
                k, v = self._protected.popitem(last=False)
                self._protected_bytes -= len(v)
                protected = True
            else:
                return
            self.evictions += 1
            if self._on_evict is not None:
                self._on_evict(k, v, protected)


class DiskCacheTier:
    """Directory of key-named files with byte-budget LRU eviction.

    Files are named by a short hash prefixed with the volume tag so
    per-volume invalidation can find them without reading anything;
    pre-existing files are re-indexed at construction (a restart keeps
    its warm disk tier)."""

    def __init__(self, directory: str, limit_bytes: int):
        self.dir = directory
        self.limit = max(1, int(limit_bytes))
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._lru: "OrderedDict[str, int]" = OrderedDict()
        self._bytes = 0
        self.evictions = 0
        for name in os.listdir(directory):
            p = os.path.join(directory, name)
            if os.path.isfile(p) and not name.endswith(".tmp"):
                sz = os.path.getsize(p)
                self._lru[name] = sz
                self._bytes += sz

    @property
    def bytes(self) -> int:
        return self._bytes

    @staticmethod
    def _fname(key: str) -> str:
        vid_tag = key.split("/", 1)[0]
        digest = hashlib.sha1(key.encode()).hexdigest()[:24]
        return f"{vid_tag}-{digest}"

    def get(self, key: str) -> Optional[bytes]:
        name = self._fname(key)
        with self._lock:
            if name not in self._lru:
                return None
            self._lru.move_to_end(name)
        try:
            with open(os.path.join(self.dir, name), "rb") as f:
                return f.read()
        except OSError:
            with self._lock:
                self._bytes -= self._lru.pop(name, 0)
            return None

    def set(self, key: str, value: bytes) -> None:
        if len(value) > self.limit:
            return
        name = self._fname(key)
        tmp = os.path.join(self.dir, name + ".tmp")
        try:
            with open(tmp, "wb") as f:
                f.write(value)
            os.replace(tmp, os.path.join(self.dir, name))
        except OSError:
            return  # disk tier is best-effort; RAM tier still serves
        with self._lock:
            self._bytes -= self._lru.pop(name, 0)
            self._lru[name] = len(value)
            self._bytes += len(value)
            while self._bytes > self.limit and self._lru:
                victim, sz = self._lru.popitem(last=False)
                self._bytes -= sz
                self.evictions += 1
                try:
                    os.unlink(os.path.join(self.dir, victim))
                except OSError:
                    pass

    def pop(self, key: str) -> bool:
        name = self._fname(key)
        with self._lock:
            sz = self._lru.pop(name, None)
            if sz is None:
                return False
            self._bytes -= sz
        try:
            os.unlink(os.path.join(self.dir, name))
        except OSError:
            pass
        return True

    def drop_volume(self, vid: int) -> int:
        """Remove every file of one volume; returns the count."""
        prefix = f"v{vid}-"
        with self._lock:
            victims = [n for n in self._lru if n.startswith(prefix)]
            for n in victims:
                self._bytes -= self._lru.pop(n, 0)
        for n in victims:
            try:
                os.unlink(os.path.join(self.dir, n))
            except OSError:
                pass
        return len(victims)


class TieredReadCache:
    """The volume server's read cache: SLRU RAM tier over an optional
    disk tier, with per-volume invalidation and single-flight."""

    def __init__(self, mem_limit_bytes: int,
                 disk_dir: Optional[str] = None,
                 disk_limit_bytes: int = 256 << 20):
        self._lock = threading.RLock()
        self.mem = SegmentedLRU(mem_limit_bytes, on_evict=self._demoted)
        self.disk = DiskCacheTier(disk_dir, disk_limit_bytes) \
            if disk_dir else None
        # union of keys alive in either tier, grouped by volume, so
        # invalidate_volume touches only that volume's entries
        self._by_vid: Dict[int, Set[str]] = {}
        # invalidation fences: a reconstruction that started before an
        # invalidation must not re-insert its (now stale) blob after
        # it — set(gen=...) checks both. Volume-level events (rebuild,
        # scrub repair) bump _gen[vid]; needle-level events bump only
        # that key's _fence entry, so delete/overwrite churn on one
        # needle never aborts the volume's other in-flight inserts.
        self._gen: Dict[int, int] = {}
        self._fence: "OrderedDict[str, int]" = OrderedDict()
        # protected-eviction demotions queued under the lock, written
        # to disk after it is released (file IO must not stall RAM hits)
        self._pending_demote: List[Tuple[str, bytes,
                                         Tuple[int, int]]] = []
        self._sf_lock = threading.Lock()
        self._sf: Dict[str, _Flight] = {}  # guarded_by(self._sf_lock)
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self._sets = 0
        self._mem_hits = CacheHitCounter.labels("mem")
        self._disk_hits = CacheHitCounter.labels("disk")

    # -- keys ---------------------------------------------------------------

    @staticmethod
    def needle_key(vid: int, needle_id: int) -> str:
        return f"v{vid}/n/{needle_id:x}"

    @staticmethod
    def span_key(vid: int, shard_id: int, offset: int, length: int) -> str:
        return f"v{vid}/s/{shard_id}/{offset}/{length}"

    @staticmethod
    def _vid_of(key: str) -> int:
        return int(key[1:key.index("/")])

    # -- tiers --------------------------------------------------------------

    def _demoted(self, key: str, value: bytes, protected: bool) -> None:  # requires(self._lock)
        # (every mem mutation goes through our
        # public methods) — protected evictions were hot once and spill
        # to disk; probation evictions are scan traffic and just leave.
        # The disk write itself is QUEUED: file IO under the cache (and
        # SLRU segment) lock would stall every concurrent RAM hit.
        CacheEvictCounter.labels("mem").inc()
        if protected and self.disk is not None:
            self._pending_demote.append((key, value, self._gen_of(key)))
        elif self.disk is None or not self._on_disk(key):
            self._by_vid.get(self._vid_of(key), set()).discard(key)

    def _flush_demotions(self) -> None:
        """Write queued protected-eviction demotions to disk, outside
        the cache lock; an invalidation that raced the eviction wins
        (the write is undone)."""
        if self.disk is None:
            return
        while True:
            with self._lock:
                if not self._pending_demote:
                    return
                key, value, gen = self._pending_demote.pop()
            self.disk.set(key, value)
            CacheAdmitCounter.labels("disk").inc()
            with self._lock:
                if gen != self._gen_of(key):
                    self.disk.pop(key)
                    self._by_vid.get(self._vid_of(key),
                                     set()).discard(key)
                self._export_bytes()

    def _on_disk(self, key: str) -> bool:
        return self.disk is not None and \
            DiskCacheTier._fname(key) in self.disk._lru

    def get(self, key: str) -> Optional[bytes]:
        try:
            with self._lock:
                v = self.mem.get(key)
                if v is not None:
                    self.hits += 1
                    self._mem_hits.inc()
                    return v
                gen = self._gen_of(key)
            if self.disk is not None:
                # file IO outside the cache lock: a disk read must not
                # stall concurrent RAM hits on the serving path
                v = self.disk.get(key)
                if v is not None:
                    with self._lock:
                        if gen == self._gen_of(key):
                            self.hits += 1
                            self._disk_hits.inc()
                            # promote: a disk hit is a touch; it
                            # re-enters probation and earns protection
                            # on the next one. An invalidation that
                            # raced the disk read wins — no promotion,
                            # no resurrection of the stale entry.
                            if self.mem.set(key, v):
                                CacheAdmitCounter.labels("mem").inc()
                            # restart-resident disk entries were never
                            # set() through us: index them so
                            # invalidation can find them
                            self._by_vid.setdefault(self._vid_of(key),
                                                    set()).add(key)
                        else:
                            v = None
                        self._export_bytes()
                    if v is not None:
                        return v
            with self._lock:
                self.misses += 1
            CacheMissCounter.inc()
            return None
        finally:
            self._flush_demotions()

    def _gen_of(self, key: str) -> Tuple[int, int]:  # requires(self._lock)
        """(volume generation, key fence)."""
        return (self._gen.get(self._vid_of(key), 0),
                self._fence.get(key, 0))

    def generation(self, key: str) -> Tuple[int, int]:
        """Snapshot before reconstructing; pass to set(gen=...) so a
        blob computed before an invalidation can never land after it."""
        with self._lock:
            return self._gen_of(key)

    def set(self, key: str, value: bytes,
            gen: Optional[Tuple[int, int]] = None) -> None:
        vid = self._vid_of(key)
        try:
            with self._lock:
                if gen is not None and gen != self._gen_of(key):
                    return  # invalidated while we reconstructed: stale
                if self.mem.set(key, value):
                    CacheAdmitCounter.labels("mem").inc()
                    self._by_vid.setdefault(vid, set()).add(key)
                    self._maybe_prune_index()
                    self._export_bytes()
                    return
                if self.disk is None:
                    return
            # oversized for RAM: the disk write runs outside the lock
            # so it cannot stall concurrent RAM hits; re-check the
            # generation after — an invalidation racing the write wins
            self.disk.set(key, value)
            CacheAdmitCounter.labels("disk").inc()
            with self._lock:
                if gen is not None and gen != self._gen_of(key):
                    self.disk.pop(key)
                    return
                self._by_vid.setdefault(vid, set()).add(key)
                self._export_bytes()
        finally:
            self._flush_demotions()

    def _export_bytes(self) -> None:
        CacheBytesGauge.labels("mem").set(self.mem.bytes)
        if self.disk is not None:
            CacheBytesGauge.labels("disk").set(self.disk.bytes)

    def _maybe_prune_index(self) -> None:  # requires(self._lock)
        """Amortized _by_vid hygiene: disk-tier
        LRU evictions can't call back into this index (victim filenames
        are hashes), so keys that left BOTH tiers would otherwise
        accumulate without bound on long-running servers."""
        self._sets += 1
        if self._sets % 4096:
            return
        for vid in list(self._by_vid):
            keys = self._by_vid[vid]
            dead = [k for k in keys
                    if k not in self.mem and not self._on_disk(k)]
            keys.difference_update(dead)
            if not keys:
                self._by_vid.pop(vid, None)

    # -- invalidation -------------------------------------------------------

    def invalidate(self, vid: int, needle_id: Optional[int] = None,
                   reason: str = "delete") -> int:
        """Drop one needle's entry, or (needle_id None) everything the
        volume has cached. Reconstructed spans survive a needle-level
        invalidation: a delete/overwrite changes the needle's record,
        never the shard bytes a span was decoded from — only
        volume-level events (rebuild, scrub repair, decode-back) drop
        spans. Returns the number of entries dropped."""
        with self._lock:
            keys = self._by_vid.get(vid) or set()
            if needle_id is None:
                # volume-level: fence every key of the volume at once
                self._gen[vid] = self._gen.get(vid, 0) + 1
                victims = list(keys)
            else:
                # needle-level: fence only this key, so churn on one
                # needle never aborts the volume's other in-flight sets
                victims = [self.needle_key(vid, needle_id)]
                self._bump_fence(victims[0])
            dropped = 0
            for k in victims:
                hit = self.mem.pop(k) is not None
                if self.disk is not None:
                    hit = self.disk.pop(k) or hit
                keys.discard(k)
                if hit:
                    dropped += 1
            if needle_id is None and self.disk is not None:
                # restart-resident disk files are not in _by_vid;
                # drop the whole volume tag on disk too
                dropped += self.disk.drop_volume(vid)
            if not keys:
                self._by_vid.pop(vid, None)
            if dropped:
                self.invalidations += dropped
                CacheInvalidateCounter.labels(reason).inc(dropped)
            self._export_bytes()
            return dropped

    def invalidate_volume(self, vid: int, reason: str = "rebuild") -> int:
        return self.invalidate(vid, None, reason)

    # Bound on remembered per-key fences. A fence only matters while a
    # reconstruction of that key is in flight (seconds); 64k entries
    # outlive any realistic race window while capping memory.
    _FENCE_CAP = 65536

    def _bump_fence(self, key: str) -> None:
        self._fence[key] = self._fence.get(key, 0) + 1
        self._fence.move_to_end(key)
        while len(self._fence) > self._FENCE_CAP:
            self._fence.popitem(last=False)

    def drop_spans(self, vid: int) -> None:
        """Drop every reconstructed-span entry of one volume (poison
        recovery: a torn span file can poison assembled needle blobs)."""
        with self._lock:
            keys = self._by_vid.get(vid)
            if not keys:
                return
            for k in [k for k in keys if "/s/" in k]:
                self.mem.pop(k)
                if self.disk is not None:
                    self.disk.pop(k)
                keys.discard(k)
            if not keys:
                self._by_vid.pop(vid, None)
            self._export_bytes()

    def drop(self, key: str) -> None:
        """Evict one key from every tier (e.g. a cached blob that
        failed its CRC parse — poison must not outlive the hit)."""
        with self._lock:
            self.mem.pop(key)
            if self.disk is not None:
                self.disk.pop(key)
            vid = self._vid_of(key)
            keys = self._by_vid.get(vid)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    self._by_vid.pop(vid, None)
            self._export_bytes()

    # -- single flight ------------------------------------------------------

    @contextmanager
    def single_flight(self, key: str):
        """Yield True for the one leader that should reconstruct; every
        other concurrent entrant blocks until the leader finishes, then
        gets False and should re-read the cache (falling back to its
        own reconstruction on a still-miss, e.g. when the leader
        errored). A leader that died of a fault of a kernel or of the
        card hands that fault to every follower instead: rerunning the
        work would only launch on the same card again."""
        with self._sf_lock:
            flight = self._sf.get(key)
            leader = flight is None
            if leader:
                flight = self._sf[key] = _Flight()
        if not leader:
            ReadsSingleFlightWaitCounter.inc()
            flight.event.wait(timeout=60)
            if flight.error is not None and _card_fault(flight.error):
                raise flight.error
            yield False
            return
        try:
            yield True
        except BaseException as e:
            flight.error = e
            raise
        finally:
            with self._sf_lock:
                self._sf.pop(key, None)
            flight.event.set()

    # -- introspection ------------------------------------------------------

    def stats(self) -> Dict:
        """The /status Cache block."""
        with self._lock:
            d = {
                "enabled": True,
                "mem_bytes": self.mem.bytes,
                "mem_limit_bytes": self.mem.limit,
                "mem_entries": len(self.mem),
                "mem_evictions": self.mem.evictions,
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "volumes": len(self._by_vid),
            }
            if self.disk is not None:
                d.update(disk_bytes=self.disk.bytes,
                         disk_limit_bytes=self.disk.limit,
                         disk_dir=self.disk.dir,
                         disk_evictions=self.disk.evictions)
            return d
