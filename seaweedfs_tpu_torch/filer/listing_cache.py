"""Event-invalidated directory-listing cache: `list_entries` pages in
a scan-resistant SegmentedLRU tier, dropped by the metadata event log.

Every namespace read path funnels through `Filer.list_entries` — the
HTTP directory browser, gRPC ListEntries (which the shell's fs.* and
the S3 gateway paginate through), WebDAV PROPFIND — and each call
walks the FilerStore. This tier caches whole pages keyed by the full
listing window `(directory, start_name, inclusive, limit, prefix)`:

  hits      decode the serialized page and skip the store entirely
            (the protobuf round trip preserves every field, so the
            served response is byte-identical to a fresh walk);
  misses    the caller walks the store and offers the raw page back
            under a generation fence (below);
  eviction  pages ride `cache/read_cache.SegmentedLRU` — new pages
            enter probation and only a second touch protects them, so
            one crawl over a million cold directories cannot flush the
            hot namespace;
  invalidation  THE EVENT LOG drives it: `MetaLog.append_event` fires
            its `on_append` hook for every recorded mutation, and
            `apply_event` drops every page of the touched directory
            (windows are membership-sensitive: any create/delete can
            shift every page boundary, so per-entry granularity would
            be wrong, not just complicated). Directory deletes and
            renames drop the cached SUBTREE — the children vanish in
            one store call with a single logged event for the top
            entry. Peer filers' events arrive through the
            meta-aggregator's subscription log and invalidate with
            reason="peer" — the prerequisite for serving listings
            from filer replicas.

The generation fence closes the walk/mutate race: a reader that
misses records the directory's generation BEFORE walking the store; a
mutation that lands mid-walk bumps the generation, and the reader's
`put` is then refused — without the fence the reader could cache the
pre-mutation page AFTER the event already invalidated, and serve a
deleted entry for as long as the page stayed warm.

Cost discipline: constructing a cache spawns nothing; a filer started
without `-meta.listingCacheMB` never constructs one and
`Filer.list_entries` pays one None check.
"""

from __future__ import annotations

import itertools
import struct
import threading
from typing import Dict, List, Optional, Set

from seaweedfs_tpu_torch.cache.read_cache import SegmentedLRU
from seaweedfs_tpu_torch.pb import filer_pb2

# Listing pages are many small entries, not one huge blob — let a page
# up to 1/4 of the budget in rather than SegmentedLRU's default 1/8
# (a 1024-entry page of long names is ~256KB).
MAX_PAGE_FRACTION = 4


def _page_key(directory: str, start_name: str, inclusive: bool,
              limit: int, prefix: str) -> str:
    # \x00 cannot appear in entry names (the stores reject NUL paths),
    # so the join is unambiguous; the directory leads so on_evict can
    # recover it with one partition
    return "\x00".join((directory, start_name,
                        "1" if inclusive else "0", str(limit), prefix))


def _ancestors(directory: str):
    """"/a/b/c" -> ("/", "/a", "/a/b", "/a/b/c") — the chain whose
    subtree fences a listing of /a/b/c depends on."""
    parts = [p for p in directory.split("/") if p]
    out, acc = ["/"], ""
    for p in parts:
        acc += "/" + p
        out.append(acc)
    return out


def _encode(entries: List[filer_pb2.Entry]) -> bytes:
    parts = []
    for e in entries:
        blob = e.SerializeToString()
        parts.append(struct.pack(">I", len(blob)))
        parts.append(blob)
    return b"".join(parts)


def _decode(blob: bytes) -> List[filer_pb2.Entry]:
    out, off = [], 0
    while off < len(blob):
        (n,) = struct.unpack_from(">I", blob, off)
        off += 4
        e = filer_pb2.Entry()
        e.ParseFromString(blob[off:off + n])
        off += n
        out.append(e)
    return out


class ListingCache:
    """Page cache over `FilerStore.list_directory_entries` windows.

    Locking: `self._lock` guards the directory index and generation
    map; the SLRU has its own lock. The ONE permitted nesting is
    slru._lock -> self._lock (the eviction callback); no ListingCache
    method calls into the SLRU while holding self._lock, so the order
    cannot cycle.
    """

    def __init__(self, limit_bytes: int):
        self._slru = SegmentedLRU(
            limit_bytes, on_evict=self._evicted,
            max_item_bytes=max(1, limit_bytes // MAX_PAGE_FRACTION))
        self._lock = threading.Lock()
        # directory -> cached page keys of that directory
        self._dir_keys: Dict[str, Set[str]] = {}  # guarded_by(self._lock)
        # directory -> generation fence. Values come off one process
        # counter and are never reused, so a reader's pre-walk
        # generation can only match if NO invalidation landed since —
        # entries are never pruned back to the absent-0 state (one int
        # per ever-mutated directory; same order as the store's
        # directory count, which already lives in this process).
        self._gens: Dict[str, int] = {}  # guarded_by(self._lock)
        # path -> subtree fence, bumped by invalidate_subtree for the
        # TOP path always — a recursive delete/rename logs ONE event,
        # and descendants with no cached pages (invisible to
        # _dir_keys) must still refuse in-flight puts; generation()
        # folds every ancestor's subtree fence into the token
        self._subtree_gens: Dict[str, int] = {}  # guarded_by(self._lock)
        # page keys with a put() in flight: the SLRU write happens
        # OUTSIDE self._lock (lock order), so concurrent puts for one
        # key must serialize through this claim or a refused stale put
        # could overwrite — and then pop — a racing fresh page
        self._putting: Set[str] = set()  # guarded_by(self._lock)
        self._next_gen = itertools.count(1).__next__
        # ledger (exact under the lock; also exported as metrics)
        self.hits = 0  # guarded_by(self._lock, writes)
        self.misses = 0  # guarded_by(self._lock, writes)
        self.invalidations = 0  # guarded_by(self._lock, writes)
        from seaweedfs_tpu_torch.stats.metrics import (
            MetaListingCounter, MetaListingInvalidationsCounter)
        # labels() locks the family per call: resolve children once
        self._c_hit = MetaListingCounter.labels("hit")
        self._c_miss = MetaListingCounter.labels("miss")
        self._c_inv = {r: MetaListingInvalidationsCounter.labels(r)
                       for r in ("local", "peer")}

    # -- read side ------------------------------------------------------------

    def get(self, directory: str, start_name: str = "",
            inclusive: bool = False, limit: int = 1024,
            prefix: str = "") -> Optional[List[filer_pb2.Entry]]:
        """The cached raw page for this exact listing window, or None.
        Callers re-apply the TTL-expiry filter on every serve — lazy
        expiry emits no event, so the filter, not the cache, owns it."""
        key = _page_key(directory, start_name, inclusive, limit, prefix)
        blob = self._slru.get(key)
        if blob is not None:
            # a page is servable only once put() INDEXED it under the
            # fence check: the blob lands in the SLRU first (set must
            # not run under self._lock — lock order), and serving it
            # in the set->index gap could hand out a page older than
            # an already-acknowledged, already-invalidated mutation
            with self._lock:
                indexed = key in self._dir_keys.get(directory, ())
                if indexed:
                    self.hits += 1
                else:
                    self.misses += 1
        else:
            indexed = False
            with self._lock:
                self.misses += 1
        if not indexed:
            self._c_miss.inc()
            return None
        self._c_hit.inc()
        return _decode(blob)

    def _token(self, directory: str):  # requires(self._lock)
        return (self._gens.get(directory, 0),
                tuple(self._subtree_gens.get(a, 0)
                      for a in _ancestors(directory)))

    def generation(self, directory: str):
        """Opaque fence token — read BEFORE walking the store on a
        miss, pass to put(). Folds the directory's own generation AND
        every ancestor's subtree fence, so a recursive delete/rename
        of any ancestor refuses the in-flight put even when this
        directory had no cached pages to enumerate."""
        with self._lock:
            return self._token(directory)

    def put(self, directory: str, start_name: str, inclusive: bool,
            limit: int, prefix: str, entries: List[filer_pb2.Entry],
            gen) -> bool:
        """Offer a freshly walked page. Refused (False) when the
        directory's fence token moved since `gen` — the walk raced a
        mutation and the page may predate it — or when the page is too
        large for the tier."""
        # ByteSize() is maintained incrementally by protobuf: reject
        # oversized pages BEFORE paying the full serialization, or a
        # hot too-big directory would encode itself on every listing
        # for a cache that never admits it
        if sum(e.ByteSize() + 4 for e in entries) > self._slru.max_item:
            return False
        key = _page_key(directory, start_name, inclusive, limit, prefix)
        with self._lock:
            # fence pre-check + per-key claim: a walker whose fence
            # already moved never touches the SLRU, and only ONE put
            # per key is ever between set and index — so the rollback
            # pop below can only ever remove this put's own blob,
            # never a racing fresher page
            if self._token(directory) != gen or key in self._putting:
                return False
            self._putting.add(key)
        try:
            if not self._slru.set(key, _encode(entries)):
                return False
            with self._lock:
                if self._token(directory) == gen:
                    self._dir_keys.setdefault(directory, set()).add(key)
                    return True
            # fence moved while the blob was already in: take it back
            # out (it was never indexed, so get() never served it)
            self._slru.pop(key)
            return False
        finally:
            with self._lock:
                self._putting.discard(key)

    # -- invalidation ---------------------------------------------------------

    def _evicted(self, key: str, value: bytes, protected: bool) -> None:
        # SLRU pressure eviction (runs under slru._lock): keep the
        # directory index honest. Generations do NOT move — eviction
        # is capacity, not staleness.
        directory = key.partition("\x00")[0]
        with self._lock:
            keys = self._dir_keys.get(directory)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._dir_keys[directory]

    def invalidate_dir(self, directory: str,
                       reason: str = "local") -> int:
        """Drop every cached page of ONE directory and advance its
        generation fence (always — in-flight walks must be refused
        even when no page is cached yet)."""
        with self._lock:
            keys = self._dir_keys.pop(directory, None) or ()
            self._gens[directory] = self._next_gen()
            self.invalidations += len(keys)
        for key in keys:  # outside self._lock: slru has its own lock
            self._slru.pop(key)
        if keys:
            self._c_inv.get(reason,
                            self._c_inv["local"]).inc(len(keys))
        return len(keys)

    def invalidate_subtree(self, path: str, reason: str = "local") -> int:
        """Drop the cached pages of `path` and every directory under
        it — directory deletes and renames move/remove whole subtrees
        with ONE logged event for the top entry. The subtree fence
        bumps ALWAYS: a descendant directory with no cached pages is
        invisible to the key index, but an in-flight walk of it must
        still be refused (generation() folds this fence in)."""
        path = path.rstrip("/") or "/"
        want = path + "/"
        with self._lock:
            self._subtree_gens[path] = self._next_gen()
            dirs = [d for d in self._dir_keys
                    if d == path or d.startswith(want)]
        dropped = 0
        for d in dirs:
            dropped += self.invalidate_dir(d, reason)
        return dropped

    def apply_event(self, directory: str, ev, reason: str = "local"
                    ) -> int:
        """MetaLog.on_append hook: one recorded mutation -> the pages
        it can have shifted. Any membership change can move every page
        boundary of the parent, so the whole directory goes; directory
        deletes/renames take their subtree with them."""
        import posixpath
        dropped = self.invalidate_dir(directory or "/", reason)
        old = ev.old_entry if ev.HasField("old_entry") else None
        new = ev.new_entry if ev.HasField("new_entry") else None
        if old is not None and old.is_directory and \
                (new is None or ev.new_parent_path):
            dropped += self.invalidate_subtree(
                posixpath.join(directory or "/", old.name), reason)
        if ev.new_parent_path:
            dropped += self.invalidate_dir(ev.new_parent_path, reason)
            if new is not None and new.is_directory:
                # the DESTINATION path of a directory move: fence and
                # drop its subtree too — an in-flight walk of the
                # (previously empty or overwritten) destination must
                # not cache a pre-rename view of what just moved in
                dropped += self.invalidate_subtree(
                    posixpath.join(ev.new_parent_path, new.name),
                    reason)
        return dropped

    def stats(self) -> Dict:
        with self._lock:
            return {"pages": len(self._slru), "bytes": self._slru.bytes,
                    "directories": len(self._dir_keys),
                    "hits": self.hits, "misses": self.misses,
                    "invalidations": self.invalidations}
