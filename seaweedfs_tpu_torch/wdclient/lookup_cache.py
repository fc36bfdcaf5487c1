"""Coalescing vid -> locations lookup cache: single-flight, TTL and
batched round trips.

The port of ``seaweedfs_tpu.wdclient.lookup_cache``. Every client path
funnels through "where does volume N live?": a chunked file's reader
resolves one lookup per chunk, ``operations`` clients one per call, and
the master answers each as its own round trip. This module makes those
reads batch, coalesce and cache:

  single-flight  concurrent misses for ONE vid elect a leader; every
                 other caller waits on the leader's flight and reuses
                 its answer (one round trip, not W).
  coalescing     misses arriving within a short window (a few ms) join
                 one FORMING batch; the window leader issues a single
                 batched ``/dir/lookup?volumeIds=a,b,c`` (or RPC
                 ``LookupVolume`` with many ``volume_ids``) covering
                 everyone.
  TTL            positive entries expire after `ttl_s`; NOT-FOUND
                 answers are cached for the shorter `negative_ttl_s`.
  invalidation   a caller that failed to READ from every returned
                 location drops the entry (`invalidate`).

Transport failures resolve waiting flights with an error but are never
cached: the next call must retry the master, not trust a blip.

Cost discipline: nothing here starts a thread; the batch leader runs on
the caller's thread and the window is a bounded sleep held OUTSIDE the
lock. Disabled (the default) no cache object exists anywhere and every
wired call site pays one module-flag check
(``tests/test_torch_client.py::test_lookup_cache_disabled_costs_nothing``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

from seaweedfs_tpu_torch.wdclient.vid_map import Location

DEFAULT_TTL_S = 30.0
DEFAULT_NEGATIVE_TTL_S = 2.0
DEFAULT_COALESCE_MS = 2.0
DEFAULT_BATCH_MAX = 128
# How long a follower waits on a flight before giving up — generous:
# a lookup RPC is milliseconds, and an abandoned wait must not hang a
# serving thread forever behind a wedged leader.
FLIGHT_WAIT_S = 30.0


class LookupResult(NamedTuple):
    """Per-vid answer: locations, or why there are none. One bad vid
    never fails its batch — errors travel per entry."""
    locations: Tuple[Location, ...]
    error: str = ""


class _Flight:
    """One in-flight fetch of one vid. The leader writes `result`
    before setting `event` (happens-before via Event)."""

    __slots__ = ("event", "result")

    def __init__(self):
        self.event = threading.Event()
        self.result: Optional[LookupResult] = None


class CoalescingLookupCache:
    """vid -> LookupResult with TTL, single-flight, and a coalescing
    batch window. `fetch_many(vids) -> Dict[vid, LookupResult]` is the
    injected transport (HTTP or gRPC batched lookup); it may raise on
    transport failure — waiters get the error, nothing is cached."""

    def __init__(self, fetch_many: Callable[[List[int]],
                                            Dict[int, LookupResult]],
                 ttl_s: float = DEFAULT_TTL_S,
                 negative_ttl_s: float = DEFAULT_NEGATIVE_TTL_S,
                 coalesce_s: float = DEFAULT_COALESCE_MS / 1000.0,
                 batch_max: int = DEFAULT_BATCH_MAX):
        self._fetch_many = fetch_many
        self.ttl_s = ttl_s
        self.negative_ttl_s = negative_ttl_s
        self.coalesce_s = coalesce_s
        self.batch_max = max(1, int(batch_max))
        self._lock = threading.Lock()
        # vid -> (result, expires_at monotonic)
        self._cache: Dict[int, Tuple[LookupResult, float]] = {}  # guarded_by(self._lock)
        self._flights: Dict[int, _Flight] = {}  # guarded_by(self._lock)
        # the batch currently forming (misses append; its window
        # leader takes it when the window closes)
        self._forming: Optional[List[int]] = None  # guarded_by(self._lock)
        # callers currently inside lookup_many — the window leader
        # only sleeps out the coalesce window when someone ELSE is in
        # flight to join it (a lone sequential caller has nothing to
        # coalesce with and must not pay the window as pure latency)
        self._active = 0  # guarded_by(self._lock)
        # ledger (exact under the lock; also exported as metrics)
        self.hits = 0  # guarded_by(self._lock, writes)
        self.negative_hits = 0  # guarded_by(self._lock, writes)
        self.misses = 0  # guarded_by(self._lock, writes)
        self.invalidations = 0  # guarded_by(self._lock, writes)
        from seaweedfs_tpu_torch.stats.metrics import MetaLookupCounter
        # labels() locks the family per call: resolve children once
        self._c_hit = MetaLookupCounter.labels("hit")
        self._c_neg = MetaLookupCounter.labels("negative_hit")
        self._c_miss = MetaLookupCounter.labels("miss")

    # -- lookups --------------------------------------------------------------

    def lookup(self, vid: int) -> LookupResult:
        return self.lookup_many([vid])[vid]

    def lookup_many(self, vids: Iterable[int]) -> Dict[int, LookupResult]:
        """Resolve many vids in (at most) one batched round trip for
        the misses; hits answer locally. Every requested vid is in the
        returned dict."""
        with self._lock:
            self._active += 1
        try:
            return self._lookup_many(vids)
        finally:
            with self._lock:
                self._active -= 1

    def _lookup_many(self, vids: Iterable[int]) -> Dict[int, LookupResult]:
        from seaweedfs_tpu_torch.stats.metrics import MetaLookupWaitersCounter
        out: Dict[int, LookupResult] = {}
        waits: List[Tuple[int, _Flight]] = []
        lead_batch: Optional[List[int]] = None
        my_added = 0
        hits = neg = misses = waiters = 0
        now = time.monotonic()
        with self._lock:
            for vid in dict.fromkeys(vids):
                ent = self._cache.get(vid)
                if ent is not None and ent[1] > now:
                    out[vid] = ent[0]
                    if ent[0].error:
                        neg += 1
                        self.negative_hits += 1
                    else:
                        hits += 1
                        self.hits += 1
                    continue
                misses += 1
                self.misses += 1
                fl = self._flights.get(vid)
                if fl is None:
                    fl = self._flights[vid] = _Flight()
                    if self._forming is None:
                        # we open the window and lead its batch
                        self._forming = []
                        lead_batch = self._forming
                    self._forming.append(vid)
                    my_added += 1
                else:
                    waiters += 1
                waits.append((vid, fl))
        # metric emission strictly outside the lock (house rule: the
        # family lock must never nest under a subsystem lock)
        if hits:
            self._c_hit.inc(hits)
        if neg:
            self._c_neg.inc(neg)
        if misses:
            self._c_miss.inc(misses)
        if waiters:
            MetaLookupWaitersCounter.inc(waiters)
        if lead_batch is not None:
            try:
                if self.coalesce_s > 0:
                    # the coalescing window: misses on other threads
                    # join `_forming` while we sleep (never under the
                    # lock). A LONE caller skips it — with nobody else
                    # inside lookup_many and no vid joined from
                    # another thread, the sleep is pure latency (a
                    # sequential shell loop over 10k vids would pay
                    # 10k windows for zero fusion).
                    with self._lock:
                        lone = self._active <= 1 and \
                            len(lead_batch) == my_added
                    if not lone:
                        time.sleep(self.coalesce_s)
            finally:
                # take the batch even when the sleep dies on a
                # BaseException (interrupt): a window left FORMING
                # forever would make every future miss join a
                # leaderless batch that nobody ever resolves
                with self._lock:
                    batch = list(lead_batch)
                    if self._forming is lead_batch:
                        self._forming = None
            for i in range(0, len(batch), self.batch_max):
                self._resolve(batch[i:i + self.batch_max])
        for vid, fl in waits:
            if vid in out:
                continue
            if not fl.event.wait(timeout=FLIGHT_WAIT_S):
                # a leader that died on a non-Exception (interrupt,
                # SystemExit) can never resolve this flight — drop it
                # so later lookups open a fresh one instead of queueing
                # behind a corpse forever; if its WINDOW is also still
                # forming (the leader died before taking the batch),
                # close that too so the next miss elects a new leader
                with self._lock:
                    if self._flights.get(vid) is fl:
                        del self._flights[vid]
                        # only while OUR flight was still registered:
                        # a forming window holding this vid must be
                        # the dead leader's (a healthy new window
                        # would have needed a fresh flight)
                        if self._forming is not None and \
                                vid in self._forming:
                            self._forming = None
                out[vid] = LookupResult(
                    (), f"lookup of volume {vid} timed out waiting for "
                        "the single-flight leader")
                continue
            out[vid] = fl.result if fl.result is not None else \
                LookupResult((), f"volume {vid} lookup produced no result")
        return out

    def _resolve(self, vids: List[int]) -> None:
        """Leader half: ONE batched round trip for `vids`, publish the
        per-vid answers, release every waiter."""
        from seaweedfs_tpu_torch.stats import trace
        from seaweedfs_tpu_torch.stats.metrics import MetaLookupBatchHistogram
        MetaLookupBatchHistogram.observe(len(vids))
        sp = trace.span("meta.lookup", vids=len(vids)) \
            if trace.is_enabled() else trace.NOOP
        err: Optional[BaseException] = None
        results: Optional[Dict[int, LookupResult]] = None
        with sp:
            try:
                results = self._fetch_many(list(vids))
            except Exception as e:  # noqa: BLE001 - resolved per flight below
                err = e
        now = time.monotonic()
        release: List[_Flight] = []
        with self._lock:
            for vid in vids:
                if results is not None:
                    res = results.get(vid)
                    if res is None:
                        res = LookupResult((), f"volume {vid} not found")
                    ttl = self.negative_ttl_s if res.error else self.ttl_s
                    if ttl > 0:
                        self._cache[vid] = (res, now + ttl)
                else:
                    # transport failure: answer the waiters, cache
                    # NOTHING — the next call must retry the master
                    res = LookupResult((), f"lookup failed: {err!r}")
                fl = self._flights.pop(vid, None)
                if fl is not None:
                    fl.result = res
                    release.append(fl)
        for fl in release:
            fl.event.set()

    # -- invalidation ---------------------------------------------------------

    def invalidate(self, vid: int, reason: str = "read_failure") -> bool:
        """Drop one vid's cached answer (the caller observed it wrong —
        e.g. every returned location failed the actual read)."""
        with self._lock:
            dropped = self._cache.pop(vid, None) is not None
            if dropped:
                self.invalidations += 1
        if dropped:
            from seaweedfs_tpu_torch.stats.metrics import \
                MetaLookupInvalidationsCounter
            MetaLookupInvalidationsCounter.labels(reason).inc()
        return dropped

    def stats(self) -> Dict:
        with self._lock:
            return {"entries": len(self._cache), "hits": self.hits,
                    "negative_hits": self.negative_hits,
                    "misses": self.misses,
                    "invalidations": self.invalidations}


# -- module seam (the -meta.lookup* flags) ------------------------------------
#
# `enabled` is the one check every wired call site pays when the cache
# is off; `configure()` is called by the server CLIs, the env vars arm
# spawned benches/tools the way SEAWEED_TRACE_SAMPLE does.

enabled = False
_ttl_s = DEFAULT_TTL_S
_negative_ttl_s = DEFAULT_NEGATIVE_TTL_S
_coalesce_s = DEFAULT_COALESCE_MS / 1000.0
_batch_max = DEFAULT_BATCH_MAX

_caches_lock = threading.Lock()
# (master_url, collection) -> shared per-process cache
_caches: Dict[Tuple[str, str], CoalescingLookupCache] = {}  # guarded_by(_caches_lock)


def configure(enable: bool = True, ttl_s: Optional[float] = None,
              negative_ttl_s: Optional[float] = None,
              coalesce_ms: Optional[float] = None,
              batch_max: Optional[int] = None) -> None:
    global enabled, _ttl_s, _negative_ttl_s, _coalesce_s, _batch_max
    if ttl_s is not None:
        _ttl_s = ttl_s
    if negative_ttl_s is not None:
        _negative_ttl_s = negative_ttl_s
    if coalesce_ms is not None:
        _coalesce_s = coalesce_ms / 1000.0
    if batch_max is not None:
        _batch_max = batch_max
    enabled = bool(enable) and _ttl_s > 0


def reset() -> None:
    """Tests: drop every cache and disable."""
    global enabled
    enabled = False
    with _caches_lock:
        _caches.clear()


def make_cache(fetch_many) -> CoalescingLookupCache:
    """A cache honoring the module tunables, over an injected
    transport (e.g. MasterClient's batched RPC lookup)."""
    return CoalescingLookupCache(
        fetch_many, ttl_s=_ttl_s, negative_ttl_s=_negative_ttl_s,
        coalesce_s=_coalesce_s, batch_max=_batch_max)


def for_master(master_url: str,
               collection: str = "") -> CoalescingLookupCache:
    """The process-wide cache for one (master, collection), fetching
    over the batched HTTP ``/dir/lookup?volumeIds=`` surface on the
    pooled data-plane client."""
    key = (master_url, collection)
    with _caches_lock:
        c = _caches.get(key)
    if c is None:
        # constructed OUTSIDE _caches_lock: __init__ resolves metric
        # children (the family lock), which must never nest under a
        # subsystem lock; a racing double construction loses to
        # setdefault and is garbage-collected
        c = make_cache(
            lambda vids: http_fetch_many(master_url, vids, collection))
        with _caches_lock:
            c = _caches.setdefault(key, c)
    return c


def http_fetch_many(master_url: str, vids: List[int],
                    collection: str = "") -> Dict[int, LookupResult]:
    """One batched ``GET /dir/lookup?volumeIds=a,b,c`` round trip.
    (``volumeIds``, not ``volumeId`` — the legacy param's comma already
    belongs to the fid grammar ``<vid>,<key><cookie>``, so a batch
    there would misparse fids whose hex happens to be all digits.)"""
    from seaweedfs_tpu_torch.util import http_client
    qs = "volumeIds=" + ",".join(str(v) for v in vids)
    if collection:
        import urllib.parse
        qs += "&collection=" + urllib.parse.quote(collection)
    r = http_client.request("GET", f"{master_url}/dir/lookup?{qs}")
    if r.status >= 300:
        # a 503 mid-leader-election is a TRANSPORT failure: raising
        # here answers waiters with the error and caches nothing —
        # swallowing it would negative-cache the whole batch as
        # not-found for negative_ttl_s after the master recovers
        raise IOError(f"lookup http {r.status} from {master_url}")
    out = json.loads(r.body)
    results: Dict[int, LookupResult] = {}
    entries = out.get("volumeIdLocations")
    if entries is None:
        if "volumeId" not in out or len(vids) > 1:
            # a top-level {"error": ...} body, or a single-vid legacy
            # answer to a MULTI-vid batch (non-batch-aware master):
            # either way we have no per-vid answers — transport-class
            # failure, cache nothing
            reason = out.get("error", "unrecognized response shape")
            raise IOError(f"lookup failed: {reason}")
        # single-vid legacy shape for the one vid we asked for
        entries = [out]
    for vl in entries:
        try:
            vid = int(str(vl.get("volumeId", "")).split(",")[0])
        except ValueError:
            continue
        if vl.get("error"):
            results[vid] = LookupResult((), vl["error"])
        else:
            results[vid] = LookupResult(tuple(
                Location(l["url"], l.get("publicUrl") or l["url"])
                for l in vl.get("locations", [])), "")
    return results


def invalidate(master_url: str, vid: int,
               reason: str = "read_failure") -> None:
    """Drop `vid` from every collection-view of `master_url`'s cache
    (read failures don't know which collection resolved the vid)."""
    with _caches_lock:
        caches = [c for (m, _coll), c in _caches.items()
                  if m == master_url]
    for c in caches:
        c.invalidate(vid, reason)


def _env_configure() -> None:
    """SEAWEED_META_LOOKUP_TTL_S arms the cache at import for spawned
    benches/tools (the SEAWEED_TRACE_SAMPLE pattern); the sibling env
    vars tune it."""
    raw = os.environ.get("SEAWEED_META_LOOKUP_TTL_S")
    if not raw:
        return
    try:
        ttl = float(raw)
    except ValueError:
        return

    # a malformed sibling tunable falls back to its default: this runs
    # at import time in every server and tool, and one typo'd env var
    # must degrade a knob, not crash the process
    def _num(name, default, cast):
        try:
            return cast(os.environ.get(name, default))
        except ValueError:
            return default

    configure(
        enable=ttl > 0, ttl_s=ttl,
        negative_ttl_s=_num("SEAWEED_META_NEGATIVE_TTL_S",
                            DEFAULT_NEGATIVE_TTL_S, float),
        coalesce_ms=_num("SEAWEED_META_COALESCE_MS",
                         DEFAULT_COALESCE_MS, float),
        batch_max=_num("SEAWEED_META_BATCH_MAX",
                       DEFAULT_BATCH_MAX, int))


_env_configure()
