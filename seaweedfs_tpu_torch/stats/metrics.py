"""Minimal Prometheus-style counters, gauges and histograms with labels.

The counterpart of ``seaweedfs_tpu.stats.metrics``: the same metric
primitives and text rendering, and the families the port's fleets and
degraded reads record into, under the same names. The HTTP exposition
server is not part of the port.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Tuple

_DEFAULT_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, double-quote
    and newline."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names: Tuple[str, ...], values: Tuple[str, ...],
                extra: str = "") -> str:
    parts = [f'{n}="{_escape_label_value(v)}"'
             for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 label_names: Iterable[str] = ()):
        self.name = name
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}  # guarded_by(self._lock)

    def labels(self, *values: str):
        values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name}: want {self.label_names}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._new_child()
                self._children[values] = child
            return child

    def remove(self, *values: str) -> bool:
        """Drop one labeled child; True when a child was present."""
        values = tuple(str(v) for v in values)
        with self._lock:
            return self._children.pop(values, None) is not None

    def _new_child(self):
        raise NotImplementedError

    def collect(self) -> str:
        raise NotImplementedError


class _CounterChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def collect(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = list(self._children.items())
        for values, child in items:
            value = child.value
            if callable(value):   # a gauge evaluated at collection time
                value = float(value())
            lines.append(f"{self.name}"
                         f"{_fmt_labels(self.label_names, values)}"
                         f" {value}")
        return "\n".join(lines)


class _GaugeChild(_CounterChild):
    def set(self, v: float) -> None:
        with self._lock:
            self.value = v

    def set_function(self, fn) -> None:
        """Evaluate ``fn()`` at collection time instead of holding a
        static value (a scan lag must keep moving between writes)."""
        with self._lock:
            self.value = fn

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Gauge(Counter):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self.labels().set(v)

    def set_function(self, fn) -> None:
        self.labels().set_function(fn)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)


class _HistogramChild:
    __slots__ = ("buckets", "counts", "total", "count", "_lock")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.total += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text, label_names=(),
                 buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(buckets)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self.labels().observe(v)

    def collect(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = list(self._children.items())
        for values, child in items:
            for b, c in zip(child.buckets, child.counts):
                le = 'le="%s"' % b
                lines.append(f"{self.name}_bucket"
                             f"{_fmt_labels(self.label_names, values, le)}"
                             f" {c}")
            le_inf = 'le="+Inf"'
            lines.append(f"{self.name}_bucket"
                         f"{_fmt_labels(self.label_names, values, le_inf)}"
                         f" {child.count}")
            lines.append(f"{self.name}_sum"
                         f"{_fmt_labels(self.label_names, values)}"
                         f" {child.total}")
            lines.append(f"{self.name}_count"
                         f"{_fmt_labels(self.label_names, values)}"
                         f" {child.count}")
        return "\n".join(lines)


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}  # guarded_by(self._lock)

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            return self._metrics.setdefault(metric.name, metric)

    def counter(self, name, help_text="", label_names=()) -> Counter:
        return self.register(Counter(name, help_text, label_names))

    def gauge(self, name, help_text="", label_names=()) -> Gauge:
        return self.register(Gauge(name, help_text, label_names))

    def histogram(self, name, help_text="", label_names=(),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_text, label_names, buckets))

    def render(self) -> str:
        """Prometheus text exposition of every registered family."""
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.collect() for m in metrics) + "\n"


REGISTRY = Registry()

# Fleet-pipeline families (ec/fleet.py): the EC scheduler's stages.
FleetStageSecondsHistogram = REGISTRY.histogram(
    "SeaweedFS_fleet_stage_seconds",
    "fleet scheduler per-stage latency", ("stage",))
FleetReaderQueueGauge = REGISTRY.gauge(
    "SeaweedFS_fleet_reader_queue_depth",
    "spans prefetched by the reader pool, not yet packed")
FleetDispatchBatchHistogram = REGISTRY.histogram(
    "SeaweedFS_fleet_dispatch_batch_spans",
    "volume spans fused into one RS dispatch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
FleetDispatchedBytesCounter = REGISTRY.counter(
    "SeaweedFS_fleet_dispatched_bytes_total",
    "data bytes through fused RS dispatches")
FleetWriterBacklogGauge = REGISTRY.gauge(
    "SeaweedFS_fleet_writer_lane_backlog",
    "writes queued on one writer lane", ("lane",))

# Unified mesh scheduler families (parallel/mesh_fleet.py): the bucket
# stream over the cards. `op` is the dispatch kind (encode | verify |
# rebuild); a fallback's `reason` is unavailable | timeout | error.
FleetMeshBucketsCounter = REGISTRY.counter(
    "SeaweedFS_fleet_mesh_buckets_total",
    "fixed-shape sharded buckets dispatched over the mesh", ("op",))
FleetMeshInflightGauge = REGISTRY.gauge(
    "SeaweedFS_fleet_mesh_inflight_buckets",
    "mesh buckets uploaded/computing, not yet retired")
FleetMeshFallbacksCounter = REGISTRY.counter(
    "SeaweedFS_fleet_mesh_fallbacks_total",
    "pod passes demoted to the per-device fleet schedulers",
    ("reason",))

# Scrub families (scrub/): the integrity scrubber's ledger. `kind` is what
# was damaged: a needle of a normal volume ("needle"), an EC data shard
# ("ec_data") or an EC parity shard ("ec_parity").
ScrubScannedBytesCounter = REGISTRY.counter(
    "SeaweedFS_scrub_scanned_bytes_total",
    "bytes read and verified by the scrub scanner")
ScrubNeedlesVerifiedCounter = REGISTRY.counter(
    "SeaweedFS_scrub_needles_verified_total",
    "needle CRCs recomputed by the scrub scanner")
ScrubStripesVerifiedCounter = REGISTRY.counter(
    "SeaweedFS_scrub_stripes_verified_total",
    "EC stripe spans re-encoded and compared against stored parity")
ScrubCorruptionsFoundCounter = REGISTRY.counter(
    "SeaweedFS_scrub_corruptions_found_total",
    "silent corruptions detected", ("kind",))
ScrubCorruptionsRepairedCounter = REGISTRY.counter(
    "SeaweedFS_scrub_corruptions_repaired_total",
    "corruptions reconstructed back to byte-identical", ("kind",))
ScrubUnrecoverableCounter = REGISTRY.counter(
    "SeaweedFS_scrub_unrecoverable_total",
    "corruptions beyond local repair (left quarantined)")
ScrubPassSecondsHistogram = REGISTRY.histogram(
    "SeaweedFS_scrub_pass_seconds",
    "wall time of one full scrub pass",
    buckets=(0.01, 0.1, 1, 10, 60, 600, 3600, 6 * 3600, 24 * 3600))
ScrubScanLagGauge = REGISTRY.gauge(
    "SeaweedFS_scrub_scan_lag_seconds",
    "seconds since the last completed scrub pass")

# Read-serving families (reads/decode_fleet.py, ec/ec_volume.py): how
# much traffic rides RS reconstruction, and how well the decode fleet
# fuses it.
ReadsDegradedCounter = REGISTRY.counter(
    "SeaweedFS_reads_degraded_total",
    "intervals served by on-the-fly RS reconstruction")
ReadsDegradedBatchHistogram = REGISTRY.histogram(
    "SeaweedFS_reads_degraded_batch_spans",
    "reconstruction spans fused into one RS decode dispatch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
ReadsDecodedBytesCounter = REGISTRY.counter(
    "SeaweedFS_reads_decoded_bytes_total",
    "bytes produced by read-path RS reconstruction")
ReadsShortShardCounter = REGISTRY.counter(
    "SeaweedFS_reads_short_shard_total",
    "local shard reads that came back short (shard truncated on disk) "
    "and fell into reconstruction", ("vid", "shard"))

# Storage families (storage/store.py collect_heartbeat): per collection,
# `type` is "volume" for the count and "normal" for the disk size.
# lint: metric-ok(reference family name predates the lowercase rule; renaming breaks dashboards)
VolumeServerVolumeCounter = REGISTRY.gauge(
    "SeaweedFS_volumeServer_volumes", "volume count", ("collection", "type"))
# lint: metric-ok(reference family name predates the lowercase rule; renaming breaks dashboards)
VolumeServerDiskSizeGauge = REGISTRY.gauge(
    "SeaweedFS_volumeServer_total_disk_size", "disk size",
    ("collection", "type"))

# Read-cache families (cache/read_cache.py): `tier` is mem | disk; an
# invalidation's `reason` is delete | overwrite | rebuild | scrub_repair.
ReadsSingleFlightWaitCounter = REGISTRY.counter(
    "SeaweedFS_reads_singleflight_waits_total",
    "reads that waited on another thread's in-flight reconstruction "
    "instead of launching their own")
CacheHitCounter = REGISTRY.counter(
    "SeaweedFS_cache_hits_total", "read cache hits", ("tier",))
CacheMissCounter = REGISTRY.counter(
    "SeaweedFS_cache_misses_total", "read cache misses (all tiers)")
CacheAdmitCounter = REGISTRY.counter(
    "SeaweedFS_cache_admitted_total", "entries admitted", ("tier",))
CacheEvictCounter = REGISTRY.counter(
    "SeaweedFS_cache_evictions_total", "entries evicted", ("tier",))
CacheInvalidateCounter = REGISTRY.counter(
    "SeaweedFS_cache_invalidations_total",
    "entries dropped by invalidation", ("reason",))
CacheBytesGauge = REGISTRY.gauge(
    "SeaweedFS_cache_bytes", "bytes resident per cache tier", ("tier",))

# Hedged-read families (resilience/hedge.py).
HedgeRequestsCounter = REGISTRY.counter(
    "SeaweedFS_hedge_requests_total",
    "hedge-eligible fetches (the budget denominator)")
HedgeIssuedCounter = REGISTRY.counter(
    "SeaweedFS_hedge_issued_total",
    "speculative second requests actually sent")
HedgeWinsCounter = REGISTRY.counter(
    "SeaweedFS_hedge_wins_total",
    "fetches where the hedge answered before the primary")
HedgeDeniedCounter = REGISTRY.counter(
    "SeaweedFS_hedge_budget_denied_total",
    "hedges withheld because the <=budget_pct extra-request cap "
    "was spent")

# Resilience family (resilience/failpoint.py).
FailpointTriggersCounter = REGISTRY.counter(
    "SeaweedFS_failpoint_triggers_total",
    "armed failpoints fired", ("site", "action"))

# Circuit breakers (resilience/breaker.py), fed by the data-plane client.
BreakerStateGauge = REGISTRY.gauge(
    "SeaweedFS_breaker_state",
    "circuit breaker state per peer (0 closed, 1 half-open, 2 open)",
    ("peer",))
BreakerTransitionsCounter = REGISTRY.counter(
    "SeaweedFS_breaker_transitions_total",
    "circuit breaker state transitions", ("peer", "to"))

# The data-plane client's connection pool (util/http_client.py).
HttpPoolIdleGauge = REGISTRY.gauge(
    "SeaweedFS_http_pool_idle_connections",
    "pooled keep-alive connections currently idle")
HttpPoolStaleRetryCounter = REGISTRY.counter(
    "SeaweedFS_http_pool_stale_retries_total",
    "requests replayed on a fresh connection after a pooled one "
    "proved stale")
HttpPoolReapedCounter = REGISTRY.counter(
    "SeaweedFS_http_pool_reaped_total",
    "pooled connections closed for exceeding the idle age cap")

# Retries (util/retry.py) and spent request budgets.
RetryAttemptsCounter = REGISTRY.counter(
    "SeaweedFS_retry_attempts_total",
    "retry attempts by outcome", ("name", "outcome"))
DeadlineRefusedCounter = REGISTRY.counter(
    "SeaweedFS_deadline_refused_total",
    "work refused because the request's budget was already spent",
    ("where",))

# The volume server's replica fan-out (server/volume.py).
IngestReplicaFanoutSecondsHistogram = REGISTRY.histogram(
    "SeaweedFS_ingest_replica_fanout_seconds",
    "wall time of one concurrent replica fan-out", ("op",))

# The client's ingest pipeline (operation/assign_lease.py): how well
# master assigns amortize over leased file ids.
IngestLeaseDepthGauge = REGISTRY.gauge(
    "SeaweedFS_ingest_lease_pool_depth",
    "leased fids banked and ready to hand out without a master trip")
IngestLeaseAssignsCounter = REGISTRY.counter(
    "SeaweedFS_ingest_lease_assigns_total",
    "count=N master assign round trips made by the lease cache")
IngestLeaseServedCounter = REGISTRY.counter(
    "SeaweedFS_ingest_lease_served_total",
    "fids served from the lease pool (master round trip avoided)")
IngestLeaseDiscardsCounter = REGISTRY.counter(
    "SeaweedFS_ingest_lease_discards_total",
    "banked leases dropped before use", ("reason",))

# The metadata plane (wdclient/lookup_cache.py): the coalescing
# vid-lookup cache's ledger. Labels are bounded enums: `outcome` in
# hit | negative_hit | miss, `reason` in read_failure | explicit.
MetaLookupCounter = REGISTRY.counter(
    "SeaweedFS_meta_lookup_total",
    "vid lookups through the coalescing cache by outcome "
    "(hit | negative_hit | miss)", ("outcome",))
MetaLookupBatchHistogram = REGISTRY.histogram(
    "SeaweedFS_meta_lookup_batch_vids",
    "vids fused into one batched master lookup round trip",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
MetaLookupWaitersCounter = REGISTRY.counter(
    "SeaweedFS_meta_lookup_singleflight_waiters_total",
    "lookups that waited on another caller's in-flight fetch "
    "instead of issuing their own")
MetaLookupInvalidationsCounter = REGISTRY.counter(
    "SeaweedFS_meta_lookup_invalidations_total",
    "cached vid answers dropped by reason", ("reason",))

# The master client (wdclient/masterclient.py).
MasterReconnectsCounter = REGISTRY.counter(
    "SeaweedFS_master_reconnects_total",
    "master client stream redials after a break")

# Errors absorbed on purpose by a broad handler that must keep running.
SwallowedErrorsCounter = REGISTRY.counter(
    "SeaweedFS_swallowed_errors_total",
    "errors absorbed by intentional broad except handlers", ("site",))


def swallowed(site: str) -> None:
    """Count one error a named handler absorbed on purpose."""
    SwallowedErrorsCounter.labels(site).inc()
