"""Minimal Prometheus client: counters, gauges and histograms with
labels, and their text exposition over HTTP (reference
weed/stats/metrics.go:21-182).

The counterpart of ``seaweedfs_tpu.stats.metrics``: the same metric
primitives and text rendering, the same family names, the shared request
instrumentation of every server role's HTTP and RPC planes
(``instrument_http_handler``, ``instrument_grpc_method``), the
``-metricsPort`` listener (``start_metrics_server``: /metrics, /healthz,
/debug/trace, /debug/requests, /debug/failpoint) and the push-gateway
loop.
"""

from __future__ import annotations

import os
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Dict, Iterable, Optional, Tuple

from seaweedfs_tpu_torch.util.http_server import TrackingHTTPServer

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

    def collect(self, openmetrics: bool = False) -> str:
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

    def collect(self, openmetrics: bool = False) -> str:
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
    __slots__ = ("buckets", "counts", "total", "count", "_lock",
                 "exemplars")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0.0
        self.count = 0
        self._lock = threading.Lock()
        # bucket index -> (trace_id_hex, value, unix_ts): the last
        # sampled observation that landed in that bucket. None until
        # cluster tracing records one, so the exemplar-free exposition
        # is byte-identical to the plain format.
        self.exemplars: Optional[Dict[int, tuple]] = None

    def observe(self, v: float) -> None:
        with self._lock:
            self.total += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1

    def observe_exemplar(self, v: float, trace_id: str) -> None:
        """observe() plus an OpenMetrics exemplar linking the bucket
        this value landed in to the trace id (the /metrics ->
        cluster.trace pivot)."""
        with self._lock:
            self.total += v
            self.count += 1
            hit = None
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    if hit is None:
                        hit = i
            if self.exemplars is None:
                self.exemplars = {}
            self.exemplars[len(self.buckets) if hit is None else hit] = \
                (trace_id, v, time.time())


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

    def collect(self, openmetrics: bool = False) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            items = list(self._children.items())
        for values, child in items:
            # exemplars are ONLY legal in the OpenMetrics exposition: a
            # classic text-format (0.0.4) parser hits the '#' after the
            # value and fails the whole scrape
            ex = child.exemplars if openmetrics else None
            for i, (b, c) in enumerate(zip(child.buckets, child.counts)):
                le = 'le="%s"' % b
                line = (f"{self.name}_bucket"
                        f"{_fmt_labels(self.label_names, values, le)}"
                        f" {c}")
                if ex and i in ex:
                    tid, v, ts = ex[i]
                    line += (f' # {{trace_id="{tid}"}} {v:.6f} '
                             f"{ts:.3f}")
                lines.append(line)
            le_inf = 'le="+Inf"'
            line = (f"{self.name}_bucket"
                    f"{_fmt_labels(self.label_names, values, le_inf)}"
                    f" {child.count}")
            if ex and len(child.buckets) in ex:
                tid, v, ts = ex[len(child.buckets)]
                line += f' # {{trace_id="{tid}"}} {v:.6f} {ts:.3f}'
            lines.append(line)
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

    def render(self, openmetrics: bool = False) -> str:
        """Text exposition of every registered family. ``openmetrics``
        adds the exemplar suffixes (classic 0.0.4 parsers reject
        them)."""
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.collect(openmetrics) for m in metrics) + "\n"


REGISTRY = Registry()

# The reference's request families (stats/metrics.go:21-127), shared by
# every server role in the process: `type` is the role, `name` the HTTP
# verb or the RPC method.
RequestCounter = REGISTRY.counter(
    "SeaweedFS_request_total", "number of requests", ("type", "name"))
RequestHistogram = REGISTRY.histogram(
    "SeaweedFS_request_seconds", "request latency", ("type", "name"))
MetricsPushErrorCounter = REGISTRY.counter(
    "SeaweedFS_metrics_push_errors_total",
    "failed pushes to the metrics gateway")

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

# Codec families (ops/rs_code.py): the host <-> card copies of every
# GF(2^8) map the "cuda" codec queues. The port's own: the JAX codec
# has no host staging to count.
CodecH2DBytesCounter = REGISTRY.counter(
    "SeaweedFS_codec_h2d_bytes_total",
    "shard bytes the cuda codec copied host to card, one input per "
    "queued map (matrix table uploads not counted)")
CodecD2HBytesCounter = REGISTRY.counter(
    "SeaweedFS_codec_d2h_bytes_total",
    "bytes the cuda codec copied card to host, one output per queued "
    "map (matrix table uploads not counted)")
CodecHostCopyBytesCounter = REGISTRY.counter(
    "SeaweedFS_codec_host_copy_bytes_total",
    "bytes the cuda codec copied on the host before their H2D: the "
    "pinned staging of pageable inputs")

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

# The filer's multi-chunk ingest pipeline (server/filer.py).
IngestPipelineChunksHistogram = REGISTRY.histogram(
    "SeaweedFS_ingest_pipeline_batch_chunks",
    "chunks per pipelined multi-chunk upload",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))
IngestPipelineOccupancyGauge = REGISTRY.gauge(
    "SeaweedFS_ingest_pipeline_occupancy",
    "chunk uploads in flight on the filer's ingest pool")

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

# The filer's directory-listing cache (filer/listing_cache.py).
MetaListingCounter = REGISTRY.counter(
    "SeaweedFS_meta_listing_total",
    "filer directory-listing pages by cache outcome (hit | miss)",
    ("outcome",))
MetaListingInvalidationsCounter = REGISTRY.counter(
    "SeaweedFS_meta_listing_invalidations_total",
    "listing-cache pages dropped by the metadata event log "
    "(reason: local | peer)", ("reason",))

# The master client (wdclient/masterclient.py).
MasterReconnectsCounter = REGISTRY.counter(
    "SeaweedFS_master_reconnects_total",
    "master client stream redials after a break")

# Errors absorbed on purpose by a broad handler that must keep running.
SwallowedErrorsCounter = REGISTRY.counter(
    "SeaweedFS_swallowed_errors_total",
    "errors absorbed by intentional broad except handlers", ("site",))

# Runtime concurrency sanitizer (util/sanitizer.py, SEAWEED_SANITIZE):
# `kind` is "cycle" (lock-order cycle = potential deadlock) or "hold"
# (lock held past the watchdog threshold).
SanitizerFindingsCounter = REGISTRY.counter(
    "SeaweedFS_sanitizer_findings_total",
    "concurrency sanitizer findings", ("kind",))


def swallowed(site: str) -> None:
    """Count one error a named handler absorbed on purpose."""
    SwallowedErrorsCounter.labels(site).inc()


# Async serving core families (util/async_server.py, -serve.async): how
# many sockets the selector loop holds, how much GET payload leaves
# through zero-copy sendfile, and what backpressure sheds. `kind` is
# bounded: accept (listener paused at -serve.maxConns) | keepalive (idle
# LRU closed over -serve.keepAliveBudget) | qos (a tenant refused at
# frame time).
ServeConnectionsGauge = REGISTRY.gauge(
    "SeaweedFS_serve_open_connections",
    "sockets held open by the async serving core", ("role",))
ServeSendfileBytesCounter = REGISTRY.counter(
    "SeaweedFS_serve_sendfile_bytes_total",
    "GET payload bytes sent zero-copy via os.sendfile", ("role",))
ServeShedCounter = REGISTRY.counter(
    "SeaweedFS_serve_shed_total",
    "connections shed by the async core's backpressure",
    ("role", "kind"))

# Multi-tenant QoS families (qos/, -qos.*). `tenant` cardinality is
# bounded by -qos.maxTenants: past the cap every new name charges (and
# labels as) the shared "_other" tenant. `reason` is bounded: requests |
# bytes | global | conns. `kind` is bounded: requests | bytes.
QosAdmittedCounter = REGISTRY.counter(
    "SeaweedFS_qos_admitted_total",
    "requests admitted by QoS admission control", ("tenant",))
QosShedCounter = REGISTRY.counter(
    "SeaweedFS_qos_shed_total",
    "requests and connections shed by QoS admission control",
    ("tenant", "reason"))
QosQueuedSecondsHistogram = REGISTRY.histogram(
    "SeaweedFS_qos_queued_seconds",
    "time tasks waited in the weighted-fair pool queues", ("tenant",),
    buckets=(.0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5,
             1.0, 2.5))
QosTokensGauge = REGISTRY.gauge(
    "SeaweedFS_qos_tokens",
    "current admission bucket credit per tenant",
    ("tenant", "kind"))
QosTenantsGauge = REGISTRY.gauge(
    "SeaweedFS_qos_tenants",
    "tenants tracked by the QoS manager")

# Cluster-trace families (stats/cluster_trace.py): the tail sampler's
# ledger and the flight recorder's live-table depth.
TraceRequestsCounter = REGISTRY.counter(
    "SeaweedFS_trace_requests_total",
    "traced requests by sampling outcome "
    "(slow | error | sample | drop)", ("outcome",))
TraceLiveGauge = REGISTRY.gauge(
    "SeaweedFS_trace_live_requests",
    "in-flight traced requests (the /debug/requests table depth)")

# Span tracer (stats/trace.py): spans the bounded ring pushed out. The
# port's own, like the codec families.
TraceSpansDroppedCounter = REGISTRY.counter(
    "SeaweedFS_trace_spans_dropped_total",
    "oldest spans dropped from the full trace ring")

# Heat telemetry (stats/heat.py): read-path access rate per volume, the
# measurement half of the heat-driven lifecycle.
VolumeHeatGauge = REGISTRY.gauge(
    "SeaweedFS_volume_heat",
    "reads of this volume within the sliding heat window", ("vid",))

# Heat-driven lifecycle families (lifecycle/): what the policy engine
# decided, what it moved, and where every volume sits in the
# hot/warm/cold lattice. The cluster heat gauge is the master-side
# aggregate of every volume server's heartbeat-carried heat summary.
ClusterVolumeHeatGauge = REGISTRY.gauge(
    "SeaweedFS_cluster_volume_heat",
    "cluster-wide reads of this volume within the heat window "
    "(summed over the heartbeat heat map)", ("vid",))
LifecycleTransitionsCounter = REGISTRY.counter(
    "SeaweedFS_lifecycle_transitions_total",
    "lifecycle transitions by kind (encode | decode | offload | "
    "download) and outcome (ok | error | dry_run)", ("kind", "outcome"))
LifecycleQueueDepthGauge = REGISTRY.gauge(
    "SeaweedFS_lifecycle_queue_depth",
    "transitions planned or forced but not yet executed")
LifecycleBytesMovedCounter = REGISTRY.counter(
    "SeaweedFS_lifecycle_bytes_moved_total",
    "volume bytes moved across tiers by the policy engine", ("kind",))
LifecycleVolumeStatesGauge = REGISTRY.gauge(
    "SeaweedFS_lifecycle_volume_states",
    "volumes currently tracked in each lifecycle state", ("state",))
LifecyclePassSecondsHistogram = REGISTRY.histogram(
    "SeaweedFS_lifecycle_pass_seconds",
    "wall time of one policy pass including executed transitions",
    buckets=(0.001, 0.01, 0.1, 1, 10, 60, 600, 3600))

# Process self-telemetry: evaluated at scrape time only (callable
# gauges).
ProcessRSSGauge = REGISTRY.gauge(
    "SeaweedFS_process_resident_memory_bytes",
    "resident set size of this process")
ProcessFdsGauge = REGISTRY.gauge(
    "SeaweedFS_process_open_fds", "open file descriptors")
ProcessThreadsGauge = REGISTRY.gauge(
    "SeaweedFS_process_threads", "live python threads")
ProcessGcCollectionsGauge = REGISTRY.gauge(
    "SeaweedFS_process_gc_collections",
    "cumulative garbage collections across all generations")


def _rss_bytes() -> float:
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE")
                                               if hasattr(os, "sysconf")
                                               else 4096)
    except (OSError, ValueError, IndexError):
        return 0.0


def _open_fds() -> float:
    try:
        return float(len(os.listdir("/proc/self/fd")))
    except OSError:
        return 0.0


def _gc_collections() -> float:
    import gc
    return float(sum(s.get("collections", 0) for s in gc.get_stats()))


def _register_process_metrics() -> None:
    ProcessRSSGauge.set_function(_rss_bytes)
    ProcessFdsGauge.set_function(_open_fds)
    ProcessThreadsGauge.set_function(lambda: float(threading.active_count()))
    ProcessGcCollectionsGauge.set_function(_gc_collections)


_register_process_metrics()


# -- shared request instrumentation -------------------------------------------
#
# Every server role wires RequestCounter/RequestHistogram (and, when
# tracing is on, a span per request) through these two wrappers instead
# of hand-rolling per-handler timing. Labeled children are resolved once
# at wrap time: labels() takes a lock per call.

# QoS admission seam: qos.configure() installs its manager here (and
# tears it out on reset()). The wrappers below are also the QoS ingress
# of every enforced role; None (the default) keeps both request paths
# one identity check away from unchanged.
_qos_http = None

# the roles whose ingress enforces admission: the volume server, the
# filer and the S3 gateway are the tenant-facing planes; master and
# WebDAV traffic is observed but never shed
_QOS_ROLES = ("volumeServer", "filer", "s3")


def instrument_http_handler(handler_cls, role: str):
    """Wrap every do_* verb method of a BaseHTTPRequestHandler subclass
    with the request counter + latency histogram (+ a trace span when
    tracing is on). Wraps the do_* dispatch, not handle_one_request, so
    keep-alive idle time between requests is never measured as request
    latency. Returns the class for chaining.

    Also the single deadline AND trace-context ingress point for HTTP:
    a request carrying X-Seaweed-Deadline has its remaining budget
    re-anchored into the handler thread's contextvar, and (when cluster
    tracing is on) X-Seaweed-Trace re-anchors the trace context the
    same way, so every outbound hop the handler makes inherits both."""
    from seaweedfs_tpu_torch.qos import tenant as qos_tenant
    from seaweedfs_tpu_torch.resilience import deadline as deadline_mod
    from seaweedfs_tpu_torch.stats import cluster_trace, trace
    qos_enforced = role in _QOS_ROLES

    if not getattr(handler_cls, "_status_hooked", False):
        # record the last status code sent, so the tail sampler keeps
        # 5xx requests that answered instead of raising (fast_reply sets
        # last_status itself)
        handler_cls._status_hooked = True
        orig_send = handler_cls.send_response

        def send_response(self, code, *a):
            self.last_status = code
            return orig_send(self, code, *a)
        handler_cls.send_response = send_response

    def _wrap(methname):
        orig = getattr(handler_cls, methname)
        verb = methname[3:].lower()
        counter = RequestCounter.labels(role, verb)
        histogram = RequestHistogram.labels(role, verb)
        span_name = f"http.{role}.{verb}"

        def wrapped(self):
            t0 = time.perf_counter()
            qtok = None
            if qos_enforced and _qos_http is not None:
                # admission BEFORE any per-request machinery: a shed
                # request writes its 429 + Retry-After and costs only
                # the counter/histogram observation below
                qtok = _qos_http.http_enter(self, role)
                if qtok is None:
                    counter.inc()
                    histogram.observe(time.perf_counter() - t0)
                    return
            token = None
            hdr = self.headers.get(deadline_mod.HEADER_LOWER)
            if hdr is not None:
                rem = deadline_mod.parse_header(hdr)
                if rem is not None:
                    token = deadline_mod.set_budget(rem)
            ct = None
            if cluster_trace._enabled:
                self.last_status = 0
                ct = cluster_trace.begin(
                    role, verb, self.path,
                    self.headers.get(cluster_trace.HEADER_LOWER),
                    peer=self.client_address[0],
                    server="%s:%d" % self.server.server_address[:2])
            sp = trace.span(span_name, path=self.path) \
                if trace.is_enabled() else trace.NOOP
            sp.__enter__()
            exc = None
            try:
                orig(self)
            except BaseException as e:
                exc = e
                raise
            finally:
                sp.__exit__(None, None, None)
                if qtok is not None:
                    qos_tenant.current.reset(qtok)
                if token is not None:
                    deadline_mod.reset(token)
                counter.inc()
                dur = time.perf_counter() - t0
                if ct is not None:
                    kept = cluster_trace.finish(
                        ct, exc, getattr(self, "last_status", 0))
                    if kept is not None:
                        histogram.observe_exemplar(dur, kept)
                    else:
                        histogram.observe(dur)
                else:
                    histogram.observe(dur)
        wrapped.__name__ = methname
        return wrapped

    for methname in [m for m in dir(handler_cls) if m.startswith("do_")]:
        setattr(handler_cls, methname, _wrap(methname))
    return handler_cls


def instrument_grpc_method(fn, role: str, method_name: str,
                           server_streaming: bool = False,
                           server: str = "",
                           client_streaming: bool = False):
    """Wrap one RPC servicer method with the request counter + latency
    histogram (+ trace span). rpc.generic_handler wraps every method of
    every service a server registers through this one point.

    Server-streaming methods count at stream START and get no latency
    histogram or span: streams can live for the process lifetime
    (SendHeartbeat, KeepConnected), so an end-of-stream observation
    would report nothing while the cluster runs and then poison
    _sum/_count with one hours-long sample at shutdown.

    Unary methods are also the deadline AND trace-context ingress point
    for RPC: the caller's deadline (context.time_remaining()) re-anchors
    into the handler thread's contextvar, and the x-seaweed-trace
    metadata key re-anchors the cluster-trace context. A server stream
    answering ONE request (a shard read, a file copy) is traced too
    when its caller was, so a remote shard fetch stitches under the
    read that made it; a client-streaming call (the heartbeat, the
    location feed) never is. (The JAX package traces no stream.)"""
    from seaweedfs_tpu_torch.qos import tenant as qos_tenant
    from seaweedfs_tpu_torch.resilience import deadline as deadline_mod
    from seaweedfs_tpu_torch.stats import cluster_trace, trace
    qos_enforced = role in _QOS_ROLES
    counter = RequestCounter.labels(role, method_name)
    histogram = RequestHistogram.labels(role, method_name)
    span_name = f"grpc.{role}.{method_name}"

    if server_streaming:
        traceable = not client_streaming

        def wrapped(request, context):
            counter.inc()
            ct = None
            if traceable and cluster_trace._enabled:
                hdr = None
                for k, v in context.invocation_metadata():
                    if k == cluster_trace.GRPC_KEY:
                        hdr = v
                        break
                if hdr is not None:
                    ct = cluster_trace.begin(role, method_name,
                                             f"grpc/{method_name}", hdr,
                                             peer=context.peer(),
                                             server=server)
            if ct is None:
                yield from fn(request, context)
                return
            exc = None
            try:
                yield from fn(request, context)
            except BaseException as e:
                exc = e
                raise
            finally:
                cluster_trace.finish(ct, exc)
    else:
        def wrapped(request, context):
            qtok = None
            if qos_enforced and _qos_http is not None:
                # shed aborts the call with RESOURCE_EXHAUSTED (abort
                # raises, so nothing below runs for a shed request)
                qtok = _qos_http.grpc_enter(context)
            t0 = time.perf_counter()
            token = None
            rem = context.time_remaining()
            if rem is not None:
                token = deadline_mod.set_budget(rem)
            ct = None
            if cluster_trace._enabled:
                hdr = None
                for k, v in context.invocation_metadata():
                    if k == cluster_trace.GRPC_KEY:
                        hdr = v
                        break
                ct = cluster_trace.begin(role, method_name,
                                         f"grpc/{method_name}", hdr,
                                         peer=context.peer(),
                                         server=server)
            sp = trace.span(span_name) if trace.is_enabled() else trace.NOOP
            sp.__enter__()
            exc = None
            try:
                return fn(request, context)
            except BaseException as e:
                exc = e
                raise
            finally:
                sp.__exit__(None, None, None)
                if qtok is not None:
                    qos_tenant.current.reset(qtok)
                if token is not None:
                    deadline_mod.reset(token)
                counter.inc()
                dur = time.perf_counter() - t0
                if ct is not None:
                    kept = cluster_trace.finish(ct, exc)
                    if kept is not None:
                        histogram.observe_exemplar(dur, kept)
                    else:
                        histogram.observe(dur)
                else:
                    histogram.observe(dur)
    wrapped.__name__ = method_name
    return wrapped


def start_metrics_server(port: int, registry: Registry = REGISTRY,
                         ip: str = "",
                         role: str = "") -> TrackingHTTPServer:
    """Serve GET /metrics (Prometheus text), GET /healthz (role + uptime
    JSON), GET /debug/trace (Chrome trace-event JSON of the span ring;
    ?trace_id=<hex> switches to the cluster collector answering one
    trace's spans, ?sampled=1 lists kept traces), GET /debug/requests
    (the flight recorder's live request table) and GET|POST
    /debug/failpoint (GET lists the armed table, POST arms/disarms when
    SEAWEED_FAILPOINTS opted the process in). Any other path is 404;
    other methods get the stock 501. Port 0 binds a free port
    (``server_address[1]``)."""
    import json as _json
    from urllib.parse import parse_qs as _parse_qs

    from seaweedfs_tpu_torch.resilience import failpoint
    from seaweedfs_tpu_torch.stats import cluster_trace, trace

    started = time.time()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path, _, query = self.path.partition("?")
            params = _parse_qs(query) if query else {}
            if path == "/metrics":
                # exemplar suffixes only on the EXPLICIT ?exemplars=1
                # opt-in, never by content negotiation: the default
                # render stays plain 0.0.4 text
                om = bool(params.get("exemplars", [""])[0])
                body = registry.render(openmetrics=om).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/healthz":
                body = _json.dumps({
                    "role": role or "unknown",
                    "uptime_seconds": round(time.time() - started, 3),
                }).encode()
                ctype = "application/json"
            elif path == "/debug/trace":
                if params.get("trace_id", [""])[0] or \
                        params.get("sampled", [""])[0]:
                    body = _json.dumps(cluster_trace.debug_payload(
                        self.path, role or "unknown", "")).encode()
                else:
                    # bare /debug/trace: the Chrome trace JSON of the
                    # local span ring
                    body = trace.chrome_trace_json().encode()
                ctype = "application/json"
            elif path == "/debug/requests":
                body = _json.dumps(cluster_trace.debug_payload(
                    self.path, role or "unknown", "")).encode()
                ctype = "application/json"
            elif path == "/debug/failpoint":
                body = _json.dumps(failpoint.active()).encode()
                ctype = "application/json"
            else:
                self._answer(404, {"error": "not found"})
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            path = self.path.partition("?")[0]
            if path != "/debug/failpoint":
                self._answer(404, {"error": "not found"})
                return
            if not failpoint.http_control_enabled():
                # fault injection over the network needs the process's
                # explicit opt-in (SEAWEED_FAILPOINTS, even just "on")
                self._answer(403, {"error":
                                   "failpoint control disabled; set "
                                   "SEAWEED_FAILPOINTS to enable"})
                return
            try:
                n = int(self.headers.get("Content-Length") or 0)
                req = _json.loads(self.rfile.read(n) or b"{}")
                action = req.get("action", "")
                if action == "reset":
                    failpoint.disarm()
                elif action == "off":
                    failpoint.disarm(req["site"])
                else:
                    failpoint.arm(
                        req["site"], action,
                        arg=float(req.get("arg", 0.0)),
                        p=float(req.get("p", 1.0)),
                        count=req.get("count"),
                        match=req.get("match"))
            except (KeyError, TypeError, ValueError) as e:
                self._answer(400, {"error": str(e)})
                return
            self._answer(200, failpoint.active())

        def _answer(self, code: int, payload) -> None:
            body = _json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    srv = TrackingHTTPServer((ip, port), Handler)
    # lint: thread-ok(metrics listener daemon; no request context)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name=f"metrics-{port}").start()
    return srv


def loop_pushing_metric(name: str, instance: str, addr: str,
                        interval_seconds: float,
                        registry: Registry = REGISTRY,
                        stop_event: Optional[threading.Event] = None
                        ) -> threading.Thread:
    """Push-gateway loop (reference stats/metrics.go:149).

    Push failures are counted (SeaweedFS_metrics_push_errors_total) and
    logged once per state TRANSITION (ok->failing, failing->ok), never
    per attempt: a down gateway must not log every interval forever."""
    from seaweedfs_tpu_torch.util import wlog
    log = wlog.logger("metrics")
    url = f"http://{addr}/metrics/job/{name}/instance/{instance}"

    def loop():
        failing = False
        while not (stop_event and stop_event.is_set()):
            try:
                req = urllib.request.Request(
                    url, data=registry.render().encode(), method="PUT")
                urllib.request.urlopen(req, timeout=5).close()
                if failing:
                    failing = False
                    log.info("metrics push to %s recovered", addr)
            except OSError as e:
                MetricsPushErrorCounter.inc()
                if not failing:
                    failing = True
                    log.warning("metrics push to %s failing: %s", addr, e)
            if stop_event:
                if stop_event.wait(interval_seconds):
                    break
            else:
                time.sleep(interval_seconds)

    # lint: thread-ok(push-gateway daemon; no request context)
    t = threading.Thread(target=loop, daemon=True, name="metrics-push")
    t.start()
    return t
