"""Server subcommands: master, volume, filer and server (all three in one
process).

Flag names and defaults follow the JAX package's command layer
(``seaweedfs_tpu/command/servers.py``, itself the reference's
weed/command/master.go:29-46, volume.go:65-90, filer.go:43-67 and
server.go) for the flags the port carries. ``-ec.encoder`` takes
``cuda`` (the default) or ``cpu``; any other name is refused. Each
subcommand blocks until SIGINT or SIGTERM, then stops its servers, and
``master``, ``volume`` and ``server`` take ``-cpuprofile`` (a cProfile
dump written at the stop, ``util/grace.py``).

The filer keeps the JAX package's ``-store`` names: ``memory``,
``sqlite`` (the default), ``weedkv``, ``mysql`` and ``postgres`` run;
the networked stores, ``s3``, ``webdav``, ``ftp``, ``server -s3`` and a
``notification.toml`` that enables a queue answer with an error naming
their ROADMAP item (``unported.py``).

Both read security.toml first (``_setup_tls``): with its ``[grpc.ca]``
and ``[grpc.master]``/``[grpc.volume]`` sections the server's RPC plane
runs mutual TLS, and a certificate that does not load ends the start.

Both read master.toml (``util/config.py``: the working directory, then
``$HOME/.seaweedfs``): the master its ``master.maintenance.scripts``,
``sleep_minutes`` and ``[master.sequencer]``, the volume server its
``[storage.backend.<scheme>.<id>]`` tier targets. ``master -peers`` names
every master of a raft set (an even count is warned about: it can split
its votes); ``volume -mserver`` may name all of them.

Observability and policy, each off unless its flag is given: both take
``-metricsPort`` (a Prometheus ``/metrics`` listener, with ``/healthz``
and ``/debug/*``), ``-trace.sample``/``-trace.slowMs`` (cluster tracing)
and ``-qos`` with its ``-qos.*`` knobs (per-tenant admission and fair
queues); the volume server takes ``-heat.track``/``-heat.windowSeconds``
and the master ``-lifecycle`` with its ``-lifecycle.*`` knobs.

Both take the ``-serve.*`` flags: ``-serve.async`` serves HTTP on the
selector loop of ``util/async_server.py`` (``-serve.maxConns``,
``-serve.keepAliveBudget``, ``-serve.workers``; the volume server's GETs
ride ``os.sendfile`` unless ``-serve.sendfile false``). Off by default:
the threaded model serves and the async module is never imported.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
from typing import List

from seaweedfs_tpu_torch import unported
from seaweedfs_tpu_torch.command import command
from seaweedfs_tpu_torch.util import grace, wlog

log = wlog.logger("command")


def _setup_tls(role: str) -> None:
    """Mutual TLS when security.toml carries [grpc.*] sections (reference
    security/tls.go; plaintext without them)."""
    from seaweedfs_tpu_torch.command import setup_client_tls
    setup_client_tls(role)


def _maybe_start_metrics(opts, role: str = ""):
    """Expose Prometheus text metrics on -metricsPort (reference
    stats/metrics.go:172 StartMetricsServer; one shared registry per
    process), plus /healthz and /debug/*. None without the flag."""
    port = getattr(opts, "metrics_port", 0)
    if not port:
        return None
    from seaweedfs_tpu_torch.stats.metrics import start_metrics_server
    srv = start_metrics_server(port, role=role)
    log.info("metrics exposed on :%d/metrics", port)
    return srv


def _serve_with_metrics(server, opts, role: str) -> int:
    srv = _maybe_start_metrics(opts, role=role)
    try:
        return _serve_until_signalled(server)
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()


def _serve_until_signalled(server) -> int:
    return _serve_all_until_signalled([server])


def _serve_all_until_signalled(servers, started: int = 0) -> int:
    """Start ``servers[started:]``, block until SIGINT or SIGTERM, then
    stop every server (the last started first) and write the
    -cpuprofile dump (``grace.stop_profiling``)."""
    done = threading.Event()

    def _stop(signum, frame):  # noqa: ARG001
        done.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _stop)
    try:
        for server in servers[started:]:
            server.start()
        while not done.wait(timeout=0.5):
            pass
    finally:
        for server in reversed(servers):
            server.stop()
        grace.stop_profiling()
    return 0


def _split_dirs(dir_flag: str) -> List[str]:
    dirs = [d.strip() for d in dir_flag.split(",") if d.strip()]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    return dirs


def _master_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="master", description="start a master")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9333)
    p.add_argument("-mdir", default=None,
                   help="data directory for sequence/raft state")
    p.add_argument("-volumeSizeLimitMB", dest="volume_size_limit_mb",
                   type=int, default=30 * 1000)
    p.add_argument("-defaultReplication", dest="default_replication",
                   default="000",
                   help="replica placement of an assign or grow that "
                        "names none (xyz: other DCs, other racks, same "
                        "rack)")
    p.add_argument("-pulseSeconds", dest="pulse_seconds", type=float,
                   default=5.0)
    p.add_argument("-peers", default="",
                   help="comma-separated ip:port of ALL masters "
                        "(including this one) for raft HA")
    p.add_argument("-garbageThreshold", dest="garbage_threshold",
                   type=float, default=0.3,
                   help="vacuum volumes whose garbage ratio reaches this")
    p.add_argument("-scrub.intervalSeconds", dest="scrub_interval_s",
                   type=float, default=0.0,
                   help="open one scrub pass per volume server every "
                        "N seconds, staggered across the servers "
                        "(0 = disabled)")
    p.add_argument("-scrubMBps", dest="scrub_throttle_mbps", type=float,
                   default=0.0,
                   help="IO budget handed to each scheduled scrub")
    _add_lifecycle_args(p)
    _add_cpuprofile_arg(p)
    p.add_argument("-metricsPort", dest="metrics_port", type=int,
                   default=0, help="Prometheus /metrics pull port")
    _add_serve_args(p)
    _add_trace_args(p)
    _add_qos_args(p)
    return p


def _add_cpuprofile_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("-cpuprofile", default=None,
                   help="write a cProfile dump of the whole run to this "
                        "file when the server stops (read it with "
                        "python -m pstats)")


def _add_serve_args(p: argparse.ArgumentParser) -> None:
    """Shared -serve.* flags (util/async_server.py). Off by default: the
    threaded model serves and no async machinery is made."""
    p.add_argument("-serve.async", dest="serve_async",
                   action="store_true",
                   help="serve HTTP on the selector event loop (one "
                        "poll loop + a bounded worker pool) instead "
                        "of a thread per connection; responses are "
                        "byte-identical, GET payloads ride zero-copy "
                        "os.sendfile")
    p.add_argument("-serve.maxConns", dest="serve_max_conns",
                   type=int, default=0,
                   help="open-connection cap for -serve.async; past "
                        "it the listener stops accepting until "
                        "connections close (0 = built-in 4096)")
    p.add_argument("-serve.keepAliveBudget",
                   dest="serve_keepalive_budget", type=int, default=0,
                   help="idle keep-alive connections retained by "
                        "-serve.async; past it the least-recently-"
                        "active idle connection is closed (0 = "
                        "built-in 1024)")
    p.add_argument("-serve.workers", dest="serve_workers", type=int,
                   default=0,
                   help="handler worker threads for -serve.async "
                        "(spawned lazily on the first requests; 0 = "
                        "built-in 16)")
    p.add_argument("-serve.sendfile", dest="serve_sendfile",
                   type=lambda s: s.lower() not in ("0", "false", "no"),
                   default=True,
                   help="zero-copy GET payloads via os.sendfile under "
                        "-serve.async (false = copy through userspace)")


def _serve_config(opts):
    """The ServeConfig of the -serve.* flags (the threaded default
    without -serve.async)."""
    from seaweedfs_tpu_torch.util.http_server import ServeConfig
    return ServeConfig(
        async_mode=opts.serve_async,
        max_conns=opts.serve_max_conns,
        keepalive_budget=opts.serve_keepalive_budget,
        workers=opts.serve_workers,
        sendfile=opts.serve_sendfile)


def _add_lifecycle_args(p: argparse.ArgumentParser) -> None:
    """Master-only -lifecycle.* flags (lifecycle/): the heat-driven
    policy engine that EC-encodes cold volumes on the card, un-cools
    re-heated ones, and tier-offloads frozen ones. Off by default: a
    master without -lifecycle constructs no engine at all."""
    p.add_argument("-lifecycle", dest="lifecycle", action="store_true",
                   help="enable the heat-driven lifecycle policy "
                        "engine (leader-only; needs volume servers "
                        "running -heat.track)")
    p.add_argument("-lifecycle.dryRun", dest="lifecycle_dry_run",
                   action="store_true",
                   help="log and ledger every decision WITHOUT acting "
                        "— run this first on any real cluster")
    p.add_argument("-lifecycle.intervalSeconds",
                   dest="lifecycle_interval_s", type=float, default=60.0,
                   help="policy pass cadence")
    p.add_argument("-lifecycle.coolThreshold",
                   dest="lifecycle_cool_threshold", type=float,
                   default=0.0,
                   help="window reads at or below this (AND a matching "
                        "EWMA) make a volume a cool-down candidate")
    p.add_argument("-lifecycle.warmThreshold",
                   dest="lifecycle_warm_threshold", type=float,
                   default=50.0,
                   help="window reads at or above this heat a volume "
                        "back up (must exceed coolThreshold — the gap "
                        "is the hysteresis band)")
    p.add_argument("-lifecycle.hotDwellSeconds",
                   dest="lifecycle_hot_dwell_s", type=float,
                   default=600.0,
                   help="minimum residence in HOT before an encode "
                        "(also the write-quiet guard)")
    p.add_argument("-lifecycle.warmDwellSeconds",
                   dest="lifecycle_warm_dwell_s", type=float,
                   default=600.0,
                   help="minimum residence in WARM before any move")
    p.add_argument("-lifecycle.coldDwellSeconds",
                   dest="lifecycle_cold_dwell_s", type=float,
                   default=3600.0,
                   help="minimum residence in COLD before a download")
    p.add_argument("-lifecycle.freezeSeconds",
                   dest="lifecycle_freeze_s", type=float, default=0.0,
                   help="WARM volumes idle this long offload to the "
                        "cold backend (0 = never freeze)")
    p.add_argument("-lifecycle.coldBackend",
                   dest="lifecycle_cold_backend", default="",
                   help="storage backend for the COLD tier, e.g. "
                        "memory.cold (empty = COLD disabled)")
    p.add_argument("-lifecycle.maxInflight",
                   dest="lifecycle_max_inflight", type=int, default=2,
                   help="cluster-wide cap on transitions in motion "
                        "per pass")
    p.add_argument("-lifecycle.throttleMBps",
                   dest="lifecycle_throttle_mbps", type=float,
                   default=0.0,
                   help="byte budget pacing transition admission "
                        "(0 = unthrottled)")


def _lifecycle_config(opts):
    if not getattr(opts, "lifecycle", False):
        return None
    from seaweedfs_tpu_torch.lifecycle import LifecycleConfig
    return LifecycleConfig(
        dry_run=opts.lifecycle_dry_run,
        interval_s=opts.lifecycle_interval_s,
        cool_threshold=opts.lifecycle_cool_threshold,
        warm_threshold=opts.lifecycle_warm_threshold,
        hot_dwell_s=opts.lifecycle_hot_dwell_s,
        warm_dwell_s=opts.lifecycle_warm_dwell_s,
        cold_dwell_s=opts.lifecycle_cold_dwell_s,
        freeze_s=opts.lifecycle_freeze_s,
        cold_backend=opts.lifecycle_cold_backend,
        max_inflight=opts.lifecycle_max_inflight,
        throttle_mbps=opts.lifecycle_throttle_mbps)


def _add_trace_args(p: argparse.ArgumentParser) -> None:
    """Shared -trace.* flags (see stats/cluster_trace.py). Off by
    default: the cluster tracer costs one flag check per seam until
    enabled."""
    p.add_argument("-trace.sample", dest="trace_sample", type=float,
                   default=-1.0,
                   help="enable cluster tracing; head-sample this "
                        "fraction of requests unconditionally (0 = "
                        "tail-only: keep slow/errored requests; "
                        "negative = tracing disabled)")
    p.add_argument("-trace.slowMs", dest="trace_slow_ms", type=float,
                   default=200.0,
                   help="floor for the tail-sampling keep threshold: a "
                        "request slower than max(this, the tracked "
                        "per-verb p95) pins its span detail")


def _configure_trace(opts) -> None:
    if getattr(opts, "trace_sample", -1.0) >= 0:
        from seaweedfs_tpu_torch.stats import cluster_trace
        cluster_trace.enable(sample_fraction=opts.trace_sample,
                             slow_threshold_ms=opts.trace_slow_ms)
        log.info("cluster tracing on (sample=%.3f slowMs=%.0f)",
                 cluster_trace.sample, cluster_trace.slow_ms)


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes", "on")


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name, "")
    try:
        return float(v) if v else default
    except ValueError:
        return default


def _add_qos_args(p: argparse.ArgumentParser) -> None:
    """Shared -qos.* flags (see qos/). Everything defaults OFF: with QoS
    disabled no bucket exists, no tenant is resolved, and every seam
    costs one identity check. SEAWEED_QOS* environment variables supply
    fleet-wide defaults the flags override per process."""
    p.add_argument("-qos", dest="qos", action="store_true",
                   default=_env_flag("SEAWEED_QOS"),
                   help="enable multi-tenant QoS: per-tenant admission "
                        "buckets, weighted-fair pool scheduling, and "
                        "explicit 429+Retry-After backpressure (env "
                        "default SEAWEED_QOS)")
    p.add_argument("-qos.requestRate", dest="qos_request_rate",
                   type=float,
                   default=_env_float("SEAWEED_QOS_REQUEST_RATE", 0.0),
                   help="per-tenant admitted requests/second (0 = "
                        "unlimited; env default SEAWEED_QOS_REQUEST_RATE)")
    p.add_argument("-qos.requestBurst", dest="qos_request_burst",
                   type=float, default=0.0,
                   help="per-tenant request burst cap (0 = 2x rate)")
    p.add_argument("-qos.bytesMBps", dest="qos_bytes_mbps", type=float,
                   default=_env_float("SEAWEED_QOS_BYTES_MBPS", 0.0),
                   help="per-tenant admitted ingress MB/s judged from "
                        "Content-Length (0 = unlimited; env default "
                        "SEAWEED_QOS_BYTES_MBPS)")
    p.add_argument("-qos.bytesBurstS", dest="qos_bytes_burst_s",
                   type=float, default=2.0,
                   help="seconds of byte budget a tenant may bank")
    p.add_argument("-qos.globalRequestRate", dest="qos_global_rate",
                   type=float, default=0.0,
                   help="whole-process admitted requests/second across "
                        "all tenants; when heat shedding is armed a "
                        "quarter of it is reserved for hot-volume "
                        "traffic so cold reads shed first (0 = "
                        "unlimited)")
    p.add_argument("-qos.weights", dest="qos_weights",
                   default=os.environ.get("SEAWEED_QOS_WEIGHTS", ""),
                   help="per-tenant fair-share weights as "
                        "name:weight,name:weight (env default "
                        "SEAWEED_QOS_WEIGHTS)")
    p.add_argument("-qos.defaultWeight", dest="qos_default_weight",
                   type=float, default=1.0,
                   help="fair-share weight for tenants not in "
                        "-qos.weights")
    p.add_argument("-qos.internalWeight", dest="qos_internal_weight",
                   type=float, default=0.25,
                   help="fair-share weight of the _internal tenant "
                        "(scrub and lifecycle background work)")
    p.add_argument("-qos.maxTenants", dest="qos_max_tenants", type=int,
                   default=64,
                   help="distinct tenants tracked before the overflow "
                        "tenant _other absorbs the rest (bounds bucket "
                        "memory and metric label cardinality)")
    p.add_argument("-qos.heatShed", dest="qos_heat_shed",
                   type=lambda s: s.lower() not in ("0", "false", "no"),
                   default=True,
                   help="under global overload, prefer shedding reads "
                        "of cold volumes (needs -heat.track on the "
                        "volume server; false = shed uniformly)")


def _parse_qos_weights(spec: str) -> dict:
    weights = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        try:
            weights[name.strip()] = float(w)
        except ValueError:
            raise SystemExit(
                f"-qos.weights: expected name:weight, got {part!r}")
    return weights


def _configure_qos(opts) -> None:
    """Build and install the process-wide QosManager from the -qos.*
    flags. Without -qos nothing is imported and every seam stays None
    (there is exactly one manager per process by design)."""
    if not getattr(opts, "qos", False):
        return
    from seaweedfs_tpu_torch import qos
    from seaweedfs_tpu_torch.qos.admission import QosConfig
    qos.configure(QosConfig(
        request_rate=opts.qos_request_rate,
        request_burst=opts.qos_request_burst,
        bytes_mbps=opts.qos_bytes_mbps,
        bytes_burst_s=opts.qos_bytes_burst_s,
        global_request_rate=opts.qos_global_rate,
        weights=_parse_qos_weights(opts.qos_weights),
        default_weight=opts.qos_default_weight,
        internal_weight=opts.qos_internal_weight,
        max_tenants=opts.qos_max_tenants,
        heat_shed=opts.qos_heat_shed))
    log.info("qos on (rate=%s/s bytes=%sMB/s global=%s/s)",
             opts.qos_request_rate or "inf",
             opts.qos_bytes_mbps or "inf",
             opts.qos_global_rate or "inf")


def _attach_qos_heat(vs) -> None:
    """Hand the volume server's HeatTracker to the QoS manager so
    -qos.heatShed can tell hot volumes from cold under global overload.
    No-op unless BOTH -qos and -heat.track are on."""
    from seaweedfs_tpu_torch import qos
    mgr = qos.manager()
    if mgr is not None and getattr(vs, "heat", None) is not None:
        mgr.heat = vs.heat


@command("master", "start a master server (control plane)")
def run_master(args) -> int:
    _setup_tls("master")
    opts = _master_parser().parse_args(args)
    _configure_trace(opts)
    _configure_qos(opts)
    grace.setup_profiling(opts.cpuprofile)
    return _serve_with_metrics(_build_master(opts), opts, "master")


def _build_master(opts):
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.util import config
    if opts.mdir:
        os.makedirs(opts.mdir, exist_ok=True)
    peers = [x.strip() for x in (opts.peers or "").split(",") if x.strip()]
    if peers and len(peers) % 2 == 0:
        # the reference enforces an odd master count so elections cannot
        # tie (command/master.go:167-196)
        log.warning("master count %d is even; raft needs an odd number "
                    "of peers to avoid split votes", len(peers))
    conf = config.load_configuration("master")
    scripts = conf.get("master.maintenance.scripts") or []
    sleep_minutes = conf.get("master.maintenance.sleep_minutes", 17)
    return MasterServer(
        ip=opts.ip, port=opts.port, meta_dir=opts.mdir,
        volume_size_limit_mb=opts.volume_size_limit_mb,
        default_replication=opts.default_replication,
        pulse_seconds=opts.pulse_seconds,
        garbage_threshold=opts.garbage_threshold,
        peers=peers,
        maintenance_scripts=list(scripts),
        maintenance_interval_s=float(sleep_minutes) * 60,
        scrub_interval_s=opts.scrub_interval_s,
        scrub_throttle_mbps=opts.scrub_throttle_mbps,
        lifecycle=_lifecycle_config(opts),
        serve=_serve_config(opts),
        sequencer_type=conf.get_string("master.sequencer.type", "memory"),
        sequencer_node_id=conf.get("master.sequencer.node_id"),
        sequencer_etcd_urls=conf.get_string(
            "master.sequencer.sequencer_etcd_urls", "127.0.0.1:2379"))


def _volume_parser() -> argparse.ArgumentParser:
    # torch is imported here, not at module import: the client commands
    # (upload, download, delete, benchmark, shell) never need it
    from seaweedfs_tpu_torch.ops.rs_code import BACKENDS
    p = argparse.ArgumentParser(prog="volume",
                                description="start a volume server")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-dir", default="./data",
                   help="comma-separated storage directories")
    p.add_argument("-max", default="7",
                   help="comma-separated max volume counts per dir")
    p.add_argument("-mserver", default="127.0.0.1:9333",
                   help="the master, or a comma-separated list of every "
                        "master of a raft set (the heartbeat follows the "
                        "leader)")
    p.add_argument("-publicUrl", dest="public_url", default="",
                   help="the address clients are sent to (default "
                        "ip:port)")
    p.add_argument("-dataCenter", dest="data_center", default="",
                   help="this server's data center, for replica "
                        "placement")
    p.add_argument("-rack", default="",
                   help="this server's rack, for replica placement")
    p.add_argument("-pulseSeconds", dest="pulse_seconds", type=float,
                   default=5.0)
    p.add_argument("-replicate.parallel", dest="replicate_parallel",
                   type=int, default=8,
                   help="replica POSTs issued concurrently per "
                        "replicated write (1 = serial fan-out)")
    p.add_argument("-ec.encoder", dest="ec_encoder", default="cuda",
                   choices=list(BACKENDS),
                   help="codec of every EC request and degraded read: "
                        "cuda (the hand-written kernels on the card; "
                        "fails without one) or cpu (their plain "
                        "versions on the host)")
    p.add_argument("-ec.mesh", dest="ec_mesh", action="store_true",
                   default=False,
                   help="run batched EC encode, verify and degraded "
                        "decode on the unified mesh scheduler (the "
                        "default mesh needs two cards; with one the "
                        "server warns at start and the per-card fleet "
                        "runs)")
    p.add_argument("-index", dest="needle_map_kind", default="memory",
                   choices=["memory", "kv"],
                   help="needle map kind: memory (dict rebuild from .idx) "
                        "or kv (persistent LogKV, O(live) reopen; reference "
                        "command/volume.go:203-211 leveldb kinds)")
    p.add_argument("-cache.sizeMB", dest="cache_size_mb", type=int,
                   default=0,
                   help="RAM budget for the tiered read cache "
                        "(0 = disabled; serves hot EC needle reads and "
                        "reconstructed spans)")
    p.add_argument("-cache.dir", dest="cache_dir", default="",
                   help="directory for the read cache's disk tier "
                        "(empty = RAM tier only)")
    p.add_argument("-compactionMBps", dest="compaction_mbps", type=float,
                   default=0.0,
                   help="pace of vacuum scans and volume file copies "
                        "(0 = unthrottled)")
    _add_resilience_args(p)
    p.add_argument("-heat.track", dest="heat_track", action="store_true",
                   help="per-volume (and sampled per-needle) read-path "
                        "heat telemetry: SeaweedFS_volume_heat{vid}, "
                        "and the heat map the master's lifecycle engine "
                        "decides from")
    p.add_argument("-heat.windowSeconds", dest="heat_window_s",
                   type=float, default=60.0,
                   help="sliding window the heat gauge counts reads "
                        "over")
    _add_cpuprofile_arg(p)
    p.add_argument("-metricsPort", dest="metrics_port", type=int,
                   default=0, help="Prometheus /metrics pull port")
    _add_serve_args(p)
    _add_trace_args(p)
    _add_qos_args(p)
    return p


def _add_resilience_args(p: argparse.ArgumentParser) -> None:
    """Shared -resilience.* flags (volume and filer; see resilience/).
    Everything defaults off: the layer costs nothing until enabled."""
    p.add_argument("-resilience.breaker", dest="resilience_breaker",
                   action="store_true",
                   help="per-peer circuit breakers: fail fast on dead "
                        "peers instead of waiting out connect timeouts")
    p.add_argument("-resilience.breakerThreshold",
                   dest="resilience_breaker_threshold", type=int,
                   default=5,
                   help="consecutive failures that open a peer's breaker")
    p.add_argument("-resilience.breakerCooldownS",
                   dest="resilience_breaker_cooldown", type=float,
                   default=5.0,
                   help="seconds an open breaker waits before the "
                        "half-open probe")
    p.add_argument("-resilience.hedge", dest="resilience_hedge",
                   action="store_true",
                   help="hedged reads: after the tracked p95, send one "
                        "speculative request to another replica or "
                        "shard holder (<=5%% extra-request budget)")
    p.add_argument("-resilience.hedgeDelayMs",
                   dest="resilience_hedge_delay_ms", type=float,
                   default=10.0,
                   help="floor for the hedge delay (the tracked p95 "
                        "takes over once measured)")


def _configure_resilience(opts) -> None:
    if opts.resilience_breaker:
        from seaweedfs_tpu_torch.resilience import breaker
        breaker.configure(enable=True,
                          threshold=opts.resilience_breaker_threshold,
                          cooldown_s=opts.resilience_breaker_cooldown)


@command("volume", "start a volume server (data plane)")
def run_volume(args) -> int:
    _setup_tls("volume")
    opts = _volume_parser().parse_args(args)
    _configure_trace(opts)
    _configure_qos(opts)
    grace.setup_profiling(opts.cpuprofile)
    vs = _build_volume(opts)
    _attach_qos_heat(vs)
    return _serve_with_metrics(vs, opts, "volume")


def _build_volume(opts):
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.util import config
    _configure_resilience(opts)
    dirs = _split_dirs(opts.dir)
    maxes = [int(x) for x in str(opts.max).split(",")]
    if len(maxes) == 1:
        maxes = maxes * len(dirs)
    return VolumeServer(
        opts.mserver, dirs, ip=opts.ip, port=opts.port,
        public_url=opts.public_url, data_center=opts.data_center,
        rack=opts.rack, max_volume_counts=maxes,
        replicate_parallel=opts.replicate_parallel,
        pulse_seconds=opts.pulse_seconds, ec_encoder=opts.ec_encoder,
        ec_mesh=opts.ec_mesh, needle_map_kind=opts.needle_map_kind,
        cache_size_mb=opts.cache_size_mb, cache_dir=opts.cache_dir or None,
        hedge_reads=opts.resilience_hedge,
        hedge_delay_ms=opts.resilience_hedge_delay_ms,
        compaction_mbps=opts.compaction_mbps,
        heat_track=opts.heat_track, heat_window_s=opts.heat_window_s,
        serve=_serve_config(opts),
        storage_backends=config.storage_backend_conf(
            config.load_configuration("master")))


def _filer_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="filer", description="start a filer")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8888)
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-store", default="sqlite",
                   help="metadata store: memory | sqlite | weedkv "
                        "(embedded log-structured KV) | mysql | postgres "
                        "(connection params come from the matching "
                        "filer.toml section); the networked stores are "
                        "not carried yet")
    p.add_argument("-dir", default="./filer",
                   help="directory for metadata store + event log")
    p.add_argument("-collection", default="")
    p.add_argument("-defaultReplicaPlacement", dest="replication",
                   default="")
    p.add_argument("-maxMB", dest="max_mb", type=int, default=32,
                   help="auto-chunking split size")
    p.add_argument("-encryptVolumeData", dest="cipher",
                   action="store_true",
                   help="encrypt every chunk with AES-256-GCM (needs the "
                        "cryptography package; without it an encrypted "
                        "write or read answers 500)")
    p.add_argument("-ingest.parallelism", dest="ingest_parallelism",
                   type=int, default=8,
                   help="chunk uploads in flight per multi-chunk body "
                        "(1 = fully serial ingest, no pool threads)")
    p.add_argument("-assign.leaseCount", dest="assign_lease_count",
                   type=int, default=0,
                   help="lease N fids per master assign and hand them "
                        "out locally (0 = one assign per chunk)")
    p.add_argument("-peers", default="",
                   help="comma-separated host:port of ALL filers in "
                        "this cluster (merged metadata view)")
    p.add_argument("-meta.lookupTTL", dest="meta_lookup_ttl_s",
                   type=float, default=0.0,
                   help="arm the coalescing volume-lookup cache: "
                        "positive answers live this many seconds (0 = "
                        "off, one round trip per lookup)")
    p.add_argument("-meta.lookupNegativeTTL",
                   dest="meta_lookup_negative_ttl_s", type=float,
                   default=2.0,
                   help="seconds a NOT-FOUND lookup answer is served "
                        "from cache (only with -meta.lookupTTL)")
    p.add_argument("-meta.lookupCoalesceMs",
                   dest="meta_lookup_coalesce_ms", type=float,
                   default=2.0,
                   help="how long a lookup miss waits for siblings to "
                        "join its batched master round trip (only with "
                        "-meta.lookupTTL)")
    p.add_argument("-meta.lookupBatchMax",
                   dest="meta_lookup_batch_max", type=int, default=128,
                   help="most vids fused into one batched lookup round "
                        "trip (only with -meta.lookupTTL)")
    p.add_argument("-meta.listingCacheMB",
                   dest="meta_listing_cache_mb", type=int, default=0,
                   help="RAM budget for the directory-listing page "
                        "cache, invalidated by the metadata event log "
                        "(0 = off, every listing walks the filer store)")
    p.add_argument("-metricsPort", dest="metrics_port", type=int,
                   default=0, help="Prometheus /metrics pull port")
    _add_resilience_args(p)
    _add_trace_args(p)
    _add_serve_args(p)
    _add_qos_args(p)
    return p


def _configure_meta(opts) -> None:
    """Arm the process-wide coalescing lookup cache from the -meta.*
    flags (wdclient/lookup_cache.py). Off by default."""
    ttl = getattr(opts, "meta_lookup_ttl_s", 0.0)
    if ttl and ttl > 0:
        from seaweedfs_tpu_torch.wdclient import lookup_cache
        lookup_cache.configure(
            enable=True, ttl_s=ttl,
            negative_ttl_s=opts.meta_lookup_negative_ttl_s,
            coalesce_ms=opts.meta_lookup_coalesce_ms,
            batch_max=opts.meta_lookup_batch_max)


def _refuse_notification(conf) -> None:
    """A notification.toml that enables a queue is refused, never
    ignored: the queues arrive with the async services."""
    sections = (conf.get("notification") or {}) if conf else {}
    for name, props in sections.items():
        if isinstance(props, dict) and props.get("enabled"):
            raise unported.refusal(
                f"notification.toml [notification.{name}]",
                unported.NOTIFICATION)


def _build_filer(opts):
    from seaweedfs_tpu_torch.server.filer import FilerServer
    from seaweedfs_tpu_torch.util import config as config_mod
    _refuse_notification(config_mod.load_configuration("notification"))
    os.makedirs(opts.dir, exist_ok=True)
    peers = [x.strip() for x in (opts.peers or "").split(",")
             if x.strip()]
    # the store's filer.toml section carries its connection params
    # (reference scaffold.go [mysql]/[postgres])
    store_options = config_mod.load_configuration("filer") \
        .get(opts.store) or {}
    return FilerServer(
        opts.master, ip=opts.ip, port=opts.port, store=opts.store,
        store_options=store_options,
        meta_dir=opts.dir, collection=opts.collection,
        replication=opts.replication,
        chunk_size=opts.max_mb << 20, cipher=opts.cipher,
        cache_dir=os.path.join(opts.dir, "cache"),
        peers=peers,
        ingest_parallelism=opts.ingest_parallelism,
        assign_lease_count=opts.assign_lease_count,
        hedge_reads=opts.resilience_hedge,
        hedge_delay_ms=opts.resilience_hedge_delay_ms,
        listing_cache_mb=opts.meta_listing_cache_mb,
        serve=_serve_config(opts))


@command("filer", "start a filer (namespace server)")
def run_filer(args) -> int:
    _setup_tls("filer")
    opts = _filer_parser().parse_args(args)
    _configure_resilience(opts)
    _configure_trace(opts)
    _configure_qos(opts)
    _configure_meta(opts)   # before the build: MasterClient arms at init
    return _serve_with_metrics(_build_filer(opts), opts, "filer")


def _refused_command(name: str, arrives_with: str):
    def run(args) -> int:  # noqa: ARG001
        raise unported.refusal(name, arrives_with)
    return run


command("s3", "start an S3-compatible gateway (not carried yet)")(
    _refused_command("s3", unported.S3))
command("webdav", "start a WebDAV gateway (not carried yet)")(
    _refused_command("webdav", unported.WEBDAV_FTP_FUSE))
command("ftp", "start an FTP gateway (not carried yet)")(
    _refused_command("ftp", unported.WEBDAV_FTP_FUSE))


@command("server", "start master + volume (+filer) in one process")
def run_server(args) -> int:
    p = argparse.ArgumentParser(prog="server", description="combined "
                                "cluster-in-one-process (reference weed "
                                "server)")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-dir", default="./data")
    p.add_argument("-master.port", dest="master_port", type=int,
                   default=9333)
    p.add_argument("-volume.port", dest="volume_port", type=int,
                   default=8080)
    p.add_argument("-volume.max", dest="volume_max", default="7")
    p.add_argument("-ec.encoder", dest="ec_encoder", default="cuda",
                   help="the volume server's codec: cuda (the default) "
                        "or cpu")
    p.add_argument("-filer", action="store_true",
                   help="also start a filer")
    p.add_argument("-filer.port", dest="filer_port", type=int,
                   default=8888)
    p.add_argument("-s3", action="store_true",
                   help="also start an S3 gateway (not carried yet)")
    p.add_argument("-s3.port", dest="s3_port", type=int, default=8333)
    p.add_argument("-volumeSizeLimitMB", dest="volume_size_limit_mb",
                   type=int, default=30 * 1000)
    _add_cpuprofile_arg(p)
    _add_qos_args(p)
    opts = p.parse_args(args)
    if opts.s3:
        raise unported.refusal("server -s3", unported.S3)
    _setup_tls("master")
    # one process-wide manager shared by every role in the combined
    # server: all of them meter against the same tenant buckets
    _configure_qos(opts)
    grace.setup_profiling(opts.cpuprofile)

    mopts = _master_parser().parse_args(
        ["-ip", opts.ip, "-port", str(opts.master_port),
         "-mdir", os.path.join(opts.dir, "master"),
         "-volumeSizeLimitMB", str(opts.volume_size_limit_mb)])
    vopts = _volume_parser().parse_args(
        ["-ip", opts.ip, "-port", str(opts.volume_port),
         "-dir", os.path.join(opts.dir, "volume"),
         "-max", str(opts.volume_max),
         "-ec.encoder", opts.ec_encoder,
         "-mserver", f"{opts.ip}:{opts.master_port}"])
    stack = [_build_master(mopts)]
    # each role starts before the next is built: the volume server and
    # the filer dial the master at construction
    stack[0].start()
    try:
        vol = _build_volume(vopts)
        _attach_qos_heat(vol)
        stack.append(vol)
        vol.start()
        if opts.filer:
            fopts = _filer_parser().parse_args(
                ["-ip", opts.ip, "-port", str(opts.filer_port),
                 "-master", f"{opts.ip}:{opts.master_port}",
                 "-dir", os.path.join(opts.dir, "filer")])
            filer = _build_filer(fopts)
            stack.append(filer)
            filer.start()
    except BaseException:
        for server in reversed(stack):
            server.stop()
        grace.stop_profiling()
        raise
    return _serve_all_until_signalled(stack, started=len(stack))
