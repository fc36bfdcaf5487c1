"""Server subcommands: master and volume.

Flag names and defaults follow the JAX package's command layer
(``seaweedfs_tpu/command/servers.py``, itself the reference's
weed/command/master.go:29-46 and volume.go:65-90) for the flags the port
carries. ``-ec.encoder`` takes ``cuda`` (the default) or ``cpu``;
any other name is refused. Each subcommand blocks until SIGINT or
SIGTERM, then stops its server.

Both read security.toml first (``_setup_tls``): with its ``[grpc.ca]``
and ``[grpc.master]``/``[grpc.volume]`` sections the server's RPC plane
runs mutual TLS, and a certificate that does not load ends the start.

Both read master.toml (``util/config.py``: the working directory, then
``$HOME/.seaweedfs``): the master its ``master.maintenance.scripts``,
``sleep_minutes`` and ``[master.sequencer]``, the volume server its
``[storage.backend.<scheme>.<id>]`` tier targets. ``master -peers`` names
every master of a raft set (an even count is warned about: it can split
its votes); ``volume -mserver`` may name all of them.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
from typing import List

from seaweedfs_tpu_torch.command import command
from seaweedfs_tpu_torch.util import wlog

log = wlog.logger("command")


def _setup_tls(role: str) -> None:
    """Mutual TLS when security.toml carries [grpc.*] sections (reference
    security/tls.go; plaintext without them)."""
    from seaweedfs_tpu_torch.command import setup_client_tls
    setup_client_tls(role)


def _serve_until_signalled(server) -> int:
    done = threading.Event()

    def _stop(signum, frame):  # noqa: ARG001
        done.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _stop)
    server.start()
    try:
        while not done.wait(timeout=0.5):
            pass
    finally:
        server.stop()
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
    return p


@command("master", "start a master server (control plane)")
def run_master(args) -> int:
    _setup_tls("master")
    opts = _master_parser().parse_args(args)
    return _serve_until_signalled(_build_master(opts))


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
    p.add_argument("-resilience.hedge", dest="resilience_hedge",
                   action="store_true",
                   help="hedged reads: after the tracked p95, send one "
                        "speculative request to another shard holder "
                        "(<=5%% extra-request budget)")
    p.add_argument("-resilience.hedgeDelayMs",
                   dest="resilience_hedge_delay_ms", type=float,
                   default=10.0,
                   help="floor for the hedge delay (the tracked p95 "
                        "takes over once measured)")
    p.add_argument("-compactionMBps", dest="compaction_mbps", type=float,
                   default=0.0,
                   help="pace of vacuum scans and volume file copies "
                        "(0 = unthrottled)")
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
    return p


@command("volume", "start a volume server (data plane)")
def run_volume(args) -> int:
    _setup_tls("volume")
    opts = _volume_parser().parse_args(args)
    return _serve_until_signalled(_build_volume(opts))


def _build_volume(opts):
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.util import config
    if opts.resilience_breaker:
        from seaweedfs_tpu_torch.resilience import breaker
        breaker.configure(enable=True,
                          threshold=opts.resilience_breaker_threshold,
                          cooldown_s=opts.resilience_breaker_cooldown)
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
        storage_backends=config.storage_backend_conf(
            config.load_configuration("master")))
