"""Async-service subcommands: ``filer.replicate``, ``filer.sync``,
``msgBroker`` and ``mount``.

The port of ``seaweedfs_tpu.command.async_services`` (reference
weed/command/filer_replication.go: consume a filer's events and apply
them to a configured sink; filer_sync.go:64+: active-active between two
filers; msg_broker.go; mount.go). The first two tail the source filer's
``SubscribeMetadata`` stream (``replication/filer_sync.py``); they and
``msgBroker`` run until SIGINT or SIGTERM, then stop and exit 0.
``mount`` serves ``filesys/`` through libfuse until unmounted, and exits
1 with the JAX package's message where libfuse or /dev/fuse is missing.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
from typing import Optional

from seaweedfs_tpu_torch.command import command, setup_client_tls
from seaweedfs_tpu_torch.util import wlog

log = wlog.logger("command.async")

NO_CONFIG = ("no replication.toml found; run "
             "`scaffold -config replication`")
INCOMPLETE_CONFIG = ("replication.toml needs [source.filer] grpcAddress "
                     "and one enabled [sink.*]")


class ReplicationConfigError(ValueError):
    """replication.toml is missing or names no source or sink."""


def load_replication_config(config_path: Optional[str] = None):
    """replication.toml: beside ``config_path`` when given, else from the
    search path of ``util/config.py``."""
    from seaweedfs_tpu_torch.util import config as config_mod
    search = [os.path.dirname(os.path.abspath(config_path)) or "."] \
        if config_path else None
    return config_mod.load_configuration("replication", search_path=search)


def replicator_from_config(conf):
    """The tail ``filer.replicate`` runs for a replication.toml:
    ``[source.filer]`` (``grpcAddress`` or ``address``, ``directory``)
    into the first enabled ``[sink.*]``. Returns ``(tail, source url,
    directory, sink kind)``; the tail is not started."""
    if not conf:
        raise ReplicationConfigError(NO_CONFIG)
    src_url = conf.get_string("source.filer.grpcAddress") or \
        conf.get_string("source.filer.address")
    directory = conf.get_string("source.filer.directory", "/")
    sinks = conf.get("sink") or {}
    enabled = [(k, v) for k, v in sinks.items()
               if isinstance(v, dict) and v.get("enabled")]
    if not src_url or not enabled:
        raise ReplicationConfigError(INCOMPLETE_CONFIG)
    kind, props = enabled[0]
    props = {k: v for k, v in props.items() if k != "enabled"}
    from seaweedfs_tpu_torch.replication.filer_sync import _OneWay
    from seaweedfs_tpu_torch.replication.replicator import Replicator
    from seaweedfs_tpu_torch.replication.sinks import make_sink
    from seaweedfs_tpu_torch.replication.source import FilerSource
    sink = make_sink(kind, **props)
    # the same resilient tail loop filer.sync uses, with this sink
    tail = _OneWay(src_url, src_url, directory,
                   replicator=Replicator(FilerSource(src_url), sink,
                                         path_filter=directory))
    return tail, src_url, directory, kind


@command("filer.replicate", "stream filer changes into a configured sink")
def run_filer_replicate(args) -> int:
    """Reads replication.toml and replays the source filer's metadata log
    from time 0 into the sink, then follows it."""
    setup_client_tls()
    p = argparse.ArgumentParser(prog="filer.replicate")
    p.add_argument("-config", default=None,
                   help="replication.toml path (default: search path)")
    opts = p.parse_args(args)
    try:
        tail, src_url, directory, kind = replicator_from_config(
            load_replication_config(opts.config))
    except ReplicationConfigError as e:
        print(str(e), file=sys.stderr)
        return 1
    return _run_until_signalled(
        tail, lambda: tail.start(since_ns=0),
        f"replicating {src_url}{directory} -> {kind} sink")


@command("filer.sync", "active-active sync between two filers")
def run_filer_sync(args) -> int:
    setup_client_tls()
    p = argparse.ArgumentParser(prog="filer.sync")
    p.add_argument("-a", required=True, help="filer A host:port")
    p.add_argument("-b", required=True, help="filer B host:port")
    p.add_argument("-a.path", dest="path_a", default="/")
    p.add_argument("-b.path", dest="path_b", default="/")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
    sync = FilerSync(opts.a, opts.b, path_prefix=opts.path_a)
    return _run_until_signalled(sync, sync.start,
                                f"filer.sync {opts.a} <-> {opts.b} started")


def msg_broker_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="msgBroker")
    p.add_argument("-port", type=int, default=17777)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-peers", default="",
                   help="comma-separated host:port of ALL brokers in "
                        "this cluster (topics consistent-hash over "
                        "them)")
    return p


@command("msgBroker", "start the pub/sub message broker")
def run_msg_broker(args) -> int:
    setup_client_tls()
    opts = msg_broker_parser().parse_args(args)
    broker = build_msg_broker(opts)
    return _run_until_signalled(
        broker, broker.start,
        f"message broker {opts.ip}:{opts.port} started")


def build_msg_broker(opts):
    """The broker ``msgBroker`` runs for its parsed flags (not started)."""
    from seaweedfs_tpu_torch.messaging.broker import MessageBroker
    return MessageBroker(filer_url=opts.filer, ip=opts.ip, port=opts.port,
                         peers=opts.peers.split(",") if opts.peers
                         else None)


MOUNT_UNAVAILABLE = ("mount needs libfuse + /dev/fuse, which this system "
                     "does not have; the filesystem layer "
                     "(seaweedfs_tpu.filesys) still works as a library "
                     "— see tests/test_filesys.py")


@command("mount", "mount the filer as a filesystem (needs kernel FUSE)")
def run_mount(args) -> int:
    p = argparse.ArgumentParser(prog="mount")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-dir", required=True, help="mount point")
    p.add_argument("-filer.path", dest="filer_path", default="/")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-allowOthers", dest="allow_others",
                   action="store_true")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.filesys import fuse_shim
    if not fuse_shim.available():
        print(MOUNT_UNAVAILABLE, file=sys.stderr)
        return 1
    from seaweedfs_tpu_torch.filesys import Wfs
    from seaweedfs_tpu_torch.util import grace
    wfs = Wfs(opts.filer, collection=opts.collection,
              replication=opts.replication)
    m = fuse_shim.FuseMount(wfs, opts.dir, filer_path=opts.filer_path)
    grace.on_interrupt(m.unmount)
    try:
        return m.mount(allow_other=opts.allow_others)
    finally:
        wfs.stop()


def _run_until_signalled(stoppable, start, message: str) -> int:
    """Start, block until SIGINT or SIGTERM, stop; exit 0."""
    done = threading.Event()

    def _stop(signum, frame):  # noqa: ARG001
        done.set()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _stop)
    try:
        start()
        log.info("%s", message)
        while not done.wait(timeout=0.5):
            pass
    finally:
        stoppable.stop()
    return 0
