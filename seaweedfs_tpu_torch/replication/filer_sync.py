"""Active-active metadata sync between two filer clusters
(reference: weed/command/filer_sync.go — tail each cluster's event log
and replay on the other; is_from_other_cluster marks replayed events
so they are not bounced back, the signature-loop-prevention analog).
The port of ``seaweedfs_tpu.replication.filer_sync``: each tail rides
the source filer's ``SubscribeMetadata`` stream as the ``_internal`` QoS
tenant.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


from seaweedfs_tpu_torch.pb import filer_pb2, filer_stub
from seaweedfs_tpu_torch.replication.replicator import Replicator
from seaweedfs_tpu_torch.replication.sinks import FilerSink
from seaweedfs_tpu_torch.replication.source import FilerSource


class _OneWay:
    def __init__(self, src_url: str, dst_url: str, path_prefix: str,
                 replicator: Optional[Replicator] = None):
        self.src_url = src_url
        self.replicator = replicator or Replicator(
            FilerSource(src_url), FilerSink(dst_url),
            path_filter=path_prefix)
        self.path_prefix = path_prefix
        self._stopping = False
        self._call = None
        self._thread: Optional[threading.Thread] = None

    def start(self, since_ns: int) -> None:
        # lint: thread-ok(replication tail daemon; no request context)
        self._thread = threading.Thread(
            target=self._loop, args=(since_ns,),
            name=f"filer-sync-{self.src_url}", daemon=True)
        self._thread.start()

    def _loop(self, since_ns: int) -> None:
        # the replication tail runs as the _internal QoS tenant for its
        # whole life: its re-uploads ride the destination's pools at
        # low fair-share weight and are exempt from admission shed.
        # Entered once, never exited — the tenant scope dies with this
        # daemon thread's context (no-op context when QoS is off).
        from seaweedfs_tpu_torch import qos
        qos.internal_context().__enter__()
        while not self._stopping:
            try:
                self._call = filer_stub(self.src_url).SubscribeMetadata(
                    filer_pb2.SubscribeMetadataRequest(
                        client_name="filer.sync",
                        path_prefix=self.path_prefix,
                        since_ns=since_ns))
                for rec in self._call:
                    if self._stopping:
                        return
                    since_ns = max(since_ns, rec.ts_ns)
                    ev = rec.event_notification
                    if ev.is_from_other_cluster:
                        continue  # our own replay echoing back
                    try:
                        # metadata-log records carry the parent dir;
                        # the replicator takes full-path keys
                        from seaweedfs_tpu_torch.filer.filer_notify import \
                            event_key
                        self.replicator.replicate(
                            event_key(rec.directory, ev), ev)
                    except Exception:
                        # one unreplayable event (e.g. source chunk
                        # already deleted) must not kill the tail
                        from seaweedfs_tpu_torch.stats import metrics
                        metrics.swallowed("filer_sync.replicate_event")
                        continue
            except Exception:
                if self._stopping:
                    return
                from seaweedfs_tpu_torch.stats import metrics
                metrics.swallowed("filer_sync.stream")
                time.sleep(0.2)

    def stop(self) -> None:
        self._stopping = True
        if self._call is not None:
            self._call.cancel()


class FilerSync:
    """Bidirectional: A→B and B→A tails running concurrently."""

    def __init__(self, filer_a: str, filer_b: str,
                 path_prefix: str = "/"):
        self.a_to_b = _OneWay(filer_a, filer_b, path_prefix)
        self.b_to_a = _OneWay(filer_b, filer_a, path_prefix)

    def start(self, since_ns: Optional[int] = None) -> None:
        ts = time.time_ns() if since_ns is None else since_ns
        self.a_to_b.start(ts)
        self.b_to_a.start(ts)

    def stop(self) -> None:
        self.a_to_b.stop()
        self.b_to_a.stop()
