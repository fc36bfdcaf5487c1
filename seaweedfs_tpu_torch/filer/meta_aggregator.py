"""MetaAggregator: merge peer filers' local metadata logs into one view.

Reference parity: weed/filer/meta_aggregator.go:20-210; the peer
streams run on the port's ``rpc.py`` in place of grpc. Each filer in a
multi-filer cluster subscribes to every PEER's SubscribeLocalMetadata
stream and folds those events into an aggregated log; clients calling
SubscribeMetadata on ANY filer then see the merged, cluster-wide event
stream (local + peers).

Design points:

- **peer events land in a durable MetaLog of their own** (same segment
  format as the local log, separate directory), re-stamped with LOCAL
  append timestamps. Local stamping makes the merged stream's watermark
  monotonic on one clock — a peer event arriving late still gets a ts
  above every already-delivered event, so subscribers never skip it —
  and the disk segments make peer history survive restarts.
- **store signatures**: every filer stamps its events with a random
  int32 signature; an event already carrying this filer's signature is
  its own write echoing back and is dropped (the self-loop guard,
  meta_aggregator.go:94-118).
- **per-peer resume offsets** (the PEER's ts, not ours) are
  checkpointed in the filer store's KV space — batched, not per event —
  so a restart resumes each peer subscription near where it left off;
  the signature guard makes small replays harmless
  (meta_aggregator.go:172-218).
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Dict, List, Optional

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.filer.filer_notify import MetaLog
from seaweedfs_tpu_torch.pb import filer_pb2, filer_stub
from seaweedfs_tpu_torch.util import wlog

log = wlog.logger("filer.meta_aggregator")

_PROGRESS_PREFIX = b"aggr.progress."
PROGRESS_EVERY_S = 1.0       # resume-offset checkpoint cadence


class MetaAggregator:
    def __init__(self, filer, self_url: str, peers: List[str],
                 signature: int, log_dir: Optional[str] = None):
        self.filer = filer          # the owning Filer (store + meta_log)
        self.self_url = self_url
        self.peers = [p for p in peers if p and p != self_url]
        self.signature = signature
        # durable, locally-timestamped log of PEER events
        self.aggr_log = MetaLog(log_dir)
        self._cond = threading.Condition()
        self.version = 0   # bumps on every local wake or peer append
        self._stopping = False
        self._threads: List[threading.Thread] = []
        self._calls: Dict[str, object] = {}
        # peer -> newest peer-ts not yet checkpointed to the KV store
        self._dirty_progress: Dict[str, int] = {}
        self._dirty_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        for peer in self.peers:
            # lint: thread-ok(per-peer subscription daemon; no request context)
            t = threading.Thread(target=self._follow_peer, args=(peer,),
                                 name=f"meta-aggr-{peer}", daemon=True)
            t.start()
            self._threads.append(t)
        # lint: thread-ok(per-peer subscription daemon; no request context)
        t = threading.Thread(target=self._checkpoint_loop,
                             name="meta-aggr-checkpoint", daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stopping = True
        with self._cond:
            self._cond.notify_all()
        for call in list(self._calls.values()):
            try:
                call.cancel()
            # lint: swallow-ok(best-effort cancel during shutdown)
            except Exception:
                pass
        for t in self._threads:
            t.join(timeout=2)
        self.aggr_log.close()

    # -- progress persistence -------------------------------------------------

    def _progress_key(self, peer: str) -> bytes:
        return _PROGRESS_PREFIX + peer.encode()

    def read_progress(self, peer: str) -> int:
        blob = self.filer.store.kv_get(self._progress_key(peer))
        if blob and len(blob) == 8:
            return struct.unpack(">Q", blob)[0]
        return 0

    def save_progress(self, peer: str, ts_ns: int) -> None:
        self.filer.store.kv_put(self._progress_key(peer),
                                struct.pack(">Q", ts_ns))

    def _mark_progress(self, peer: str, ts_ns: int) -> None:
        with self._dirty_lock:
            self._dirty_progress[peer] = max(
                self._dirty_progress.get(peer, 0), ts_ns)

    def _flush_progress(self) -> None:
        with self._dirty_lock:
            dirty, self._dirty_progress = self._dirty_progress, {}
        for peer, ts in dirty.items():
            try:
                self.save_progress(peer, ts)
            except Exception:
                log.exception("progress save for %s failed", peer)
                self._mark_progress(peer, ts)  # retry next pass

    def _checkpoint_loop(self) -> None:
        """Flush per-peer resume offsets on a timer: per-event KV
        writes would be hot-path write amplification, and batching is
        safe — the signature guard and ts filter absorb the few
        replayed events a crash can cause."""
        while not self._stopping:
            time.sleep(PROGRESS_EVERY_S)
            self._flush_progress()
        self._flush_progress()

    # -- ingestion ------------------------------------------------------------

    def wake(self) -> None:
        """Local-write hook: merged-view subscribers re-read both logs."""
        with self._cond:
            self.version += 1
            self._cond.notify_all()

    def _follow_peer(self, peer: str) -> None:
        since = self.read_progress(peer)
        # newest peer ts already applied to the aggregated log: stream
        # breaks resume from the (1s-batched) checkpoint, so replayed
        # records MUST be dropped here or merged-view subscribers see
        # duplicates (the signature guard only filters this filer's own
        # events)
        applied = since
        while not self._stopping:
            try:
                call = filer_stub(peer).SubscribeLocalMetadata(
                    filer_pb2.SubscribeMetadataRequest(
                        client_name=f"aggr@{self.self_url}",
                        path_prefix="/", since_ns=since,
                        signature=self.signature))
                self._calls[peer] = call
                for rec in call:
                    if self._stopping:
                        break
                    since = max(since, rec.ts_ns)
                    if rec.ts_ns <= applied:
                        continue  # checkpoint-lag replay
                    applied = rec.ts_ns
                    ev = rec.event_notification
                    if self.signature not in ev.signatures:
                        # re-stamped with a LOCAL ts by append_event
                        self.aggr_log.append_event(rec.directory, ev)
                        with self._cond:
                            self.version += 1
                            self._cond.notify_all()
                    self._mark_progress(peer, applied)
            except rpc.RpcError:
                pass  # peer down/restarting: retry below
            except Exception:
                # anything else must not silently kill the follower
                log.exception("meta aggregation from %s failed; retrying",
                              peer)
            if self._stopping:
                return
            time.sleep(0.5)

    # -- merged read side ------------------------------------------------------

    def events_since(self, ts_ns: int
                     ) -> List[filer_pb2.SubscribeMetadataResponse]:
        """Merged view: local log + peer log, one local clock.
        Unfiltered on purpose — see MetaLog.read_events_since."""
        local = self.filer.meta_log.read_events_since(ts_ns)
        peers = self.aggr_log.read_events_since(ts_ns)
        out = list(local) + list(peers)
        out.sort(key=lambda e: e.ts_ns)
        return out

    def wait_for_version(self, seen_version: int, timeout: float) -> bool:
        """Block until something was appended after the caller read
        `version` (no lost wakeups: an append between the caller's
        events_since and this call returns immediately)."""
        with self._cond:
            if self.version != seen_version:
                return True
            self._cond.wait(timeout)
            return self.version != seen_version
