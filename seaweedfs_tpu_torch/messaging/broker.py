"""Message broker: topics partitioned by key hash, per-partition logs
kept in memory and persisted through the filer KV/paths so subscribers
can start from EARLIEST after restarts (reference:
weed/messaging/broker/broker_server.go, broker_grpc_server_publish.go,
_subscribe.go, topic_manager.go; proto pb/messaging.proto).

The port of ``seaweedfs_tpu_torch.messaging.broker`` on the port's RPC plane
(``rpc.py``): the same topics, partitions, persistence and replay.
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import filer_pb2, filer_stub, messaging_pb2
from seaweedfs_tpu_torch.util.log_buffer import LogEntry

DEFAULT_PARTITIONS = 4
TOPICS_DIR = "/topics"


@dataclass
class _Partition:
    entries: List[Tuple[int, bytes]] = field(default_factory=list)
    cond: threading.Condition = field(
        default_factory=threading.Condition)

    def append(self, ts_ns: int, blob: bytes) -> int:
        """Returns the (possibly bumped-for-monotonicity) final ts —
        the one that must also go to the durable log."""
        with self.cond:
            if self.entries and ts_ns <= self.entries[-1][0]:
                ts_ns = self.entries[-1][0] + 1
            self.entries.append((ts_ns, blob))
            self.cond.notify_all()
        return ts_ns

    def read_since(self, ts_ns: int) -> List[Tuple[int, bytes]]:
        with self.cond:
            return [(t, b) for t, b in self.entries if t > ts_ns]

    def wait(self, after_ts: int, timeout: float) -> bool:
        with self.cond:
            if self.entries and self.entries[-1][0] > after_ts:
                return True
            self.cond.wait(timeout)
            return bool(self.entries) and self.entries[-1][0] > after_ts


@dataclass
class _Topic:
    config: messaging_pb2.TopicConfiguration
    partitions: List[_Partition]


class MessageBroker:
    """One broker node. Filer-backed persistence: each publish also
    lands in the filer KV as <topic>/<partition> segments when a filer
    is attached (transient topics skip persistence)."""

    def __init__(self, filer_url: str = "", ip: str = "127.0.0.1",
                 port: int = 17777, peers: Optional[List[str]] = None):
        self.filer_url = filer_url
        self.ip = ip
        self.port = port
        # all brokers of this cluster (incl. self); FindBroker
        # consistent-hashes topics over this list
        self.peers = [p.strip() for p in (peers or []) if p.strip()]
        self._topics: Dict[Tuple[str, str], _Topic] = {}
        self._lock = threading.Lock()
        self._grpc_server = None
        self._stopping = False

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    def start(self) -> None:
        handler = rpc.generic_handler(
            messaging_pb2, "SeaweedMessaging", self)
        self._grpc_server = rpc.make_server(
            f"{self.ip}:{self.port + rpc.GRPC_PORT_OFFSET}", [handler])
        if self.filer_url:
            # advertise ourselves + owned topics over the filer's
            # KeepConnected stream so LocateBroker finds us (reference
            # broker_server.go keepConnectedToOneFiler)
            # lint: thread-ok(broker listener thread; no ambient request state)
            self._reg_thread = threading.Thread(
                target=self._register_loop, name="broker-register",
                daemon=True)
            self._reg_thread.start()

    def _register_loop(self) -> None:
        def requests():
            while not self._stopping:
                with self._lock:
                    resources = [f"{ns}/{t}" for ns, t in self._topics]
                yield filer_pb2.KeepConnectedRequest(
                    name="msgbroker",
                    grpc_port=self.port + rpc.GRPC_PORT_OFFSET,
                    resources=resources)
                for _ in range(10):   # ~2s cadence, fast stop
                    if self._stopping:
                        return
                    time.sleep(0.2)

        while not self._stopping:
            try:
                for _resp in filer_stub(self.filer_url).KeepConnected(
                        requests()):
                    if self._stopping:
                        return
            except rpc.RpcError:
                if self._stopping:
                    return
                time.sleep(1.0)

    def stop(self) -> None:
        self._stopping = True
        with self._lock:
            for topic in self._topics.values():
                for p in topic.partitions:
                    with p.cond:
                        p.cond.notify_all()
        if self._grpc_server:
            self._grpc_server.stop()

    # -- topic management -----------------------------------------------------

    def _get_topic(self, namespace: str, topic: str,
                   create: bool = True) -> Optional[_Topic]:
        key = (namespace, topic)
        with self._lock:
            t = self._topics.get(key)
            if t is None and create:
                cfg = self._restore_config(namespace, topic)
                t = _Topic(
                    config=cfg,
                    partitions=[_Partition()
                                for _ in range(cfg.partition_count)])
                self._topics[key] = t
                self._restore(namespace, topic, t)
            return t

    def _partition_for(self, t: _Topic, key: bytes,
                       explicit: int) -> int:
        n = len(t.partitions)
        if explicit >= 0 and explicit < n:
            return explicit
        if key:
            return int.from_bytes(
                hashlib.md5(key).digest()[:4], "big") % n
        return int(time.time_ns() // 1000) % n  # round robin-ish

    # -- persistence through the filer ---------------------------------------
    #
    # Each partition is a log FILE under /topics/<ns>/<topic>/ whose
    # records are appended via the filer's AppendToEntry path — O(1)
    # per message (the old KV read-modify-write was O(history) per
    # publish and lost records under concurrency). Topic config lives
    # in the filer KV.

    def _topic_dir(self, ns: str, topic: str) -> str:
        return f"{TOPICS_DIR}/{ns}/{topic}"

    def _seg_path(self, ns: str, topic: str, p: int) -> str:
        return f"{self._topic_dir(ns, topic)}/{p:02d}.log"

    def _cfg_key(self, ns: str, topic: str) -> bytes:
        return f"{self._topic_dir(ns, topic)}/.config".encode()

    def _persist(self, ns: str, topic: str, t: _Topic, p: int,
                 ts_ns: int, blob: bytes) -> None:
        if not self.filer_url or t.config.is_transient:
            return
        frame = LogEntry(ts_ns, 0, blob).pack()
        try:
            from seaweedfs_tpu_torch.operation import operations
            stub = filer_stub(self.filer_url)
            a = stub.AssignVolume(filer_pb2.AssignVolumeRequest(count=1))
            if a.error:
                return
            operations.upload_data(f"{a.url}/{a.file_id}", frame)
            stub.AppendToEntry(filer_pb2.AppendToEntryRequest(
                directory=self._topic_dir(ns, topic),
                entry_name=f"{p:02d}.log",
                chunks=[filer_pb2.FileChunk(
                    file_id=a.file_id, size=len(frame),
                    mtime=ts_ns)]))
        except (rpc.RpcError, OSError, RuntimeError):
            pass

    def _persist_config(self, ns: str, topic: str, t: _Topic) -> None:
        if not self.filer_url:
            return
        try:
            filer_stub(self.filer_url).KvPut(filer_pb2.KvPutRequest(
                key=self._cfg_key(ns, topic),
                value=t.config.SerializeToString()))
        except rpc.RpcError:
            pass

    def _restore_config(self, ns: str,
                        topic: str) -> messaging_pb2.TopicConfiguration:
        cfg = messaging_pb2.TopicConfiguration(
            partition_count=DEFAULT_PARTITIONS)
        if not self.filer_url:
            return cfg
        try:
            blob = filer_stub(self.filer_url).KvGet(
                filer_pb2.KvGetRequest(
                    key=self._cfg_key(ns, topic))).value
            if blob:
                cfg.ParseFromString(blob)
                if not cfg.partition_count:
                    cfg.partition_count = DEFAULT_PARTITIONS
        except rpc.RpcError:
            pass
        return cfg

    def _restore(self, ns: str, topic: str, t: _Topic) -> None:
        if not self.filer_url:
            return
        from seaweedfs_tpu_torch.filer import http_client as filer_http
        import urllib.error
        for p, part in enumerate(t.partitions):
            try:
                _, blob, _ = filer_http.get(
                    self.filer_url, self._seg_path(ns, topic, p))
            except (urllib.error.HTTPError, OSError):
                continue
            records = [(e.ts_ns, e.data)
                       for e in LogEntry.unpack_stream(blob)]
            records.sort(key=lambda r: r[0])
            part.entries.extend(records)

    # -- gRPC -----------------------------------------------------------------

    def Publish(self, request_iterator, context):
        topic_obj: Optional[_Topic] = None
        ns = topic = ""
        partition = -1
        for req in request_iterator:
            if req.HasField("init"):
                ns, topic = req.init.namespace, req.init.topic
                partition = req.init.partition
                topic_obj = self._get_topic(ns, topic)
                yield messaging_pb2.PublishResponse(
                    config=messaging_pb2.PublishResponse.ConfigMessage(
                        partition_count=len(topic_obj.partitions)))
                continue
            if topic_obj is None:
                context.abort(rpc.StatusCode.FAILED_PRECONDITION,
                              "publish before init")
            if req.data.is_close:
                # fixed-partition streams (channels) append the close
                # marker into the log so subscribers observe the end of
                # stream (reference broker_grpc_server_publish.go:88-93
                # AddToBuffer before break); keyed fan-out topics have
                # no single close partition and skip it
                if 0 <= partition < len(topic_obj.partitions):
                    ts = req.data.event_time_ns or time.time_ns()
                    blob = req.data.SerializeToString()
                    final_ts = topic_obj.partitions[partition].append(
                        ts, blob)
                    self._persist(ns, topic, topic_obj, partition,
                                  final_ts, blob)
                yield messaging_pb2.PublishResponse(is_closed=True)
                return
            ts = req.data.event_time_ns or time.time_ns()
            p = self._partition_for(topic_obj, bytes(req.data.key),
                                    partition)
            blob = req.data.SerializeToString()
            # persist with the ts the in-memory log actually assigned,
            # so restart replay matches what live subscribers saw
            final_ts = topic_obj.partitions[p].append(ts, blob)
            self._persist(ns, topic, topic_obj, p, final_ts, blob)
            yield messaging_pb2.PublishResponse()

    def Subscribe(self, request_iterator, context):
        init = None
        for req in request_iterator:
            if req.HasField("init"):
                init = req.init
                break
            if req.is_close:
                return
        if init is None:
            return
        t = self._get_topic(init.namespace, init.topic)
        p = t.partitions[init.partition % len(t.partitions)]
        Start = messaging_pb2.SubscriberMessage.InitMessage
        if init.startPosition == Start.EARLIEST:
            since = 0
        elif init.startPosition == Start.TIMESTAMP:
            since = init.timestampNs
        else:  # LATEST
            entries = p.read_since(0)
            since = entries[-1][0] if entries else 0
        while context.is_active() and not self._stopping:
            batch = p.read_since(since)
            if not batch:
                p.wait(since, timeout=0.5)
                continue
            for ts, blob in batch:
                msg = messaging_pb2.Message()
                msg.ParseFromString(blob)
                msg.event_time_ns = ts
                yield messaging_pb2.BrokerMessage(data=msg)
                since = max(since, ts)

    def DeleteTopic(self, request, context):
        ns, topic = request.namespace, request.topic
        with self._lock:
            self._topics.pop((ns, topic), None)
        if self.filer_url:
            try:
                stub = filer_stub(self.filer_url)
                # drop the whole topic directory: every partition log
                # regardless of how wide the topic was configured
                stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
                    directory=f"{TOPICS_DIR}/{ns}", name=topic,
                    is_delete_data=True, is_recursive=True,
                    ignore_recursive_error=True))
                stub.KvPut(filer_pb2.KvPutRequest(
                    key=self._cfg_key(ns, topic), value=b""))
            except rpc.RpcError:
                pass
        return messaging_pb2.DeleteTopicResponse()

    def ConfigureTopic(self, request, context):
        t = self._get_topic(request.namespace, request.topic)
        want = request.configuration.partition_count or DEFAULT_PARTITIONS
        with self._lock:
            t.config.CopyFrom(request.configuration)
            t.config.partition_count = want
            while len(t.partitions) < want:
                t.partitions.append(_Partition())
        self._persist_config(request.namespace, request.topic, t)
        return messaging_pb2.ConfigureTopicResponse()

    def GetTopicConfiguration(self, request, context):
        t = self._get_topic(request.namespace, request.topic)
        return messaging_pb2.GetTopicConfigurationResponse(
            configuration=t.config)

    def FindBroker(self, request, context):
        """Which broker owns a TOPIC: consistent hash over the
        configured broker cluster (reference
        broker/consistent_distribution.go PickMember) — every broker
        answers identically, so clients may bootstrap from any one.
        Placement is per topic, not per partition: this broker's
        partition logs, configuration, and delete are whole-topic
        state, so splitting one topic's partitions across brokers
        would strand subscribers on empty logs."""
        members = self.peers or [self.url]
        from seaweedfs_tpu_torch.messaging.consistent import pick_member
        key = f"{request.namespace}/{request.topic}".encode()
        return messaging_pb2.FindBrokerResponse(
            broker=pick_member(members, key))
