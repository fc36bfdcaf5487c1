"""Notification queues: publish filer events for external consumers
(reference: weed/notification — log/Kafka/SQS/PubSub backends behind
one interface). The port of ``seaweedfs_tpu_torch.notification``: the memory
and file-log queues, the registry, ``from_config`` for
notification.toml, and ``AsyncQueue``, whose sender thread exists only
once a remote backend (kafka, aws_sqs, google_pub_sub) is built."""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

from seaweedfs_tpu_torch.pb import filer_pb2
from seaweedfs_tpu_torch.util.log_buffer import LogEntry


class MessageQueue:
    """SPI: send_message(key, EventNotification)."""

    def send_message(self, key: str,
                     event: filer_pb2.EventNotification) -> None:
        raise NotImplementedError


class MemoryQueue(MessageQueue):
    """In-process queue with subscriber callbacks (test/dev backend)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.messages: List[Tuple[str, filer_pb2.EventNotification]] = []
        self._subscribers: List[Callable] = []

    def send_message(self, key, event):
        with self._lock:
            self.messages.append((key, event))
            subs = list(self._subscribers)
        for fn in subs:
            fn(key, event)

    def subscribe(self, fn: Callable) -> None:
        with self._lock:
            self._subscribers.append(fn)


class LogQueue(MessageQueue):
    """Append events to a local log file with the shared length-prefixed
    framing (reference notification/log — a debugging sink)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()

    def send_message(self, key, event):
        rec = filer_pb2.SubscribeMetadataResponse(
            directory=key, event_notification=event)
        blob = LogEntry(0, 0, rec.SerializeToString()).pack()
        with self._lock, open(self.path, "ab") as f:
            f.write(blob)

    def read_all(self) -> List[Tuple[str, filer_pb2.EventNotification]]:
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as f:
            blob = f.read()
        out = []
        for e in LogEntry.unpack_stream(blob):
            rec = filer_pb2.SubscribeMetadataResponse()
            rec.ParseFromString(e.data)
            out.append((rec.directory, rec.event_notification))
        return out


def _gated(name: str, package: str) -> Callable[..., MessageQueue]:
    """Factory for broker backends whose client SDK is not in this
    image (reference ships kafka/sqs/pubsub backends behind the same
    interface): config naming them fails loudly with the remedy."""
    def factory(*a, **kw):
        raise RuntimeError(
            f"notification backend {name!r} needs the {package} client "
            f"library, which is not in this image; use 'log' (durable "
            f"file queue) or 'memory', or install {package}")
    return factory


def _aws_sqs_factory(**kw) -> MessageQueue:
    # lazy import: aws_sqs imports MessageQueue from this module
    from seaweedfs_tpu_torch.notification.aws_sqs import AwsSqsQueue
    return AwsSqsQueue(**kw)


def _kafka_factory(**kw) -> MessageQueue:
    from seaweedfs_tpu_torch.notification.kafka import KafkaQueue
    return KafkaQueue(**kw)


def _pubsub_factory(**kw) -> MessageQueue:
    from seaweedfs_tpu_torch.notification.google_pub_sub import \
        GooglePubSubQueue
    return GooglePubSubQueue(**kw)


_REGISTRY: Dict[str, Callable[..., MessageQueue]] = {
    "memory": MemoryQueue,
    "log": LogQueue,
    "kafka": _kafka_factory,        # binary wire protocol, no SDK needed
    "aws_sqs": _aws_sqs_factory,    # SigV4 over HTTP, no SDK needed
    "google_pub_sub": _pubsub_factory,  # REST + RS256 JWT, no SDK needed
    "gocdk_pub_sub": _gated("gocdk_pub_sub", "a Go CDK bridge"),
}


def register(name: str, factory: Callable[..., MessageQueue]) -> None:
    _REGISTRY[name] = factory


def new_queue(name: str, **kwargs) -> MessageQueue:
    factory = _REGISTRY.get(name)
    if factory is None:
        raise ValueError(
            f"notification backend {name!r} not available in this "
            f"image; registered: {sorted(_REGISTRY)}")
    return factory(**kwargs)


# backends that talk to an external service get the async wrapper so
# their outages never stall the filer write path
_REMOTE = frozenset({"kafka", "aws_sqs", "google_pub_sub",
                     "gocdk_pub_sub"})


def from_config(conf) -> Optional[MessageQueue]:
    """Build the queue from a notification.toml Configuration: the
    first enabled [notification.X] section wins, its remaining keys
    become factory kwargs (reference notification.LoadConfiguration,
    weed/notification/configuration.go). Remote backends come back
    wrapped in AsyncQueue."""
    sections = (conf.get("notification") or {}) if conf else {}
    for name, props in sections.items():
        if not isinstance(props, dict) or not props.get("enabled"):
            continue
        kwargs = {k: v for k, v in props.items() if k != "enabled"}
        q = new_queue(name, **kwargs)
        return AsyncQueue(q) if name in _REMOTE else q
    return None


class AsyncQueue(MessageQueue):
    """Non-blocking wrapper for remote backends: send_message enqueues
    into a bounded buffer and a sender thread does the wire work, so a
    dead broker/endpoint stalls the publisher thread, not the filer
    write path (the reference gets this from sarama's AsyncProducer for
    kafka; here every remote backend rides the same mechanism). When
    the buffer is full the OLDEST event is dropped and counted."""

    MAX_PENDING = 1024

    def __init__(self, inner: MessageQueue):
        import collections
        self.inner = inner
        self._pending = collections.deque()
        self._cv = threading.Condition()
        self._inflight = 0
        self._closed = False
        self.dropped = 0
        self.failed = 0      # monotonic: sends the backend rejected
        self.last_error: Optional[Exception] = None   # None after success
        self.last_failure: Optional[Exception] = None  # never reset
        # lint: gate-ok(built only when a notification backend is configured) # lint: thread-ok(async sender is deliberately decoupled from the committing request)
        self._sender = threading.Thread(target=self._run,
                                        name="notify-sender", daemon=True)
        self._sender.start()

    def send_message(self, key, event) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("notification queue is closed")
            if len(self._pending) >= self.MAX_PENDING:
                self._pending.popleft()
                self.dropped += 1
            self._pending.append((key, event))
            self._cv.notify()

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until everything enqueued so far is delivered (or
        failed); False on timeout."""
        import time
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending or self._inflight:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.05))
        return True

    def _run(self) -> None:
        from seaweedfs_tpu_torch.util import wlog
        log = wlog.logger("notify")
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending and self._closed:
                    return
                key, event = self._pending.popleft()
                self._inflight += 1
            try:
                self.inner.send_message(key, event)
                with self._cv:
                    self.last_error = None
            except Exception as e:   # noqa: BLE001 — any backend error
                with self._cv:
                    self.last_error = e
                    self.last_failure = e
                    self.failed += 1
                log.warning("notification publish failed, event "
                            "dropped: %s", e)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._sender.join(timeout=30.0)
        if hasattr(self.inner, "close"):
            self.inner.close()
