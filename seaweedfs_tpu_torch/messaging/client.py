"""Messaging client: publishers, subscribers, and named pub/sub
CHANNELS over the broker's bidi streams, with consistent-hash broker
discovery (reference: weed/messaging/msgclient — client.go findBroker,
chan_pub.go/chan_sub.go channel objects with md5 integrity sums,
publisher.go/subscriber.go the partitioned forms). The port of
``seaweedfs_tpu_torch.messaging.client`` on the port's RPC plane."""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.pb import messaging_pb2, messaging_stub


class Publisher:
    def __init__(self, broker_url: str, namespace: str, topic: str,
                 partition: int = -1):
        self.stub = messaging_stub(broker_url)
        self._q: "queue.Queue" = queue.Queue()
        self._q.put(messaging_pb2.PublishRequest(
            init=messaging_pb2.PublishRequest.InitMessage(
                namespace=namespace, topic=topic, partition=partition)))
        self._call = self.stub.Publish(self._request_iter())
        self._responses = iter(self._call)
        first = next(self._responses)  # config message
        self.partition_count = first.config.partition_count

    def _request_iter(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def publish(self, value: bytes, key: bytes = b"",
                headers: Optional[dict] = None) -> None:
        msg = messaging_pb2.Message(
            event_time_ns=time.time_ns(), key=key, value=value)
        for k, v in (headers or {}).items():
            msg.headers[k] = v
        self._q.put(messaging_pb2.PublishRequest(data=msg))
        next(self._responses)  # per-message ack

    def close(self) -> None:
        self._q.put(messaging_pb2.PublishRequest(
            data=messaging_pb2.Message(is_close=True)))
        try:
            next(self._responses)
        except StopIteration:
            pass
        self._q.put(None)


class Subscriber:
    def __init__(self, broker_url: str, namespace: str, topic: str,
                 partition: int = 0, start: str = "latest",
                 since_ns: int = 0, subscriber_id: str = ""):
        Start = messaging_pb2.SubscriberMessage.InitMessage
        pos = {"latest": Start.LATEST, "earliest": Start.EARLIEST,
               "timestamp": Start.TIMESTAMP}[start]
        init = messaging_pb2.SubscriberMessage(
            init=Start(namespace=namespace, topic=topic,
                       partition=partition, startPosition=pos,
                       timestampNs=since_ns,
                       subscriber_id=subscriber_id))
        self._call = messaging_stub(broker_url).Subscribe(iter([init]))

    def __iter__(self) -> Iterator[messaging_pb2.Message]:
        for resp in self._call:
            if resp.data.is_close:
                return
            yield resp.data

    def cancel(self) -> None:
        self._call.cancel()


class PubChannel:
    """Named channel writer (reference chan_pub.go): a publisher on
    ("chan", name, partition 0) that md5-sums everything it sends, so
    both ends can compare integrity after the stream closes."""

    def __init__(self, client: "MessagingClient", chan_name: str):
        broker = client.find_broker("chan", chan_name, 0)
        self._pub = Publisher(broker, "chan", chan_name, partition=0)
        self._md5 = hashlib.md5()

    def publish(self, value: bytes) -> None:
        self._pub.publish(value)
        self._md5.update(value)

    def md5(self) -> bytes:
        return self._md5.digest()

    def close(self) -> None:
        self._pub.close()


class SubChannel:
    """Named channel reader (reference chan_sub.go): a background
    stream fills a local queue; iteration ends at the writer's close
    message. md5() mirrors PubChannel for integrity comparison."""

    def __init__(self, client: "MessagingClient", subscriber_id: str,
                 chan_name: str):
        broker = client.find_broker("chan", chan_name, 0)
        self._sub = Subscriber(broker, "chan", chan_name, partition=0,
                               start="earliest",
                               subscriber_id=subscriber_id)
        self._md5 = hashlib.md5()
        self._q: "queue.Queue" = queue.Queue()
        # lint: gate-ok(a subscription's pump starts at subscribe: construction is first use) # lint: thread-ok(pump feeds a local queue; no deadline or trace to carry)
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self) -> None:
        try:
            for msg in self._sub:
                self._md5.update(msg.value)
                self._q.put(msg.value)
        except rpc.RpcError as e:
            # a broken stream must NOT look like the writer's clean
            # close — consumers would silently process a truncated
            # prefix as if complete
            self._q.put(("error", e))
            return
        self._q.put(None)  # clean-close sentinel

    def __iter__(self) -> Iterator[bytes]:
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, tuple) and item[0] == "error":
                raise RuntimeError(
                    "channel stream broke before close") from item[1]
            yield item

    def md5(self) -> bytes:
        return self._md5.digest()

    def cancel(self) -> None:
        self._sub.cancel()


class MessagingClient:
    """Entry point bound to one or more bootstrap brokers. Every
    (namespace, topic, partition) resolves to its owning broker via
    FindBroker (the brokers consistent-hash placement identically, so
    any bootstrap broker can answer), cached per topic-partition
    (reference client.go findBroker + grpcConnections cache)."""

    def __init__(self, *broker_urls: str):
        if not broker_urls:
            raise ValueError("need at least one bootstrap broker")
        self.bootstrap = list(broker_urls)
        self._owners: Dict[Tuple[str, str], str] = {}
        self._lock = threading.Lock()

    @property
    def broker_url(self) -> str:
        return self.bootstrap[0]

    def find_broker(self, namespace: str, topic: str,
                    partition: int = 0) -> str:
        """Placement is per TOPIC (all partitions co-locate — see
        MessageBroker.FindBroker); `partition` is accepted for API
        symmetry and forwarded, but does not affect the answer."""
        tp = (namespace, topic)
        with self._lock:
            cached = self._owners.get(tp)
        if cached:
            return cached
        last_err: Optional[Exception] = None
        for b in self.bootstrap:
            try:
                resp = messaging_stub(b).FindBroker(
                    messaging_pb2.FindBrokerRequest(
                        namespace=namespace, topic=topic,
                        parition=partition))
                with self._lock:
                    self._owners[tp] = resp.broker
                return resp.broker
            except rpc.RpcError as e:
                last_err = e
        raise RuntimeError(
            f"no bootstrap broker reachable: {last_err}")

    def new_publisher(self, namespace: str, topic: str,
                      partition: int = -1) -> Publisher:
        return Publisher(self.find_broker(namespace, topic),
                         namespace, topic, partition)

    def new_subscriber(self, namespace: str, topic: str,
                       partition: int = 0, start: str = "latest",
                       since_ns: int = 0) -> Subscriber:
        return Subscriber(self.find_broker(namespace, topic),
                          namespace, topic, partition, start, since_ns)

    def new_pub_channel(self, chan_name: str) -> PubChannel:
        return PubChannel(self, chan_name)

    def new_sub_channel(self, subscriber_id: str,
                        chan_name: str) -> SubChannel:
        return SubChannel(self, subscriber_id, chan_name)

    def configure_topic(self, namespace: str, topic: str,
                        partition_count: int) -> None:
        messaging_stub(self.find_broker(namespace, topic)) \
            .ConfigureTopic(messaging_pb2.ConfigureTopicRequest(
                namespace=namespace, topic=topic,
                configuration=messaging_pb2.TopicConfiguration(
                    partition_count=partition_count)))

    def delete_topic(self, namespace: str, topic: str) -> None:
        messaging_stub(self.find_broker(namespace, topic)) \
            .DeleteTopic(messaging_pb2.DeleteTopicRequest(
                namespace=namespace, topic=topic))
