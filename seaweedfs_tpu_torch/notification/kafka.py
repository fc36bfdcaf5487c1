"""Kafka notification queue speaking the binary wire protocol — no SDK.

Behavioral parity with the reference's sarama producer
(weed/notification/kafka/kafka_queue.go:15-64): events are produced to
one topic, keyed by the entry path, value = the serialized
EventNotification, partition chosen by hashing the key the way
sarama's default HashPartitioner does (FNV-1a 32-bit, toPositive, mod
numPartitions).

Protocol subset implemented here:
  - Metadata v1  (leader discovery per partition)
  - Produce  v3  (acks=1) carrying a RecordBatch v2 (magic 2): CRC32C
    over the batch body, zigzag-varint record framing
Both are supported by every broker since Kafka 0.11 and are the only
message format modern brokers (3.x+) still accept for writes.

The port of ``seaweedfs_tpu_torch.notification.kafka``: the same requests,
byte for byte; the batch checksum is ``native/crc.py``'s CRC-32C.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, Optional, Tuple

from seaweedfs_tpu_torch.native import crc
from seaweedfs_tpu_torch.notification import MessageQueue


class KafkaError(Exception):
    pass


# -- primitive codecs ---------------------------------------------------------


def _int8(v):
    return struct.pack(">b", v)


def _int16(v):
    return struct.pack(">h", v)


def _int32(v):
    return struct.pack(">i", v)


def _int64(v):
    return struct.pack(">q", v)


def _string(s: Optional[str]) -> bytes:
    if s is None:
        return _int16(-1)
    b = s.encode()
    return _int16(len(b)) + b


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return _int32(-1)
    return _int32(len(b)) + b


def _varint(v: int) -> bytes:
    """Zigzag-encoded signed varint (record framing)."""
    z = (v << 1) ^ (v >> 63)
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = z = 0
    while True:
        b = buf[pos]
        pos += 1
        z |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (z >> 1) ^ -(z & 1), pos


# -- CRC32C (Castagnoli), the RecordBatch checksum: the port's own ---------

crc32c = crc.crc32c


# -- sarama-compatible key partitioner ---------------------------------------


def fnv1a_32(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def partition_for_key(key: bytes, num_partitions: int) -> int:
    """sarama NewHashPartitioner: FNV-1a 32 as int32, negated when
    negative, mod numPartitions."""
    h = fnv1a_32(key)
    if h & 0x80000000:            # int32 < 0 -> -h, like sarama
        h = (1 << 32) - h
    return h % num_partitions


# -- record batch (magic 2) ---------------------------------------------------


def encode_record_batch(key: bytes, value: bytes, timestamp_ms: int) -> bytes:
    record_body = (
        _int8(0)                      # record attributes
        + _varint(0)                  # timestamp delta
        + _varint(0)                  # offset delta
        + _varint(len(key)) + key
        + _varint(len(value)) + value
        + _varint(0)                  # headers count
    )
    record = _varint(len(record_body)) + record_body
    body = (
        _int16(0)                     # batch attributes (no compression)
        + _int32(0)                   # lastOffsetDelta
        + _int64(timestamp_ms)        # firstTimestamp
        + _int64(timestamp_ms)        # maxTimestamp
        + _int64(-1)                  # producerId
        + _int16(-1)                  # producerEpoch
        + _int32(-1)                  # baseSequence
        + _int32(1)                   # record count
        + record
    )
    header = (
        _int64(0)                     # baseOffset
        + _int32(4 + 1 + 4 + len(body))   # batchLength (after this field)
        + _int32(-1)                  # partitionLeaderEpoch
        + _int8(2)                    # magic
        + struct.pack(">I", crc32c(body))  # crc (unsigned, covers body)
    )
    return header + body


class KafkaQueue(MessageQueue):
    """Synchronous wire client; production configs get wrapped in
    notification.AsyncQueue by from_config so a down broker stalls the
    sender thread, not the filer write path."""

    def __init__(self, hosts=None, topic: str = "seaweedfs_filer",
                 client_id: str = "seaweedfs-tpu",
                 timeout: float = 10.0, **_ignored):
        if isinstance(hosts, str):
            hosts = [h.strip() for h in hosts.split(",") if h.strip()]
        if not hosts:
            raise ValueError("kafka needs hosts = [\"host:port\", ...]")
        self.hosts = hosts
        self.topic = topic
        self.client_id = client_id
        self.timeout = timeout
        self._corr = 0
        # one lock serializes all wire traffic: connections are shared
        # per broker and concurrent callers touch shared state
        self._lock = threading.Lock()
        self._conns: Dict[str, socket.socket] = {}
        # leader discovery up front, like sarama's producer
        self.partition_leaders: Dict[int, str] = {}
        self.num_partitions = 0   # TOTAL partitions (even leaderless)
        with self._lock:
            self._refresh_metadata()

    # -- framing --------------------------------------------------------------

    def _connect(self, host: str) -> socket.socket:
        sock = self._conns.get(host)
        if sock is not None:
            return sock
        h, _, p = host.partition(":")
        sock = socket.create_connection((h, int(p or 9092)),
                                        timeout=self.timeout)
        self._conns[host] = sock
        return sock

    def _drop(self, host: str) -> None:
        sock = self._conns.pop(host, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _call(self, host: str, api_key: int, api_version: int,
              body: bytes) -> bytes:
        """One size-framed request/response round trip."""
        self._corr += 1
        corr = self._corr
        msg = (_int16(api_key) + _int16(api_version) + _int32(corr)
               + _string(self.client_id) + body)
        sock = self._connect(host)
        try:
            sock.sendall(_int32(len(msg)) + msg)
            raw = self._read_exact(sock, 4)
            (size,) = struct.unpack(">i", raw)
            resp = self._read_exact(sock, size)
        except OSError as e:
            self._drop(host)
            raise KafkaError(f"kafka {host}: {e}") from None
        (got_corr,) = struct.unpack(">i", resp[:4])
        if got_corr != corr:
            self._drop(host)
            raise KafkaError(f"kafka {host}: correlation mismatch")
        return resp[4:]

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise OSError("connection closed")
            buf += chunk
        return buf

    # -- metadata -------------------------------------------------------------

    def _refresh_metadata(self, attempts: int = 3) -> None:
        """Bounded retry like sarama (Metadata.Retry.Max): a Metadata
        request against a fresh broker triggers topic auto-creation and
        the immediate response has no leaders yet — the next poll
        does."""
        import time
        err: Optional[Exception] = None
        for attempt in range(attempts):
            for host in self.hosts:
                try:
                    body = _int32(1) + _string(self.topic)  # [topic]
                    resp = self._call(host, 3, 1, body)     # Metadata v1
                    self._parse_metadata(resp)
                    if self.partition_leaders:
                        return
                except (KafkaError, OSError) as e:
                    err = e
            if attempt < attempts - 1:
                time.sleep(0.25 * (attempt + 1))
        raise KafkaError(
            f"no kafka broker reachable or topic {self.topic!r} has no "
            f"leaders (hosts={self.hosts}): {err}")

    def _parse_metadata(self, b: bytes) -> None:
        pos = 0
        (n_brokers,) = struct.unpack_from(">i", b, pos)
        pos += 4
        brokers: Dict[int, str] = {}
        for _ in range(n_brokers):
            (node_id,) = struct.unpack_from(">i", b, pos)
            pos += 4
            (hlen,) = struct.unpack_from(">h", b, pos)
            pos += 2
            host = b[pos:pos + hlen].decode()
            pos += hlen
            (port,) = struct.unpack_from(">i", b, pos)
            pos += 4
            (rlen,) = struct.unpack_from(">h", b, pos)  # rack (nullable)
            pos += 2 + max(rlen, 0)
            brokers[node_id] = f"{host}:{port}"
        pos += 4                                        # controller_id
        (n_topics,) = struct.unpack_from(">i", b, pos)
        pos += 4
        leaders: Dict[int, str] = {}
        total = 0
        for _ in range(n_topics):
            (topic_err,) = struct.unpack_from(">h", b, pos)
            pos += 2
            (tlen,) = struct.unpack_from(">h", b, pos)
            pos += 2
            name = b[pos:pos + tlen].decode()
            pos += tlen
            pos += 1                                    # is_internal bool
            (n_parts,) = struct.unpack_from(">i", b, pos)
            pos += 4
            if name == self.topic:
                total = n_parts
            for _ in range(n_parts):
                (perr, pid, leader) = struct.unpack_from(">hii", b, pos)
                pos += 10
                (n_replicas,) = struct.unpack_from(">i", b, pos)
                pos += 4 + 4 * n_replicas
                (n_isr,) = struct.unpack_from(">i", b, pos)
                pos += 4 + 4 * n_isr
                if name == self.topic and perr == 0 and leader in brokers:
                    leaders[pid] = brokers[leader]
        self.partition_leaders = leaders
        # the key->partition map must use the TOTAL partition count:
        # hashing over only the currently-leadered ones would remap
        # every key whenever one partition loses its leader
        self.num_partitions = total

    # -- produce --------------------------------------------------------------

    # produce error codes that a metadata refresh can fix
    _RETRIABLE = (5, 6)   # LEADER_NOT_AVAILABLE, NOT_LEADER_FOR_PARTITION

    def send_message(self, key, event) -> None:
        import time
        kb, value = key.encode(), event.SerializeToString()
        with self._lock:
            if not self.num_partitions:
                self._refresh_metadata()

            def build():
                # partition + request body derive from the CURRENT
                # metadata; after a refresh both must be recomputed
                # (sarama re-partitions on retry too) or a re-created/
                # expanded topic would see the key land off-map
                partition = partition_for_key(kb, self.num_partitions)
                batch = encode_record_batch(kb, value,
                                            int(time.time() * 1000))
                return partition, (
                    _string(None)     # transactional_id (Produce v3)
                    + _int16(1)       # acks = leader (WaitForLocal)
                    + _int32(int(self.timeout * 1000))
                    + _int32(1) + _string(self.topic)
                    + _int32(1) + _int32(partition)
                    + _bytes(batch)
                )

            partition, body = build()
            try:
                self._produce(partition, body)
            except KafkaError as e:
                # stale leader (transport error OR a retriable produce
                # error code): refresh once and retry on the new one
                if getattr(e, "code", None) is not None and \
                        e.code not in self._RETRIABLE:
                    raise
                self._refresh_metadata()
                partition, body = build()
                self._produce(partition, body)

    def _produce(self, partition: int, body: bytes) -> None:
        leader = self.partition_leaders.get(partition)
        if leader is None:
            raise KafkaError(
                f"partition {partition} of {self.topic!r} has no leader")
        resp = self._call(leader, 0, 3, body)           # Produce v3
        self._check_produce_response(resp)

    @staticmethod
    def _check_produce_response(b: bytes) -> None:
        pos = 4                                         # topic array len
        (tlen,) = struct.unpack_from(">h", b, pos)
        pos += 2 + tlen
        pos += 4                                        # partition array len
        (_pid, err) = struct.unpack_from(">ih", b, pos)
        if err != 0:
            e = KafkaError(f"produce failed: kafka error code {err}")
            e.code = err
            raise e

    def close(self) -> None:
        with self._lock:
            for host in list(self._conns):
                self._drop(host)
