"""Redis FilerStore over a RESP client of its own: the port of
``seaweedfs_tpu.filer.stores.redis_store`` (reference
weed/filer/redis/universal_redis_store.go, which rides go-redis). The
wire protocol is spoken directly: RESP arrays of bulk strings, the
half-dozen commands the store needs.

Layout matches the reference and the JAX package byte for byte: the
serialized Entry lives at the full path key; each directory has a SET
of child names at ``<dir>\x00:children`` powering listings; KV pairs at
``kv:<key>``. ``RedisClusterStore`` (``redis_cluster``, and
``redis_cluster2`` in the factory) is the same store over a slot-routing
client: CLUSTER SLOTS, MOVED and ASK redirects, a failed node dropped.
"""

from __future__ import annotations

import socket
import threading
from typing import List

from seaweedfs_tpu_torch.filer.filerstore import (FilerStore, NotFound,
                                            join_path, normalize_path)
from seaweedfs_tpu_torch.pb import filer_pb2

DIR_LIST_MARKER = b"\x00:children"


class RespError(Exception):
    pass


class RespConnectionError(RespError, OSError):
    """Connection-level RESP failure (peer closed / reset): distinct
    from a server -ERR reply so cluster routing can treat it as a node
    failure (drop the connection, refresh the slot map, re-route)."""


class RespClient:
    """One redis connection; thread-safe via a lock (the store's call
    pattern is short request/response, no pipelining needed)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 password: str = "", database: int = 0,
                 timeout: float = 10.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._buf = self._sock.makefile("rb")
        self._lock = threading.Lock()
        if password:
            self.command(b"AUTH", password.encode())
        if database:
            self.command(b"SELECT", str(database).encode())

    def command(self, *parts: bytes):
        with self._lock:
            out = [b"*%d\r\n" % len(parts)]
            for p in parts:
                out.append(b"$%d\r\n%s\r\n" % (len(p), p))
            # lint: block-ok(single-socket wire protocol: the lock IS the request/response serializer)
            self._sock.sendall(b"".join(out))
            return self._read_reply()

    def _read_reply(self):
        line = self._buf.readline()
        if not line:
            raise RespConnectionError("connection closed")
        kind, rest = line[:1], line[1:-2]
        if kind == b"+":
            return rest
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None
            data = self._buf.read(n + 2)
            return data[:-2]
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RespError(f"bad reply type {kind!r}")

    def command_asking(self, *parts: bytes):
        """ASKING + command pipelined under ONE lock hold — the ASK
        redirect's one-shot permission must not be consumed by another
        thread's command interleaving on this shared connection."""
        with self._lock:
            out = [b"*1\r\n$6\r\nASKING\r\n",
                   b"*%d\r\n" % len(parts)]
            for p in parts:
                out.append(b"$%d\r\n%s\r\n" % (len(p), p))
            # lint: block-ok(single-socket wire protocol: the lock IS the request/response serializer)
            self._sock.sendall(b"".join(out))
            self._read_reply()  # +OK for ASKING
            return self._read_reply()

    # batch-sweep surface shared with RedisClusterClient so the store
    # code is transport-agnostic
    def scan_batches(self, pattern: bytes, count: int = 512):
        """Yield batches of keys matching `pattern` via cursored SCAN."""
        cursor = b"0"
        while True:
            reply = self.command(b"SCAN", cursor, b"MATCH", pattern,
                                 b"COUNT", str(count).encode())
            cursor, keys = reply[0], reply[1]
            if keys:
                yield keys
            if cursor == b"0":
                return

    def delete_many(self, keys):
        if keys:
            self.command(b"DEL", *keys)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


# -- cluster mode -------------------------------------------------------------

# CRC16/XMODEM (poly 0x1021), the redis cluster key-slot hash
_CRC16_TABLE = []
for _i in range(256):
    _c = _i << 8
    for _ in range(8):
        _c = ((_c << 1) ^ 0x1021) if _c & 0x8000 else (_c << 1)
    _CRC16_TABLE.append(_c & 0xFFFF)


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]
    return crc


def key_slot(key: bytes) -> int:
    """Redis cluster slot for a key: CRC16 mod 16384, hashing only the
    {hash tag} span when one is present (the cluster spec's rule)."""
    brace = key.find(b"{")
    if brace >= 0:
        close = key.find(b"}", brace + 1)
        if close > brace + 1:  # non-empty tag only
            key = key[brace + 1:close]
    return crc16(key) % 16384


class RedisClusterClient:
    """Cluster-aware RESP client: startup CLUSTER SLOTS map, per-key
    slot routing, MOVED (remap + retry) and ASK (one-shot redirect
    with ASKING) handling — the go-redis ClusterClient behavior the
    reference's redis_cluster stores lean on
    (weed/filer/redis2/redis_cluster_store.go:35-42).
    """

    MAX_REDIRECTS = 5

    def __init__(self, addresses, password: str = "",
                 timeout: float = 10.0):
        self._password = password
        self._timeout = timeout
        # refresh_slots iterates a lock-free snapshot (stale is fine —
        # a dropped node just errors and is skipped); inserts/drops lock
        self._conns = {}  # guarded_by(self._lock, writes)   (host, port) -> RespClient
        self._lock = threading.Lock()
        self._slots: List[tuple] = []  # (start, end, (host, port))
        self._seeds = []
        for addr in addresses:
            host, _, port = str(addr).partition(":")
            self._seeds.append((host or "127.0.0.1", int(port or 6379)))
        self.refresh_slots()

    def _conn(self, node) -> RespClient:
        with self._lock:
            c = self._conns.get(node)
        if c is not None:
            return c
        # dial OUTSIDE the lock: a down node's connect timeout must not
        # stall threads talking to healthy nodes
        c = RespClient(node[0], node[1], password=self._password,
                       timeout=self._timeout)
        with self._lock:
            existing = self._conns.get(node)
            if existing is not None:
                c.close()
                return existing
            self._conns[node] = c
            return c

    def _drop_conn(self, node) -> None:
        with self._lock:
            c = self._conns.pop(node, None)
        if c is not None:
            c.close()

    def refresh_slots(self) -> None:
        last_err: Exception = RespError("no seed nodes")
        for node in self._seeds + list(self._conns):
            try:
                raw = self._conn(node).command(b"CLUSTER", b"SLOTS")
            except (OSError, RespError) as e:
                last_err = e
                self._drop_conn(node)
                continue
            slots = []
            for row in raw or []:
                start, end, master = int(row[0]), int(row[1]), row[2]
                slots.append((start, end,
                              (master[0].decode(), int(master[1]))))
            if slots:
                self._slots = slots
                return
        raise last_err

    def _node_for(self, slot: int):
        for start, end, node in self._slots:
            if start <= slot <= end:
                return node
        # stale/empty map: re-ask the cluster
        self.refresh_slots()
        for start, end, node in self._slots:
            if start <= slot <= end:
                return node
        raise RespError(f"no node serves slot {slot}")

    @staticmethod
    def _parse_redirect(msg: str):
        # "MOVED 3999 127.0.0.1:6381" / "ASK 3999 127.0.0.1:6381"
        parts = msg.split()
        host, _, port = parts[2].partition(":")
        return int(parts[1]), (host, int(port))

    def command(self, *parts: bytes):
        """Route by the command's key (parts[1]) with redirect
        handling."""
        return self._routed(key_slot(bytes(parts[1])), parts)

    def _routed(self, slot: int, parts):
        node = self._node_for(slot)
        asking = False
        for _ in range(self.MAX_REDIRECTS):
            try:
                conn = self._conn(node)
                if asking:
                    return conn.command_asking(*parts)
                return conn.command(*parts)
            except OSError:
                # node unreachable or died mid-conversation
                # (RespConnectionError is an OSError): drop the
                # connection, re-learn the map from survivors, re-route
                self._drop_conn(node)
                self.refresh_slots()
                node = self._node_for(slot)
                asking = False
            except RespError as e:
                msg = str(e)
                if msg.startswith("MOVED "):
                    _, node = self._parse_redirect(msg)
                    # topology changed: refresh the whole map (a
                    # migration rarely moves just one slot)
                    try:
                        self.refresh_slots()
                    except (OSError, RespError):
                        pass  # routing still follows the redirect
                    asking = False
                    continue
                if msg.startswith("ASK "):
                    # one-shot redirect, no remap (slot mid-migration)
                    _, node = self._parse_redirect(msg)
                    asking = True
                    continue
                raise
        raise RespError(f"redirect loop for slot {slot}")

    def masters(self):
        seen = []
        for _start, _end, node in self._slots:
            if node not in seen:
                seen.append(node)
        return seen

    def scan_batches(self, pattern: bytes, count: int = 512):
        """Cursored SCAN over EVERY master — cluster keyspaces are
        per-node, so a sweep must visit each one."""
        for node in self.masters():
            conn = self._conn(node)
            cursor = b"0"
            while True:
                reply = conn.command(b"SCAN", cursor, b"MATCH", pattern,
                                     b"COUNT", str(count).encode())
                cursor, keys = reply[0], reply[1]
                if keys:
                    yield keys
                if cursor == b"0":
                    break

    def delete_many(self, keys) -> None:
        """DEL grouped by slot — a multi-key DEL crossing slots is a
        CROSSSLOT error on a real cluster."""
        by_slot: dict = {}
        for k in keys:
            by_slot.setdefault(key_slot(bytes(k)), []).append(k)
        for slot, group in by_slot.items():
            self._routed(slot, (b"DEL", *group))

    def close(self) -> None:
        with self._lock:
            conns, self._conns = list(self._conns.values()), {}
        for c in conns:
            c.close()


class RedisStore(FilerStore):
    name = "redis"

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 password: str = "", database: int = 0):
        self.client = RespClient(host, port, password=password,
                                 database=database)

    @staticmethod
    def _children_key(directory: str) -> bytes:
        return normalize_path(directory).encode() + DIR_LIST_MARKER

    def insert_entry(self, directory, entry):
        directory = normalize_path(directory)
        path = join_path(directory, entry.name)
        self.client.command(b"SET", path.encode(),
                            entry.SerializeToString())
        self.client.command(b"SADD", self._children_key(directory),
                            entry.name.encode())

    update_entry = insert_entry

    def find_entry(self, directory, name):
        path = join_path(normalize_path(directory), name)
        blob = self.client.command(b"GET", path.encode())
        if blob is None:
            raise NotFound(path)
        e = filer_pb2.Entry()
        e.ParseFromString(blob)
        return e

    def delete_entry(self, directory, name):
        directory = normalize_path(directory)
        path = join_path(directory, name)
        self.client.command(b"DEL", path.encode())
        self.client.command(b"DEL", path.encode() + DIR_LIST_MARKER)
        self.client.command(b"SREM", self._children_key(directory),
                            name.encode())

    @staticmethod
    def _glob_escape(b: bytes) -> bytes:
        out = bytearray()
        for c in b:
            if c in b"*?[\\":
                out += b"[" + bytes([c]) + b"]"
            else:
                out.append(c)
        return bytes(out)

    def delete_folder_children(self, directory):
        """Prefix sweep via cursored SCAN (non-blocking on a production
        redis, unlike KEYS) with batched DELs: also wipes orphan
        subtrees whose parent entry was never written (the SPI contract
        the path-prefix SQL stores satisfy). scan_batches/delete_many
        hide the topology: one node standalone, every master + per-slot
        DEL groups in cluster mode."""
        directory = normalize_path(directory)
        prefix = (directory.rstrip("/") + "/").encode()
        pattern = self._glob_escape(prefix) + b"*"
        for keys in self.client.scan_batches(pattern):
            self.client.delete_many(keys)
        self.client.command(b"DEL", self._children_key(directory))

    def list_directory_entries(self, directory, start_name="",
                               inclusive=False, limit=1024, prefix=""):
        directory = normalize_path(directory)
        names = sorted(
            n.decode() for n in (self.client.command(
                b"SMEMBERS", self._children_key(directory)) or []))
        out: List[filer_pb2.Entry] = []
        for name in names:
            if prefix and not name.startswith(prefix):
                continue
            if start_name:
                if name < start_name or \
                        (name == start_name and not inclusive):
                    continue
            try:
                out.append(self.find_entry(directory, name))
            except NotFound:
                # child-set entry without a path key (torn write):
                # self-heal the set instead of failing every listing
                self.client.command(b"SREM",
                                    self._children_key(directory),
                                    name.encode())
            if len(out) >= limit:
                break
        return out

    def kv_put(self, key, value):
        self.client.command(b"SET", b"kv:" + bytes(key), bytes(value))

    def kv_get(self, key):
        return self.client.command(b"GET", b"kv:" + bytes(key))

    def close(self):
        self.client.close()


class RedisClusterStore(RedisStore):
    """RedisStore over a RedisClusterClient (reference
    weed/filer/redis/redis_cluster_store.go +
    redis2/redis_cluster_store.go — go-redis ClusterClient under the
    same universal store logic; here the universal logic IS RedisStore
    and only the transport changes)."""

    name = "redis_cluster"

    def __init__(self, addresses, password: str = ""):
        self.client = RedisClusterClient(addresses, password=password)
