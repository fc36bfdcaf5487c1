"""Minimal etcd v3 client over the JSON gateway (standard library only).

The port of ``seaweedfs_tpu.util.etcd_client``. The reference links the
etcd clientv3 gRPC SDK (weed/sequence/etcd_sequencer.go); this client
speaks etcd's built-in HTTP/JSON gateway (``/v3/kv/*``, base64 keys and
values): KV CRUD, prefix ranges and the compare-and-swap transactions the
etcd sequencer needs.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request
from typing import List, Optional, Tuple


class EtcdError(Exception):
    pass


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def prefix_range_end(prefix: bytes) -> bytes:
    """etcd convention: the key range [prefix, prefix+1) covers every
    key with that prefix."""
    end = bytearray(prefix)
    for i in range(len(end) - 1, -1, -1):
        if end[i] < 0xFF:
            end[i] += 1
            return bytes(end[: i + 1])
    return b"\x00"  # all-0xff prefix: range to the end of keyspace


class EtcdClient:
    def __init__(self, endpoint: str = "127.0.0.1:2379",
                 timeout: float = 10.0):
        self.base = "http://" + endpoint.replace("http://", "").rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.load(r)
        except urllib.error.HTTPError as e:
            raise EtcdError(
                f"etcd {path}: HTTP {e.code} "
                f"{e.read().decode('utf-8', 'replace')[:200]}") from None
        except urllib.error.URLError as e:
            raise EtcdError(f"etcd {path}: {e.reason}") from None

    # -- KV ------------------------------------------------------------------

    def put(self, key: bytes, value: bytes) -> None:
        self._post("/v3/kv/put",
                   {"key": _b64(key), "value": _b64(value)})

    def get(self, key: bytes) -> Optional[bytes]:
        kvs = self.range(key)
        return kvs[0][1] if kvs else None

    def range(self, key: bytes, range_end: Optional[bytes] = None,
              limit: int = 0) -> List[Tuple[bytes, bytes]]:
        body = {"key": _b64(key)}
        if range_end is not None:
            body["range_end"] = _b64(range_end)
        if limit:
            body["limit"] = str(limit)
        body["sort_order"] = "ASCEND"
        body["sort_target"] = "KEY"
        resp = self._post("/v3/kv/range", body)
        return [(_unb64(kv["key"]), _unb64(kv.get("value", "")))
                for kv in resp.get("kvs", [])]

    def delete_range(self, key: bytes,
                     range_end: Optional[bytes] = None) -> int:
        body = {"key": _b64(key)}
        if range_end is not None:
            body["range_end"] = _b64(range_end)
        resp = self._post("/v3/kv/deleterange", body)
        return int(resp.get("deleted", 0))

    # -- transactions --------------------------------------------------------

    def cas(self, key: bytes, expect: Optional[bytes],
            new_value: bytes) -> bool:
        """Compare-and-swap: expect=None means 'key must not exist'.
        Returns True when the swap applied."""
        if expect is None:
            compare = [{"key": _b64(key), "target": "CREATE",
                        "result": "EQUAL", "create_revision": "0"}]
        else:
            compare = [{"key": _b64(key), "target": "VALUE",
                        "result": "EQUAL", "value": _b64(expect)}]
        body = {
            "compare": compare,
            "success": [{"request_put": {"key": _b64(key),
                                         "value": _b64(new_value)}}],
            "failure": [],
        }
        resp = self._post("/v3/kv/txn", body)
        return bool(resp.get("succeeded", False))
