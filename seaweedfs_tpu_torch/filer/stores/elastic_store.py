"""Elasticsearch FilerStore over its plain REST/JSON API: the port of
``seaweedfs_tpu.filer.stores.elastic_store``.

Reference weed/filer/elastic/v7/elastic_store.go (+_kv.go) rides the
olivere client; here the same API surface is spoken over the pooled
HTTP client (``util/http_client.py``): one index per top-level directory
(``.seaweedfs_<name>``), ``_doc`` id = md5(full path), a dedicated
``.seaweedfs_kv_entries`` index for KV pairs, basic-auth support.

As in the JAX package, documents carry explicit ``directory``, ``name``
and base64 ``meta`` fields, so listings are a term query + name range +
sort (the reference pages by ``_id``, an md5, which cannot give the
FilerStore contract's name-sorted listings).
"""

from __future__ import annotations

import base64
import hashlib
import json
import urllib.parse
from typing import List, Optional

from seaweedfs_tpu_torch.filer.filerstore import (FilerStore, NotFound,
                                            join_path, normalize_path)
from seaweedfs_tpu_torch.pb import filer_pb2
from seaweedfs_tpu_torch.util import http_client

INDEX_PREFIX = ".seaweedfs_"
INDEX_KV = ".seaweedfs_kv_entries"


class ElasticError(Exception):
    pass


class ElasticStore(FilerStore):
    name = "elastic7"

    def __init__(self, servers: Optional[List[str]] = None,
                 username: str = "", password: str = ""):
        self.server = (servers or ["localhost:9200"])[0]
        if self.server.startswith("http://"):
            self.server = self.server[7:]
        self.headers = {"Content-Type": "application/json"}
        if username and password:
            cred = base64.b64encode(
                f"{username}:{password}".encode()).decode()
            self.headers["Authorization"] = f"Basic {cred}"
        self._request("PUT", f"/{INDEX_KV}", ok_statuses=(200, 400))

    def _request(self, method: str, path: str, body: dict = None,
                 ok_statuses=(200, 201), query: str = "") -> dict:
        # the index name is the top-level directory's: percent-encode
        # the path so any name fits the request line (which is latin-1)
        # and a "?" or "#" in it stays in the path; the server decodes
        # it, so /_cat/indices lists the names as they were
        # (the JAX store sends the path raw)
        target = urllib.parse.quote(path, safe="/")
        if query:
            target += "?" + query
        r = http_client.request(
            method, f"{self.server}{target}",
            body=json.dumps(body).encode() if body is not None else None,
            headers=self.headers, timeout=30)
        if r.status not in ok_statuses and r.status != 404:
            raise ElasticError(
                f"{method} {path}: http {r.status} "
                f"{r.body[:200].decode('utf-8', 'replace')}")
        try:
            out = json.loads(r.body) if r.body else {}
        except ValueError:
            out = {}
        if isinstance(out, list):  # e.g. /_cat/indices?format=json
            out = {"_rows": out}
        out["_status"] = r.status
        return out

    # -- layout ---------------------------------------------------------------

    @staticmethod
    def _index_of(path: str) -> str:
        """Index per top-level directory (reference getIndex): /a/b/c
        lives in .seaweedfs_a; / itself is virtual."""
        parts = path.strip("/").split("/", 1)
        return INDEX_PREFIX + (parts[0] or "root")

    @staticmethod
    def _doc_id(path: str) -> str:
        return hashlib.md5(path.encode()).hexdigest()

    # -- SPI ------------------------------------------------------------------

    def insert_entry(self, directory, entry):
        directory = normalize_path(directory)
        full = join_path(directory, entry.name)
        doc = {"directory": directory, "name": entry.name,
               "meta": base64.b64encode(
                   entry.SerializeToString()).decode()}
        self._request(
            "PUT",
            f"/{self._index_of(full)}/_doc/{self._doc_id(full)}", doc,
            query="refresh=true")

    update_entry = insert_entry

    def find_entry(self, directory, name):
        directory = normalize_path(directory)
        full = join_path(directory, name)
        out = self._request(
            "GET", f"/{self._index_of(full)}/_doc/{self._doc_id(full)}")
        if out["_status"] == 404 or not out.get("found"):
            raise NotFound(full)
        e = filer_pb2.Entry()
        e.ParseFromString(base64.b64decode(out["_source"]["meta"]))
        return e

    def delete_entry(self, directory, name):
        directory = normalize_path(directory)
        full = join_path(directory, name)
        self._request(
            "DELETE",
            f"/{self._index_of(full)}/_doc/{self._doc_id(full)}",
            query="refresh=true")

    def delete_folder_children(self, directory):
        directory = normalize_path(directory)
        prefix = directory.rstrip("/") + "/"
        body = {"query": {"bool": {"should": [
            {"term": {"directory": directory}},
            {"prefix": {"directory": prefix}},
        ]}}}
        idx = self._index_of(directory if directory != "/" else "/x")
        if directory == "/":
            return  # root wipe would be per-index deletes; unused
        self._request("POST", f"/{idx}/_delete_by_query", body,
                      query="refresh=true")

    def list_directory_entries(self, directory, start_name="",
                               inclusive=False, limit=1024, prefix=""):
        directory = normalize_path(directory)
        if directory == "/":
            return self._list_root(start_name, inclusive, limit, prefix)
        must = [{"term": {"directory": directory}}]
        if start_name:
            must.append({"range": {"name": {
                "gte" if inclusive else "gt": start_name}}})
        if prefix:
            must.append({"prefix": {"name": prefix}})
        body = {"query": {"bool": {"must": must}},
                "sort": [{"name": "asc"}],
                "size": min(limit, 10000)}
        out = self._request(
            "POST", f"/{self._index_of(directory)}/_search", body)
        hits = (out.get("hits") or {}).get("hits") or []
        entries = []
        for h in hits:
            e = filer_pb2.Entry()
            e.ParseFromString(base64.b64decode(h["_source"]["meta"]))
            entries.append(e)
        return entries

    def _list_root(self, start_name, inclusive, limit, prefix):
        """Root listing = the top-level dir entries stored in their own
        indices (reference listRootDirectoryEntries walks cat/indices)."""
        out = self._request("GET", "/_cat/indices", ok_statuses=(200,),
                            query="format=json")
        names = sorted(
            row["index"][len(INDEX_PREFIX):]
            for row in out.get("_rows", [])
            if row.get("index", "").startswith(INDEX_PREFIX)
            and row["index"] != INDEX_KV)
        entries = []
        for n in names:
            try:
                e = self.find_entry("/", n)
            except NotFound:
                continue
            if prefix and not e.name.startswith(prefix):
                continue
            if start_name and (e.name < start_name or
                               (e.name == start_name and not inclusive)):
                continue
            entries.append(e)
            if len(entries) >= limit:
                break
        return entries

    # -- KV (reference elastic_store_kv.go: dedicated index) -----------------

    def kv_put(self, key, value):
        self._request(
            "PUT",
            f"/{INDEX_KV}/_doc/{bytes(key).hex()}",
            {"Value": base64.b64encode(bytes(value)).decode()},
            query="refresh=true")

    def kv_get(self, key):
        out = self._request("GET", f"/{INDEX_KV}/_doc/{bytes(key).hex()}")
        if out["_status"] == 404 or not out.get("found"):
            return None
        return base64.b64decode(out["_source"]["Value"])

    def close(self):
        pass
