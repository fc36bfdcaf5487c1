"""Path-specific filer configuration (reference weed/filer/filer_conf.go).

The filer stores its own config as a regular file at
``/etc/seaweedfs/filer.conf`` inside its namespace: a JSON document of
per-path-prefix rules picking collection / replication / ttl / fsync
for anything written under that prefix (the reference uses a protobuf
text FilerConf with the same fields). The filer reloads the rules when
that path is written through it, so `fs.configure`-style updates take
effect live.
"""

from __future__ import annotations

import json
from typing import List, Optional

FILER_CONF_PATH = "/etc/seaweedfs/filer.conf"


class PathConf:
    __slots__ = ("location_prefix", "collection", "replication", "ttl",
                 "fsync")

    def __init__(self, location_prefix: str, collection: str = "",
                 replication: str = "", ttl: str = "", fsync: bool = False,
                 **_ignored):
        self.location_prefix = location_prefix
        self.collection = collection
        self.replication = replication
        self.ttl = ttl
        self.fsync = fsync

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class FilerConf:
    """Longest-prefix matcher over PathConf rules."""

    def __init__(self, rules: Optional[List[PathConf]] = None):
        self.rules = sorted(rules or [],
                            key=lambda r: len(r.location_prefix),
                            reverse=True)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "FilerConf":
        doc = json.loads(blob.decode() or "{}") if blob else {}
        return cls([PathConf(**loc) for loc in doc.get("locations", [])
                    if loc.get("location_prefix")])

    def to_bytes(self) -> bytes:
        return json.dumps(
            {"locations": [r.to_dict() for r in self.rules]},
            indent=2).encode()

    def match(self, path: str) -> Optional[PathConf]:
        for rule in self.rules:  # longest prefix first
            if path.startswith(rule.location_prefix):
                return rule
        return None
