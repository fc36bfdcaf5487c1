"""TOML configuration with the reference's search path: the port of
``seaweedfs_tpu.util.config`` (reference weed/util/config.go:20-60;
viper there, tomllib here).

``load_configuration("master")`` reads the first master.toml found in
"." and "$HOME/.seaweedfs/" (the reference also searches
/usr/local/etc/seaweedfs/ and /etc/seaweedfs/; the port reads nothing
outside its working directory and home); values are read with dotted
keys, viper-style:
``cfg.get("master.maintenance.scripts")``. Of master.toml the port
reads ``master.maintenance.scripts`` and ``sleep_minutes`` (the master's
maintenance cron) and the ``[storage.backend.<scheme>.<id>]`` sections
(the volume server's tier backends).
"""

from __future__ import annotations

import os
import tomllib
from typing import Any, List, Optional

SEARCH_PATH = [
    ".",
    os.path.join(os.path.expanduser("~"), ".seaweedfs"),
]


class Configuration:
    def __init__(self, data: Optional[dict] = None):
        self.data = data or {}

    def get(self, dotted_key: str, default: Any = None) -> Any:
        node: Any = self.data
        for part in dotted_key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_string(self, key: str, default: str = "") -> str:
        v = self.get(key, default)
        return str(v) if v is not None else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        return bool(self.get(key, default))

    def sub(self, dotted_key: str) -> "Configuration":
        v = self.get(dotted_key)
        return Configuration(v if isinstance(v, dict) else {})

    def __bool__(self) -> bool:
        return bool(self.data)


def load_configuration(name: str, required: bool = False,
                       search_path: Optional[List[str]] = None
                       ) -> Configuration:
    for d in (search_path or SEARCH_PATH):
        p = os.path.join(d, name + ".toml")
        if os.path.isfile(p):
            with open(p, "rb") as f:
                return Configuration(tomllib.load(f))
    if required:
        raise FileNotFoundError(
            f"missing {name}.toml in {search_path or SEARCH_PATH}")
    return Configuration({})


def storage_backend_conf(conf: Configuration) -> dict:
    """master.toml's ``[storage.backend.<scheme>.<id>]`` sections as
    ``{"scheme.id": properties}``, the enabled ones only (reference
    backend.go LoadConfiguration)."""
    flat = {}
    for scheme, ids in (conf.get("storage.backend") or {}).items():
        if not isinstance(ids, dict):
            continue
        for ident, props in ids.items():
            if isinstance(props, dict) and props.get("enabled", True):
                flat[f"{scheme}.{ident}"] = {
                    k: v for k, v in props.items() if k != "enabled"}
    return flat
