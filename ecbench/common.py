"""Small pieces every driver uses: the checkout, the clocks of a run, the
bytes a run wrote, Prometheus text, free ports and percentiles."""

from __future__ import annotations

import json
import math
import os
import re
import resource
import socket
import sys
from typing import Dict, Iterable, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "ecbench")
BANNED = ("jax", "jaxlib", "flax", "seaweedfs_tpu")


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(bench: dict, name: str, listed_only: bool = True) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``. Tests may also name one
    that is not listed, as ``<config>.<traffic>``, on one chip."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    config, _, traffic = name.partition(".")
    if listed_only or not traffic or not os.path.exists(
            os.path.join(HERE, "configs", f"{config}.json")):
        raise SystemExit(f"unknown workload {name!r}")
    return {"name": name, "config": config, "traffic": traffic, "chips": 1}


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def banned_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (``seaweedfs_tpu_torch`` is not ``seaweedfs_tpu``)."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(BANNED))


def process_start_epoch(pid: str = "self") -> float:
    """Unix time at which a process started (``/proc``; 10 ms ticks)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rpartition(")")[2].split()
    start_ticks = int(fields[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def proc_io(pid: str = "self") -> Dict[str, int]:
    """``/proc/<pid>/io``: ``write_bytes`` (sent to a block device; 0 on
    a network filesystem such as 9p) and ``wchar`` (every byte passed to
    a write call, sockets and pipes too)."""
    out = {}
    with open(f"/proc/{pid}/io") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key in ("write_bytes", "wchar"):
                out[key] = int(value)
    return out


def bytes_written() -> Dict[str, object]:
    """Bytes this process and its reaped children wrote."""
    children = resource.getrusage(resource.RUSAGE_CHILDREN).ru_oublock * 512
    return {"own": proc_io(), "children_write_bytes": children}


def fs_type(path: str) -> str:
    """Filesystem type of the mount that holds ``path``."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    with open("/proc/self/mountinfo") as f:
        for line in f:
            left, _, right = line.partition(" - ")
            mount = left.split()[4].replace("\\040", " ")
            if (path == mount or path.startswith(mount.rstrip("/") + "/")) \
                    and len(mount) >= len(best):
                best, kind = mount, right.split()[0]
    return kind


_SAMPLE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})?\s+(\S+)")


def parse_prometheus(text: str) -> Dict[str, float]:
    """``{'name{labels}': value}`` of a text exposition."""
    out = {}
    for line in text.splitlines():
        m = _SAMPLE.match(line)
        if m:
            try:
                out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
            except ValueError:
                continue
    return out


def delta(before: Dict[str, float], after: Dict[str, float]
          ) -> Dict[str, float]:
    return {k: v - before.get(k, 0.0) for k, v in after.items()}


def free_port_pair() -> int:
    """A port p where p and p + 10000 (the RPC port) are both free."""
    for _ in range(200):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        if p + 10000 > 65535:
            continue
        try:
            with socket.socket() as s2:
                s2.bind(("127.0.0.1", p + 10000))
            return p
        except OSError:
            continue
    raise RuntimeError("no free port pair")


def nearest_rank(values: Iterable[float], q: float) -> float:
    """The q-quantile by nearest rank (the smallest value with at least
    q of the sample at or below it)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, min(len(v), math.ceil(q * len(v) - 1e-9)) - 1)]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def note(key: str, value) -> None:
    """An earlier line of standard output: a fact about the run that is
    not a metric (bytes written, filesystem, the client's CPU share)."""
    print(json.dumps({"note": key, "value": value}), flush=True)


def env_for_children(extra: Optional[dict] = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env.update(cache_env())
    env.update(extra or {})
    return env


def cache_env() -> dict:
    """Build caches at fixed paths inside the checkout, so only a
    checkout's first run builds."""
    base = os.path.join(ROOT, ".ecbench_cache")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "USE_FLAX": "0"}
