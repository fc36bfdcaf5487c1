"""GETs of 1 KiB needles from an EC cluster that has lost a server.

Set-up writes the configuration's volumes into the volume servers'
directories (``weed benchmark``'s needles, spread over the volumes the
master grows for copy count 1), starts the master in a process of its own
and the volume servers in one host process (``launch.py``: the only
process of the run that uses the card), encodes every volume with the
shell's ``ec.encode`` (which spreads the shards as it does on a real
cluster), then stops the server that holds the most data shards among
those whose loss every volume survives, and waits until the master has
dropped it. Warm-up GETs reach every live server for every lost data
shard of every volume it holds, so every decode map is built before the
window.

The window is a closed loop of ``clients`` keep-alive clients
(``client.py``) in this process. Each GET names a needle drawn from the
seed, from the mix's set (``needles``: ``degraded``, whose record lies on
a lost data shard, or ``all``), and goes to a live holder of its volume
drawn from the seed, as ``weed benchmark`` picks a location. ``correct``
compares every body the window produced with the needle the benchmark
made, and counts every non-200 reply.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import urllib.request
from typing import Dict, List

import numpy as np

from ecbench import client, common, data
from ecbench.common import log
from ecbench.reference import gf256, layout, needle

FAIL_MS = 60_000.0   # a failed GET's latency: beyond any limit


class Host:
    """The volume servers' process and its command pipe."""

    def __init__(self, env: dict, log_path: str):
        self.log = open(log_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ecbench.launch", "host"],
            cwd=common.ROOT, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.log)

    def call(self, **cmd) -> dict:
        self.proc.stdin.write((json.dumps(cmd) + "\n").encode())
        self.proc.stdin.flush()
        while True:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(f"the server host exited during {cmd}")
            if line.startswith(b"ECBENCH "):
                out = json.loads(line[8:])
                if not out.get("ok"):
                    raise RuntimeError(f"{cmd['op']}: {out.get('error')}")
                return out

    def close(self, timeout: float = 120) -> dict:
        out = {}
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
                for line in self.proc.stdout:
                    if line.startswith(b"ECBENCH "):
                        out = json.loads(line[8:])
                self.proc.wait(timeout=timeout)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()
        self.log.close()
        return out


def http_json(url: str, timeout: float = 10):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def wait_until(predicate, timeout: float, what: str):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        got = predicate()
        if got:
            return got
        time.sleep(0.2)
    raise RuntimeError(f"timed out waiting for {what}")


def topology_nodes(murl: str) -> Dict[str, dict]:
    try:
        topo = http_json(f"http://{murl}/dir/status")["Topology"]
    except (OSError, ValueError, KeyError):
        return {}
    return {n["url"]: n for dc in topo.get("data_centers", [])
            for r in dc.get("racks", []) for n in r.get("nodes", [])}


def ec_locations(murl: str, vid: int) -> Dict[int, List[str]]:
    from seaweedfs_tpu_torch import rpc
    from seaweedfs_tpu_torch.pb import master_pb2, master_stub
    try:
        resp = master_stub(murl).LookupEcVolume(
            master_pb2.LookupEcVolumeRequest(volume_id=vid), timeout=10)
    except rpc.RpcError:
        return {}
    return {sl.shard_id: [loc.url for loc in sl.locations]
            for sl in resp.shard_id_locations}


def placement(dirs: List[str]) -> List[Dict[int, set]]:
    """Per server, {vid: shard ids} from the shard files on its disk."""
    out = []
    for d in dirs:
        held: Dict[int, set] = {}
        for name in os.listdir(d):
            stem, dot, ext = name.rpartition(".")
            if not dot or not ext.startswith("ec") or not ext[2:].isdigit():
                continue
            vid = int(stem.rpartition("_")[2])
            held.setdefault(vid, set()).add(int(ext[2:]))
        out.append(held)
    return out


def choose_victim(held: List[Dict[int, set]]) -> int:
    """The server with the most data shards among those holding at most
    four shards of every volume (whose loss every volume survives)."""
    ok = [s for s, h in enumerate(held)
          if all(len(x) <= gf256.PARITY_SHARDS for x in h.values())]
    if not ok:
        raise RuntimeError(f"no server's loss leaves every volume whole: "
                           f"{held}")
    return max(ok, key=lambda s: (sum(
        1 for x in held[s].values() for i in x
        if i < gf256.DATA_SHARDS), -s))


def needle_path(v, i: int) -> str:
    return f"{v.vid},{int(v.ids[i]):x}{int(v.cookies[i]):08x}"


def run(r) -> dict:
    cfg, mix = r.config, r.traffic
    nserv, col = cfg["servers"], cfg["collection"]
    mdir = os.path.join(r.workdir, "m")
    vdirs = [os.path.join(r.workdir, f"v{k}") for k in range(nserv)]
    for d in [mdir] + vdirs:
        os.makedirs(d)
    mport = common.free_port_pair()
    vports = [common.free_port_pair() for _ in range(nserv)]
    metrics_port = common.free_port_pair()
    murl = f"127.0.0.1:{mport}"
    vurls = [f"127.0.0.1:{p}" for p in vports]
    # both children import while this process makes and writes the data
    mlog = open(os.path.join(r.workdir, "master.log"), "wb")
    master = subprocess.Popen(
        [sys.executable, "-m", "ecbench.launch", "command", "master",
         "-port", str(mport), "-mdir", mdir,
         "-volumeSizeLimitMB", str(cfg["volume_size_limit_mb"])],
        cwd=common.ROOT, stdout=mlog, stderr=mlog,
        env=common.env_for_children({"CUDA_VISIBLE_DEVICES": ""}))
    host = Host(common.env_for_children(), os.path.join(r.workdir,
                                                          "host.log"))
    result = None
    try:
        vols = data.bench1k(r.seed, cfg)
        r.stage("data made")
        for v in vols:
            v.write(vdirs[(v.vid - 1) % nserv], col)
        r.stage("volumes written")
        wait_until(lambda: _up(murl) or master.poll() is not None, 120,
                   "the master")
        if master.poll() is not None:
            raise RuntimeError(f"the master exited ({master.returncode})")
        r.stage("master up")
        # one at a time: the topology lists the servers in the order they
        # registered, and ec.encode's spread breaks ties in that order, so
        # every run places the shards alike
        for k in range(nserv):
            host.call(op="volume", name=f"v{k}", args=[
                "-port", str(vports[k]), "-dir", vdirs[k],
                "-mserver", murl, "-max", str(cfg["max_volumes"]),
                "-ec.encoder", r.backend])
            wait_until(lambda: vurls[k] in topology_nodes(murl), 120,
                       f"volume server {k}")
        host.call(op="metrics", port=metrics_port)
        kind = host.call(op="device")["kind"]
        r.stage("volume servers up")
        from seaweedfs_tpu_torch.shell import Shell
        vids = [v.vid for v in vols]
        # a volume at a time, each spread settled in the master's view
        # before the next: ec.encode spreads by the free slots the master
        # reports, so a stale view would place shards differently from
        # run to run
        for vid in vids:
            Shell(murl).run_command(
                f"ec.encode -collection={col} -volumeId={vid}")
            wait_until(lambda: _settled(murl, vdirs, vurls), 120,
                       f"the master's view after volume {vid}'s spread")
        r.stage("ec.encode")
        held = placement(vdirs)
        victim = choose_victim(held)
        host.call(op="stop", name=f"v{victim}")
        wait_until(lambda: vurls[victim] not in topology_nodes(murl) and
                   all(vurls[victim] not in u for vid in vids
                       for u in ec_locations(murl, vid).values()),
                   120, "the master to drop the stopped server")
        r.stage("server lost and dropped")
        result = _traffic(r, vols, held, victim, vports, host, kind,
                          metrics_port)
    finally:
        peak = host.close().get("memory_peak_bytes", 0)
        if master.poll() is None:
            master.terminate()
        try:
            master.wait(timeout=60)
        except subprocess.TimeoutExpired:
            master.kill()
            master.wait()
        mlog.close()
        if result is None:
            for name in ("host.log", "master.log"):
                path = os.path.join(r.workdir, name)
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        log(f"--- {name}\n" + f.read()[-6000:].decode(
                            errors="replace"))
    result["memory_peak_bytes"] = peak
    return result


def _settled(murl, vdirs, vurls) -> bool:
    """The master's view of every server matches its disk: the volumes
    whose ``.dat`` it holds and the EC shards whose files it holds."""
    nodes = topology_nodes(murl)
    for k, d in enumerate(vdirs):
        node = nodes.get(vurls[k])
        if node is None:
            return False
        names = os.listdir(d)
        dats = {int(n[:-4].rpartition("_")[2]) for n in names
                if n.endswith(".dat")}
        if {int(v["id"]) for v in node["volumes"]} != dats:
            return False
        bits = {e["id"]: {i for i in range(gf256.TOTAL_SHARDS)
                          if e["ec_index_bits"] >> i & 1}
                for e in node["ec_shards"] if e["ec_index_bits"]}
        if bits != placement([d])[0]:
            return False
    return True


def _up(murl: str) -> bool:
    try:
        http_json(f"http://{murl}/dir/status", timeout=2)
        return True
    except (OSError, ValueError):
        return False


def _traffic(r, vols, held, victim, vports, host, kind, metrics_port):
    cfg, mix = r.config, r.traffic
    live = [s for s in range(len(vports)) if s != victim]
    ports = [vports[s] for s in live]
    lost = {vid: {i for i in held[victim].get(vid, ())
                  if i < gf256.DATA_SHARDS} for vid in range(1, len(vols) + 1)}
    holders = {v.vid: [j for j, s in enumerate(live) if held[s].get(v.vid)]
               for v in vols}
    # every needle's record, and the data shards it lies on (volumes
    # under ten large blocks: small-block rows only, so at most two)
    rec = needle.record_size(cfg["size"])
    small = cfg["small_block"]
    entries, first, last = [], [], []
    for v in vols:
        if layout.rows(v.dat_size, cfg["large_block"], small)[0]:
            raise ValueError("volumes of large-block rows are not drawn")
        offs = v.offsets.astype(np.int64)
        entries.extend((v, i) for i in range(len(v.ids)))
        first.append((offs // small) % gf256.DATA_SHARDS)
        last.append(((offs + rec - 1) // small) % gf256.DATA_SHARDS)
    first, last = np.concatenate(first), np.concatenate(last)
    vid_of = np.array([v.vid for v, _ in entries])
    degraded = np.array([f in lost[vid] or g in lost[vid]
                         for f, g, vid in zip(first, last, vid_of)])
    pool = np.nonzero(degraded)[0] if mix["needles"] == "degraded" \
        else np.arange(len(entries))
    gen = data.rng(r.seed, "traffic")
    picks = gen.choice(pool, mix["max_gets"])
    where = gen.random(mix["max_gets"])
    nclients = mix["clients"]
    jobs: List[list] = [[] for _ in range(nclients)]
    for k, (e, u) in enumerate(zip(picks, where)):
        v, i = entries[int(e)]
        hs = holders[v.vid]
        jobs[k % nclients].append((hs[int(u * len(hs))], client.get_request(
            needle_path(v, i)), int(e)))

    # warm-up: every live server, every volume it holds, every lost data
    # shard of it and a healthy needle, then the closed loop for a moment,
    # all untimed
    warm = []
    for j, s in enumerate(live):
        for vid in held[s]:
            in_vol = np.nonzero(vid_of == vid)[0]
            picks_w = [in_vol[:1]] + [
                in_vol[first[in_vol] == shard][:1]
                for shard in sorted(lost[vid])]
            for e in np.concatenate(picks_w):
                v, i = entries[int(e)]
                warm.append((j, client.get_request(needle_path(v, i)),
                             int(e)))
    wrecs, _, _ = client.run(ports, [warm[c::nclients]
                                     for c in range(nclients)])
    bad = [w for w in wrecs if w.status != 200]
    if bad:
        log(f"warm-up: {len(bad)} of {len(wrecs)} GETs not 200")
    r.stage(f"warm-up GETs ({len(wrecs)})")
    wloop, _, _ = client.run(ports, jobs, seconds=mix["warmup_seconds"])
    r.stage("warm-up loop")

    prom0 = _prom(metrics_port)
    if r.trace:
        host.call(op="trace_start", path=os.path.join(r.workdir,
                                                      "trace.json"),
                  cuda=r.cuda)
    ru0 = os.times()
    r.window_started()
    records, start, deadline = client.run(ports, jobs, seconds=r.seconds)
    r.window_closed()
    ru1 = os.times()
    io = host.call(op="io")["io"]
    launches, spans = [], []
    if r.trace:
        spans_path = os.path.join(r.workdir, "spans.json")
        launches = host.call(op="trace_stop", spans=spans_path)["launches"]
        with open(spans_path) as f:
            spans = json.load(f)
    prom1 = _prom(metrics_port)

    # the check, once the window has closed
    wrong, failed, lat, done_ok = 0, 0, [], 0
    for rc in records:
        v, i = entries[rc.tag]
        ok = rc.status == 200 and rc.body == v.data(i).tobytes()
        if rc.status != 200:
            failed += 1
        elif not ok:
            wrong += 1
            if wrong <= 3:
                log(f"GET {needle_path(v, i)}: {len(rc.body)} bytes differ "
                    "from the needle written")
        lat.append((rc.done - rc.sent) * 1e3 if ok else FAIL_MS)
        if ok and rc.done <= deadline:
            done_ok += 1
    window = deadline - start
    per_second = [0] * int(math.ceil(window))
    for rc in records:
        if rc.done <= deadline:
            per_second[min(len(per_second) - 1, int(rc.done - start))] += 1
    device = {}
    if r.trace and r.cuda:
        from ecbench import profiling
        events = profiling.device_events(os.path.join(r.workdir,
                                                      "trace.json"))
        device = profiling.summarize(events, r.window_epoch, r.closed_epoch,
                                     [tuple(x) for x in launches], spans)
    cpu = (ru1.user - ru0.user + ru1.system - ru0.system) / window
    sent_degraded = int(sum(degraded[rc.tag] for rc in records))
    return {
        "e2e": {"get_rps": done_ok / window,
                "get_p99_ms": common.nearest_rank(lat, 0.99)},
        "attempted": len(records),
        "failed": failed + wrong,
        "checks": [
            ("gets_checked", len(records), ">=1", len(records) >= 1),
            ("bodies_wrong", wrong, 0, wrong == 0),
            ("gets_failed", failed, 0, failed == 0),
        ],
        "layer": {"prom_delta": common.delta(prom0, prom1),
                  "device": device},
        "device_kind": kind,
        "notes": {"client_cpu_share": cpu,
                  "warmup_loop_rps": len(wloop) / mix["warmup_seconds"],
                  "completed_per_second": per_second, "host_io_until_window_end": io,
                  "victim": {"server": victim, "lost_data_shards": {
                      str(k): sorted(x) for k, x in lost.items()}},
                  "gets": len(records), "degraded_share":
                      sent_degraded / max(1, len(records)),
                  "get_p50_ms": common.nearest_rank(lat, 0.5)},
    }


def _prom(port: int) -> Dict[str, float]:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        return common.parse_prometheus(resp.read().decode())
