"""Collection, cluster and lock commands (reference weed/shell:
command_collection_list.go, command_collection_delete.go,
command_fs_lock_unlock.go, cluster status); the port of
``seaweedfs_tpu.shell.command_misc``.

The cluster views: ``cluster.trace`` stitches one trace id's spans from
every server into one Chrome trace, ``cluster.requests`` lists the
traced requests in flight, ``cluster.heat`` renders the master's heat
map and ``cluster.qos`` the per-tenant admission state of every server.
"""

from __future__ import annotations

import argparse
import json
from typing import List

from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.shell import command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv


@command("collection.list", "list collections")
def collection_list(env: CommandEnv, argv: List[str], out) -> None:
    resp = env.master.CollectionList(master_pb2.CollectionListRequest(
        include_normal_volumes=True, include_ec_volumes=True))
    for c in resp.collections:
        out.write(f"collection: {c.name}\n")
    if not resp.collections:
        out.write("no named collections\n")


@command("collection.delete", "delete a collection cluster-wide")
def collection_delete(env: CommandEnv, argv: List[str], out) -> None:
    p = argparse.ArgumentParser(prog="collection.delete")
    p.add_argument("-collection", required=True)
    args = p.parse_args(argv)
    env.acquire_lock()
    try:
        env.master.CollectionDelete(master_pb2.CollectionDeleteRequest(
            name=args.collection))
        out.write(f"collection {args.collection} deleted\n")
    finally:
        env.release_lock()


@command("cluster.status", "master + topology summary")
def cluster_status(env: CommandEnv, argv: List[str], out) -> None:
    topo = env.topology()
    stats = env.master.Statistics(master_pb2.StatisticsRequest())
    out.write(f"master: {env.master_url}\n"
              f"volumes: {topo.volume_count}/{topo.max_volume_count}\n"
              f"used bytes: {stats.used_size}\n"
              f"files: {stats.file_count}\n")


def stitch_chrome_trace(span_lists) -> dict:
    """Merge per-server span lists (the /debug/trace?trace_id= answers)
    into one Chrome trace-event JSON: each server becomes a named
    process lane, spans dedupe by id (an in-process test cluster's
    servers share one collector, so every endpoint answers with the
    same spans), and timestamps are already epoch-based microseconds so
    lanes line up across processes. Pure over the fetched lists — unit-
    testable without a cluster (the house planning-function pattern)."""
    events = []
    pids = {}
    seen = set()
    for spans in span_lists:
        for s in spans:
            sid = s.get("id")
            if sid in seen:
                continue
            seen.add(sid)
            proc = f"{s.get('role', '?')} {s.get('server', '?')}"
            pid = pids.get(proc)
            if pid is None:
                pid = pids[proc] = len(pids) + 1
                events.append({"ph": "M", "pid": pid, "tid": 0,
                               "name": "process_name",
                               "args": {"name": proc}})
            args = dict(s.get("tags") or {})
            args["id"] = sid
            if s.get("parent"):
                args["parent"] = s["parent"]
            if s.get("trace"):
                args["trace"] = s["trace"]
            if s.get("in_flight"):
                args["in_flight"] = True
            events.append({"ph": "X", "pid": pid,
                           "tid": s.get("tid", 0),
                           "name": s.get("name", "?"),
                           "ts": s.get("ts_us", 0),
                           "dur": s.get("dur_us", 0),
                           "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


@command("cluster.trace", "fetch + stitch one trace id across every server")
def cluster_trace_cmd(env: CommandEnv, argv: List[str], out) -> None:
    """Fan GET /debug/trace?trace_id= over the master and every volume
    server, then stitch one Chrome-trace JSON for the request — the cross-process view the
    per-process span rings cannot give."""
    from seaweedfs_tpu_torch.util import http_client
    p = argparse.ArgumentParser(prog="cluster.trace")
    p.add_argument("-traceId", required=True,
                   help="the 16-hex-digit trace id (from the slow-"
                        "request log, /debug/requests, or a /metrics "
                        "exemplar)")
    p.add_argument("-out", default="",
                   help="write the stitched Chrome trace JSON here "
                        "(default: print a summary only)")
    args = p.parse_args(argv)
    targets = [env.master_url]
    targets += sorted(dn.id for _, _, dn in
                      env.data_nodes(env.topology()))
    span_lists, reached = [], 0
    for url in targets:
        try:
            resp = http_client.request(
                "GET", f"{url}/debug/trace?trace_id={args.traceId}",
                timeout=10)
        except OSError as e:
            out.write(f"{url}: unreachable ({e})\n")
            continue
        if resp.status != 200:
            out.write(f"{url}: HTTP {resp.status}\n")
            continue
        reached += 1
        try:
            spans = json.loads(resp.body).get("spans", [])
        except ValueError:
            spans = []
        if spans:
            out.write(f"{url}: {len(spans)} spans\n")
        span_lists.append(spans)
    stitched = stitch_chrome_trace(span_lists)
    n_spans = sum(1 for e in stitched["traceEvents"] if e["ph"] == "X")
    n_procs = sum(1 for e in stitched["traceEvents"] if e["ph"] == "M")
    out.write(f"trace {args.traceId}: {n_spans} spans across "
              f"{n_procs} processes ({reached}/{len(targets)} servers "
              f"answered)\n")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(stitched, f)
        out.write(f"chrome trace written to {args.out}\n")
    elif n_spans == 0:
        out.write("no spans found: the trace may have been dropped by "
                  "tail sampling (only slow/errored/head-sampled "
                  "requests are pinned) or aged out of the rings\n")


@command("cluster.requests", "live in-flight request table, cluster-wide")
def cluster_requests(env: CommandEnv, argv: List[str], out) -> None:
    """Fan GET /debug/requests over every server: the flight recorder
    view an operator opens when something is stuck RIGHT NOW."""
    from seaweedfs_tpu_torch.util import http_client
    targets = [env.master_url]
    targets += sorted(dn.id for _, _, dn in
                      env.data_nodes(env.topology()))
    rows = []
    for url in targets:
        try:
            resp = http_client.request("GET", f"{url}/debug/requests",
                                       timeout=10)
        except OSError:
            continue
        if resp.status != 200:
            continue
        try:
            rows.extend(json.loads(resp.body).get("requests", []))
        except ValueError:
            continue
    # an in-process cluster's servers share one table and answer the
    # same rows from every endpoint: dedupe on the request-span id
    # (stable per request; age_ms is recomputed per fetch)
    seen = set()
    rows = [r for r in rows
            if r.get("id") not in seen and not seen.add(r.get("id"))]
    rows.sort(key=lambda r: -r.get("age_ms", 0))
    if not rows:
        out.write("no traced requests in flight\n")
        return
    for r in rows:
        budget = r.get("deadline_left_ms")
        out.write(
            f"{r.get('trace_id')} {r.get('role')}.{r.get('verb')} "
            f"{r.get('path')} age={r.get('age_ms', 0):.0f}ms "
            f"span={r.get('current_span')} peer={r.get('peer')}"
            + (f" budget={budget:.0f}ms" if budget is not None else "")
            + "\n")


@command("cluster.heat", "the live cluster heat map, per volume")
def cluster_heat(env: CommandEnv, argv: List[str], out) -> None:
    """Render the master's heartbeat-fed heat map (GET /cluster/heat):
    per volume, cluster-summed window reads + decayed EWMA rate, the
    servers reporting it, and the lifecycle state when the policy
    engine runs. Empty unless volume servers run -heat.track."""
    from seaweedfs_tpu_torch.util import http_client
    p = argparse.ArgumentParser(prog="cluster.heat")
    p.add_argument("-volumeId", type=int, default=0,
                   help="restrict to one volume id")
    args = p.parse_args(argv)
    resp = http_client.request(
        "GET", f"{env.master_url}/cluster/heat", timeout=30)
    vols = json.loads(resp.body).get("volumes", {})
    if args.volumeId:
        vols = {k: v for k, v in vols.items()
                if k == str(args.volumeId)}
    if not vols:
        out.write("no heat reported (are volume servers running "
                  "-heat.track?)\n")
        return
    for vid, rec in sorted(vols.items(), key=lambda kv: int(kv[0])):
        state = rec.get("state", rec.get("tier", "?"))
        out.write(
            f"volume {vid}: reads/window:{rec.get('reads_window', 0):.0f} "
            f"ewma:{rec.get('ewma', 0):.2f}/s state:{state} "
            f"servers:{','.join(rec.get('servers', [])) or '-'}\n")


@command("cluster.qos", "per-tenant admission state, cluster-wide")
def cluster_qos(env: CommandEnv, argv: List[str], out) -> None:
    """Render the master's fanned QoS view (GET /cluster/qos): per
    server, per tenant — weight, admitted/shed counts by reason, live
    bucket tokens, and open connections. Empty unless servers run
    -qos."""
    from seaweedfs_tpu_torch.util import http_client
    p = argparse.ArgumentParser(prog="cluster.qos")
    p.add_argument("-tenant", default="",
                   help="restrict to one tenant name")
    args = p.parse_args(argv)
    resp = http_client.request(
        "GET", f"{env.master_url}/cluster/qos", timeout=30)
    view = json.loads(resp.body)
    blocks = [("master", view.get("master", {}))]
    blocks += sorted(view.get("nodes", {}).items())
    any_enabled = False
    for url, st in blocks:
        if st.get("error"):
            out.write(f"{url}: unreachable ({st['error']})\n")
            continue
        if not st.get("enabled"):
            continue
        any_enabled = True
        out.write(f"{url}: rate:{st.get('request_rate') or 'inf'}/s "
                  f"bytes:{st.get('bytes_mbps') or 'inf'}MB/s "
                  f"global:{st.get('global_request_rate') or 'inf'}/s "
                  f"heatShed:{st.get('heat_shed')}\n")
        tenants = st.get("tenants", {})
        if args.tenant:
            tenants = {k: v for k, v in tenants.items()
                       if k == args.tenant}
        for name, t in sorted(tenants.items()):
            shed = t.get("shed", {})
            shed_s = " ".join(f"{k}:{v}" for k, v in sorted(shed.items())
                              if v) or "0"
            tok = t.get("tokens", {})
            out.write(
                f"  {name}{' (internal)' if t.get('internal') else ''} "
                f"w:{t.get('weight')} admitted:{t.get('admitted')} "
                f"shed:{shed_s} conns:{t.get('conns', 0)} "
                f"tokens(req:{tok.get('requests')} "
                f"bytes:{tok.get('bytes')})\n")
    if not any_enabled:
        out.write("qos disabled everywhere (start servers with -qos)\n")


@command("lock", "acquire the cluster admin lock")
def lock(env: CommandEnv, argv: List[str], out) -> None:
    env.acquire_lock()
    out.write("locked\n")


@command("unlock", "release the cluster admin lock")
def unlock(env: CommandEnv, argv: List[str], out) -> None:
    env.release_lock()
    out.write("unlocked\n")

