"""The port's metrics exposition, cluster tracing and heat tracking against
the JAX package's.

Pure host computations held to the JAX package exactly: the Prometheus
text of the same families with the same seeded observations (plain and
with OpenMetrics exemplars; the process gauges aside, which read this
process); every family this slice adds under the same name, help, labels
and buckets; ``chrome_trace``, ``rollup`` and ``busy_union_s`` of the same
seeded spans; trace headers formatted by one package and parsed by the
other; the tail sampler's keep/drop, per-verb p95 and outcome counts over
the same seeded request stream (its random draw and clock injected); the
heat tracker's ``summary()`` and ``snapshot()`` after the same seeded
reads on a fake clock; heartbeat wire bytes with heats against the JAX
protobuf, and without heats unchanged (field 17 absent); the topology's
cluster heat map and its gauge.

Then the port's servers: ``-metricsPort`` answers /metrics (parseable
Prometheus text), /healthz, /debug/trace, /debug/requests and
/debug/failpoint; the push-gateway loop PUTs the exposition and counts a
failing gateway; request counters move per role and verb; with cluster
tracing on, one replicated write is stitched by ``cluster.trace`` from
two servers' spans and ``cluster.requests`` answers; volume servers under
``heat_track`` send their heat to the master's ``/cluster/heat`` and
``cluster.heat``. The off contract: tracing off makes ``span()`` the
shared no-op and sends no trace header, and a volume server without
``heat_track`` has no tracker and heartbeats without heat.
"""

import json
import re
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from seaweedfs_tpu.pb import master_pb2 as jax_master_pb2
from seaweedfs_tpu.server import convert as jax_convert
from seaweedfs_tpu.stats import cluster_trace as jax_ct
from seaweedfs_tpu.stats import heat as jax_heat
from seaweedfs_tpu.stats import metrics as jax_metrics
from seaweedfs_tpu.stats import trace as jax_trace
from seaweedfs_tpu_torch.operation.file_id import parse_fid
from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.server import convert
from seaweedfs_tpu_torch.shell import Shell
from seaweedfs_tpu_torch.stats import cluster_trace as port_ct
from seaweedfs_tpu_torch.stats import heat as port_heat
from seaweedfs_tpu_torch.stats import metrics as port_metrics
from seaweedfs_tpu_torch.stats import trace as port_trace
from seaweedfs_tpu_torch.topology.topology import Topology
from seaweedfs_tpu_torch.util import http_client
from tests.test_torch_cluster import Cluster, wait_for

# every family this slice adds to the port's registry
NEW_FAMILIES = [
    "RequestCounter", "RequestHistogram", "MetricsPushErrorCounter",
    "QosAdmittedCounter", "QosShedCounter", "QosQueuedSecondsHistogram",
    "QosTokensGauge", "QosTenantsGauge", "TraceRequestsCounter",
    "TraceLiveGauge", "VolumeHeatGauge", "ClusterVolumeHeatGauge",
    "LifecycleTransitionsCounter", "LifecycleQueueDepthGauge",
    "LifecycleBytesMovedCounter", "LifecycleVolumeStatesGauge",
    "LifecyclePassSecondsHistogram", "ProcessRSSGauge", "ProcessFdsGauge",
    "ProcessThreadsGauge", "ProcessGcCollectionsGauge"]

_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?\})? '
    r'[-+]?([0-9.]+([eE][-+]?[0-9]+)?|inf|Inf|nan|NaN)$')


def parse_prometheus(text: str) -> dict:
    """{sample name with labels: value} of a 0.0.4 text exposition;
    fails on any line that is neither a comment nor a sample."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("# HELP ") or \
                line.startswith("# TYPE "):
            continue
        assert _PROM_LINE.match(line), f"not Prometheus text: {line!r}"
        key, _, value = line.rpartition(" ")
        out[key] = float(value)
    return out


class FakeTime:
    def __init__(self, t: float = 5000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    perf_counter = monotonic

    def time(self) -> float:
        return 1.7e9 + self.t


# -- metrics: families and text ------------------------------------------------


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_new_families_match_jax(name):
    p, j = getattr(port_metrics, name), getattr(jax_metrics, name)
    assert (p.name, p.help, p.label_names, p.kind, type(p).__name__) == \
        (j.name, j.help, j.label_names, j.kind, type(j).__name__)
    assert getattr(p, "buckets", None) == getattr(j, "buckets", None)
    assert port_metrics.REGISTRY._metrics[p.name] is p


@pytest.mark.parametrize("openmetrics", [False, True])
def test_exposition_equals_jax_for_seeded_observations(monkeypatch,
                                                       openmetrics):
    ft = FakeTime()
    monkeypatch.setattr(jax_metrics, "time", ft)
    monkeypatch.setattr(port_metrics, "time", ft)
    names = [n for n in NEW_FAMILIES if not n.startswith("Process")] + [
        "FleetStageSecondsHistogram", "CacheHitCounter", "BreakerStateGauge"]
    regs = []
    for mod in (port_metrics, jax_metrics):
        reg = mod.Registry()
        fams = []
        for n in names:
            src = getattr(mod, n)
            if src.kind == "histogram":
                fams.append(reg.histogram(src.name, src.help,
                                          src.label_names, src.buckets))
            else:
                fams.append(getattr(reg, src.kind)(src.name, src.help,
                                                   src.label_names))
        regs.append((reg, fams))
    rng = np.random.default_rng(42)
    label_pool = ["a", "b", 'q"uote', "back\\slash", "new\nline", "7"]
    for step in range(3000):
        i = int(rng.integers(len(names)))
        labels = tuple(str(rng.choice(label_pool))
                       for _ in regs[0][1][i].label_names)
        v = float(rng.choice([rng.exponential(0.05), rng.uniform(0, 5000),
                              1.0, 0.0]))
        ft.t += 0.5
        exemplar = rng.integers(5) == 0
        for reg, fams in regs:
            child = fams[i].labels(*labels)
            kind = fams[i].kind
            if kind == "histogram":
                if exemplar:
                    child.observe_exemplar(v, f"{step:016x}")
                else:
                    child.observe(v)
            elif kind == "gauge" and step % 3 == 0:
                child.set(v)
            elif kind == "gauge" and step % 3 == 1:
                child.dec(v)
            else:
                child.inc(v)
    got = regs[0][0].render(openmetrics=openmetrics)
    want = regs[1][0].render(openmetrics=openmetrics)
    assert got == want
    assert (" # {trace_id=" in got) == openmetrics
    if not openmetrics:
        parse_prometheus(got)


# -- tracing: spans, headers, the tail sampler --------------------------------


def _seeded_spans(mod, rng_seed=3, n=300):
    rng = np.random.default_rng(rng_seed)
    out = []
    for i in range(n):
        s = mod.Span(str(rng.choice(["fleet.read", "fleet.dispatch",
                                     "http.volumeServer.get", "qos.queue"])),
                     None, {"k": int(rng.integers(9))}
                     if rng.integers(2) else {})
        s.id = 0x4000_0000_0000_0000 | i
        s.parent_id = (0x4000_0000_0000_0000 | int(rng.integers(i))) \
            if i and rng.integers(2) else None
        s.t0 = float(rng.uniform(0, 10))
        s.dur = float(rng.choice([0.0, rng.exponential(0.2)]))
        s.tid = int(rng.integers(1, 5))
        s.trace_id = int(rng.integers(1, 1 << 62)) if rng.integers(2) else 0
        out.append(s)
    return out


def test_chrome_trace_rollup_and_busy_union_equal_jax(monkeypatch):
    for mod in (port_trace, jax_trace):
        mod.clear()
        # the perf_counter -> epoch offset is taken at import: pin one
        monkeypatch.setattr(mod, "EPOCH_OFFSET", 1.7e9)
    ps, js = _seeded_spans(port_trace), _seeded_spans(jax_trace)
    assert port_trace.chrome_trace(ps) == jax_trace.chrome_trace(js)
    assert port_trace.rollup(ps) == jax_trace.rollup(js)
    rng = np.random.default_rng(8)
    for _ in range(50):
        t0 = float(rng.uniform(0, 8))
        t1 = t0 + float(rng.uniform(0, 4))
        pre = [None, ["fleet."], ["http.", "qos."]][int(rng.integers(3))]
        assert port_trace.busy_union_s(ps, t0, t1, pre) == \
            jax_trace.busy_union_s(js, t0, t1, pre)
    assert [port_trace.span_dict(s) for s in ps] == \
        [jax_trace.span_dict(s) for s in js]
    assert port_trace.chrome_trace_json() == jax_trace.chrome_trace_json()


def test_trace_headers_cross_parse():
    rng = np.random.default_rng(12)
    for _ in range(300):
        tid = int(rng.integers(0, 1 << 63))
        sid = int(rng.integers(0, 1 << 63))
        head = bool(rng.integers(2))
        for fmt, parse in ((port_ct.format_header, jax_ct.parse_header),
                           (jax_ct.format_header, port_ct.parse_header)):
            h = fmt(tid, sid, head)
            assert h == jax_ct.format_header(tid, sid, head)
            assert parse(h) == (None if tid == 0 else (tid, sid, head))
    for junk in ("", None, "zz-01", "0-1", "12", "ab-cd-s", "ab-cd-x",
                 "-", "1-2-s-extra"):
        assert port_ct.parse_header(junk) == jax_ct.parse_header(junk)
    assert (port_ct.HEADER, port_ct.HEADER_LOWER, port_ct.GRPC_KEY) == \
        (jax_ct.HEADER, jax_ct.HEADER_LOWER, jax_ct.GRPC_KEY)


def _sampler_run(ct, tr, monkeypatch, seed):
    ft = FakeTime()
    monkeypatch.setattr(tr, "time", ft)
    monkeypatch.setattr(ct, "time", ft)
    draws = iter(np.random.default_rng(seed).uniform(0, 1, 10_000))

    class Draws:
        """The head-sample draw, injected into this module only."""

        @staticmethod
        def random():
            return float(next(draws))
    monkeypatch.setattr(ct, "random", Draws)
    ct.reset()
    ct.enable(sample_fraction=0.2, slow_threshold_ms=40.0)
    rng = np.random.default_rng(seed + 1)
    kept, p95s = [], []
    try:
        for _ in range(400):
            verb = str(rng.choice(["get", "post", "LookupVolume"]))
            hdr = None
            if rng.integers(4) == 0:
                hdr = ct.format_header(int(rng.integers(1, 1 << 60)), 7,
                                       bool(rng.integers(2)))
            ctx = ct.begin("volumeServer", verb, "/3,01", hdr)
            with tr.span("inner", n=1):
                ft.t += float(rng.exponential(0.02))
            exc = RuntimeError("x") if rng.integers(20) == 0 else None
            status = int(rng.choice([200, 200, 200, 404, 500]))
            kept.append(ct.finish(ctx, exc, status) is not None)
            p95s.append(ct._p95[f"volumeServer.{verb}"].p95)
        return kept, p95s, len(ct.sampled_traces(limit=1000))
    finally:
        ct.disable()
        ct.reset()


def test_tail_sampler_keep_drop_equals_jax(monkeypatch):
    before = {o: port_metrics.TraceRequestsCounter.labels(o).value
              for o in ("slow", "error", "sample", "drop")}
    got = _sampler_run(port_ct, port_trace, monkeypatch, 31)
    want = _sampler_run(jax_ct, jax_trace, monkeypatch, 31)
    assert got == want
    moved = {o: port_metrics.TraceRequestsCounter.labels(o).value - v
             for o, v in before.items()}
    assert sum(moved.values()) == 400 and all(moved.values())
    assert sum(got[0]) == sum(moved.values()) - moved["drop"]


# -- heat ---------------------------------------------------------------------------


def test_heat_tracker_summary_equals_jax(monkeypatch):
    ft = FakeTime()
    monkeypatch.setattr(jax_heat, "time", ft)
    monkeypatch.setattr(port_heat, "time", ft)
    pt = port_heat.make_tracker(True, window_s=4.0, needle_sample=3)
    jt = jax_heat.make_tracker(True, window_s=4.0, needle_sample=3)
    try:
        rng = np.random.default_rng(17)
        for step in range(3000):
            ft.t += float(rng.choice([0.0, 0.001, 0.05, 0.7]))
            vid = int(rng.integers(880001, 880012))
            nid = int(rng.integers(0, 60))
            pt.record(vid, nid)
            jt.record(vid, nid)
            if step % 97 == 0:
                assert pt.summary() == jt.summary()
            if step % 500 == 0:
                pt.forget(vid)
                jt.forget(vid)
        assert pt.snapshot() == jt.snapshot()
        ft.t += 100.0     # idle: the window empties, the EWMA decays to 0
        for _ in range(6):
            ft.t += 10.0
            assert pt.summary() == jt.summary()
        assert all(r["reads_window"] == 0 and r["ewma"] == 0.0
                   for r in pt.summary())
    finally:
        pt.close()
        jt.close()
    assert port_heat.make_tracker(False) is None


def _hb(heats=None):
    hb = {"ip": "10.1.2.3", "port": 8081, "public_url": "p:1",
          "max_volume_count": 8, "max_file_key": 123,
          "volumes": [{"id": 4, "size": 100, "collection": "c",
                       "file_count": 3, "modified_at_second": 17}],
          "ec_shards": [{"id": 5, "collection": "e", "ec_index_bits": 0b11}]}
    if heats is not None:
        hb["volume_heats"] = heats
    return hb


def test_heartbeat_wire_bytes_with_and_without_heat():
    rng = np.random.default_rng(23)
    heats = [{"id": int(rng.integers(1, 1 << 31)),
              "reads_window": int(rng.integers(0, 1 << 40)),
              "ewma": float(rng.choice([0.0, rng.uniform(0, 1e4)]))}
             for _ in range(40)]
    got = convert.heartbeat_to_pb(_hb(heats), "dc", "r").SerializeToString()
    want = jax_convert.heartbeat_to_pb(_hb(heats), "dc", "r") \
        .SerializeToString()
    assert got == want
    back = convert.heartbeat_from_pb(master_pb2.Heartbeat.FromString(want))
    jback = jax_convert.heartbeat_from_pb(
        jax_master_pb2.Heartbeat.FromString(want))
    assert back == jback and len(back["volume_heats"]) == 40
    # without heat: the bytes the heat-less encoder gave, field 17 absent
    plain = convert.heartbeat_to_pb(_hb(), "dc", "r").SerializeToString()
    assert plain == jax_convert.heartbeat_to_pb(_hb(), "dc", "r") \
        .SerializeToString()
    assert plain == master_pb2.Heartbeat(
        ip="10.1.2.3", port=8081, public_url="p:1", max_volume_count=8,
        max_file_key=123, data_center="dc", rack="r",
        volumes=[convert.volume_info_to_pb(_hb()["volumes"][0])],
        ec_shards=[convert.ec_info_to_pb(_hb()["ec_shards"][0])]) \
        .SerializeToString()
    assert convert.heartbeat_to_pb(_hb([]), "dc", "r") \
        .SerializeToString() == plain
    assert "volume_heats" not in convert.heartbeat_from_pb(
        master_pb2.Heartbeat.FromString(plain))


def test_topology_cluster_heat_and_gauge():
    topo = Topology()

    def hb(port, heats):
        return {"ip": "10.0.0.9", "port": port, "volumes": [],
                "ec_shards": [], "volume_heats": heats}
    topo.sync_heartbeat(hb(1, [{"id": 771234, "reads_window": 5,
                                "ewma": 1.0}]))
    topo.sync_heartbeat(hb(2, [{"id": 771234, "reads_window": 7,
                                "ewma": 2.0}]), rack="r2")
    heat = topo.cluster_heat()
    assert heat[771234]["reads_window"] == 12.0
    assert heat[771234]["ewma"] == 3.0
    assert sorted(heat[771234]["servers"]) == ["10.0.0.9:1", "10.0.0.9:2"]
    out = port_metrics.ClusterVolumeHeatGauge.collect()
    assert 'SeaweedFS_cluster_volume_heat{vid="771234"} 12.0' in out
    topo.sync_heartbeat(hb(1, []))
    topo.unregister_node("10.0.0.9:2")
    assert 'vid="771234"' not in port_metrics.ClusterVolumeHeatGauge.collect()
    assert topo.cluster_heat() == {}


# -- the servers --------------------------------------------------------------------


def _get(url: str):
    try:
        with urllib.request.urlopen(f"http://{url}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_metrics_server_endpoints():
    srv = port_metrics.start_metrics_server(0, ip="127.0.0.1",
                                            role="volume")
    url = "127.0.0.1:%d" % srv.server_address[1]
    try:
        code, body = _get(f"{url}/metrics")
        assert code == 200
        samples = parse_prometheus(body.decode())
        assert samples["SeaweedFS_process_threads"] >= 1
        assert "SeaweedFS_process_open_fds" in samples
        code, body = _get(f"{url}/healthz")
        assert code == 200 and json.loads(body)["role"] == "volume"
        code, body = _get(f"{url}/debug/trace")
        assert code == 200 and "traceEvents" in json.loads(body)
        code, body = _get(f"{url}/debug/trace?sampled=1")
        assert code == 200 and "sampled" in json.loads(body)
        code, body = _get(f"{url}/debug/requests")
        assert code == 200 and json.loads(body)["requests"] == []
        code, body = _get(f"{url}/debug/failpoint")
        assert code == 200 and isinstance(json.loads(body), list)
        assert _get(f"{url}/nope")[0] == 404
        req = urllib.request.Request(f"http://{url}/debug/failpoint",
                                     data=b"{}", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 403
    finally:
        srv.shutdown()
        srv.server_close()


def test_push_gateway_loop_puts_and_counts_failures():
    got = []

    class Gateway(BaseHTTPRequestHandler):
        def do_PUT(self):
            n = int(self.headers["Content-Length"])
            got.append((self.path, self.rfile.read(n)))
            self.send_response(202)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    gw = ThreadingHTTPServer(("127.0.0.1", 0), Gateway)
    threading.Thread(target=gw.serve_forever, daemon=True).start()
    stop = threading.Event()
    t = port_metrics.loop_pushing_metric(
        "job1", "inst1", "127.0.0.1:%d" % gw.server_address[1], 0.05,
        stop_event=stop)
    try:
        wait_for(lambda: len(got) >= 2, 10, "two pushes")
        assert got[0][0] == "/metrics/job/job1/instance/inst1"
        parse_prometheus(got[0][1].decode())
    finally:
        stop.set()
        t.join(timeout=5)
        gw.shutdown()
        gw.server_close()
    before = port_metrics.MetricsPushErrorCounter.labels().value
    stop = threading.Event()
    t = port_metrics.loop_pushing_metric("j", "i", "127.0.0.1:1", 0.05,
                                         stop_event=stop)
    try:
        wait_for(lambda: port_metrics.MetricsPushErrorCounter.labels()
                 .value >= before + 2, 10, "failed pushes counted")
    finally:
        stop.set()
        t.join(timeout=5)


@pytest.fixture(scope="module")
def ocluster(tmp_path_factory):
    c = Cluster(tmp_path_factory.mktemp("obs"), n_volume_servers=2,
                volume_kwargs=[{"heat_track": True, "heat_window_s": 30.0},
                               {}])
    yield c
    c.stop()


def test_request_counters_move_per_role_and_verb(ocluster):
    c = ocluster
    counter = port_metrics.RequestCounter
    before = (counter.labels("volumeServer", "get").value,
              counter.labels("master", "get").value,
              counter.labels("master", "Assign").value,
              counter.labels("volumeServer", "VolumeServerStatus").value)
    fid = c.upload(b"counted" * 10)
    with c.fetch(fid) as r:
        assert r.read() == b"counted" * 10
    from seaweedfs_tpu_torch.pb import volume_server_pb2, volume_stub
    volume_stub(c.volume_servers[0].url).VolumeServerStatus(
        volume_server_pb2.VolumeServerStatusRequest())
    after = (counter.labels("volumeServer", "get").value,
             counter.labels("master", "get").value,
             counter.labels("master", "Assign").value,
             counter.labels("volumeServer", "VolumeServerStatus").value)
    assert after[0] > before[0] and after[1] > before[1]
    assert after[3] == before[3] + 1
    hist = port_metrics.RequestHistogram.collect()
    assert 'SeaweedFS_request_seconds_count{type="volumeServer",' \
           'name="get"}' in hist


def test_cluster_trace_stitches_a_replicated_write(ocluster, tmp_path):
    c = ocluster
    port_ct.reset()
    port_ct.enable(sample_fraction=1.0, slow_threshold_ms=10_000.0)
    try:
        a = c.assign(replication="001")
        assert "fid" in a, a
        tid = "%016x" % 0x5eed_0000_0000_0001
        req = urllib.request.Request(
            f"http://{a['url']}/{a['fid']}", data=b"traced" * 50,
            method="POST",
            headers={port_ct.HEADER: f"{tid}-{1:016x}-s"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 201
        out_file = tmp_path / "trace.json"
        out = Shell(c.master.url).run_command(
            f"cluster.trace -traceId={tid} -out={out_file}")
        stitched = json.loads(out_file.read_text())
        lanes = {e["args"]["name"] for e in stitched["traceEvents"]
                 if e["ph"] == "M"}
        servers = {n.split(" ", 1)[1] for n in lanes}
        assert len(servers) >= 2, (out, lanes)
        assert "chrome trace written" in out
        names = {e["name"] for e in stitched["traceEvents"]
                 if e["ph"] == "X"}
        assert "request.volumeServer.post" in names and \
            "http.client" in names
        # the fan-out's own /debug/requests calls are the only traced
        # requests in flight
        rows = Shell(c.master.url).run_command("cluster.requests")
        assert rows.strip() and all("/debug/requests" in r
                                    for r in rows.strip().splitlines())
        code, body = _get(f"{a['url']}/debug/trace?sampled=1")
        assert code == 200 and tid in body.decode()
    finally:
        port_ct.disable()
        port_ct.reset()


def test_heat_reaches_the_master_and_cluster_heat(ocluster):
    c = ocluster
    hot = c.volume_servers[0]
    fid = None
    for _ in range(20):
        f = c.upload(b"heat" * 30)
        if hot.store.has_volume(parse_fid(f).volume_id):
            fid = f
            break
    assert fid is not None
    vid = parse_fid(fid).volume_id
    for _ in range(5):
        code, body = _get(f"{hot.url}/{fid}")
        assert (code, body) == (200, b"heat" * 30)
    assert hot.heat.window_reads(vid) >= 5
    hot.trigger_heartbeat()
    wait_for(lambda: c.master.topo.cluster_heat().get(vid, {})
             .get("reads_window", 0) >= 5, 10, "heat at the master")
    code, body = _get(f"{c.master.url}/cluster/heat")
    rec = json.loads(body)["volumes"][str(vid)]
    assert rec["tier"] == "hot" and rec["servers"] == [hot.url]
    assert f"volume {vid}: reads/window:" in Shell(
        c.master.url).run_command(f"cluster.heat -volumeId={vid}")
    gauge = port_metrics.VolumeHeatGauge.collect()
    assert f'SeaweedFS_volume_heat{{vid="{vid}"}}' in gauge


def test_off_contract_no_tracker_no_trace(ocluster):
    c = ocluster
    cold = c.volume_servers[1]
    assert cold.heat is None
    assert "volume_heats" not in cold.store.collect_heartbeat()
    assert not port_ct.enabled() and port_trace.span("x") is port_trace.NOOP
    seen = []

    class Echo(BaseHTTPRequestHandler):
        def do_GET(self):
            seen.append(dict(self.headers))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Echo)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        http_client.request("GET", "127.0.0.1:%d/x" % srv.server_address[1],
                            timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()
    assert port_ct.HEADER not in seen[0] and \
        "X-Seaweed-Tenant" not in seen[0]


def test_cluster_trace_stitches_a_degraded_read(ocluster, tmp_path):
    """A traced GET through server A of an EC needle whose shard is gone:
    A's remote shard fetches (the decode fleet's pool threads included)
    carry the trace, so B's shard-read spans stitch under it. The JAX
    package traces no stream and its fleet threads no context, so its
    stitched view holds A alone (ROADMAP Queue 3)."""
    from seaweedfs_tpu_torch.pb import volume_server_pb2, volume_stub
    c = ocluster
    data = bytes(range(256)) * 20
    fid = c.upload(data, collection="trd")
    vid = parse_fid(fid).volume_id
    Shell(c.master.url).run_command(
        f"ec.encode -collection=trd -volumeId={vid}")
    wait_for(lambda: len(c.master.topo.lookup_ec(vid)) == 2 and
             not c.master.topo.lookup(vid, "trd"), 10, "the EC spread")

    def holder_of(sid):
        return next(vs for vs in c.volume_servers
                    if vs.store.find_ec_volume(vid) is not None and
                    sid in vs.store.find_ec_volume(vid).shard_bits.shard_ids)
    ecv = holder_of(0).store.find_ec_volume(vid)
    sid = ecv.locate_needle(parse_fid(fid).key)[2][0].to_shard_and_offset(
        ecv.large_block, ecv.small_block)[0]
    b = holder_of(sid)
    a = next(vs for vs in c.volume_servers if vs is not b)
    volume_stub(b.url).VolumeEcShardsUnmount(
        volume_server_pb2.VolumeEcShardsUnmountRequest(
            volume_id=vid, shard_ids=[sid]))
    port_ct.reset()
    port_ct.enable(sample_fraction=0.0, slow_threshold_ms=10_000.0)
    try:
        tid = "%016x" % 0x5eed_0000_0000_0002
        d0 = a.degraded.dispatches
        req = urllib.request.Request(
            f"http://{a.url}/{fid}",
            headers={port_ct.HEADER: f"{tid}-{1:016x}-s"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.read() == data
        assert a.degraded.dispatches > d0, "the read was not degraded"
        out_file = tmp_path / "degraded.json"
        Shell(c.master.url).run_command(
            f"cluster.trace -traceId={tid} -out={out_file}")
        events = json.loads(out_file.read_text())["traceEvents"]
        lanes = {e["args"]["name"] for e in events if e["ph"] == "M"}
        # (the master's lane holds A's shard-location lookup)
        assert {f"volumeServer {a.url}", f"volumeServer {b.url}"} <= lanes
        names = {e["name"] for e in events if e["ph"] == "X"}
        assert {"request.volumeServer.get", "reads.degraded",
                "request.volumeServer.VolumeEcShardRead"} <= names
    finally:
        port_ct.disable()
        port_ct.reset()
