"""The port's multi-tenant QoS against the JAX package's.

Pure host logic held to the JAX package exactly, on a fake clock shared by
both: the token bucket's admit/shed decisions, its Retry-After and its
credit over a seeded stream of charges; tenant resolution over seeded
header sets; the weighted-fair queue's dequeue order for seeded puts; the
heat-aware global shed over a seeded stream of hot and cold reads; the
connection-share logic (``conn_*``, carried as logic); and ``status()``.
Then the seams on a port volume server under ``-qos``: an over-rate
tenant gets 429 with ``Retry-After`` and the JAX package's body, a
well-behaved one is never shed and its bodies are the uploaded bytes, a
unary RPC sheds with RESOURCE_EXHAUSTED, and the ambient tenant is
forwarded on outbound HTTP and RPC hops. The off contract: without
``-qos`` no manager exists, every seam holds None, a fan-out pool takes
its FIFO branch and the internal context is the shared no-op.
"""

import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from seaweedfs_tpu import qos as jax_qos
from seaweedfs_tpu.qos import admission as jax_adm
from seaweedfs_tpu.qos import fair as jax_fair
from seaweedfs_tpu.qos import tenant as jax_tenant
from seaweedfs_tpu.stats import heat as jax_heat
from seaweedfs_tpu.stats import metrics as jax_metrics
from seaweedfs_tpu_torch import qos, rpc
from seaweedfs_tpu_torch.pb import volume_server_pb2, volume_stub
from seaweedfs_tpu_torch.qos import admission as port_adm
from seaweedfs_tpu_torch.qos import fair as port_fair
from seaweedfs_tpu_torch.qos import tenant as port_tenant
from seaweedfs_tpu_torch.stats import heat as port_heat
from seaweedfs_tpu_torch.stats import metrics
from seaweedfs_tpu_torch.util import fanout, http_client
from seaweedfs_tpu_torch.util.http_server import HeaderDict
from tests.test_torch_cluster import Cluster, holder


class FakeTime:
    """A clock both packages read through their module's ``time``."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    perf_counter = monotonic

    def time(self) -> float:
        return 1.7e9 + self.t


@pytest.fixture
def clock(monkeypatch):
    ft = FakeTime()
    for mod in (jax_adm, port_adm, jax_fair, port_fair, jax_heat,
                port_heat):
        monkeypatch.setattr(mod, "time", ft)
    return ft


@pytest.fixture(autouse=True)
def _qos_off():
    yield
    qos.reset()
    jax_qos.reset()
    port_tenant.current.set(None)


# -- pure logic, seeded against the JAX package -------------------------------


@pytest.mark.parametrize("rate,burst", [(5.0, 0.0), (200.0, 200.0),
                                        (0.5, 3.0), (1000.0, 10.0),
                                        (0.0, 0.0)])
def test_bucket_decisions_equal_jax(clock, rate, burst):
    rng = np.random.default_rng(int(rate * 10 + burst))
    jb, pb = jax_adm.AdmissionBucket(rate, burst), \
        port_adm.AdmissionBucket(rate, burst)
    assert (pb.rate, pb.burst, pb.disabled) == \
        (jb.rate, jb.burst, jb.disabled)
    sheds = 0
    for _ in range(400):
        clock.t += float(rng.choice([0.0, 0.001, 0.01,
                                     rng.exponential(1.0 / max(rate, 1))]))
        n = float(rng.choice([1.0, 1.0, 2.0, rng.uniform(0.1, 3 * max(
            pb.burst, 1.0))]))
        got, want = pb.try_admit(n), jb.try_admit(n)
        assert got == want
        sheds += got[0] > 0
        if rng.integers(8) == 0:
            assert pb.tokens() == jb.tokens()
    if rate:
        assert sheds > 0


def test_retry_after_header_equals_jax(clock):
    """The shed reply: 429, Retry-After = ceil(refill), the same body."""
    class Capture:
        def fast_reply(self, code, body, headers, ctype=""):
            self.reply = (code, body, dict(headers), ctype)

    cfg = dict(request_rate=4.0, request_burst=2.0)
    mj = jax_adm.QosManager(jax_adm.QosConfig(**cfg))
    mp = port_adm.QosManager(port_adm.QosConfig(**cfg))
    for i in range(40):
        clock.t += 0.07 * (i % 5)
        a, b = mp.admit("t-retry"), mj.admit("t-retry")
        assert a == b
        if a[0] > 0:
            cp, cj = Capture(), Capture()
            mp.shed_reply(cp, "volumeServer", "t-retry", *a)
            mj.shed_reply(cj, "volumeServer", "t-retry", *b)
            assert cp.reply == cj.reply
            assert cp.reply[0] == 429 and "Retry-After" in cp.reply[2]


def test_tenant_resolution_equals_jax():
    rng = np.random.default_rng(7)
    keys = ["AKIA" + "".join(rng.choice(list("ABCDEFGH0123"), 8))
            for _ in range(4)]
    for _ in range(500):
        h = HeaderDict()
        if rng.integers(3) == 0:
            h["X-Seaweed-Tenant"] = str(rng.choice(["good", "noisy", "",
                                                    "a:b"]))
        if rng.integers(3) == 0:
            k = str(rng.choice(keys))
            h["Authorization"] = str(rng.choice([
                f"AWS4-HMAC-SHA256 Credential={k}/20260101/us/s3/aws4",
                f"AWS {k}:sig", "Bearer x", "AWS :x",
                "AWS4-HMAC-SHA256 Credential=/x"]))
        path = str(rng.choice(["/3,01ab", "/dir/assign?collection=c1",
                               "/x?a=1&collection=", "/x?collection=hot&y",
                               "/?collection=z"]))
        assert port_tenant.resolve(h, path) == jax_tenant.resolve(h, path)
    assert (port_tenant.HEADER, port_tenant.GRPC_KEY, port_tenant.DEFAULT,
            port_tenant.INTERNAL, port_tenant.OTHER) == \
        (jax_tenant.HEADER, jax_tenant.GRPC_KEY, jax_tenant.DEFAULT,
         jax_tenant.INTERNAL, jax_tenant.OTHER)


def test_wfq_dequeue_order_equals_jax(clock):
    weights = {"wq-a": 8.0, "wq-b": 2.0, "wq-c": 1.0}
    mj = jax_adm.QosManager(jax_adm.QosConfig(weights=weights))
    mp = port_adm.QosManager(port_adm.QosConfig(weights=weights))
    qj, qp = mj.make_wfq("pool"), mp.make_wfq("pool")
    rng = np.random.default_rng(11)
    order_j, order_p = [], []
    for i in range(600):
        clock.t += 0.001
        if rng.integers(3):
            name = str(rng.choice(list(weights) + ["wq-d", "_internal"]))
            tj, tp = jax_tenant.current.set(name), \
                port_tenant.current.set(name)
            try:
                qj.put((name, i))
                qp.put((name, i))
            finally:
                jax_tenant.current.reset(tj)
                port_tenant.current.reset(tp)
        else:
            order_j.append(qj.pop())
            order_p.append(qp.pop())
    while len(qp):
        order_j.append(qj.pop())
        order_p.append(qp.pop())
    assert order_p == order_j and len(qj) == 0
    assert sum(1 for x in order_p if x) > 300


def test_heat_aware_global_shed_equals_jax(clock):
    cfg = dict(global_request_rate=50.0)
    mj = jax_adm.QosManager(jax_adm.QosConfig(**cfg))
    mp = port_adm.QosManager(port_adm.QosConfig(**cfg))
    mj.heat = jax_heat.HeatTracker(window_s=8.0)
    mp.heat = port_heat.HeatTracker(window_s=8.0)
    try:
        rng = np.random.default_rng(5)
        hot = [101, 102]
        for _ in range(300):
            vid = int(rng.choice(hot)) if rng.integers(3) else \
                int(rng.integers(103, 110))
            mj.heat.record(vid)
            mp.heat.record(vid)
        outcomes = set()
        for _ in range(600):
            clock.t += float(rng.choice([0.0, 0.002, 0.02]))
            vid = int(rng.choice(hot)) if rng.integers(2) else \
                int(rng.integers(103, 110))
            got, want = mp.admit("heat-t", vid=vid), \
                mj.admit("heat-t", vid=vid)
            assert got == want
            outcomes.add((got[1], vid in hot))
        # hot reads rode the reserve while cold ones were shed
        assert ("global", False) in outcomes and ("", True) in outcomes
    finally:
        mj.heat.close()
        mp.heat.close()


def test_conn_shares_and_status_equal_jax(clock):
    cfg = dict(request_rate=3.0, bytes_mbps=1.0,
               weights={"cs-a": 4.0, "cs-b": 1.0})
    mj = jax_adm.QosManager(jax_adm.QosConfig(**cfg))
    mp = port_adm.QosManager(port_adm.QosConfig(**cfg))
    rng = np.random.default_rng(9)
    names = ["cs-a", "cs-b", "cs-c", "_internal"]
    # the admitted and shed counts of status() are process-wide counter
    # children that other tests in this process may have moved before:
    # compare what this stream added to them
    base_j, base_p = _counter_base(jax_metrics, names), \
        _counter_base(metrics, names)
    for _ in range(300):
        name = str(rng.choice(names))
        op = int(rng.integers(4))
        if op == 0:
            mj.conn_opened(name)
            mp.conn_opened(name)
        elif op == 1:
            mj.conn_closed(name)
            mp.conn_closed(name)
        elif op == 2:
            cap = int(rng.integers(1, 12))
            assert mp.conn_over_share(name, cap) == \
                mj.conn_over_share(name, cap)
        else:
            clock.t += 0.1
            n = int(rng.integers(0, 3 << 20))
            assert mp.admit(name, nbytes=n) == mj.admit(name, nbytes=n)
        counts = {str(n): int(rng.integers(0, 6)) for n in names}
        assert mp.most_over_share(counts, 8) == \
            mj.most_over_share(counts, 8)
    sj = _minus_base(mj.status(), base_j)
    sp = _minus_base(mp.status(), base_p)
    assert sp == sj
    assert set(sp["tenants"]) == set(names)


def _counter_base(metrics_mod, names):
    """{tenant: (admitted, {reason: shed})} as the registry holds them
    now. Reads the children without removing or resetting them: a live
    manager of another test may still hold them."""
    return {n: (int(metrics_mod.QosAdmittedCounter.labels(n).value),
                {r: int(metrics_mod.QosShedCounter.labels(n, r).value)
                 for r in port_adm._SHED_REASONS})
            for n in names}


def _minus_base(status, base):
    for name, t in status["tenants"].items():
        admitted, shed = base[name]
        t["admitted"] -= admitted
        t["shed"] = {r: v - shed[r] for r, v in t["shed"].items()}
    return status


# -- the seams on a port volume server ----------------------------------------


@pytest.fixture(scope="module")
def qcluster(tmp_path_factory):
    c = Cluster(tmp_path_factory.mktemp("qos"), n_volume_servers=1)
    yield c
    c.stop()


def _get(url, tenant=None):
    req = urllib.request.Request(
        f"http://{url}", headers={"X-Seaweed-Tenant": tenant}
        if tenant else {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def test_volume_server_sheds_over_rate_tenant(qcluster):
    c = qcluster
    data = bytes(np.random.default_rng(1).integers(0, 256, 5000,
                                                   dtype=np.uint8))
    fid = c.upload(data, collection="q")
    url = holder(c.master, int(fid.split(",")[0]), "q")
    mgr = qos.configure(qos.QosConfig(request_rate=0.01, request_burst=5,
                                      weights={"vs-good": 4.0}))
    answers = [_get(f"{url}/{fid}", "vs-noisy") for _ in range(12)]
    assert [a[0] for a in answers[:5]] == [200] * 5
    assert all(a[1] == data for a in answers[:5])
    shed = answers[5:]
    assert {a[0] for a in shed} == {429}
    for code, body, headers in shed:
        assert int(headers["Retry-After"]) >= 1
        assert body == (f"qos: tenant vs-noisy over requests budget; "
                        f"retry after {headers['Retry-After']}s\n").encode()
    # the well-behaved tenant is untouched by the other's sheds
    for _ in range(4):
        code, body, _ = _get(f"{url}/{fid}", "vs-good")
        assert (code, body) == (200, data)
    st = mgr.status()["tenants"]
    assert (st["vs-noisy"]["admitted"], st["vs-noisy"]["shed"]["requests"]) \
        == (5, 7)
    assert st["vs-good"]["shed"]["requests"] == 0
    # the data port's own admission view, and the master's gathered one
    code, body, _ = _get(f"{url}/qos/status")
    assert code == 200 and b'"vs-noisy"' in body
    code, body, _ = _get(f"{c.master.url}/cluster/qos")
    assert code == 200 and url.encode() in body
    assert metrics.QosShedCounter.labels("vs-noisy", "requests").value >= 7


def test_unary_rpc_sheds_with_resource_exhausted(qcluster):
    c = qcluster
    qos.configure(qos.QosConfig(request_rate=0.01, request_burst=2))
    url = c.volume_servers[0].url
    stub = volume_stub(url)
    with port_tenant.as_tenant("rpc-noisy"):
        for _ in range(2):
            stub.VolumeServerStatus(
                volume_server_pb2.VolumeServerStatusRequest())
        with pytest.raises(rpc.RpcError) as ei:
            stub.VolumeServerStatus(
                volume_server_pb2.VolumeServerStatusRequest())
    assert ei.value.code() == rpc.StatusCode.RESOURCE_EXHAUSTED
    assert "rpc-noisy" in ei.value.details()


def test_ambient_tenant_is_forwarded_on_http_and_rpc(qcluster):
    """With QoS on, an outbound hop carries the caller's tenant: the
    receiving server charges it, not "default"."""
    c = qcluster
    mgr = qos.configure(qos.QosConfig())
    url = c.volume_servers[0].url
    with port_tenant.as_tenant("fw-http"):
        http_client.request("GET", f"{url}/status", timeout=10)
    with port_tenant.as_tenant("fw-rpc"):
        volume_stub(url).VolumeServerStatus(
            volume_server_pb2.VolumeServerStatusRequest())
    st = mgr.status()["tenants"]
    assert st["fw-http"]["admitted"] == 1 and st["fw-rpc"]["admitted"] == 1


def test_off_contract_nothing_constructed():
    qos.reset()
    assert qos.manager() is None and not qos.enabled()
    assert fanout._qos_sched is None and metrics._qos_http is None
    assert http_client._qos_tenant is None and rpc._qos_tenant is None
    assert qos.internal_context() is qos._NULL_CTX
    pool = fanout.FanOutPool(2, "off-branch")
    try:
        assert [f.wait()[0] for f in
                [pool.submit(lambda i=i: i * 2) for i in range(6)]] == \
            [0, 2, 4, 6, 8, 10]
        assert pool._wfq is None
    finally:
        pool.stop()
    # with QoS on, the same pool orders its backlog through a WFQ
    qos.configure(qos.QosConfig())
    pool = fanout.FanOutPool(1, "on-branch")
    try:
        done = threading.Event()
        assert pool.submit(done.set).wait(timeout=5)[1] is None
        assert pool._wfq is not None
    finally:
        pool.stop()
    assert qos.internal_context() is not qos._NULL_CTX
