"""The port's chaos suite: the twin of ``tests/test_chaos.py`` on the port's
in-process cluster (``tests/test_torch_cluster.Cluster``), with the port's
failpoints, deadlines, breakers and hedger.

Kill, stall and fault-inject servers under concurrent load, and hold the
resilience invariants end to end with the JAX suite's bounds:

  - reads return byte-identical data or a correct typed error, always
    before their deadline
  - the dead peer's circuit breaker opens, then recovers after the
    peer returns
  - hedged reads keep the stalled-shard tail bounded while spending
    <= 5% extra requests
  - a replica that really dies (server stopped, port closed) is failed
    over, and a replacement on its port closes its breaker again

The whole module runs with the port's runtime concurrency sanitizer
armed (``port_sanitizer_armed``): a lock-order cycle anywhere in it
fails the module, so every 32-way scenario is also a race hunt. Waits
follow state (a breaker's cooldown is waited out on the breaker), and
each test has its own time limit.

Volume placement is pinned by registering volumes directly on chosen
servers (heartbeats advertise them to the master like any other
volume), so each scenario targets exactly the replica pair it means
to.
"""

import json
import signal
import threading
import time
import urllib.error

import pytest

from seaweedfs_tpu_torch.resilience import breaker, deadline, failpoint
from seaweedfs_tpu_torch.resilience.deadline import DeadlineExceeded
from seaweedfs_tpu_torch.resilience.hedge import Hedger
from seaweedfs_tpu_torch.server.filer import FilerServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.util import http_client
from tests.test_torch_cluster import (Cluster, free_port_pair,
                                      port_sanitizer_armed, wait_for)

COOKIE = 0xABCDEF01


@pytest.fixture(scope="module", autouse=True)
def _port_sanitizer():
    with port_sanitizer_armed("test_torch_chaos"):
        yield


@pytest.fixture(scope="module", autouse=True)
def _sigpipe_ignored():
    """SIGPIPE ignored, the interpreter's own setting, for the module.
    A libfuse mount earlier in the same worker (tests/test_filesys.py)
    leaves the process at SIGPIPE's default action, and this module
    makes servers write to sockets their clients gave up on (the
    hedge's abandoned losers, a stalled read past its deadline): such a
    write would end the worker instead of raising BrokenPipeError.
    ``signal.signal`` sets the disposition in the kernel; what it hands
    back is the interpreter's own record, which the mount never
    changed, so putting that back leaves the interpreter's setting."""
    old = signal.signal(signal.SIGPIPE, signal.SIG_IGN)
    try:
        yield
    finally:
        signal.signal(signal.SIGPIPE, old)


def time_limit(seconds: float):
    """The test's own time limit, enforced by ``_time_limit``."""
    def mark(fn):
        fn.time_limit = seconds
        return fn
    return mark


@pytest.fixture(autouse=True)
def _time_limit(request):
    limit = request.function.time_limit

    def expire(signum, frame):
        raise TimeoutError(f"{request.node.name} ran past its "
                           f"{limit} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _clean_resilience_state():
    yield
    failpoint.disarm()
    breaker.reset()
    http_client.close_all()


def _racked(n: int):
    return [{"rack": f"r{i + 1}"} for i in range(n)]


def _fid(vid: int, key: int) -> str:
    return f"{vid},{key:x}{COOKIE:08x}"


def _place_volume(cluster, vid: int, servers) -> None:
    """Register `vid` on exactly `servers` (replication 010 so writes
    fan out) and wait until the master's lookup sees every copy."""
    for vs in servers:
        vs.store.add_volume(vid, "", replica_placement="010")
        vs.trigger_heartbeat()

    def registered():
        with cluster.http(f"{cluster.master.url}/dir/lookup"
                          f"?volumeId={vid}") as r:
            locs = json.load(r).get("locations") or []
        return len(locs) == len(servers)

    wait_for(registered, what=f"volume {vid} on all replicas")


def _upload(url: str, fid: str, data: bytes) -> None:
    r = http_client.request("POST", f"{url}/{fid}", body=data,
                            headers={"Content-Type":
                                     "application/octet-stream"})
    assert r.status == 201, (r.status, r.body)


def _read_one(url: str, fid: str, timeout: float = 4.0) -> bytes:
    r = http_client.request("GET", f"{url}/{fid}", timeout=timeout)
    if r.status != 200:
        raise IOError(f"GET {url}/{fid}: http {r.status}")
    return r.body


def _p(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


def _wait_cooldown(url: str) -> None:
    """Until the OPEN breaker of `url` shows HALF_OPEN: its cooldown ran
    out, and the next request through it is the probe."""
    wait_for(lambda: breaker.for_peer(url).state == breaker.HALF_OPEN,
             what=f"the breaker of {url} past its cooldown")


@time_limit(150)
def test_chaos_end_to_end(tmp_path):
    """The acceptance scenario: a dead replica (injected connect
    failure) and a 2s-stalled volume under 32-way concurrent load."""
    cluster = Cluster(tmp_path, n_volume_servers=3,
                      volume_kwargs=_racked(3))
    hedger = None
    try:
        vs_healthy, vs_dead, vs_stall = cluster.volume_servers
        VID_DEAD, VID_STALL, VID_PLAIN = 101, 102, 103
        _place_volume(cluster, VID_DEAD, [vs_healthy, vs_dead])
        _place_volume(cluster, VID_STALL, [vs_healthy, vs_stall])
        _place_volume(cluster, VID_PLAIN, [vs_healthy, vs_dead])

        blobs = {}
        for i in range(1, 9):
            for vid, primary in ((VID_DEAD, vs_healthy),
                                 (VID_STALL, vs_healthy),
                                 (VID_PLAIN, vs_healthy)):
                fid = _fid(vid, i)
                blobs[fid] = (f"chaos-{fid}-".encode() * 97)[:4096]
                _upload(primary.url, fid, blobs[fid])

        breaker.configure(enable=True, threshold=3, cooldown_s=1.0)
        # wide lanes: 32 threads × (primary + hedge) must never force
        # the saturation fallback, or a stalled primary can't hedge.
        # The hedge delay's floor is 200 ms (JAX's twin: 50 ms). On a
        # busy host the pool hand-off alone takes a two-candidate read
        # past 50 ms often enough that healthy reads hedge and spend the
        # 5% budget before the stalled reads come (12-31 stalled hedges
        # denied in runs beside five busy test workers, and JAX's twin
        # fails the same way there); a later hedge only makes the
        # stalled-read bounds below harder to meet
        floor = 0.2
        hedger = Hedger(delay_floor_s=floor, budget_pct=0.05,
                        max_inflight=96, name="chaos-hedge")

        def hedged_read(fid: str, candidates) -> bytes:
            with deadline.budget(5.0):
                urls = breaker.sort_candidates(candidates)
                return hedger.fetch(
                    [lambda u=u: _read_one(u, fid) for u in urls])

        # -- baseline: healthy tail, breakers closed ----------------------
        healthy_lat = []
        for i in range(1, 9):
            t0 = time.perf_counter()
            got = hedged_read(_fid(VID_PLAIN, i),
                              [vs_healthy.url, vs_dead.url])
            healthy_lat.append(time.perf_counter() - t0)
            assert got == blobs[_fid(VID_PLAIN, i)]

        # -- inject: vs_dead unreachable, VID_STALL stalled on vs_stall ---
        http_client.close_all()   # pooled sockets would dodge connect
        failpoint.arm("http.connect", "error",
                      match={"peer": vs_dead.url})
        failpoint.arm("volume.read", "delay", arg=2.0,
                      match={"server": vs_stall.url,
                             "vid": str(VID_STALL)})

        results = {}            # fid -> set of byte payloads seen
        errors = []
        stall_lat, all_lat = [], []
        lock = threading.Lock()
        READS_PER_THREAD = 50

        def worker(widx: int):
            for it in range(READS_PER_THREAD):
                key = (widx + it) % 8 + 1
                if it == 10 + widx % 20:
                    # one stalled-primary read per thread, spread out
                    fid = _fid(VID_STALL, key)
                    candidates = [vs_stall.url, vs_healthy.url]
                    bucket = stall_lat
                elif it % 8 == 0:
                    # dead-primary reads: breaker + failover path
                    fid = _fid(VID_DEAD, key)
                    candidates = [vs_dead.url, vs_healthy.url]
                    bucket = None
                else:
                    # plain reads are single-candidate: hedging only
                    # applies where another replica exists
                    fid = _fid(VID_PLAIN, key)
                    candidates = [vs_healthy.url]
                    bucket = None
                t0 = time.perf_counter()
                try:
                    got = hedged_read(fid, candidates)
                except Exception as e:  # noqa: BLE001 - asserted below
                    with lock:
                        errors.append((fid, repr(e)))
                    continue
                dt = time.perf_counter() - t0
                with lock:
                    all_lat.append(dt)
                    if bucket is not None:
                        bucket.append(dt)
                    results.setdefault(fid, set()).add(got)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "workers wedged"

        # 1. every read byte-identical or a typed error — here the
        # failover/hedge paths cover both faults, so no errors at all
        assert not errors, errors[:5]
        for fid, seen in results.items():
            assert seen == {blobs[fid]}, f"{fid}: non-identical bytes"
        # 2. every read beat its 5s budget (deadline honored e2e)
        assert max(all_lat) < 5.0
        # 3. the dead peer's breaker opened under load
        assert breaker.for_peer(vs_dead.url).state == breaker.OPEN
        # 4. hedged reads bounded the stalled tail: p90 within 3x the
        # healthy p99 (with an absolute floor), and EVERY stalled read
        # beat the injected 2s stall
        healthy_p99 = max(_p(healthy_lat, 0.99), _p(all_lat, 0.5))
        ledger = (f"; {hedger.requests} requests, {hedger.hedges} hedges, "
                  f"{hedger.wins} wins, {hedger.denied} denied, hedge "
                  f"delay {hedger.hedge_delay():.3f}s (floor {floor:.3f}s)")
        assert len(stall_lat) == 32
        assert _p(stall_lat, 0.9) <= max(3 * healthy_p99, 0.6), \
            f"stalled p90 {_p(stall_lat, 0.9):.3f}s " \
            f"vs healthy {healthy_p99:.3f}s" + ledger
        assert max(stall_lat) < 1.9, \
            f"a stalled read waited out the stall: {max(stall_lat):.3f}s" + \
            ledger
        # 5. hedge budget: <= 5% extra requests (+1 burst allowance)
        assert hedger.hedges <= 0.05 * hedger.requests + 2, \
            f"{hedger.hedges} hedges for {hedger.requests} requests"
        assert hedger.hedges >= len(stall_lat) // 2, \
            "stalled reads were not hedging at all"
        assert hedger.wins >= len(stall_lat) // 2, \
            "hedges were issued but never won against the stall"

        # -- recovery: the dead peer returns ------------------------------
        failpoint.disarm("http.connect")
        _wait_cooldown(vs_dead.url)
        got = hedged_read(_fid(VID_DEAD, 1), [vs_dead.url,
                                              vs_healthy.url])
        assert got == blobs[_fid(VID_DEAD, 1)]
        assert breaker.for_peer(vs_dead.url).state == breaker.CLOSED
    finally:
        if hedger is not None:
            hedger.stop()
        cluster.stop()


@time_limit(60)
def test_deadline_propagates_filer_to_volume(tmp_path):
    """X-Seaweed-Deadline rides the filer -> volume chain: a stalled
    volume read makes the filer give up when the CLIENT's budget says
    so, not after its own 60s timeouts."""
    cluster = Cluster(tmp_path, n_volume_servers=1)
    filer = None
    try:
        vs = cluster.volume_servers[0]
        filer = FilerServer(cluster.master.url, port=free_port_pair(),
                            meta_dir=str(tmp_path / "filer"))
        filer.start()
        payload = b"deadline-payload " * 1024
        for name in ("f1", "f2"):
            with cluster.http(f"{filer.url}/chaos/{name}",
                              data=payload, method="POST") as r:
                assert r.status == 201
        # sanity: readable without a budget
        with cluster.http(f"{filer.url}/chaos/f1") as r:
            assert r.read() == payload

        failpoint.arm("volume.read", "delay", arg=1.5,
                      match={"server": vs.url})
        t0 = time.perf_counter()
        with pytest.raises(urllib.error.HTTPError) as ei:
            # f2 was never read, so the filer's chunk cache cannot
            # answer — the read MUST cross the stalled volume hop
            cluster.http(f"{filer.url}/chaos/f2",
                         headers={"X-Seaweed-Deadline": "0.4"})
        elapsed = time.perf_counter() - t0
        # the filer surfaced a typed failure (504 budget-spent or 500
        # no-reachable-replica after the budget-sized timeout) well
        # before the 1.5s stall, let alone its own 60s client timeout
        assert ei.value.code in (500, 504)
        assert elapsed < 1.2, f"filer ignored the budget ({elapsed:.2f}s)"

        failpoint.disarm()
        with cluster.http(f"{filer.url}/chaos/f2") as r:
            assert r.read() == payload
    finally:
        if filer is not None:
            filer.stop()
        cluster.stop()


@time_limit(60)
def test_deadline_refuses_work_client_side(tmp_path):
    """An exhausted ambient budget refuses outbound work instantly —
    no socket is opened for a caller that already gave up."""
    cluster = Cluster(tmp_path, n_volume_servers=1)
    try:
        fid = cluster.upload(b"x" * 100)
        with cluster.http(f"{cluster.master.url}/dir/lookup"
                          f"?volumeId={fid}") as r:
            url = json.load(r)["locations"][0]["url"]
        with deadline.budget(5.0):
            assert http_client.request(
                "GET", f"{url}/{fid}").status == 200
        with deadline.budget(0.0):
            t0 = time.perf_counter()
            with pytest.raises(DeadlineExceeded):
                http_client.request("GET", f"{url}/{fid}")
            assert time.perf_counter() - t0 < 0.1
    finally:
        cluster.stop()


@time_limit(90)
def test_chaos_kill_and_restart_replica(tmp_path):
    """REAL death (server stopped, port closed), not just an injected
    connect error: reads fail over, the breaker opens, and a
    replacement server on the same port brings the breaker back to
    closed."""
    cluster = Cluster(tmp_path, n_volume_servers=2,
                      volume_kwargs=_racked(2))
    try:
        vs0, vs1 = cluster.volume_servers
        VID = 201
        _place_volume(cluster, VID, [vs0, vs1])
        blobs = {}
        for i in range(1, 5):
            fid = _fid(VID, i)
            blobs[fid] = (f"kill-{fid}-".encode() * 211)[:4096]
            _upload(vs0.url, fid, blobs[fid])

        breaker.configure(enable=True, threshold=3, cooldown_s=0.5)
        dead_port, dead_dir = vs1.port, vs1.store.locations[0].directory
        vs1.stop()
        http_client.close_all()

        def failover_read(fid):
            for u in breaker.sort_candidates([vs1.url, vs0.url]):
                try:
                    return _read_one(u, fid, timeout=2.0)
                except OSError:
                    continue
            raise IOError("no replica answered")

        for round_ in range(6):
            fid = _fid(VID, round_ % 4 + 1)
            assert failover_read(fid) == blobs[fid]
        assert breaker.for_peer(vs1.url).state == breaker.OPEN

        def restart():
            try:
                vs = VolumeServer(
                    cluster.master.url, [dead_dir], port=dead_port,
                    pulse_seconds=0.2, ec_encoder="cpu", rack="r2")
                vs.start()
            except OSError:
                return None   # the old listener's port is not free yet
            return vs

        replacement = wait_for(restart, timeout=15,
                               what="a replacement on the dead port")
        try:
            _wait_cooldown(vs1.url)
            for i in range(1, 5):
                fid = _fid(VID, i)
                assert failover_read(fid) == blobs[fid]
            wait_for(
                lambda: breaker.for_peer(vs1.url).state == breaker.CLOSED,
                what="breaker recovery after replica restart")
        finally:
            replacement.stop()
    finally:
        cluster.stop()
