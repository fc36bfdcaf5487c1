"""Test config: force JAX onto a virtual 8-device CPU mesh.

Multi-chip hardware is unavailable in the dev loop; sharding logic is
validated on 8 virtual CPU devices (the driver's dryrun_multichip does the
same, via the same helper — see seaweedfs_tpu/util/cpu_mesh.py for why
plain env vars are captured too late in this image).
"""

from seaweedfs_tpu.util.cpu_mesh import force_cpu_platform

force_cpu_platform(8)


import threading

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running case excluded from tier-1 "
        "(-m 'not slow')")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")


def pytest_collection_modifyitems(items):
    """Run the heavy 8-device mesh tests FIRST: they allocate
    multi-GB XLA buffers and have aborted (bad_alloc-style SIGABRT)
    when scheduled late in a long suite with hundreds of tests' worth
    of ambient state; fresh-process placement keeps them deterministic
    and the rest of the suite unaffected."""
    heavy = [it for it in items if "test_parallel" in it.nodeid]
    rest = [it for it in items if "test_parallel" not in it.nodeid]
    items[:] = heavy + rest


@pytest.fixture(autouse=True)
def _no_leaked_nondaemon_threads():
    """Graceful-shutdown audit (ISSUE 6 satellite): any test that
    leaves a NON-daemon thread running would block interpreter exit.
    Daemon threads (every pool/daemon in this tree) and
    concurrent.futures executor workers (joined by the stdlib's atexit
    hook after sentinel delivery, so they never hang the process) are
    exempt; everything else must be gone — after a short join grace
    for threads still winding down — or the test fails by name."""
    import concurrent.futures.thread as cft
    before = set(threading.enumerate())
    yield

    def leaked():
        return [t for t in threading.enumerate()
                if t.is_alive() and not t.daemon
                and t is not threading.current_thread()
                and t not in before
                and t not in cft._threads_queues]

    offenders = leaked()
    for t in offenders:
        t.join(timeout=2.0)
    offenders = leaked()
    assert not offenders, \
        f"test leaked non-daemon threads: {[t.name for t in offenders]}"


@pytest.fixture(scope="module", autouse=True)
def _sanitize_e2e_suites(request):
    """ISSUE 8: the chaos harness and the cluster E2E suite run with
    the runtime concurrency sanitizer ARMED, so every 32-way scenario
    doubles as a race hunt. At module teardown any lock-order cycle
    observed anywhere in the run fails the module (hold findings are
    informational — chaos deliberately injects multi-second stalls).
    Arm/disarm is scoped here so the rest of tier-1 (perf gates above
    all) runs on stock threading.Lock."""
    import os
    mod = request.module.__name__.rsplit(".", 1)[-1]
    if mod not in ("test_chaos", "test_cluster") or \
            os.environ.get("SEAWEED_SANITIZE_E2E") == "0":
        yield
        return
    from seaweedfs_tpu.util import sanitizer
    sanitizer.reset()
    sanitizer.arm()
    try:
        yield
        cycles = sanitizer.cycles()
        assert not cycles, (
            f"{mod}: sanitizer observed lock-order cycles "
            "(potential deadlocks):\n" +
            "\n\n".join(
                " -> ".join(c["locks"]) + "\n" +
                "\n".join(e["edge"] + "\n" + e["stack"]
                          for e in c["stacks"])
                for c in cycles))
    finally:
        sanitizer.disarm()
        sanitizer.reset()


@pytest.fixture(scope="session", autouse=True)
def _close_grpc_channels_at_exit():
    """The gRPC channel cache is process-global; closing it per-cluster
    would kill channels that other live clusters still use."""
    yield
    from seaweedfs_tpu import rpc
    rpc.close_channels()
