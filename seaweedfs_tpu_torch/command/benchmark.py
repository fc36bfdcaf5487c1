"""Built-in load generator (reference weed/command/benchmark.go:109-560).

The port of ``seaweedfs_tpu.command.benchmark``. Writes then randomly
reads N fixed-seed payload files against a running cluster through the
public data path (master assign + volume-server HTTP; with
``-assign.leaseCount`` the writes take leased file ids, and the reads
resolve through a MasterClient), with a worker pool of -c threads, and
prints the reference's report: req/s, MB/s, latency percentiles.
"""

from __future__ import annotations

import argparse
import random
import threading
import time
from typing import List, Optional

from seaweedfs_tpu_torch.command import command, setup_client_tls
from seaweedfs_tpu_torch.operation import operations


class Stats:
    """Latency collector; percentile math mirrors the reference's
    report (benchmark.go printLatencies)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.latencies_ms: List[float] = []
        self.completed = 0
        self.failed = 0
        self.transferred = 0

    def add(self, latency_s: float, nbytes: int) -> None:
        with self.lock:
            self.latencies_ms.append(latency_s * 1e3)
            self.completed += 1
            self.transferred += nbytes

    def fail(self) -> None:
        with self.lock:
            self.failed += 1

    def percentile(self, sorted_ms: List[float], p: float) -> float:
        if not sorted_ms:
            return 0.0
        i = min(len(sorted_ms) - 1, int(p / 100.0 * len(sorted_ms)))
        return sorted_ms[i]

    def report(self, title: str, elapsed_s: float, out) -> None:
        ms = sorted(self.latencies_ms)
        n = self.completed
        print(f"\n{title}", file=out)
        print(f"concurrency level:      taken {elapsed_s:.2f} s", file=out)
        print(f"completed requests:     {n}", file=out)
        print(f"failed requests:        {self.failed}", file=out)
        print(f"transferred bytes:      {self.transferred}", file=out)
        rps = n / elapsed_s if elapsed_s > 0 else 0.0
        mbps = self.transferred / 1e6 / elapsed_s if elapsed_s > 0 else 0.0
        print(f"requests per second:    {rps:.1f} req/s", file=out)
        print(f"transfer rate:          {mbps:.2f} MB/s", file=out)
        if ms:
            print("\npercentage of the requests served within (ms):",
                  file=out)
            for p in (50, 66, 75, 80, 90, 95, 98, 99, 99.9):
                print(f"  {p:>5}%  {self.percentile(ms, p):8.1f}",
                      file=out)
            print(f"  100.0%  {ms[-1]:8.1f}  (longest)", file=out)


def _payload(size: int, seed: int) -> bytes:
    """Fixed-seed payload like the reference's FakeReader."""
    rng = random.Random(seed)
    return bytes(rng.getrandbits(8) for _ in range(min(size, 1024))) \
        * (size // min(size, 1024) + 1)


def run_benchmark_programmatic(master: str, n: int = 1024,
                               concurrency: int = 16, size: int = 1024,
                               collection: str = "benchmark",
                               replication: str = "000",
                               do_read: bool = True,
                               lease_count: int = 0,
                               out=None) -> dict:
    """Run the benchmark and return {write: Stats, read: Stats,
    write_seconds, read_seconds}. lease_count > 1 amortizes master
    assigns through a fid LeaseCache shared by all writers
    (-assign.leaseCount, reference benchmark.go's count=N batches)."""
    import sys
    out = out or sys.stdout
    leases = None
    if lease_count > 1:
        from seaweedfs_tpu_torch.operation.assign_lease import LeaseCache
        leases = LeaseCache(count=lease_count)
    fids: List[str] = []
    fid_lock = threading.Lock()
    wstats = Stats()
    payload = _payload(size, seed=1)

    counter = iter(range(n))
    counter_lock = threading.Lock()

    def next_index() -> Optional[int]:
        with counter_lock:
            return next(counter, None)

    def writer():
        while True:
            i = next_index()
            if i is None:
                return
            t0 = time.monotonic()
            try:
                fid = operations.upload(
                    master, payload[:size], filename=f"bench{i}",
                    collection=collection, replication=replication,
                    leases=leases)
                wstats.add(time.monotonic() - t0, size)
                with fid_lock:
                    fids.append(fid)
            except Exception:
                wstats.fail()

    t0 = time.monotonic()
    # lint: thread-ok(benchmark load thread is its own request; stats.fail accounts errors)
    threads = [threading.Thread(target=writer, daemon=True)
               for _ in range(concurrency)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    write_s = time.monotonic() - t0
    wstats.report(f"benchmark: write {n} x {size}B files, "
                  f"c={concurrency}", write_s, out)

    rstats = Stats()
    read_s = 0.0
    if do_read and fids:
        rcounter = iter(range(n))

        def next_read() -> Optional[int]:
            with counter_lock:
                return next(rcounter, None)

        # Reads resolve fids through the KeepConnected vid cache like the
        # reference's readFiles (benchmark.go: masterClient.LookupFileId),
        # not a lookup RPC per read.
        from seaweedfs_tpu_torch.wdclient.masterclient import MasterClient
        mc = MasterClient([master]).start()
        mc.wait_until_connected()

        def reader():
            rng = random.Random(threading.get_ident())
            while True:
                i = next_read()
                if i is None:
                    return
                fid = fids[rng.randrange(len(fids))]
                t0 = time.monotonic()
                try:
                    data = operations.download_url(mc.lookup_file_id(fid))
                    rstats.add(time.monotonic() - t0, len(data))
                except Exception:
                    rstats.fail()

        t0 = time.monotonic()
        # lint: thread-ok(benchmark load thread is its own request; stats.fail accounts errors)
        threads = [threading.Thread(target=reader, daemon=True)
                   for _ in range(concurrency)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        read_s = time.monotonic() - t0
        mc.stop()
        rstats.report(f"benchmark: random read {n} files, "
                      f"c={concurrency}", read_s, out)

    return {"write": wstats, "read": rstats,
            "write_seconds": write_s, "read_seconds": read_s}


@command("benchmark", "write/read load generator with latency stats")
def run_bench(args) -> int:
    setup_client_tls()
    p = argparse.ArgumentParser(prog="benchmark")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-c", dest="concurrency", type=int, default=16)
    p.add_argument("-n", type=int, default=1024 * 1024)
    p.add_argument("-size", type=int, default=1024)
    p.add_argument("-collection", default="benchmark")
    p.add_argument("-replication", default="000")
    p.add_argument("-noread", dest="no_read", action="store_true")
    p.add_argument("-assign.leaseCount", dest="lease_count", type=int,
                   default=0,
                   help="lease N fids per master assign (0 = one "
                        "assign round trip per write)")
    opts = p.parse_args(args)
    run_benchmark_programmatic(
        opts.master, n=opts.n, concurrency=opts.concurrency,
        size=opts.size, collection=opts.collection,
        replication=opts.replication, do_read=not opts.no_read,
        lease_count=opts.lease_count)
    return 0
