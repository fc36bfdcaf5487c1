"""Scrub passes over a warm EC fleet held by one volume server's Store.

Set-up writes the configuration's volumes, encodes them all in one
fused ``store_ec.generate_ec_shards_batch`` on the card, retires each
``.dat`` and opens the shards as EC volumes, as ``ec.encode`` leaves them
on a one-server deployment. Before every pass the driver flips bytes
drawn from the seed: one in the data of a live needle (on the lowest data
shard the needle touches, so the sweep names it on its first try) and
one in a parity shard, in different volumes. ``ScrubDaemon.run_pass``
must find and repair each; a warm-up pass does the same before the
window. The window runs passes back to back until one ends past
``--seconds``.

``correct`` compares, after the window, what each pass reported against
``reference/``: per volume, the fused verify's mismatch count and first
offset per parity shard, worked out again from the shards the reference
encodes itself with the flips applied; the pass's counts of corruptions
found, repaired and unrecoverable; and at the end every shard byte
against the reference's encode.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from ecbench import data
from ecbench.common import delta, log, parse_prometheus
from ecbench.reference import gf256, layout


class VerifyRecorder:
    """Keeps what each fleet verify of a pass returned, by volume."""

    def __init__(self, fleet_module):
        self.module = fleet_module
        self.orig = fleet_module.fleet_verify_ec_files
        self.calls: List[Dict[str, object]] = []

        def recorded(base_names, *a, **kw):
            out = self.orig(base_names, *a, **kw)
            self.calls.append(dict(out))
            return out
        fleet_module.fleet_verify_ec_files = recorded

    def close(self) -> None:
        self.module.fleet_verify_ec_files = self.orig


def plan_flips(gen, vols, shard_sizes, mix) -> List[tuple]:
    """(vid, shard, shard offset, xor mask) of one pass's flips."""
    picks = gen.choice(len(vols), mix["data_flips"] + mix["parity_flips"],
                       replace=False)
    flips = []
    for k, vi in enumerate(picks):
        v = vols[int(vi)]
        mask = int(gen.integers(1, 256))
        if k < mix["data_flips"]:
            i = int(gen.integers(0, len(v.ids)))
            start = int(v.offsets[i]) + 20
            pieces = layout.locate(v.dat_size, start, int(v.lengths[i]))
            low = min(s for s, _, _ in pieces)
            mine = [(off, n) for s, off, n in pieces if s == low]
            j = int(gen.integers(0, sum(n for _, n in mine)))
            for off, n in mine:
                if j < n:
                    flips.append((v.vid, low, off + j, mask))
                    break
                j -= n
        else:
            shard = int(gen.integers(gf256.DATA_SHARDS, gf256.TOTAL_SHARDS))
            off = int(gen.integers(0, shard_sizes[v.vid]))
            flips.append((v.vid, shard, off, mask))
    return flips


def apply_flips(vdir: str, flips) -> None:
    for vid, shard, off, mask in flips:
        with open(os.path.join(vdir, f"{vid}.ec{shard:02d}"), "r+b") as f:
            f.seek(off)
            b = f.read(1)[0]
            f.seek(off)
            f.write(bytes([b ^ mask]))


def reference_verdict(clean: torch.Tensor, flips) -> dict:
    """What an exact verify reports for one volume: its shards as the
    reference encodes them, with ``flips`` applied; the parity is worked
    out again from the (flipped) data and compared byte for byte."""
    shards = clean.clone()
    for _, shard, off, mask in flips:
        shards[shard, off] ^= mask
    parity = gf256.encode_parity(shards[:gf256.DATA_SHARDS])
    counts, firsts = {}, {}
    for p in range(gf256.PARITY_SHARDS):
        diff = torch.nonzero(parity[p] != shards[gf256.DATA_SHARDS + p])
        if len(diff):
            counts[gf256.DATA_SHARDS + p] = len(diff)
            firsts[gf256.DATA_SHARDS + p] = int(diff[0])
    return {"parity_mismatch": counts, "first_mismatch": firsts}


def run(r) -> dict:
    cfg, mix = r.config, r.traffic
    vols = data.warm_fleet(r.seed, cfg)
    vdir = os.path.join(r.workdir, "volumes")
    os.makedirs(vdir)
    for v in vols:
        v.write(vdir)
    r.stage("volumes written")
    from seaweedfs_tpu_torch.ec import fleet, store_ec
    from seaweedfs_tpu_torch.scrub import ScrubDaemon
    from seaweedfs_tpu_torch.stats import trace
    from seaweedfs_tpu_torch.stats.metrics import REGISTRY
    from seaweedfs_tpu_torch.storage.store import Store
    vids = [v.vid for v in vols]
    store = Store([vdir], [len(vols) + 1])
    store_ec.generate_ec_shards_batch(store, vids, backend=r.backend)
    for vid in vids:
        store.delete_volume(vid)
    store.close()
    r.stage("encoded")
    store = Store([vdir], [len(vols) + 1])
    sizes = {v.vid: layout.shard_size(v.dat_size, cfg["large_block"],
                                      cfg["small_block"]) for v in vols}
    data_bytes = sum(gf256.DATA_SHARDS * s for s in sizes.values())
    daemon = ScrubDaemon(store, backend=r.backend, export_lag=False)
    recorder = VerifyRecorder(fleet)
    gen = data.rng(r.seed, "flips")
    passes = []   # (flips, PassResult, verify call index, seconds)

    def one_pass():
        flips = plan_flips(gen, vols, sizes, mix)
        apply_flips(vdir, flips)
        call = len(recorder.calls)
        t = time.perf_counter()
        res = daemon.run_pass()
        passes.append((flips, res, call, time.perf_counter() - t))

    try:
        for _ in range(mix["warmup_passes"]):
            one_pass()
        r.stage("warm-up passes")
        if r.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        probe = r.start_trace(trace)
        prom0 = parse_prometheus(REGISTRY.render())
        first = len(passes)
        t0 = time.perf_counter()
        r.window_started()
        while True:
            one_pass()
            if time.perf_counter() - t0 >= r.seconds:
                break
        window = time.perf_counter() - t0
        r.window_closed()
        prom1 = parse_prometheus(REGISTRY.render())
        device = r.stop_trace(probe, spans=[
            (s.name, s.t0 + trace.EPOCH_OFFSET,
             s.t0 + s.dur + trace.EPOCH_OFFSET) for s in trace.spans()])
        memory = torch.cuda.max_memory_allocated() if r.cuda else 0
        window_spans = [s for s in trace.spans()
                        if s.t0 >= t0 - 1e-3] if r.trace else []
    finally:
        recorder.close()
        store.close()
    timed = passes[first:]
    log(f"scrub: {len(timed)} timed passes, {window:.3f} s, "
        f"{data_bytes * len(timed) / window / 1e9:.4f} GB/s")

    # the reference, once the window has closed and the store is shut
    dev = torch.device("cuda") if r.cuda else torch.device("cpu")
    clean = {}
    for v in vols:
        dshards = layout.data_shards(v.dat(), cfg["large_block"],
                                     cfg["small_block"])
        d = torch.from_numpy(dshards).to(dev)
        clean[v.vid] = torch.cat([d, gf256.encode_parity(d)])
    wrong_verdicts, wrong_counts = 0, 0
    for k, (flips, res, call, _) in enumerate(passes):
        got_by_vid = {}
        verify = recorder.calls[call] if call < len(recorder.calls) else {}
        for base, vr in verify.items():
            got_by_vid[int(os.path.basename(base))] = {
                "parity_mismatch": dict(vr.parity_mismatch),
                "first_mismatch": dict(vr.first_mismatch)}
        for vid in vids:
            want = reference_verdict(
                clean[vid], [f for f in flips if f[0] == vid])
            if got_by_vid.get(vid) != want:
                wrong_verdicts += 1
                if wrong_verdicts <= 3:
                    log(f"pass {k} volume {vid}: verify said "
                        f"{got_by_vid.get(vid)}, the reference {want}")
        n = len(flips)
        got = (res.corruptions_found, res.corruptions_repaired,
               res.unrecoverable, res.ec_volumes)
        if got != (n, n, 0, len(vids)):
            wrong_counts += 1
            log(f"pass {k}: found, repaired, unrecoverable, EC volumes "
                f"{got}, want {(n, n, 0, len(vids))}")
    wrong_bytes = 0
    for vid in vids:
        for shard in range(gf256.TOTAL_SHARDS):
            path = os.path.join(vdir, f"{vid}.ec{shard:02d}")
            disk = np.fromfile(path, dtype=np.uint8) \
                if os.path.exists(path) else np.zeros(0, dtype=np.uint8)
            want = clean[vid][shard]
            if len(disk) != len(want):
                wrong_bytes += len(want)
                continue
            wrong_bytes += int((torch.from_numpy(disk).to(dev) != want)
                               .sum())
    scanned = data_bytes * len(timed)
    layer = {"prom_delta": delta(prom0, prom1),
             "bytes_scrubbed": scanned,
             "spans": [(s.name, s.dur) for s in window_spans],
             "device": device}
    return {
        "e2e": {"scrub_gbps": scanned / window / 1e9},
        "attempted": len(passes),
        "failed": sum(1 for f, res, *_ in passes
                      if res.corruptions_repaired != len(f)),
        "checks": [
            ("passes_timed", len(timed), ">=1", len(timed) >= 1),
            ("verdicts_wrong", wrong_verdicts, 0, wrong_verdicts == 0),
            ("pass_counts_wrong", wrong_counts, 0, wrong_counts == 0),
            ("shard_bytes_wrong", wrong_bytes, 0, wrong_bytes == 0),
        ],
        "layer": layer,
        "memory_peak_bytes": memory,
        "device_kind": torch.cuda.get_device_name(0) if r.cuda else "cpu",
        "notes": {"pass_seconds": [round(p[3], 3) for p in passes]},
    }
