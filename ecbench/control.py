"""The controls: the reference put in the program's place, with one of the
configuration's guarantees broken, judged by the cells' own comparisons.
A control must come out as not correct; its reading is the upper end of
each limit (``PERF.md``, "How correct is decided"). The benchmark's runs
never run it.

- ``warm_fleet.scrub``: a sampled verify that compares one byte in
  ``SAMPLE`` of each parity shard (a cheaper scrub that would tempt a
  later change) in place of the exact one; the guarantee it breaks is
  "every corrupted byte is found". Reading: ``verdicts_wrong`` over the
  passes a run makes, with the run's flips.
- ``bench1k_ec.*``: a decoder that survives three lost shards, not four
  (it zero-fills the tenth row it reads), answers the mix's GETs from the
  reference's own shards of the seed's volumes, four shards lost a volume;
  the guarantee it breaks is "any 4 of 14 lost". Reading: ``bodies_wrong``
  over as many GETs as a run checks.

    python -m ecbench.control --workload <cell> --seeds a,b,c
        [--passes P | --gets G]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ecbench import common, data
from ecbench.drivers import scrub
from ecbench.reference import gf256, layout, needle

SAMPLE = 4096


def sampled_verdict(clean: torch.Tensor, flips) -> dict:
    """The control's verify: only every SAMPLE-th byte is compared."""
    shards = clean.clone()
    for _, shard, off, mask in flips:
        shards[shard, off] ^= mask
    idx = torch.arange(0, shards.shape[1], SAMPLE, device=shards.device)
    parity = gf256.encode_parity(shards[:gf256.DATA_SHARDS][:, idx])
    counts, firsts = {}, {}
    for p in range(gf256.PARITY_SHARDS):
        diff = torch.nonzero(parity[p] != shards[gf256.DATA_SHARDS + p][idx])
        if len(diff):
            counts[gf256.DATA_SHARDS + p] = len(diff)
            firsts[gf256.DATA_SHARDS + p] = int(idx[diff[0]])
    return {"parity_mismatch": counts, "first_mismatch": firsts}


def _shards(v, cfg, dev) -> torch.Tensor:
    d = torch.from_numpy(layout.data_shards(
        v.dat(), cfg["large_block"], cfg["small_block"])).to(dev)
    return torch.cat([d, gf256.encode_parity(d)])


def scrub_control(seed: int, cfg: dict, mix: dict, passes: int,
                  dev) -> int:
    vols = data.warm_fleet(seed, cfg)
    sizes = {v.vid: layout.shard_size(v.dat_size, cfg["large_block"],
                                      cfg["small_block"]) for v in vols}
    clean = {v.vid: _shards(v, cfg, dev) for v in vols}
    gen = data.rng(seed, "flips")
    wrong = 0
    for _ in range(passes + mix["warmup_passes"]):
        flips = scrub.plan_flips(gen, vols, sizes, mix)
        for v in vols:
            mine = [f for f in flips if f[0] == v.vid]
            if sampled_verdict(clean[v.vid], mine) != \
                    scrub.reference_verdict(clean[v.vid], mine):
                wrong += 1
    return wrong


def get_control(seed: int, cfg: dict, mix: dict, gets: int, dev) -> int:
    vols = data.bench1k(seed, cfg)
    gen = np.random.default_rng(seed)
    rec = needle.record_size(cfg["size"])
    wrong = 0
    per_vol = gets // len(vols) + 1
    for v in vols:
        shards = _shards(v, cfg, dev)
        lost = sorted(gen.choice(gf256.DATA_SHARDS, 3, replace=False)) + \
            [int(gen.integers(gf256.DATA_SHARDS, gf256.TOTAL_SHARDS))]
        present = [i for i in range(gf256.TOTAL_SHARDS) if i not in lost]
        rows = present[:gf256.DATA_SHARDS]
        survivors = shards[rows].clone()
        survivors[-1] = 0          # the control's broken guarantee
        rebuilt = shards.clone()
        want = [i for i in lost if i < gf256.DATA_SHARDS]
        rebuilt[want] = gf256.apply(gf256.decode_matrix(rows, want),
                                    survivors)
        small = cfg["small_block"]
        offs = v.offsets.astype(np.int64)
        on_lost = np.isin((offs // small) % gf256.DATA_SHARDS, want) | \
            np.isin(((offs + rec - 1) // small) % gf256.DATA_SHARDS, want)
        pool = np.nonzero(on_lost)[0] if mix["needles"] == "degraded" \
            else np.arange(len(offs))
        for i in gen.choice(pool, per_vol):
            start, end = needle.data_range(int(offs[i]), int(v.lengths[i]))
            body = bytearray()
            for shard, off, n in layout.locate(v.dat_size, start,
                                               end - start,
                                               cfg["large_block"], small):
                body += rebuilt[shard, off:off + n].cpu().numpy().tobytes()
            if bytes(body) != v.data(int(i)).tobytes():
                wrong += 1
    return wrong


def reading(workload: str, seed: int, passes: int, gets: int,
            config_overrides=None) -> int:
    cell = common.find_cell(common.load_benchmark(), workload,
                            listed_only=False)
    cfg = common.load_json("configs", f"{cell['config']}.json")
    cfg.update(config_overrides or {})
    mix = common.load_json("traffic", f"{cell['traffic']}.json")
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if mix["driver"] == "scrub":
        return scrub_control(seed, cfg, mix, passes, dev)
    return get_control(seed, cfg, mix, gets, dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ecbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--passes", type=int, default=5)
    p.add_argument("--gets", type=int, default=3000)
    a = p.parse_args(argv)
    for seed in [int(s) for s in a.seeds.split(",")]:
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "reading": reading(a.workload, seed, a.passes,
                                             a.gets)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
