"""Run one cell of the benchmark once.

    python3 -m ecbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (``ecbench/configs/<config>.json``) and a
traffic mix (``ecbench/traffic/<traffic>.json``, whose ``driver`` names a
module of ``ecbench/drivers/``); both are found by name from
``BENCHMARK.json``. The driver sets the cell up, measures for
``--seconds`` and checks what the timed path produced against
``ecbench/reference/``. With ``--trace 0`` the result line carries the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, each
read by ``ecbench/layers/<metric>.py`` from the traced run.

Earlier lines of standard output are notes (bytes written, the data
directory's filesystem, ...); the last line is the result. The last lines
of standard error are each compared number beside its limit. The run
refuses, with no result, without a CUDA card, and when ``jax``, ``flax``
or the JAX package has been loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

from ecbench import common


class Run:
    """What a driver gets: the cell's parameters and the run's clocks."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, workdir: str, cuda: bool):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.workdir, self.cuda = workdir, cuda
        self.backend = "cuda" if cuda else "cpu"
        self.window_epoch = None
        self.closed_epoch = None
        self._launch_log = None
        self.stages = {}
        self._start = common.process_start_epoch()

    def stage(self, name: str) -> None:
        """Set-up's clock: seconds from process start to the end of a
        stage, printed as a note."""
        self.stages[name] = round(time.time() - self._start, 3)

    def window_started(self) -> None:
        self.window_epoch = time.time()

    def window_closed(self) -> None:
        self.closed_epoch = time.time()

    def start_trace(self, program_trace):
        """In-process trace of the window: the program's spans and, on a
        card, the profiler with K1's launch shapes. None untraced."""
        if not self.trace:
            return None
        program_trace.clear()
        program_trace.enable()
        if not self.cuda:
            return "spans"
        from ecbench import profiling
        self._launch_log = profiling.LaunchLog()
        probe = profiling.Probe(os.path.join(self.workdir, "trace.json"),
                                self._launch_log)
        probe.start()
        return probe

    def stop_trace(self, probe, spans) -> dict:
        if probe is None or probe == "spans":
            return {}
        from ecbench import profiling
        probe.stop()
        self._launch_log.close()
        events = profiling.device_events(probe.path)
        return profiling.summarize(events, self.window_epoch,
                                   self.closed_epoch,
                                   self._launch_log.launches, spans)


def load_reader(name: str):
    path = os.path.join(common.HERE, "layers", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"ecbench_layer_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             need_card: bool = True, config_overrides=None,
             traffic_overrides=None) -> dict:
    """One run; returns the result object (the last line). Without
    ``need_card`` (tests only) it runs the program's CPU path, names the
    platform ``cpu`` and takes smaller sizes through the overrides."""
    bench = common.load_benchmark()
    cell = common.find_cell(bench, workload, listed_only=need_card)
    import torch
    cuda = torch.cuda.is_available()
    if need_card and (not cuda or torch.cuda.device_count() < cell["chips"]):
        raise SystemExit(f"{workload} needs {cell['chips']} CUDA card(s); "
                         f"torch.cuda.is_available() is {cuda}")
    cuda = cuda and need_card
    config = common.load_json("configs", f"{cell['config']}.json")
    traffic = common.load_json("traffic", f"{cell['traffic']}.json")
    config.update(config_overrides or {})
    traffic.update(traffic_overrides or {})
    driver = importlib.import_module(f"ecbench.drivers.{traffic['driver']}")
    os.environ.update(common.cache_env())
    workdir = tempfile.mkdtemp(prefix="ecbench-")
    try:
        r = Run(cell, config, traffic, seed, seconds, trace, workdir, cuda)
        common.note("data_dir_fs", common.fs_type(workdir))
        out = driver.run(r)
        setup_s = r.window_epoch - r._start
        common.note("setup_stages", r.stages)
        common.note("bytes_written", common.bytes_written())
        for key, value in out.get("notes", {}).items():
            common.note(key, value)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    checks = out["checks"]
    metrics = {}
    if not trace:
        values = dict(out["e2e"], setup_s=setup_s)
        for m in cell_metrics(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        layer = dict(out["layer"], workload=workload,
                     device_kind=out.get("device_kind", ""))
        for m in cell_metrics(bench, workload, "per_layer"):
            value = load_reader(m["name"]).read(layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": out.get("device_kind", ""),
              "count": cell["chips"] if cuda else 0,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": all(ok for *_, ok in checks),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    dev = out["layer"].get("device") or {}
    if trace and dev:
        device["busy_s"] = dev["busy_s"]
        device["window_s"] = dev["window_s"]
        result["breakdown"] = {"device_ops": dev["device_ops"],
                               "idle_gaps": dev["idle_gaps"]}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit, _ in checks}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ecbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    banned = common.banned_modules()
    if banned:
        common.log(f"refused: the run loaded {', '.join(banned)}")
        return 3
    for name, c in result["checks"].items():
        common.log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
