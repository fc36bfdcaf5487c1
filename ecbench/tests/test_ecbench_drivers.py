"""Each cell at a tiny size on the program's CPU path: the control flow
and the shape of the result line, and ``correct`` coming out false under
each fault a cell can have. No number here is a device number."""

import json
import os
import subprocess
import sys

import pytest
import torch

from ecbench import control, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCRUB = dict(volumes=3, volume_bytes=1 << 20, chunk_bytes=256 << 10,
             file_bytes_min=16 << 10, file_bytes_max=1 << 20)
GET = dict(n=70000)
GET_MIX = dict(warmup_seconds=0.5, min_gets=10)


def shape(res, trace):
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    return res


def test_scrub_cell_runs_and_is_correct():
    res = shape(run.run_cell("warm_fleet.scrub", 2 ** 31 + 11, 0.5, False,
                             need_card=False, config_overrides=SCRUB), False)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"scrub_gbps", "setup_s"}


def test_scrub_cell_traced_reads_its_spans():
    res = shape(run.run_cell("warm_fleet.scrub", 5, 0.5, True,
                             need_card=False, config_overrides=SCRUB), True)
    assert res["correct"]
    # spans and counters exist on the CPU path; the device metrics do not
    assert {"scrub_sweep_s_per_gib", "fleet_verify_s_per_gib",
            "fleet_read_s_per_gib"} <= set(res["metrics"])
    assert "k1_roofline.scrub" not in res["metrics"]


def _broken_repair(monkeypatch):
    from seaweedfs_tpu_torch.scrub import planner
    monkeypatch.setattr(planner, "repair_ec_volume", lambda *a, **k: None)


def _altered_verdict(monkeypatch):
    from seaweedfs_tpu_torch.ec import fleet
    orig = fleet.fleet_verify_ec_files

    def altered(base_names, *a, **k):
        out = orig(base_names, *a, **k)
        vr = out[sorted(out)[0]]
        vr.parity_mismatch[13] = vr.parity_mismatch.get(13, 0) + 1
        vr.first_mismatch.setdefault(13, 0)
        return out
    monkeypatch.setattr(fleet, "fleet_verify_ec_files", altered)


def _half_the_batch(monkeypatch):
    from seaweedfs_tpu_torch.ec import fleet
    orig = fleet.fleet_verify_ec_files
    monkeypatch.setattr(fleet, "fleet_verify_ec_files",
                        lambda names, *a, **k: orig(
                            list(names)[::2], *a, **k))


@pytest.mark.parametrize("fault", [_broken_repair, _altered_verdict,
                                   _half_the_batch],
                         ids=["state_unchanged", "answer_altered",
                              "half_the_batch"])
def test_scrub_faults_are_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run.run_cell("warm_fleet.scrub", 7, 0.5, False, need_card=False,
                       config_overrides=SCRUB,
                       traffic_overrides=dict(warmup_passes=2))
    assert not res["correct"], res["checks"]


def test_get_cell_runs_and_is_correct():
    res = shape(run.run_cell("bench1k_ec.get_uniform", 2 ** 31 + 3, 1.0,
                             False, need_card=False, config_overrides=GET,
                             traffic_overrides=GET_MIX), False)
    assert res["correct"], res["checks"]
    # the GET cells are not in BENCHMARK.json yet (PERF.md, Open
    # questions): only the metric every cell reports is printed
    assert set(res["metrics"]) == {"setup_s"}
    assert res["checks"]["gets_checked"]["value"] > 0


@pytest.mark.parametrize("spec", ["corrupt", "short"],
                         ids=["answer_altered", "half_the_answer"])
def test_get_faults_are_not_correct(monkeypatch, spec):
    monkeypatch.setenv("SEAWEED_FAILPOINTS", f"volume.read={spec}")
    res = run.run_cell("bench1k_ec.get_degraded", 9, 1.0, False,
                       need_card=False, config_overrides=GET,
                       traffic_overrides=GET_MIX)
    assert not res["correct"], res["checks"]
    assert res["checks"]["bodies_wrong"]["value"] > 0


@pytest.mark.parametrize("workload,kw", [
    ("warm_fleet.scrub", dict(passes=2, gets=0, config_overrides=SCRUB)),
    ("bench1k_ec.get_degraded", dict(passes=0, gets=200,
                                     config_overrides=dict(n=140000))),
    ("bench1k_ec.get_uniform", dict(passes=0, gets=200,
                                    config_overrides=dict(n=140000)))])
def test_control_is_not_correct(workload, kw):
    assert control.reading(workload, 3, **kw) > 0


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown here")
    p = subprocess.run(
        [sys.executable, "-m", "ecbench.run", "--workload",
         "warm_fleet.scrub", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not any(line.startswith("{\"correct\"")
                   for line in p.stdout.splitlines())


@pytest.mark.cuda
def test_scrub_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "-m", "ecbench.run", "--workload",
         "warm_fleet.scrub", "--seed", "2147483659", "--seconds", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.splitlines()[-1])["correct"]
