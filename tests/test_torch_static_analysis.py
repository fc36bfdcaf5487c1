"""The port's house-rules analyzer (``seaweedfs_tpu_torch/analysis/``)
against the JAX package's.

The port's engine finds nothing in the port, through ``run()`` and through
``python -m seaweedfs_tpu_torch.analysis``, and it registers the same
seven checks as the JAX engine. Every planted source of the JAX
analyzer's own tests (``tests/test_static_analysis.py`` and
``tests/test_guard_check.py``, read from those files) is written to a
fresh directory and analysed by both engines with the same ``root=`` and
``checks=``: the findings (check, path, line, message) are equal, and
non-empty wherever the JAX test expects a finding.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from seaweedfs_tpu.analysis import check_names as jax_check_names
from seaweedfs_tpu.analysis import engine as jax_engine
from seaweedfs_tpu_torch.analysis import check_names, engine, run

REPO = Path(__file__).resolve().parent.parent


def test_port_tree_has_zero_findings():
    findings = run()
    assert not findings, (
        "house-rules analyzer found violations:\n" +
        "\n".join(str(f) for f in findings))


def test_module_entry_point_reports_zero_findings():
    proc = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.analysis"], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == \
        "0 finding(s) across 7 checks"


def test_check_names_equal_jax():
    assert check_names() == jax_check_names()
    assert set(check_names()) == {"block", "dead", "gate", "guard",
                                  "metric", "swallow", "thread"}


def _planted_sources():
    """(id, file name, source, checks, expects findings) for every
    ``_analyze(...)`` call in the JAX analyzer's tests. A test that
    asserts ``not fs`` expects none."""
    cases = []
    for test_file, default_checks in (("test_static_analysis.py", None),
                                      ("test_guard_check.py", ["guard"])):
        tree = ast.parse((REPO / "tests" / test_file).read_text())
        for fn in tree.body:
            if not (isinstance(fn, ast.FunctionDef) and
                    fn.name.startswith("test_")):
                continue
            calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                     and getattr(c.func, "id", "") == "_analyze"]
            expects_none = any(
                isinstance(a, ast.Assert) and
                ast.unparse(a.test) == "not fs" for a in ast.walk(fn))
            for call in calls:
                args = [ast.literal_eval(a) for a in call.args[1:]]
                name, source = args if len(args) == 2 else ("m.py", args[0])
                checks = default_checks
                for kw in call.keywords:
                    if kw.arg == "checks":
                        value = ast.literal_eval(kw.value)
                        checks = list(value) if value else None
                cases.append(pytest.param(name, source, checks,
                                          not expects_none, id=fn.name))
    return cases


@pytest.mark.parametrize("name,source,checks,expects", _planted_sources())
def test_planted_source_finds_as_jax(tmp_path, name, source, checks,
                                     expects):
    (tmp_path / name).write_text(textwrap.dedent(source))

    def key(findings):
        return [(f.check, f.path, f.line, f.message) for f in findings]

    want = key(jax_engine.run_checks(root=tmp_path, checks=checks))
    got = key(engine.run_checks(root=tmp_path, checks=checks))
    assert got == want
    assert bool(got) == expects, got
