"""House-rules invariant analyzer — `go vet` for the port.

The counterpart of ``seaweedfs_tpu.analysis``. It walks every module
under `seaweedfs_tpu_torch/` and enforces the house rules on
concurrency and hygiene as named, allowlistable AST checks (engine.py /
invariants.py / deadcode.py / guards.py; the catalog is
ARCHITECTURE.md "Static analysis & sanitizers"), paired with the
runtime halves in `util/sanitizer.py` (lock-order cycles + hold-time
watchdog, armed by SEAWEED_SANITIZE=1) and `util/scheduler.py`
(deterministic schedule exploration with exact seeded replay of
failing interleavings).

The checks are the JAX package's, byte for byte apart from the package
name; the findings they surfaced and the fixes made rather than
allowlisted are listed in that package's docstring
(``seaweedfs_tpu/analysis/__init__.py``), and the port carries each
fix. Runs as tier-1 tests (tests/test_torch_static_analysis.py).

Usage:
    python -m seaweedfs_tpu_torch.analysis          # human report, exit 1 on findings
    from seaweedfs_tpu_torch.analysis import run    # [Finding, ...]
"""

from __future__ import annotations

from seaweedfs_tpu_torch.analysis.engine import (Finding, check_names,
                                                 run_checks)

__all__ = ["Finding", "run", "check_names"]


def run(checks=None):
    """Run the analyzer over the package; returns list[Finding]."""
    return run_checks(checks=checks)


def main() -> int:
    findings = run()
    for f in findings:
        print(f)
    print(f"{len(findings)} finding(s) across "
          f"{len(check_names())} checks")
    return 1 if findings else 0
