"""The port is whole: every module and every metric family of the JAX
package has its counterpart.

The ``.py``, ``.cpp`` and ``.cu`` files of the two packages are the same
list but for the JAX files ROADMAP lists under "Not to port" and the
port's own additions (its kernels and their builders, the host CRC, and
the protobuf runtime it carries in place of ``protobuf``). The two
``stats.metrics.REGISTRY`` hold the same families, each with the same
name, help, label names and kind.
"""

from __future__ import annotations

from pathlib import Path

import seaweedfs_tpu
import seaweedfs_tpu_torch

# JAX files with no port copy (ROADMAP, "Not to port"): the Pallas and
# XLA kernels K1 serves, the JAX host codec backends, the virtual CPU
# mesh helper
NOT_TO_PORT = {"ops/rs_pallas.py", "ops/rs_kernel.py",
               "native/rs_native.py", "native/rs_cpu.cpp",
               "util/cpu_mesh.py"}
# the port's own: the CUDA kernels and their wrappers, the kernel
# builder, the host CRC, and protobuf's wire and JSON formats
PORT_ONLY = {"csrc/gf_linear.cu", "csrc/gf_compare.cu",
             "native/builder.py", "native/crc.py", "native/crc32c.cpp",
             "ops/gf_kernel.py", "ops/gf_compare.py",
             "pb/wire.py", "pb/json_format.py"}


def _files(pkg) -> set:
    root = Path(pkg.__file__).parent
    return {p.relative_to(root).as_posix()
            for ext in ("*.py", "*.cpp", "*.cu") for p in root.rglob(ext)
            if "__pycache__" not in p.parts and "_build" not in p.parts}


def test_file_lists_match_but_for_the_named_exceptions():
    jax_files, port_files = _files(seaweedfs_tpu), _files(seaweedfs_tpu_torch)
    assert NOT_TO_PORT <= jax_files and PORT_ONLY <= port_files
    assert not NOT_TO_PORT & port_files and not PORT_ONLY & jax_files
    assert jax_files - NOT_TO_PORT == port_files - PORT_ONLY
    assert {"analysis/engine.py", "analysis/guards.py",
            "util/sanitizer.py", "util/scheduler.py"} <= port_files


def _families(metrics) -> dict:
    return {m.name: (m.help, m.label_names, m.kind)
            for m in metrics.REGISTRY._metrics.values()}


def test_metric_registries_hold_the_same_families():
    # the families registered outside stats/metrics.py, by module import
    from seaweedfs_tpu.filer import filerstore as _jax_fs  # noqa: F401
    from seaweedfs_tpu.stats import metrics as jax_metrics
    from seaweedfs_tpu_torch.filer import filerstore as _fs  # noqa: F401
    from seaweedfs_tpu_torch.stats import metrics
    jax, port = _families(jax_metrics), _families(metrics)
    # the port's own: the codec's copies and the span ring's drops
    port_only = {"SeaweedFS_codec_h2d_bytes_total",
                 "SeaweedFS_codec_d2h_bytes_total",
                 "SeaweedFS_codec_host_copy_bytes_total",
                 "SeaweedFS_trace_spans_dropped_total"}
    assert port_only <= set(port) and not port_only & set(jax)
    assert {k: v for k, v in port.items() if k not in port_only} == jax
    assert port["SeaweedFS_sanitizer_findings_total"] == \
        ("concurrency sanitizer findings", ("kind",), "counter")
