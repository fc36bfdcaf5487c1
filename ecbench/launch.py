"""Child processes of a run, started through the port's own entries.

    python -m ecbench.launch command <port command> [args]
        runs ``seaweedfs_tpu_torch.command.main`` (the master, here);
    python -m ecbench.launch host
        hosts volume servers in this one process, the only one of the run
        that uses the card. It reads one JSON command a line on standard
        input and answers each with one line ``ECBENCH <json>`` on
        standard output; end of input stops every server.

Host commands (``op``): ``volume`` (``args`` parsed by the ``volume``
command's own parser and built as it builds them), ``stop`` (``name``),
``metrics`` (``port``: the ``/metrics`` listener), ``device``,
``trace_start`` (``path``) and ``trace_stop`` (``torch.profiler`` and
K1's launch shapes over a window; ``spans``: the program's span ring
written to a file) and ``exit``.
"""

from __future__ import annotations

import json
import sys
import traceback


def _answer(obj) -> None:
    sys.stdout.write("ECBENCH " + json.dumps(obj) + "\n")
    sys.stdout.flush()


def host() -> int:
    from seaweedfs_tpu_torch.command import servers
    from seaweedfs_tpu_torch.stats import metrics, trace
    running = {}
    probe = None
    log = None
    metrics_srv = None
    try:
        for line in sys.stdin:
            cmd = json.loads(line)
            op = cmd["op"]
            try:
                if op == "volume":
                    opts = servers._volume_parser().parse_args(cmd["args"])
                    servers._configure_trace(opts)
                    vs = servers._build_volume(opts)
                    vs.start()
                    running[cmd["name"]] = vs
                    _answer({"ok": True})
                elif op == "stop":
                    running.pop(cmd["name"]).stop()
                    _answer({"ok": True})
                elif op == "metrics":
                    metrics_srv = metrics.start_metrics_server(
                        cmd["port"], role="volume")
                    _answer({"ok": True})
                elif op == "device":
                    import torch
                    _answer({"ok": True, "kind": torch.cuda.get_device_name(0)
                             if torch.cuda.is_available() else "cpu"})
                elif op == "trace_start":
                    from ecbench import profiling
                    log = profiling.LaunchLog() \
                        if cmd.get("cuda", True) else None
                    probe = profiling.Probe(cmd["path"], log) \
                        if cmd.get("cuda", True) else None
                    trace.clear()
                    trace.enable()
                    if probe is not None:
                        probe.start()
                    _answer({"ok": True})
                elif op == "trace_stop":
                    if probe is not None:
                        probe.stop()
                        log.close()
                    with open(cmd["spans"], "w") as f:
                        json.dump([(s.name, s.t0 + trace.EPOCH_OFFSET,
                                    s.t0 + s.dur + trace.EPOCH_OFFSET)
                                   for s in trace.spans()], f)
                    trace.disable()
                    _answer({"ok": True,
                             "launches": log.launches if log else []})
                elif op == "io":
                    from ecbench import common
                    _answer({"ok": True, "io": common.proc_io()})
                elif op == "exit":
                    break
                else:
                    _answer({"ok": False, "error": f"unknown op {op}"})
            except Exception as e:  # noqa: BLE001 - reported to the harness
                traceback.print_exc()
                _answer({"ok": False, "error": f"{type(e).__name__}: {e}"})
    finally:
        for vs in running.values():
            vs.stop()
        if metrics_srv is not None:
            metrics_srv.shutdown()
            metrics_srv.server_close()
        peak = 0
        if "torch" in sys.modules:
            import torch
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                peak = torch.cuda.max_memory_allocated()
        _answer({"ok": True, "memory_peak_bytes": peak})
    return 0


def main(argv) -> int:
    if argv and argv[0] == "host":
        return host()
    if argv and argv[0] == "command":
        from seaweedfs_tpu_torch.command import main as command_main
        return command_main(argv[1:])
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
