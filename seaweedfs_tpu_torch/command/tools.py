"""Client subcommands: the admin shell and the offline volume tools.

Reference: weed/command/shell.go, fix.go and export.go; the counterparts
of the JAX package's ``command/tools.py`` subcommands of the same names.
"""

from __future__ import annotations

import argparse
import os
import sys

from seaweedfs_tpu_torch.command import command


@command("shell", "admin shell against a master (one-shot or a REPL)")
def run_shell(args) -> int:
    p = argparse.ArgumentParser(prog="shell")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="one-shot command (omit for a REPL)")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.shell import CommandError, Shell
    sh = Shell(opts.master)
    if opts.command:
        try:
            print(sh.run_command(" ".join(opts.command)), end="")
            return 0
        except CommandError as e:
            if e.partial:
                print(e.partial, end="")
            print(f"error: {e}", file=sys.stderr)
            return 1
    sh.repl()
    return 0


def _volume_base(opts) -> str:
    return os.path.join(
        opts.dir, (f"{opts.collection}_" if opts.collection else "")
        + str(opts.volume_id))


def _offline_parser(prog: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("-dir", default=".")
    p.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    p.add_argument("-collection", default="")
    return p


@command("fix", "rebuild a volume's .idx by scanning its .dat")
def run_fix(args) -> int:
    """Reference weed/command/fix.go:21-100: walk every needle record of
    the .dat and derive the index again (tombstones for deleted ones)."""
    opts = _offline_parser("fix").parse_args(args)
    from seaweedfs_tpu_torch.storage import fix as fix_mod
    base = _volume_base(opts)
    n = fix_mod.rebuild_idx(base)
    print(f"rebuilt {base}.idx with {n} entries")
    return 0


@command("export", "export a volume's needles to a tar archive")
def run_export(args) -> int:
    """Reference weed/command/export.go: the live needles (named by their
    stored name, else by "<vid>/<id>") into a tar file."""
    p = _offline_parser("export")
    p.add_argument("-o", dest="output", required=True,
                   help="output .tar path")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.storage import fix as fix_mod
    n = fix_mod.export_tar(_volume_base(opts), opts.volume_id, opts.output)
    print(f"exported {n} files to {opts.output}")
    return 0
