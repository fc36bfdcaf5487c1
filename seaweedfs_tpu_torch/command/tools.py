"""Client subcommands: the admin shell.

Reference: weed/command/shell.go.
"""

from __future__ import annotations

import argparse
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
