"""Admin shell: the ops plane (reference weed/shell).

Commands are plain functions `fn(env, argv, out)` registered by name;
`Shell` is the REPL/one-shot driver. Placement decisions are computed
from the master's TopologyInfo proto so they stay unit-testable against
fabricated cluster views (the house pattern, SURVEY.md §4).
"""

from __future__ import annotations

import io
import shlex
from typing import Callable, Dict

from seaweedfs_tpu_torch.shell.command_env import CommandEnv

COMMANDS: Dict[str, Callable] = {}
HELP: Dict[str, str] = {}


def command(name: str, help_text: str = ""):
    def deco(fn):
        COMMANDS[name] = fn
        HELP[name] = help_text or (fn.__doc__ or "").strip().splitlines()[0] \
            if (help_text or fn.__doc__) else ""
        return fn
    return deco


# registration side effects
from seaweedfs_tpu_torch.shell import command_ec  # noqa: E402,F401
from seaweedfs_tpu_torch.shell import command_fs  # noqa: E402,F401
from seaweedfs_tpu_torch.shell import command_misc  # noqa: E402,F401
from seaweedfs_tpu_torch.shell import command_s3  # noqa: E402,F401
from seaweedfs_tpu_torch.shell import command_volume  # noqa: E402,F401


class CommandError(Exception):
    """Command failure; .partial holds output written before the error
    so the operator can see which irreversible steps already ran."""

    def __init__(self, message: str, partial: str = ""):
        super().__init__(message)
        self.partial = partial


class Shell:
    def __init__(self, master_url: str, filer_url: str = ""):
        self.env = CommandEnv(master_url, filer_url=filer_url)

    def run_command(self, line: str) -> str:
        argv = shlex.split(line)
        if not argv:
            return ""
        name, args = argv[0], argv[1:]
        if name in ("help", "?"):
            return "\n".join(f"{n}\t{HELP.get(n, '')}"
                             for n in sorted(COMMANDS))
        fn = COMMANDS.get(name)
        if fn is None:
            raise CommandError(f"unknown command {name!r}; try 'help'")
        out = io.StringIO()
        try:
            fn(self.env, args, out)
        except SystemExit:
            # argparse exits on bad flags/-h; keep the shell alive
            raise CommandError(
                f"bad arguments for {name}: {' '.join(args)!r}",
                partial=out.getvalue()) from None
        except CommandError as e:
            raise CommandError(str(e), partial=out.getvalue() + e.partial) \
                from None
        except Exception as e:
            # surface what already happened before the failure
            raise CommandError(f"{type(e).__name__}: {e}",
                               partial=out.getvalue()) from e
        return out.getvalue()

    def repl(self, input_fn=input, print_fn=print) -> None:
        print_fn("seaweedfs-tpu-torch shell; 'help' lists commands, "
                 "'exit' quits")
        while True:
            try:
                line = input_fn("> ")
            except (EOFError, KeyboardInterrupt):
                break
            if line.strip() in ("exit", "quit"):
                break
            try:
                print_fn(self.run_command(line), end="")
            except CommandError as e:
                if e.partial:
                    print_fn(e.partial, end="")
                print_fn(f"error: {e}")
            except Exception as e:  # keep the repl alive
                print_fn(f"error: {type(e).__name__}: {e}")
