"""The single-binary command layer: ``python -m seaweedfs_tpu_torch <cmd>``.

The port of ``seaweedfs_tpu.command`` for the cluster and its clients:
``master``, ``volume``, ``filer``, ``server``, ``shell``, ``upload``,
``download``, ``delete``, ``benchmark``, ``backup``, ``fix``, ``export``,
``compact``, ``scaffold``, ``version``, ``filer.cat``, ``filer.copy`` and
``filer.meta.tail``; ``s3``, ``webdav`` and ``ftp`` answer with an error
naming their ROADMAP item. Global flags (-v verbosity,
-logFile) are peeled off before dispatch, like the reference's glog flags
(weed/command/command.go:10-34, weed/weed.go:37). Every server and client
command reads ``security.toml`` first (``setup_client_tls``).
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Tuple

from seaweedfs_tpu_torch.util import wlog

COMMANDS: Dict[str, Tuple[Callable, str]] = {}


def command(name: str, help_text: str):
    def deco(fn):
        COMMANDS[name] = (fn, help_text)
        return fn
    return deco


def _usage(out=sys.stderr) -> None:
    print("usage: python -m seaweedfs_tpu_torch [-v N] [-logFile PATH] "
          "<command> [args]\n\ncommands:", file=out)
    for name in sorted(COMMANDS):
        print(f"  {name:<16} {COMMANDS[name][1]}", file=out)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # global flags before the subcommand, matched exactly: argparse's
    # prefix matching would read -volumeSizeLimitMB as "-v olumeSize..."
    verbosity, log_file = None, None
    rest = argv
    while rest:
        if rest[0] == "-v" and len(rest) >= 2:
            try:
                verbosity = int(rest[1])
            except ValueError:
                print(f"-v expects an integer, got {rest[1]!r}",
                      file=sys.stderr)
                _usage()
                return 2
            rest = rest[2:]
        elif rest[0] == "-logFile" and len(rest) >= 2:
            log_file, rest = rest[1], rest[2:]
        else:
            break
    if verbosity is not None or log_file:
        wlog.configure(verbosity=verbosity, log_file=log_file)
    if not rest or rest[0] in ("-h", "--help", "help"):
        _usage(sys.stdout if rest and rest[0] != "-h" else sys.stderr)
        return 0 if rest else 2
    name, args = rest[0], rest[1:]
    entry = COMMANDS.get(name)
    if entry is None:
        print(f"unknown command {name!r}", file=sys.stderr)
        _usage()
        return 2
    from seaweedfs_tpu_torch import unported
    try:
        return entry[0](args) or 0
    except unported.NotPortedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except KeyboardInterrupt:
        return 130


def setup_client_tls(role: str = "client") -> None:
    """Mutual TLS from security.toml's [grpc.*] sections for this
    process's RPC plane (``util/config.py`` finds the file in the working
    directory, then $HOME/.seaweedfs): the role's pair for its server, the
    [grpc.client] pair for what it dials. Plaintext without them; a file
    that names certificates which do not load raises."""
    from seaweedfs_tpu_torch.security import tls as tls_mod
    from seaweedfs_tpu_torch.util import config as config_mod
    conf = config_mod.load_configuration("security")
    if conf:
        tls_mod.configure_process_tls(conf, role)


# registration side effects
from seaweedfs_tpu_torch.command import servers  # noqa: E402,F401
from seaweedfs_tpu_torch.command import tools  # noqa: E402,F401
from seaweedfs_tpu_torch.command import benchmark  # noqa: E402,F401
from seaweedfs_tpu_torch.command import filer_tools  # noqa: E402,F401
