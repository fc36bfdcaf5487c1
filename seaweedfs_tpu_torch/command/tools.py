"""Client subcommands: the admin shell, upload, download, delete and the
offline volume tools.

Reference: weed/command/shell.go, upload.go, download.go, fix.go and
export.go; the counterparts of the JAX package's ``command/tools.py``
subcommands of the same names. The commands that dial the cluster read
security.toml first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from seaweedfs_tpu_torch.command import command, setup_client_tls


@command("shell", "admin shell against a master (one-shot or a REPL)")
def run_shell(args) -> int:
    setup_client_tls()
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


@command("upload", "upload files via master assignment")
def run_upload(args) -> int:
    setup_client_tls()
    p = argparse.ArgumentParser(prog="upload")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttl", default="")
    p.add_argument("-maxMB", dest="max_mb", type=int, default=32,
                   help="split files larger than this into chunk "
                        "needles + a manifest (reference upload.go)")
    p.add_argument("files", nargs="+")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.operation import operations
    results = []
    for path in opts.files:
        with open(path, "rb") as f:
            data = f.read()
        fid = operations.submit(
            opts.master, data, filename=os.path.basename(path),
            collection=opts.collection, replication=opts.replication,
            ttl=opts.ttl, max_mb=opts.max_mb)
        results.append({"fileName": os.path.basename(path),
                        "fid": fid, "size": len(data)})
    print(json.dumps(results, indent=2))
    return 0


@command("download", "download a file id to disk")
def run_download(args) -> int:
    setup_client_tls()
    p = argparse.ArgumentParser(prog="download")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-dir", default=".")
    p.add_argument("fids", nargs="+")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.operation import operations
    for fid in opts.fids:
        data = operations.download(opts.master, fid)
        out = os.path.join(opts.dir, fid.replace(",", "_"))
        with open(out, "wb") as f:
            f.write(data)
        print(out)
    return 0


@command("delete", "delete file ids")
def run_delete(args) -> int:
    setup_client_tls()
    p = argparse.ArgumentParser(prog="delete")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("fids", nargs="+")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.operation import operations
    for fid in opts.fids:
        operations.delete_file(opts.master, fid)
        print(f"deleted {fid}")
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
