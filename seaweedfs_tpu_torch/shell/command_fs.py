"""fs.* shell family: browse and repair the filer namespace.

Equivalent behavior to the reference shell's filer commands
(weed/shell/command_fs_ls.go, _cat.go, _du.go,
_tree.go, _mv.go, _cd.go, _pwd.go, _meta_save.go, _meta_load.go,
_meta_cat.go, registered in shell/commands.go:35-39). Metadata rides
the filer gRPC service; fs.cat streams bytes through the filer HTTP
read path (the same data path every gateway uses).

fs.meta.save/load use the reference's wire format: a stream of
4-byte big-endian length-prefixed filer_pb.FullEntry records, so a
namespace snapshot can be carried between clusters.
"""

from __future__ import annotations

import posixpath
import stat as stat_mod
import time

from seaweedfs_tpu_torch import unported
from seaweedfs_tpu_torch.pb import filer_pb2
from seaweedfs_tpu_torch.shell import command, refuse


def _split(path: str):
    directory, name = posixpath.split(path.rstrip("/") or "/")
    return directory or "/", name


def _flags_and_path(env, argv, known: str = ""):
    """Parse leading -x flag clusters; the last non-flag arg is the
    path (reference findInputDirectory)."""
    flags = set()
    path = None
    for a in argv:
        if a.startswith("-"):
            flags.update(a[1:])
        else:
            path = a
    unknown = flags - set(known)
    if unknown:
        raise ValueError(f"unknown flag(s): {', '.join(sorted(unknown))}")
    return flags, env.resolve_path(path or ".")


def _mode_str(entry) -> str:
    mode = entry.attributes.file_mode & 0o7777
    kind = "d" if entry.is_directory else "-"
    return kind + stat_mod.filemode(0o100000 | mode)[1:]


def _entry_size(entry) -> int:
    return max(entry.attributes.file_size,
               sum(c.size for c in entry.chunks))


@command("fs.cd", "change the current filer directory")
def fs_cd(env, argv, out):
    path = env.resolve_path(argv[0] if argv else "/")
    e = env.filer_entry(path)
    if e is None or not e.is_directory:
        raise ValueError(f"{path} is not a directory")
    env.cwd = path


@command("fs.pwd", "print the current filer directory")
def fs_pwd(env, argv, out):
    print(env.cwd, file=out)


@command("fs.ls", "list entries: fs.ls [-l] [-a] [dir|file|prefix]")
def fs_ls(env, argv, out):
    flags, path = _flags_and_path(env, argv, known="la")
    long_fmt, show_hidden = "l" in flags, "a" in flags
    e = env.filer_entry(path)
    if e is not None and e.is_directory:
        directory, prefix = path, ""
    else:
        # file or prefix listing (reference fs.ls supports both)
        directory, prefix = _split(path)
    n = matched = 0
    for entry in env.list_filer_entries(directory, prefix=prefix):
        matched += 1
        if not show_hidden and entry.name.startswith("."):
            continue
        n += 1
        if long_fmt:
            a = entry.attributes
            ts = time.strftime("%Y-%m-%d %H:%M",
                               time.localtime(a.mtime or 0))
            name = entry.name + ("/" if entry.is_directory else "")
            print(f"{_mode_str(entry)} {a.user_name or '-':>8} "
                  f"{_entry_size(entry):>12} {ts} "
                  f"{posixpath.join(directory, name)}", file=out)
        else:
            print(entry.name + ("/" if entry.is_directory else ""),
                  file=out)
    if e is None and matched == 0:
        raise ValueError(f"{path}: no such file or directory")
    if long_fmt:
        print(f"total {n}", file=out)


@command("fs.cat", "print a file's content: fs.cat /path/file")
def fs_cat(env, argv, out):
    from seaweedfs_tpu_torch.filer import http_client
    _, path = _flags_and_path(env, argv)
    e = env.filer_entry(path)
    if e is None:
        raise ValueError(f"{path}: no such entry")
    if e.is_directory:
        raise ValueError(f"{path} is a directory")
    status, body, _ = http_client.get(env.filer_url, path)
    out.write(body.decode(errors="replace"))


@command("fs.du", "disk usage: fs.du [/dir]")
def fs_du(env, argv, out):
    _, path = _flags_and_path(env, argv)

    def walk(directory) -> tuple[int, int, int]:
        """(blocks, bytes, entries) under directory, printing per-child
        dir lines like the reference fs.du."""
        blocks = size = n = 0
        for entry in env.list_filer_entries(directory):
            full = posixpath.join(directory, entry.name)
            if entry.is_directory:
                b, s, k = walk(full)
                print(f"block:{b:>8}\tbyte:{s:>12}\t{full}", file=out)
                blocks += b
                size += s
                n += k
            else:
                blocks += max(1, len(entry.chunks))
                size += _entry_size(entry)
                n += 1
        return blocks, size, n

    e = env.filer_entry(path)
    if e is None:
        raise ValueError(f"{path}: no such entry")
    if e.is_directory:
        b, s, _ = walk(path)
        print(f"block:{b:>8}\tbyte:{s:>12}\t{path}", file=out)
    else:
        print(f"block:{max(1, len(e.chunks)):>8}"
              f"\tbyte:{_entry_size(e):>12}\t{path}", file=out)


@command("fs.tree", "recursively print the namespace: fs.tree [/dir]")
def fs_tree(env, argv, out):
    _, path = _flags_and_path(env, argv)

    def walk(directory, indent):
        entries = list(env.list_filer_entries(directory))
        for i, entry in enumerate(entries):
            last = i == len(entries) - 1
            branch = "└── " if last else "├── "
            name = entry.name + ("/" if entry.is_directory else "")
            print(indent + branch + name, file=out)
            if entry.is_directory:
                walk(posixpath.join(directory, entry.name),
                     indent + ("    " if last else "│   "))

    print(path, file=out)
    walk(path, "")


@command("fs.mv", "move/rename: fs.mv /src/path /dst/path")
def fs_mv(env, argv, out):
    args = [a for a in argv if not a.startswith("-")]
    if len(args) != 2:
        raise ValueError("usage: fs.mv <source> <destination>")
    src = env.resolve_path(args[0])
    dst = env.resolve_path(args[1])
    src_dir, src_name = _split(src)
    dst_entry = env.filer_entry(dst)
    if dst_entry is not None and dst_entry.is_directory:
        # moving INTO a directory keeps the source name (reference fs.mv)
        dst_dir, dst_name = dst, src_name
    else:
        dst_dir, dst_name = _split(dst)
    env.filer.AtomicRenameEntry(filer_pb2.AtomicRenameEntryRequest(
        old_directory=src_dir, old_name=src_name,
        new_directory=dst_dir, new_name=dst_name))
    print(f"moved {src} -> {posixpath.join(dst_dir, dst_name)}", file=out)


@command("fs.meta.cat", "print one entry's metadata proto")
def fs_meta_cat(env, argv, out):
    _, path = _flags_and_path(env, argv)
    e = env.filer_entry(path)
    if e is None:
        raise ValueError(f"{path}: no such entry")
    print(e, file=out)


def _walk_full_entries(env, directory):
    """Depth-first FullEntry stream of everything under directory."""
    for entry in env.list_filer_entries(directory):
        yield filer_pb2.FullEntry(dir=directory, entry=entry)
        if entry.is_directory:
            yield from _walk_full_entries(
                env, posixpath.join(directory, entry.name))


@command("fs.meta.save", "snapshot namespace metadata: "
                         "fs.meta.save [-o file.meta] [/dir]")
def fs_meta_save(env, argv, out):
    out_file = None
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "-o":
            if i + 1 >= len(argv):
                raise ValueError("-o needs a filename")
            out_file = argv[i + 1]
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    _, path = _flags_and_path(env, rest)
    if out_file is None:
        out_file = time.strftime("%Y-%m-%d-%H-%M.meta")
    n = 0
    with open(out_file, "wb") as f:
        for fe in _walk_full_entries(env, path):
            blob = fe.SerializeToString()
            f.write(len(blob).to_bytes(4, "big"))
            f.write(blob)
            n += 1
    print(f"saved {n} entries from {path} to {out_file}", file=out)


@command("fs.meta.load", "restore namespace metadata: "
                         "fs.meta.load file.meta")
def fs_meta_load(env, argv, out):
    args = [a for a in argv if not a.startswith("-")]
    if len(args) != 1:
        raise ValueError("usage: fs.meta.load <file.meta>")
    n = errors = 0
    with open(args[0], "rb") as f:
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                break
            blob = f.read(int.from_bytes(hdr, "big"))
            fe = filer_pb2.FullEntry.FromString(blob)
            resp = env.filer.CreateEntry(filer_pb2.CreateEntryRequest(
                directory=fe.dir, entry=fe.entry))
            if resp.error:
                errors += 1
                print(f"  {fe.dir}/{fe.entry.name}: {resp.error}",
                      file=out)
            else:
                n += 1
    print(f"loaded {n} entries from {args[0]}"
          + (f" ({errors} errors)" if errors else ""), file=out)


@command("fs.configure", "add/view path-specific filer rules; -apply saves")
def fs_configure(env, argv, out):
    """Read-modify-write the filer's path-config document
    (/etc/seaweedfs/filer.conf): per-prefix collection / replication /
    ttl / fsync rules the filer applies to new writes. Without flags it
    prints the current rules. Reference:
    weed/shell/command_fs_configure.go."""
    import argparse
    from seaweedfs_tpu_torch.filer import http_client
    from seaweedfs_tpu_torch.filer.filer_conf import (FILER_CONF_PATH, FilerConf,
                                                PathConf)
    p = argparse.ArgumentParser(prog="fs.configure")
    p.add_argument("-locationPrefix", default="")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttl", default="")
    p.add_argument("-fsync", action="store_true")
    p.add_argument("-delete", action="store_true")
    p.add_argument("-apply", action="store_true")
    args = p.parse_args(argv)

    try:
        status, body, _ = http_client.get(env.filer_url, FILER_CONF_PATH)
        conf = FilerConf.from_bytes(body) if status == 200 else FilerConf()
    # lint: swallow-ok(absent/unreadable conf means the empty default)
    except Exception:
        conf = FilerConf()

    if args.locationPrefix:
        rules = [r for r in conf.rules
                 if r.location_prefix != args.locationPrefix]
        if not args.delete:
            rules.append(PathConf(
                location_prefix=args.locationPrefix,
                collection=args.collection,
                replication=args.replication,
                ttl=args.ttl, fsync=args.fsync))
        conf = FilerConf(rules)

    blob = conf.to_bytes()
    out.write(blob.decode() + "\n")
    if args.apply:
        http_client.put(env.filer_url, FILER_CONF_PATH, blob,
                        mime="application/json")
        out.write("applied\n")
    elif args.locationPrefix:
        out.write("use -apply to save\n")


# fs.meta.notify publishes to a notification queue, which arrives with
# the async services (notification/)
refuse("fs.meta.notify", unported.NOTIFICATION)
