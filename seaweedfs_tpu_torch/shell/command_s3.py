"""S3 admin-shell family: bucket lifecycle and identity configuration.

Reference: weed/shell/command_s3_bucket_create.go, _delete.go, _list.go,
command_s3_configure.go. Buckets are directories under the filer's
buckets path whose collection matches the bucket name; identities live
as a JSON document at /etc/iam/identity.json in the filer namespace and
the S3 gateway reloads them live (s3api/server.py _watch_iam). The
port of ``seaweedfs_tpu.shell.command_s3``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List

from seaweedfs_tpu_torch.pb import filer_pb2, master_pb2
from seaweedfs_tpu_torch.shell import command
from seaweedfs_tpu_torch.shell.command_env import CommandEnv

IAM_PATH = "/etc/iam/identity.json"
S3_ACTIONS = ("Read", "Write", "List", "Tagging", "Admin")


def _buckets_dir(env: CommandEnv) -> str:
    return env.filer.GetFilerConfiguration(
        filer_pb2.GetFilerConfigurationRequest()).dir_buckets or "/buckets"


@command("s3.bucket.create", "create an S3 bucket: s3.bucket.create "
                             "-name <bucket> [-replication xyz]")
def s3_bucket_create(env: CommandEnv, argv: List[str], out) -> None:
    p = argparse.ArgumentParser(prog="s3.bucket.create")
    p.add_argument("-name", required=True)
    p.add_argument("-replication", default="")
    args = p.parse_args(argv)
    now = int(time.time())
    env.filer.CreateEntry(filer_pb2.CreateEntryRequest(
        directory=_buckets_dir(env),
        entry=filer_pb2.Entry(
            name=args.name, is_directory=True,
            attributes=filer_pb2.FuseAttributes(
                mtime=now, crtime=now, file_mode=0o777 | 0o40000,
                collection=args.name, replication=args.replication))))
    out.write(f"created bucket {args.name}\n")


@command("s3.bucket.delete", "delete a bucket and its collection")
def s3_bucket_delete(env: CommandEnv, argv: List[str], out) -> None:
    """Drops the namespace subtree AND the backing collection on the
    master, reclaiming the volumes (reference
    command_s3_bucket_delete.go)."""
    p = argparse.ArgumentParser(prog="s3.bucket.delete")
    p.add_argument("-name", required=True)
    args = p.parse_args(argv)
    env.filer.DeleteEntry(filer_pb2.DeleteEntryRequest(
        directory=_buckets_dir(env), name=args.name,
        is_delete_data=True, is_recursive=True))
    env.master.CollectionDelete(master_pb2.CollectionDeleteRequest(
        name=args.name))
    out.write(f"deleted bucket {args.name}\n")


@command("s3.bucket.list", "list S3 buckets")
def s3_bucket_list(env: CommandEnv, argv: List[str], out) -> None:
    for entry in env.list_filer_entries(_buckets_dir(env)):
        if not entry.is_directory:
            continue
        q = f"\tquota:{entry.quota}" if getattr(entry, "quota", 0) else ""
        out.write(f"{entry.name}{q}\n")


def _read_iam(env: CommandEnv) -> dict:
    from seaweedfs_tpu_torch.filer import http_client
    try:
        status, body, _ = http_client.get(env.filer_url, IAM_PATH)
    # lint: swallow-ok(absent/unreadable iam config means no identities)
    except Exception:
        return {"identities": []}
    if status != 200 or not body:
        return {"identities": []}
    return json.loads(body)


@command("s3.configure", "add/update/delete S3 identities; -apply saves")
def s3_configure(env: CommandEnv, argv: List[str], out) -> None:
    """Read-modify-write the identities document the S3 gateway
    enforces. Without flags it prints the current configuration; with
    -user etc. it edits in memory and prints the result; -apply writes
    it back to the filer (the gateway reloads live). Reference:
    weed/shell/command_s3_configure.go."""
    p = argparse.ArgumentParser(prog="s3.configure")
    p.add_argument("-user", default="")
    p.add_argument("-access_key", default="")
    p.add_argument("-secret_key", default="")
    p.add_argument("-actions", default="",
                   help=f"comma-separated from {','.join(S3_ACTIONS)}")
    p.add_argument("-buckets", default="",
                   help="restrict -actions to these buckets")
    p.add_argument("-delete", action="store_true",
                   help="delete the user / access key / actions given")
    p.add_argument("-apply", action="store_true")
    args = p.parse_args(argv)

    cfg = _read_iam(env)
    idents = cfg.setdefault("identities", [])

    cmd_actions = []
    for action in filter(None, args.actions.split(",")):
        if action.split(":")[0] not in S3_ACTIONS:
            raise ValueError(f"unknown action {action!r}")
        if args.buckets:
            cmd_actions += [f"{action}:{b}"
                            for b in args.buckets.split(",")]
        else:
            cmd_actions.append(action)

    if args.user:
        ident = next((i for i in idents if i.get("name") == args.user),
                     None)
        if args.delete and ident is not None and not cmd_actions \
                and not args.access_key:
            idents.remove(ident)          # drop the whole user
        else:
            if ident is None:
                if args.delete:
                    raise ValueError(f"no such user {args.user!r}")
                ident = {"name": args.user, "credentials": [],
                         "actions": []}
                idents.append(ident)
            creds = ident.setdefault("credentials", [])
            acts = ident.setdefault("actions", [])
            if args.delete:
                if args.access_key:
                    creds[:] = [c for c in creds
                                if c.get("accessKey") != args.access_key]
                for a in cmd_actions:
                    if a in acts:
                        acts.remove(a)
            else:
                if args.access_key:
                    cred = next((c for c in creds
                                 if c.get("accessKey") == args.access_key),
                                None)
                    if cred is None:
                        creds.append({"accessKey": args.access_key,
                                      "secretKey": args.secret_key})
                    elif args.secret_key:
                        cred["secretKey"] = args.secret_key
                for a in cmd_actions:
                    if a not in acts:
                        acts.append(a)

    blob = json.dumps(cfg, indent=2)
    out.write(blob + "\n")
    if args.apply:
        from seaweedfs_tpu_torch.filer import http_client
        http_client.put(env.filer_url, IAM_PATH, blob.encode(),
                        mime="application/json")
        out.write("applied\n")
    elif args.user:
        out.write("use -apply to save\n")
