"""Client subcommands: the admin shell, upload, download, delete, backup,
the offline volume tools (fix, export, compact), scaffold and version.

Reference: weed/command/shell.go, upload.go, download.go, fix.go,
export.go, compact.go, scaffold.go, backup.go and version.go; the
counterparts of the JAX package's ``command/tools.py`` subcommands of the
same names. The commands that dial the cluster read security.toml first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from seaweedfs_tpu_torch.command import command, setup_client_tls


@command("version", "print version")
def run_version(args) -> int:
    from seaweedfs_tpu_torch import __version__
    print(f"seaweedfs-tpu {__version__}")
    return 0


@command("shell", "admin shell against a master (one-shot or a REPL)")
def run_shell(args) -> int:
    setup_client_tls()
    p = argparse.ArgumentParser(prog="shell")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-filer", default="",
                   help="filer host:port enabling the fs.* commands")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="one-shot command (omit for a REPL)")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.shell import CommandError, Shell
    sh = Shell(opts.master, filer_url=opts.filer)
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


@command("compact", "offline-compact a volume's deleted space")
def run_compact(args) -> int:
    """Reference weed/command/compact.go: force a compaction of an
    on-disk volume. Without -commit the result is left as .cpd/.cpx
    shadow files for INSPECTION ONLY — the next load of the volume
    treats lingering shadows as an aborted vacuum and deletes them
    (storage/vacuum.py recover_compaction). Use -commit to actually
    swap them into place."""
    p = argparse.ArgumentParser(prog="compact")
    p.add_argument("-dir", default=".")
    p.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-commit", action="store_true",
                   help="rename the shadows over the .dat/.idx")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.storage.vacuum import commit_compact, compact
    from seaweedfs_tpu_torch.storage.volume import Volume
    v = Volume(opts.dir, opts.collection, opts.volume_id,
               create_if_missing=False, async_write=False)
    try:
        state = compact(v)
        live = len(state.new_offsets)
        if opts.commit:
            commit_compact(v, state)
            print(f"compacted volume {opts.volume_id}: {live} live "
                  f"needles, committed")
        else:
            print(f"compacted volume {opts.volume_id}: {live} live "
                  f"needles -> {state.cpd_path} / {state.cpx_path}")
    finally:
        v.close()
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


SCAFFOLDS = {
    "master": """\
# master.toml — maintenance automation (reference command/scaffold.go:422-433)
[master.maintenance]
# shell commands the master leader runs periodically
scripts = [
  "lock",
  "ec.encode -fullPercent=95 -quietFor=1h",
  "ec.rebuild -force",
  "ec.balance -force",
  "volume.balance",
  "unlock",
]
sleep_minutes = 17

[master.sequencer]
type = "memory"  # or "snowflake" (coordination-free time-based ids)
# snowflake only: unique 0-1023 per master (default: hash of ip:port)
#node_id = 1

# cloud-tier targets for `volume.tier.upload` (reference scaffold.go
# [storage.backend.s3.default]); volume servers read this section too
#[storage.backend.s3.default]
#enabled = true
#endpoint = "127.0.0.1:8333"
#bucket = "volume_tier"
#access_key = ""
#secret_key = ""
#region = "us-east-1"
""",
    "security": """\
# security.toml (reference command/scaffold.go [jwt.signing] + [grpc.*])

# mutual TLS for all gRPC (reference security/tls.go). All three paths
# must be set per role to enable; absent = plaintext.
#[grpc]
#ca = "/etc/seaweedfs/ca.crt"
#[grpc.master]
#cert = "/etc/seaweedfs/master.crt"
#key = "/etc/seaweedfs/master.key"
#[grpc.volume]
#cert = "/etc/seaweedfs/volume.crt"
#key = "/etc/seaweedfs/volume.key"
#[grpc.filer]
#cert = "/etc/seaweedfs/filer.crt"
#key = "/etc/seaweedfs/filer.key"
#[grpc.client]
#cert = "/etc/seaweedfs/client.crt"
#key = "/etc/seaweedfs/client.key"

[jwt.signing]
key = ""             # base64 secret; empty disables write JWT
expires_after_seconds = 10

[jwt.signing.read]
key = ""
expires_after_seconds = 10
""",
    "filer": """\
# filer.toml — metadata store selection
[filer.options]
recursive_delete = false

[memory]
enabled = false

[sqlite]
# the default embedded store
enabled = true
dbFile = "./filer.db"

# MongoDB over the OP_MSG wire protocol (no SDK needed); schema matches
# the reference: filemeta {directory, name, meta} with a unique index.
[mongodb]
enabled = false
uri = "mongodb://localhost:27017"
database = "seaweedfs"

# Cassandra over the CQL v4 binary protocol (no SDK needed). Create:
#   CREATE TABLE filemeta (directory varchar, name varchar,
#                          meta blob, PRIMARY KEY (directory, name));
[cassandra]
enabled = false
keyspace = "seaweedfs"
hosts = ["localhost:9042"]
username = ""
password = ""

# Elasticsearch 7 over plain REST/JSON (no SDK needed); one index per
# top-level directory plus .seaweedfs_kv_entries for KV pairs.
[elastic7]
enabled = false
servers = ["localhost:9200"]
username = ""
password = ""
""",
    "replication": """\
# replication.toml (reference command/scaffold.go [source.filer]/[sink.*])
[source.filer]
grpcAddress = "localhost:18888"
directory = "/buckets"

[sink.filer]
enabled = false
grpcAddress = "localhost:18888"
directory = "/backup"
replication = ""

[sink.local]
enabled = false
directory = "/data/backup"

[sink.s3]
enabled = false
endpoint = ""
bucket = ""
directory = ""
""",
    "notification": """\
# notification.toml (reference command/scaffold.go [notification.*])
# At most one enabled section is used; everything ships disabled so the
# stock scaffold never breaks filer startup.
[notification.log]
enabled = false
path = "/tmp/seaweedfs_events.log"

[notification.memory]
enabled = false

# Google Cloud Pub/Sub over REST (no SDK needed): service-account
# OAuth via a stdlib RS256 JWT; topic auto-created if missing.
[notification.google_pub_sub]
enabled = false
google_application_credentials = ""   # or GOOGLE_APPLICATION_CREDENTIALS
project_id = ""                       # defaults to the one in the creds
topic = "seaweedfs_filer"

# Kafka over the binary wire protocol (no SDK needed): Metadata +
# Produce v3 with record batches, sarama-compatible key partitioning.
[notification.kafka]
enabled = false
hosts = ["localhost:9092"]
topic = "seaweedfs_filer"

# AWS SQS over plain HTTP + SigV4 (no SDK needed). Give either the
# queue name (resolved via GetQueueUrl) or the queue_url directly;
# endpoint overrides the public sqs.<region>.amazonaws.com for
# SQS-compatible emulators.
[notification.aws_sqs]
enabled = false
aws_access_key_id = ""
aws_secret_access_key = ""
region = "us-east-1"
sqs_queue_name = "my_sqs_queue"
# queue_url = "http://localhost:9324/000000000000/my_sqs_queue"
# endpoint = "localhost:9324"
""",
}


@command("scaffold", "print an example configuration file")
def run_scaffold(args) -> int:
    p = argparse.ArgumentParser(prog="scaffold")
    p.add_argument("-config", default="master",
                   choices=sorted(SCAFFOLDS))
    p.add_argument("-output", default="",
                   help="write to <output>/<config>.toml instead of stdout")
    opts = p.parse_args(args)
    text = SCAFFOLDS[opts.config]
    if opts.output:
        path = os.path.join(opts.output, f"{opts.config}.toml")
        with open(path, "w") as f:
            f.write(text)
        print(path)
    else:
        print(text, end="")
    return 0


@command("backup", "incrementally back up a volume from a volume server")
def run_backup(args) -> int:
    """Reference weed/command/backup.go: keep a local replica of one
    volume in sync with the cluster. The first run copies everything
    (an incremental from ns=0); later runs ship only the delta after
    the local replica's newest appendAtNs. A compaction-revision
    mismatch or a local replica that is AHEAD of the source forces a
    full resync (backup.go step 0)."""
    setup_client_tls()
    p = argparse.ArgumentParser(prog="backup")
    p.add_argument("-dir", default=".")
    p.add_argument("-server", default="127.0.0.1:9333",
                   help="master url")
    p.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    p.add_argument("-collection", default="")
    opts = p.parse_args(args)
    from seaweedfs_tpu_torch.operation.operations import lookup
    from seaweedfs_tpu_torch.pb import volume_server_pb2, volume_stub
    from seaweedfs_tpu_torch.storage import volume_backup
    from seaweedfs_tpu_torch.storage.volume import Volume

    locations = lookup(opts.server, opts.volume_id, opts.collection)
    if not locations:
        print(f"volume {opts.volume_id} not found via {opts.server}",
              file=sys.stderr)
        return 1
    src = volume_stub(locations[0])
    status = src.VolumeSyncStatus(
        volume_server_pb2.VolumeSyncStatusRequest(volume_id=opts.volume_id))

    v = Volume(opts.dir, opts.collection or status.collection,
               opts.volume_id)
    if v.super_block.compaction_revision != status.compact_revision or \
            v.content_size > status.tail_offset:
        # source was compacted (or we are somehow ahead): full resync
        print(f"volume {opts.volume_id}: full resync "
              f"(local rev {v.super_block.compaction_revision} size "
              f"{v.content_size}, remote rev {status.compact_revision} "
              f"size {status.tail_offset})")
        v.destroy()
        v = Volume(opts.dir, opts.collection or status.collection,
                   opts.volume_id)
        v.super_block.compaction_revision = status.compact_revision
        v._dat.write_at(v.super_block.to_bytes(), 0)
    appended = volume_backup.incremental_backup(v, src)
    total = v.content_size
    v.close()
    print(f"volume {opts.volume_id}: +{appended} bytes (local .dat now "
          f"{total} bytes)")
    return 0
