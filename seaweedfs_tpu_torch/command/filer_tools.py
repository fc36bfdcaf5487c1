"""Filer client tools: filer.cat, filer.copy, filer.meta.tail.

Reference: weed/command/filer_cat.go (read one file resolving chunks
straight from volume servers), filer_copy.go (client-side chunked
upload of local files/dirs), filer_meta_tail.go (follow the metadata
event stream). All three talk filer gRPC for metadata and volume-server
HTTP for bytes — the filer never proxies the data.
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import posixpath
import sys
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

from seaweedfs_tpu_torch.command import command, setup_client_tls
from seaweedfs_tpu_torch.pb import filer_pb2, filer_stub


def _parse_filer_url(arg: str):
    """http://host:port/path or host:port/path -> (host:port, /path)."""
    if "://" in arg:
        u = urllib.parse.urlparse(arg)
        return u.netloc, urllib.parse.unquote(u.path) or "/"
    host, _, path = arg.partition("/")
    return host, "/" + urllib.parse.unquote(path)


@command("filer.cat", "copy one filer file to stdout or a local file")
def run_filer_cat(args) -> int:
    setup_client_tls()
    p = argparse.ArgumentParser(prog="filer.cat")
    p.add_argument("-o", default="", help="write to file instead of stdout")
    p.add_argument("url", help="http://<filer:port>/path/to/file")
    opts = p.parse_args(args)
    filer, path = _parse_filer_url(opts.url)
    stub = filer_stub(filer)
    directory, name = posixpath.split(path.rstrip("/"))
    try:
        entry = stub.LookupDirectoryEntry(
            filer_pb2.LookupDirectoryEntryRequest(
                directory=directory or "/", name=name)).entry
    except Exception as e:
        print(f"lookup {path}: {e}", file=sys.stderr)
        return 1
    if entry.is_directory:
        print(f"{path} is a directory", file=sys.stderr)
        return 1
    from seaweedfs_tpu_torch.filer.stream import filer_lookup_fn, stream_content
    lookup = filer_lookup_fn(stub)
    out = open(opts.o, "wb") if opts.o else sys.stdout.buffer
    try:
        # stream_content expands manifest chunks and fetches every
        # piece straight from the volume servers
        for piece in stream_content(lookup, list(entry.chunks)):
            out.write(piece)
    finally:
        if opts.o:
            out.close()
    return 0


@command("filer.copy", "copy local files/dirs up to the filer")
def run_filer_copy(args) -> int:
    setup_client_tls()
    p = argparse.ArgumentParser(prog="filer.copy")
    p.add_argument("-include", default="",
                   help="filename pattern for directory walks, e.g. *.pdf")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttl", default="")
    p.add_argument("-maxMB", type=int, default=32,
                   help="split files larger than this per chunk")
    p.add_argument("-c", type=int, default=8, dest="concurrency",
                   help="concurrent file uploads")
    p.add_argument("sources", nargs="+",
                   help="local files/dirs, last arg is "
                        "http://<filer:port>/dest/dir/")
    opts = p.parse_args(args)
    *sources, dest = opts.sources
    if not sources:
        print("nothing to copy", file=sys.stderr)
        return 1
    filer, dest_dir = _parse_filer_url(dest)
    if not dest.rstrip().endswith("/"):
        print(f"destination {dest} must be a directory (end with /)",
              file=sys.stderr)
        return 1

    jobs = []                            # (local_path, remote_dir)
    for src in sources:
        src = os.path.abspath(src)
        if os.path.isdir(src):
            base = os.path.basename(src.rstrip("/"))
            for root, _dirs, files in os.walk(src):
                rel = os.path.relpath(root, src)
                rdir = posixpath.join(dest_dir, base) if rel == "." else \
                    posixpath.join(dest_dir, base, *rel.split(os.sep))
                for f in files:
                    if opts.include and not fnmatch.fnmatch(f, opts.include):
                        continue
                    jobs.append((os.path.join(root, f), rdir))
        elif os.path.isfile(src):
            jobs.append((src, dest_dir))
        else:
            print(f"{src}: no such file", file=sys.stderr)
            return 1

    stub = filer_stub(filer)
    chunk_size = opts.maxMB << 20
    failed = []

    def copy_one(job):
        local, rdir = job
        try:
            _upload_one(stub, local, rdir, chunk_size, opts)
            print(f"{local} -> {rdir}/{os.path.basename(local)}")
        except Exception as e:
            failed.append((local, e))
            print(f"{local}: {e}", file=sys.stderr)

    # lint: thread-ok(offline CLI copy tool; no server request context exists)
    with ThreadPoolExecutor(max_workers=max(1, opts.concurrency)) as pool:
        list(pool.map(copy_one, jobs))
    return 1 if failed else 0


def _upload_one(stub, local: str, rdir: str, chunk_size: int,
                opts) -> None:
    """Client-side chunking (filer_copy.go uploadFileAsOne/InChunks):
    assign a fid per chunk from the filer, POST bytes straight to the
    volume server, then save the entry with the chunk list."""
    from seaweedfs_tpu_torch.operation import operations
    from seaweedfs_tpu_torch.storage.superblock import TTL
    ttl_sec = TTL.parse(opts.ttl).minutes * 60 if opts.ttl else 0
    st = os.stat(local)
    chunks = []
    uploaded = []                        # (volume url, fid) for rollback
    try:
        with open(local, "rb") as f:
            offset = 0
            while True:
                data = f.read(chunk_size)
                if not data:
                    # empty files get an entry with no chunks — the
                    # volume layer refuses zero-byte needles (they'd
                    # read as delete markers)
                    break
                assign = stub.AssignVolume(filer_pb2.AssignVolumeRequest(
                    count=1, collection=opts.collection,
                    replication=opts.replication, ttl_sec=ttl_sec,
                    path=posixpath.join(rdir, os.path.basename(local))))
                if assign.error:
                    raise RuntimeError(f"assign: {assign.error}")
                operations.upload_data(
                    f"{assign.url}/{assign.file_id}", data,
                    filename=os.path.basename(local), ttl=opts.ttl)
                uploaded.append((assign.url, assign.file_id))
                chunks.append(filer_pb2.FileChunk(
                    file_id=assign.file_id, offset=offset,
                    size=len(data), mtime=time.time_ns()))
                offset += len(data)
    except Exception:
        # delete the chunks already uploaded: with no entry referencing
        # them they would sit as orphans until a volume.fsck purge
        # (reference filer_copy.go deletes collected fids on failure)
        import urllib.request
        for url, fid in uploaded:
            try:
                urllib.request.urlopen(urllib.request.Request(
                    f"http://{url}/{fid}", method="DELETE"), timeout=10)
            except OSError:
                pass
        raise
    now = int(time.time())
    resp = stub.CreateEntry(filer_pb2.CreateEntryRequest(
        directory=rdir,
        entry=filer_pb2.Entry(
            name=os.path.basename(local), is_directory=False,
            chunks=chunks,
            attributes=filer_pb2.FuseAttributes(
                file_size=st.st_size, mtime=int(st.st_mtime), crtime=now,
                file_mode=st.st_mode & 0o777,
                collection=opts.collection,
                replication=opts.replication,
                ttl_sec=ttl_sec))))
    if resp.error:
        raise RuntimeError(f"create entry: {resp.error}")


@command("filer.meta.tail", "print filer metadata changes as they happen")
def run_filer_meta_tail(args) -> int:
    setup_client_tls()
    p = argparse.ArgumentParser(prog="filer.meta.tail")
    p.add_argument("-filer", default="127.0.0.1:8888")
    p.add_argument("-pathPrefix", default="/")
    p.add_argument("-timeAgo", type=float, default=0,
                   help="start N seconds before now")
    p.add_argument("-pattern", default="",
                   help="filename glob, or full-path glob if it has a /")
    opts = p.parse_args(args)

    def matches(directory: str, entry_name: str) -> bool:
        if not opts.pattern:
            return True
        if "/" in opts.pattern:
            return fnmatch.fnmatch(f"{directory}/{entry_name}",
                                   opts.pattern)
        return fnmatch.fnmatch(entry_name, opts.pattern)

    since_ns = time.time_ns() - int(opts.timeAgo * 1e9)
    stub = filer_stub(opts.filer)
    try:
        for rec in stub.SubscribeMetadata(
                filer_pb2.SubscribeMetadataRequest(
                    client_name="filer.meta.tail",
                    path_prefix=opts.pathPrefix, since_ns=since_ns)):
            ev = rec.event_notification
            old_name = ev.old_entry.name if ev.HasField("old_entry") else ""
            new_name = ev.new_entry.name if ev.HasField("new_entry") else ""
            if not (matches(rec.directory, old_name or new_name) or
                    (new_name and matches(ev.new_parent_path or
                                          rec.directory, new_name))):
                continue
            if new_name and old_name:
                kind = "update" if (ev.new_parent_path or rec.directory) \
                    == rec.directory and old_name == new_name else "rename"
            elif new_name:
                kind = "create"
            else:
                kind = "delete"
            doc = {"ts": rec.ts_ns, "dir": rec.directory, "op": kind}
            if old_name:
                doc["old"] = old_name
            if new_name:
                doc["new"] = new_name
                doc["size"] = ev.new_entry.attributes.file_size
            print(json.dumps(doc), flush=True)
    except KeyboardInterrupt:
        return 130
    return 0
