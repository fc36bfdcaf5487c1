"""Replication sinks (reference: weed/replication/sink/{filersink,
localsink,s3sink,...}): apply create/update/delete of one entry to a
destination. Data arrives as plain bytes from the source reader, so any
sink that can store bytes works. The port of
``seaweedfs_tpu.replication.sinks``: the same sinks, registry and
replication.toml key aliases."""

from __future__ import annotations

import os
from typing import Optional

from seaweedfs_tpu_torch import rpc
from seaweedfs_tpu_torch.filer.filerstore import split_path
from seaweedfs_tpu_torch.pb import filer_pb2, filer_stub


class ReplicationSink:
    def create_entry(self, path: str, entry: filer_pb2.Entry,
                     data: Optional[bytes]) -> None:
        raise NotImplementedError

    def update_entry(self, path: str, entry: filer_pb2.Entry,
                     data: Optional[bytes]) -> None:
        self.create_entry(path, entry, data)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        raise NotImplementedError


class FilerSink(ReplicationSink):
    """Replicate into another filer cluster: bytes via its HTTP path
    (re-chunked there), directories/deletes via its RPCs. Writes are marked
    from-other-cluster so filer.sync doesn't bounce them back."""

    def __init__(self, filer_url: str, path_prefix: str = "/"):
        self.filer_url = filer_url
        self.prefix = path_prefix.rstrip("/")

    @property
    def stub(self):
        return filer_stub(self.filer_url)

    def _target(self, path: str) -> str:
        return f"{self.prefix}{path}" if self.prefix else path

    def create_entry(self, path, entry, data):
        target = self._target(path)
        d, n = split_path(target)
        e = filer_pb2.Entry(name=n, is_directory=entry.is_directory)
        e.attributes.CopyFrom(entry.attributes)
        if not entry.is_directory and data:
            # upload bytes as fresh chunks on the destination cluster;
            # the HTTP write path cannot carry is_from_other_cluster,
            # so going through the RPCs keeps filer.sync loop-free
            import time as _time
            from seaweedfs_tpu_torch.operation import operations
            a = self.stub.AssignVolume(filer_pb2.AssignVolumeRequest(
                count=1))
            if a.error:
                raise RuntimeError(f"sink assign: {a.error}")
            resp = operations.upload_data(f"{a.url}/{a.file_id}", data)
            e.chunks.add(file_id=a.file_id, size=len(data),
                         mtime=_time.time_ns(),
                         e_tag=resp.get("eTag", ""))
        self.stub.CreateEntry(filer_pb2.CreateEntryRequest(
            directory=d, entry=e, is_from_other_cluster=True))

    def delete_entry(self, path, is_directory):
        d, n = split_path(self._target(path))
        try:
            self.stub.DeleteEntry(filer_pb2.DeleteEntryRequest(
                directory=d, name=n, is_delete_data=True,
                is_recursive=is_directory, ignore_recursive_error=True,
                is_from_other_cluster=True))
        except rpc.RpcError:
            pass


class LocalSink(ReplicationSink):
    """Replicate into a local directory tree
    (reference sink/localsink)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _target(self, path: str) -> str:
        return os.path.join(self.root, path.lstrip("/"))

    def create_entry(self, path, entry, data):
        target = self._target(path)
        if entry.is_directory:
            os.makedirs(target, exist_ok=True)
            return
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
        with open(target, "wb") as f:
            f.write(data or b"")

    def delete_entry(self, path, is_directory):
        target = self._target(path)
        try:
            if is_directory:
                import shutil
                shutil.rmtree(target, ignore_errors=True)
            else:
                os.unlink(target)
        except OSError:
            pass


class ObjectStoreSink(ReplicationSink):
    """Replicate entries into any S3-compatible object store over real
    SigV4 REST (util/s3_client — no SDK needed).

    Covers the reference's cloud sink family
    (weed/replication/sink/{s3sink,gcssink,b2sink}): S3 itself, GCS via
    its XML interoperability endpoint (storage.googleapis.com + HMAC
    keys), and Backblaze B2 via its S3-compatible endpoint
    (s3.<region>.backblazeb2.com). One implementation, three targets —
    the wire protocol is the same.
    """

    def __init__(self, endpoint: str, bucket: str, access_key: str = "",
                 secret_key: str = "", directory: str = "",
                 region: str = "us-east-1"):
        from seaweedfs_tpu_torch.util.s3_client import S3Client
        self.client = S3Client(endpoint, access_key, secret_key,
                               region=region)
        self.bucket = bucket
        self.prefix = directory.strip("/")

    def _key(self, path: str) -> str:
        key = path.lstrip("/")
        return f"{self.prefix}/{key}" if self.prefix else key

    def create_entry(self, path, entry, data):
        if entry.is_directory:
            return  # object stores have no directories
        self.client.put_object(self.bucket, self._key(path), data or b"")

    def delete_entry(self, path, is_directory):
        # delete_object already treats 404 as success (converged);
        # anything else must surface so the replication loop retries
        # instead of silently orphaning objects in the target bucket
        if is_directory:
            for obj in self.client.list_objects(
                    self.bucket, prefix=self._key(path) + "/"):
                self.client.delete_object(self.bucket, obj["key"])
        else:
            self.client.delete_object(self.bucket, self._key(path))


class AzureSink(ReplicationSink):
    """Replicate entries into Azure Blob storage over real SharedKey
    REST (util/azure_client — no SDK needed; the auth is plain
    HMAC-SHA256 over a canonicalized request, the same class of client
    as the SigV4 ObjectStoreSink). Reference:
    weed/replication/sink/azuresink/azure_sink.go:20-100 — directories
    map to a trailing-slash marker key, deletes include snapshots.
    """

    def __init__(self, account_name: str, account_key: str,
                 container: str, directory: str = "",
                 endpoint: str = ""):
        from seaweedfs_tpu_torch.util.azure_client import AzureBlobClient
        self.client = AzureBlobClient(account_name, account_key,
                                      endpoint=endpoint or None)
        self.container = container
        self.prefix = directory.strip("/")

    def _key(self, path: str) -> str:
        key = path.lstrip("/")
        return f"{self.prefix}/{key}" if self.prefix else key

    def create_entry(self, path, entry, data):
        if entry.is_directory:
            return  # blob stores have no directories
        self.client.put_blob(self.container, self._key(path), data or b"")

    def delete_entry(self, path, is_directory):
        if is_directory:
            for name in self.client.list_blobs(
                    self.container, prefix=self._key(path) + "/"):
                self.client.delete_blob(self.container, name)
        else:
            self.client.delete_blob(self.container, self._key(path))


SINK_FACTORIES = {
    "filer": FilerSink,
    "local": LocalSink,
    "s3": ObjectStoreSink,
    "gcs": ObjectStoreSink,   # GCS XML interop endpoint + HMAC keys
    "b2": ObjectStoreSink,    # B2 S3-compatible endpoint
    "azure": AzureSink,
}


# scaffold-key -> constructor-kwarg translation per sink kind, so the
# shipped replication.toml sections construct directly
_PROP_ALIASES = {
    "local": {"directory": "root"},
    "filer": {"grpcAddress": "filer_url", "address": "filer_url",
              "directory": "path_prefix"},
}
_PROP_DROP = {"filer": {"replication"}}


def make_sink(kind: str, **props) -> ReplicationSink:
    """Build a sink from replication.toml-style [sink.<kind>] props
    (reference replication/sink registry). Scaffold key names are
    translated to constructor kwargs."""
    factory = SINK_FACTORIES.get(kind)
    if factory is None:
        raise ValueError(f"unknown replication sink {kind!r}; "
                         f"have {sorted(SINK_FACTORIES)}")
    aliases = _PROP_ALIASES.get(kind, {})
    drop = _PROP_DROP.get(kind, set())
    kwargs = {aliases.get(k, k): v for k, v in props.items()
              if k not in drop}
    return factory(**kwargs)
