"""S3-compatible cloud-tier backend for sealed volume .dat files.

Reference parity: weed/storage/backend/s3_backend/s3_backend.go:23-100
(upload/download a volume .dat to S3, ranged reads for the tiered read
path), as ``seaweedfs_tpu.storage.backend_s3``. Uses the stdlib SigV4
client (util/s3_client.py) instead of an
AWS SDK, so it works against any S3-compatible endpoint — including
this package's own s3api gateway (which the tests use as the server).

Config (reference master.toml [storage.backend.s3.default]):
    endpoint, access_key, secret_key, bucket, region.
"""

from __future__ import annotations

from seaweedfs_tpu_torch.storage import backend as bk
from seaweedfs_tpu_torch.util.s3_client import S3Client, S3Error


class S3BackendStorage(bk.BackendStorage):
    def __init__(self, name: str, props: dict):
        self.name = name
        missing = [k for k in ("endpoint", "bucket") if not props.get(k)]
        if missing:
            raise bk.BackendError(
                f"backend {name}: missing config {missing}")
        self.bucket = props["bucket"]
        self.client = S3Client(
            props["endpoint"],
            access_key=props.get("access_key", ""),
            secret_key=props.get("secret_key", ""),
            region=props.get("region", "us-east-1"))

    def copy_file(self, local_path, key, progress=None):
        try:
            return self.client.upload_file(local_path, self.bucket, key,
                                           progress=progress)
        except S3Error as e:
            raise bk.BackendError(f"{self.name}: upload {key}: {e}") from e

    def download_file(self, key, local_path, progress=None):
        try:
            return self.client.download_file(self.bucket, key, local_path,
                                             progress=progress)
        except S3Error as e:
            raise bk.BackendError(f"{self.name}: download {key}: {e}") from e

    def read_range(self, key, offset, length):
        if length <= 0:
            return b""
        try:
            return self.client.get_object(
                self.bucket, key, byte_range=(offset, offset + length - 1))
        except S3Error as e:
            raise bk.BackendError(f"{self.name}: read {key}: {e}") from e

    def delete_file(self, key):
        try:
            self.client.delete_object(self.bucket, key)
        except S3Error as e:
            raise bk.BackendError(f"{self.name}: delete {key}: {e}") from e


bk.register_backend_factory(
    "s3", lambda name, props: S3BackendStorage(name, props))
