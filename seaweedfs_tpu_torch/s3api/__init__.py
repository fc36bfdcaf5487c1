"""S3-compatible gateway over the filer (reference: weed/s3api); the
port of ``seaweedfs_tpu.s3api``."""

from seaweedfs_tpu_torch.s3api.server import S3ApiServer  # noqa: F401
from seaweedfs_tpu_torch.s3api.auth import Iam, Identity, Credential  # noqa: F401
