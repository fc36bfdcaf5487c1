"""Image post-processing on the volume read path, the counterpart of
``seaweedfs_tpu.images`` (reference weed/images/resizing.go +
orientation.go, hooked at server/volume_server_handlers_read.go:219-243).
Both functions need PIL and return the stored bytes without it, as the
JAX package does."""

from seaweedfs_tpu_torch.images.resizing import resized  # noqa: F401
from seaweedfs_tpu_torch.images.orientation import (  # noqa: F401
    fix_orientation)
