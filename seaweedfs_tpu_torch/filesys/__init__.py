"""Mount filesystem layer (reference: weed/filesys — bazil.org/fuse): the
port of ``seaweedfs_tpu.filesys``.

The filesystem logic (dirty-page write-back, meta cache, node
operations) is a plain library driven by ``Wfs``; ``fuse_shim`` binds it
to the kernel through libfuse 2.9 where libfuse and /dev/fuse exist.
"""

from seaweedfs_tpu_torch.filesys.dirty_pages import ContinuousIntervals  # noqa: F401
from seaweedfs_tpu_torch.filesys.wfs import Wfs, FileHandle  # noqa: F401
