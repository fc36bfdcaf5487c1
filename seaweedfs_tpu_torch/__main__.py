"""Entry point: ``python -m seaweedfs_tpu_torch <command>``."""

import sys

from seaweedfs_tpu_torch.command import main

if __name__ == "__main__":
    sys.exit(main())
