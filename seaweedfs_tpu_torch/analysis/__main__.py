import sys

from seaweedfs_tpu_torch.analysis import main

sys.exit(main())
