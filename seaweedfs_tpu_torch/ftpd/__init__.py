"""FTP gateway over the filer (reference weed/ftpd — an 81-LoC
library-backed skeleton; here a small self-contained server). The port
of ``seaweedfs_tpu.ftpd``."""

from seaweedfs_tpu_torch.ftpd.server import FtpServer  # noqa: F401
