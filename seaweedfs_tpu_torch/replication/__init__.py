"""Replication of filer events to sinks (reference: weed/replication):
the port of ``seaweedfs_tpu.replication``. A ``Replicator`` turns one
metadata event into sink calls; ``FilerSource`` reads a file's bytes
through the source filer (whose degraded reads decode on the card);
``filer_sync`` tails a filer's metadata log into another, both ways."""

from seaweedfs_tpu_torch.replication.replicator import Replicator  # noqa: F401
from seaweedfs_tpu_torch.replication.sinks import (  # noqa: F401
    FilerSink, LocalSink, ReplicationSink,
)
from seaweedfs_tpu_torch.replication.source import FilerSource  # noqa: F401
