"""Cluster metadata: the master's in-memory view.

DataCenter -> Rack -> DataNode tree with capacity counters, per-
(collection, replication, ttl) volume layouts, volume growth, and the
file-id sequencer.

Reference: weed/topology (topology.go, volume_layout.go,
volume_growth.go), weed/sequence.
"""

from seaweedfs_tpu_torch.topology.node import DataNode, Rack, DataCenter
from seaweedfs_tpu_torch.topology.topology import Topology
from seaweedfs_tpu_torch.topology.volume_layout import VolumeLayout
from seaweedfs_tpu_torch.topology.sequence import MemorySequencer

__all__ = [
    "DataNode", "Rack", "DataCenter", "Topology", "VolumeLayout",
    "MemorySequencer",
]
