"""Volume growth: choose the server for a new volume.

The port places replication ``000`` only (the master refuses every other
placement), so a new volume goes to one node with a free slot, picked at
random among those of the asked data center. The reference's xyz
placement (weed/topology/volume_growth.go:70-240) returns with
replication.
"""

from __future__ import annotations

import random

from seaweedfs_tpu_torch.topology.node import DataNode

# volumes grown per request for one copy (reference volume_growth.go:30-45)
GROWTH_COUNT = 7


class NoFreeSlots(Exception):
    pass


def pick_node(topo, data_center: str = "") -> DataNode:
    """One node with a free slot, in ``data_center`` when one is named."""
    nodes = [n for n in topo.nodes() if n.free_slots() > 0 and
             (not data_center or n.rack.data_center.id == data_center)]
    if not nodes:
        raise NoFreeSlots(
            f"no free volume slot in "
            f"{'dc ' + data_center if data_center else 'the cluster'}")
    return random.choice(nodes)
