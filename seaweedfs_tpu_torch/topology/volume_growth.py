"""VolumeGrowth: choose the servers for a new volume's replicas under the
xyz replica placement (x copies in other data centers, y in other racks
of the same data center, z on other servers of the same rack).

The port of ``seaweedfs_tpu.topology.volume_growth`` (reference
weed/topology/volume_growth.go:70-240): candidate filtering and random
sampling over nodes with free slots. The port draws from an explicit
``random.Random`` where the JAX package uses the ``random`` module, so
the same seed picks the same nodes in both.
"""

from __future__ import annotations

import random
from typing import List, Optional

from seaweedfs_tpu_torch.storage.superblock import ReplicaPlacement
from seaweedfs_tpu_torch.topology.node import DataNode


def growth_count(copy_count: int) -> int:
    """Volumes grown per request, by total copy count (reference
    volume_growth.go:30-45: more copies, fewer volumes at once)."""
    return {1: 7, 2: 6, 3: 3}.get(copy_count, 1)


class NoFreeSlots(Exception):
    pass


class VolumeGrowth:
    def __init__(self, topology, rng: Optional[random.Random] = None):
        self.topo = topology
        self.rng = rng or random.Random()

    def find_empty_slots(self, rp: ReplicaPlacement,
                         data_center: str = "") -> List[DataNode]:
        """copy_count nodes that satisfy the placement: the main rack's
        1 + same_rack nodes first, then one node in each of diff_rack
        other racks of that data center, then one in each of diff_dc
        other data centers (findEmptySlotsForOneVolume)."""
        dcs = list(self.topo.data_centers.values())
        if data_center:
            dcs = [dc for dc in dcs if dc.id == data_center]
        self.rng.shuffle(dcs)
        for dc in dcs:
            picked = self._try_dc(dc, rp)
            if picked is not None:
                return picked
        raise NoFreeSlots(
            f"no placement for {rp}: not enough free slots spread over "
            f"{'dc ' + data_center if data_center else 'the cluster'}")

    def _try_dc(self, dc, rp: ReplicaPlacement) -> Optional[List[DataNode]]:
        rng = self.rng
        racks = [r for r in dc.racks.values() if r.free_slots() > 0]
        rng.shuffle(racks)
        for main_rack in racks:
            nodes = [n for n in main_rack.nodes.values()
                     if n.free_slots() > 0]
            if len(nodes) < 1 + rp.same_rack:
                continue
            main_nodes = rng.sample(nodes, 1 + rp.same_rack)
            other_racks = [r for r in racks if r is not main_rack]
            if len(other_racks) < rp.diff_rack:
                continue
            rack_nodes = []
            for r in rng.sample(other_racks, rp.diff_rack):
                cands = [n for n in r.nodes.values() if n.free_slots() > 0]
                if not cands:
                    break
                rack_nodes.append(rng.choice(cands))
            if len(rack_nodes) < rp.diff_rack:
                continue
            other_dcs = [d for d in self.topo.data_centers.values()
                         if d is not dc and d.free_slots() > 0]
            if len(other_dcs) < rp.diff_dc:
                continue
            dc_nodes = []
            for d in rng.sample(other_dcs, rp.diff_dc):
                cands = [n for n in d.nodes() if n.free_slots() > 0]
                if not cands:
                    break
                dc_nodes.append(rng.choice(cands))
            if len(dc_nodes) < rp.diff_dc:
                continue
            return main_nodes + rack_nodes + dc_nodes
        return None
