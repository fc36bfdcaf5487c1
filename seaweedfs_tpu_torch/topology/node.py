"""The DataCenter -> Rack -> DataNode tree.

Reference: weed/topology/node.go, data_center.go, rack.go,
data_node.go, data_node_ec.go. Capacity accounting is recomputed from
the children on demand instead of incrementally adjusted — cluster
sizes (thousands of nodes) make O(children) walks cheap and remove the
reference's careful up-the-tree delta propagation.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from seaweedfs_tpu_torch.ec.shard_bits import ShardBits, TOTAL_SHARDS


class VolumeInfo:
    """The master's record of one volume replica on one node
    (a plain-data mirror of Store.volume_info)."""

    __slots__ = ("id", "collection", "size", "file_count", "delete_count",
                 "deleted_byte_count", "read_only", "replica_placement",
                 "ttl", "version", "modified_at_second")

    def __init__(self, id: int, collection: str = "", size: int = 0,
                 file_count: int = 0, delete_count: int = 0,
                 deleted_byte_count: int = 0, read_only: bool = False,
                 replica_placement: int = 0, ttl: str = "", version: int = 3,
                 modified_at_second: int = 0,
                 **_ignored):
        self.id = id
        self.collection = collection
        self.size = size
        self.file_count = file_count
        self.delete_count = delete_count
        self.deleted_byte_count = deleted_byte_count
        self.read_only = read_only
        self.replica_placement = replica_placement
        self.ttl = ttl
        self.version = version
        self.modified_at_second = modified_at_second

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class DataNode:
    def __init__(self, node_id: str, ip: str, port: int,
                 public_url: str = "", max_volumes: int = 8):
        self.id = node_id
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.max_volumes = max_volumes
        self.volumes: Dict[int, VolumeInfo] = {}
        self.ec_shards: Dict[int, ShardBits] = {}  # vid -> mounted shards
        self.ec_collections: Dict[int, str] = {}
        # vid -> (reads_window, ewma) from the heartbeat heat payload
        # (empty unless the server runs -heat.track)
        self.heat: Dict[int, tuple] = {}
        self.rack: Optional["Rack"] = None
        self.last_seen = time.time()

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def volume_count(self) -> int:
        return len(self.volumes)

    @property
    def ec_shard_count(self) -> int:
        return sum(b.count for b in self.ec_shards.values())

    def free_slots(self) -> int:
        # EC shards consume slot capacity at shard granularity
        # (14 shards ~ 1.4 volumes of space but bookkept conservatively
        # as shards/total like the reference's slot math)
        used = self.volume_count + (
            self.ec_shard_count + TOTAL_SHARDS - 1) // TOTAL_SHARDS
        return max(0, self.max_volumes - used)

    def update_volumes(self, infos: List[dict]) -> tuple:
        """Full sync from a heartbeat; returns (new, deleted) VolumeInfos."""
        incoming = {int(i["id"]): VolumeInfo(**{**i, "id": int(i["id"])})
                    for i in infos}
        new = [v for vid, v in incoming.items() if vid not in self.volumes]
        deleted = [v for vid, v in self.volumes.items() if vid not in incoming]
        self.volumes = incoming
        self.last_seen = time.time()
        return new, deleted

    def update_heat(self, infos: List[dict]) -> bool:
        """Full sync of the heartbeat heat payload: the node's view is
        replaced wholesale, so a vid the server forgot (deleted volume,
        EC conversion) drops out of the cluster heat map on the very
        next pulse instead of freezing at its last value. Returns True
        when the VID SET changed — gauge children read values through
        scrape-time callables, so only membership changes need the
        (cluster-wide) gauge registry resync."""
        incoming = {int(h["id"]): (float(h.get("reads_window", 0)),
                                   float(h.get("ewma", 0.0)))
                    for h in infos}
        changed = incoming.keys() != self.heat.keys()
        self.heat = incoming
        return changed

    def update_ec_shards(self, infos: List[dict]) -> tuple:
        """Full sync of EC shard bits; returns (new, deleted) as
        (vid, ShardBits) pairs."""
        incoming: Dict[int, ShardBits] = {}
        collections: Dict[int, str] = {}
        for i in infos:
            vid = int(i["id"])
            bits = i["ec_index_bits"]
            if not isinstance(bits, ShardBits):
                bits = ShardBits(int(bits))
            incoming[vid] = bits
            collections[vid] = i.get("collection", "")
        new, deleted = [], []
        for vid, bits in incoming.items():
            prev = self.ec_shards.get(vid, ShardBits(0))
            gained = bits.minus(prev)
            if gained.count:
                new.append((vid, gained))
        for vid, prev in self.ec_shards.items():
            lost = prev.minus(incoming.get(vid, ShardBits(0)))
            if lost.count:
                deleted.append((vid, lost))
        self.ec_shards = incoming
        self.ec_collections = collections
        return new, deleted


class Rack:
    def __init__(self, rack_id: str):
        self.id = rack_id
        self.nodes: Dict[str, DataNode] = {}
        self.data_center: Optional["DataCenter"] = None

    def get_or_create_node(self, node_id: str, ip: str, port: int,
                           public_url: str = "",
                           max_volumes: int = 8) -> DataNode:
        dn = self.nodes.get(node_id)
        if dn is None:
            dn = DataNode(node_id, ip, port, public_url, max_volumes)
            dn.rack = self
            self.nodes[node_id] = dn
        dn.max_volumes = max_volumes or dn.max_volumes
        return dn

    def free_slots(self) -> int:
        return sum(n.free_slots() for n in self.nodes.values())


class DataCenter:
    def __init__(self, dc_id: str):
        self.id = dc_id
        self.racks: Dict[str, Rack] = {}

    def get_or_create_rack(self, rack_id: str) -> Rack:
        r = self.racks.get(rack_id)
        if r is None:
            r = Rack(rack_id)
            r.data_center = self
            self.racks[rack_id] = r
        return r

    def free_slots(self) -> int:
        return sum(r.free_slots() for r in self.racks.values())

    def nodes(self) -> List[DataNode]:
        return [n for r in self.racks.values() for n in r.nodes.values()]
