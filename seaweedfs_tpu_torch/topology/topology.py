"""Topology: the master's root object.

Heartbeat ingest, vid -> locations lookup (normal + EC), layout
bookkeeping, write assignment, dead-node reaping.

Reference: weed/topology/topology.go, topology_ec.go, and the
heartbeat handler server/master_grpc_server.go:20-176.
"""

from __future__ import annotations

import random
import threading
import weakref
from typing import Dict, List, Optional, Tuple

from seaweedfs_tpu_torch.ec.shard_bits import ShardBits
from seaweedfs_tpu_torch.storage.superblock import ReplicaPlacement
from seaweedfs_tpu_torch.topology.node import DataCenter, DataNode, VolumeInfo
from seaweedfs_tpu_torch.topology.sequence import MemorySequencer
from seaweedfs_tpu_torch.topology.volume_layout import VolumeLayout

# Topologies that have ever seen heartbeat heat, for the
# SeaweedFS_cluster_volume_heat{vid} gauge: children read through a
# weak set at scrape time (the stats/heat.py pattern) so a stopped
# master's topology is collectable and two in-process masters SUM
# rather than clobber. Registration happens only on heartbeats that
# carry heat, so heat-disabled clusters never touch any of this.
_HEAT_TOPOS: "weakref.WeakSet[Topology]" = weakref.WeakSet()
_heat_registered: set = set()  # guarded_by(_heat_reg_lock)
_heat_reg_lock = threading.Lock()


def _cluster_vid_heat(vid: int) -> float:
    total = 0.0
    for t in list(_HEAT_TOPOS):
        for n in t.nodes():
            h = n.heat.get(vid)
            if h is not None:
                total += h[0]
    return total


def _sync_cluster_heat_gauge(topo: "Topology") -> None:
    """Register gauge children for newly-heated vids and drop children
    for vids no longer reported anywhere — label hygiene at the
    cluster aggregate, mirroring HeatTracker.forget server-side."""
    from seaweedfs_tpu_torch.stats.metrics import ClusterVolumeHeatGauge
    _HEAT_TOPOS.add(topo)
    live = {vid for t in list(_HEAT_TOPOS)
            for n in t.nodes() for vid in n.heat}
    with _heat_reg_lock:
        for vid in live - _heat_registered:
            ClusterVolumeHeatGauge.labels(str(vid)).set_function(
                lambda vid=vid: _cluster_vid_heat(vid))
        for vid in _heat_registered - live:
            ClusterVolumeHeatGauge.remove(str(vid))
        _heat_registered.clear()
        _heat_registered.update(live)


def _layout_key(info: VolumeInfo) -> tuple:
    return info.collection, info.replica_placement, info.ttl


class Topology:
    def __init__(self, volume_size_limit: int = 30 << 30,
                 sequencer: Optional[MemorySequencer] = None,
                 pulse_seconds: float = 5.0):
        self.volume_size_limit = volume_size_limit
        self.sequence = sequencer or MemorySequencer()
        self.pulse_seconds = pulse_seconds
        self.data_centers: Dict[str, DataCenter] = {}
        # (collection, replica_byte, ttl) -> VolumeLayout
        self.layouts: Dict[Tuple[str, int, str], VolumeLayout] = {}
        self.ec_locations: Dict[int, Dict[str, ShardBits]] = {}  # vid -> url -> bits
        self.ec_collections: Dict[int, str] = {}
        # url -> node; membership changes take the lock, point reads
        # (nodes()/find_node snapshots) are GIL-atomic and may be stale
        self._nodes: Dict[str, DataNode] = {}  # guarded_by(self._lock, writes)
        self._lock = threading.RLock()
        self.next_volume_id = 1

    # -- tree ---------------------------------------------------------------

    def get_or_create_dc(self, dc_id: str) -> DataCenter:
        dc = self.data_centers.get(dc_id)
        if dc is None:
            dc = DataCenter(dc_id)
            self.data_centers[dc_id] = dc
        return dc

    def nodes(self) -> List[DataNode]:
        return list(self._nodes.values())

    def find_node(self, url: str) -> Optional[DataNode]:
        return self._nodes.get(url)

    def free_slots(self) -> int:
        return sum(dc.free_slots() for dc in self.data_centers.values())

    # -- layouts ------------------------------------------------------------

    def layout_for(self, collection: str, replica_byte: int,
                   ttl: str = "") -> VolumeLayout:
        with self._lock:
            key = (collection, replica_byte, ttl)
            vl = self.layouts.get(key)
            if vl is None:
                rp = ReplicaPlacement.from_byte(replica_byte)
                vl = VolumeLayout(replica_count=rp.copy_count, ttl=ttl,
                                  volume_size_limit=self.volume_size_limit)
                self.layouts[key] = vl
            return vl

    # -- heartbeat ingest ----------------------------------------------------

    def sync_heartbeat(self, hb: dict, dc: str = "DefaultDataCenter",
                       rack: str = "DefaultRack") -> DataNode:
        """Full-state heartbeat from one volume server (dict shaped like
        Store.collect_heartbeat)."""
        with self._lock:
            url = f"{hb['ip']}:{hb['port']}"
            node = self._nodes.get(url)
            if node is None:
                node = self.get_or_create_dc(dc).get_or_create_rack(rack) \
                    .get_or_create_node(
                        url, hb["ip"], hb["port"],
                        hb.get("public_url", ""),
                        hb.get("max_volume_count", 8))
                self._nodes[url] = node
            node.max_volumes = hb.get("max_volume_count", node.max_volumes)
            self.sequence.set_max(hb.get("max_file_key", 0))

            before = dict(node.volumes)
            _, deleted = node.update_volumes(hb.get("volumes", []))
            # a volume whose collection, placement or ttl changed (shell
            # volume.configure.replication) leaves its old layout, which
            # would otherwise go on answering lookups with the old
            # replica set
            deleted += [old for vid, old in before.items()
                        if vid in node.volumes and
                        _layout_key(old) != _layout_key(node.volumes[vid])]
            # re-register every current volume: register() is the
            # idempotent state sync (size growth past the limit, a
            # read_only flip, etc. must reach the layout every pulse)
            for v in node.volumes.values():
                self.register_volume(v, node)
            for v in deleted:
                self.unregister_volume(v, node)
            self._sync_ec(node, hb.get("ec_shards", []))
            heats = hb.get("volume_heats")
            if heats is not None or node.heat:
                # one dict-key check per pulse when heat is disabled;
                # the `or node.heat` arm clears a node whose operator
                # turned -heat.track off mid-flight. The gauge-registry
                # resync runs only when this node's heat MEMBERSHIP
                # changed — values flow through scrape-time callables
                if node.update_heat(heats or []):
                    _sync_cluster_heat_gauge(self)
            return node

    def register_volume(self, info: VolumeInfo, dn: DataNode) -> None:
        with self._lock:
            if info.id >= self.next_volume_id:
                self.next_volume_id = info.id + 1
            self.layout_for(info.collection, info.replica_placement,
                            info.ttl).register(info, dn)

    def unregister_volume(self, info: VolumeInfo, dn: DataNode) -> None:
        with self._lock:
            self.layout_for(info.collection, info.replica_placement,
                            info.ttl).unregister(info.id, dn)

    def _sync_ec(self, node: DataNode, infos: List[dict]) -> None:
        """Replace this node's shard locations with its heartbeat's."""
        node.update_ec_shards(infos)
        for vid, by_url in list(self.ec_locations.items()):
            by_url.pop(node.url, None)
        for vid, bits in node.ec_shards.items():
            self.ec_locations.setdefault(vid, {})[node.url] = bits
            self.ec_collections[vid] = node.ec_collections.get(vid, "")
        self.ec_locations = {vid: by_url for vid, by_url
                             in self.ec_locations.items() if by_url}
        self.ec_collections = {vid: col for vid, col
                               in self.ec_collections.items()
                               if vid in self.ec_locations}

    def unregister_node(self, url: str) -> None:
        """Heartbeat stream broke: drop the node and its volumes
        (reference master_grpc_server.go:22-50)."""
        with self._lock:
            node = self._nodes.pop(url, None)
            if node is None:
                return
            for info in node.volumes.values():
                self.unregister_volume(info, node)
            for vid in list(node.ec_shards):
                by_url = self.ec_locations.get(vid)
                if by_url:
                    by_url.pop(url, None)
                    if not by_url:
                        self.ec_locations.pop(vid, None)
                        self.ec_collections.pop(vid, None)
            if node.rack is not None:
                node.rack.nodes.pop(node.id, None)
            if node.heat:
                node.heat = {}
                _sync_cluster_heat_gauge(self)

    # -- lookup / assign ------------------------------------------------------

    def lookup(self, vid: int, collection: str = "") -> List[DataNode]:
        """vid -> replica locations (normal volumes)."""
        with self._lock:
            for (col, _, _), vl in self.layouts.items():
                if collection and col != collection:
                    continue
                locs = vl.lookup(vid)
                if locs:
                    return locs
            return []

    def lookup_ec(self, vid: int) -> Dict[str, ShardBits]:
        with self._lock:
            return dict(self.ec_locations.get(vid, {}))

    # -- cluster heat map ----------------------------------------------------

    def cluster_heat(self) -> Dict[int, dict]:
        """vid -> {reads_window, ewma, servers}: the live cluster heat
        map summed over every node's heartbeat heat payload — what the
        lifecycle policy engine (and `cluster.heat`) decides from."""
        with self._lock:
            out: Dict[int, dict] = {}
            for n in self._nodes.values():
                for vid, (window, ewma) in n.heat.items():
                    rec = out.setdefault(
                        vid, {"reads_window": 0.0, "ewma": 0.0,
                              "servers": []})
                    rec["reads_window"] += window
                    rec["ewma"] += ewma
                    rec["servers"].append(n.url)
            return out

    def has_writable(self, collection: str, replica_byte: int,
                     ttl: str = "") -> bool:
        return self.layout_for(
            collection, replica_byte, ttl).writable_count > 0

    def pick_for_write(self, count: int = 1, collection: str = "",
                       replica_byte: int = 0, ttl: str = ""):
        """Assign a file id: (fid, count, DataNode list) or None.

        fid format mirrors the reference: "<vid>,<key_hex><cookie_hex8>".
        """
        vl = self.layout_for(collection, replica_byte, ttl)
        picked = vl.pick_for_write()
        if picked is None:
            return None
        vid, locs = picked
        key = self.sequence.next_batch(count)
        cookie = random.getrandbits(32)
        fid = f"{vid},{key:x}{cookie:08x}"
        return fid, count, locs

    def reserve_volume_ids(self, count: int) -> List[int]:
        with self._lock:
            first = self.next_volume_id
            self.next_volume_id += count
            return list(range(first, first + count))

    def adjust_max_volume_id(self, vid: int) -> None:
        """Raise the next-volume-id floor (raft MaxVolumeId command
        replay; reference topology.go UpAdjustMaxVolumeId)."""
        with self._lock:
            if vid >= self.next_volume_id:
                self.next_volume_id = vid + 1

    # -- map output -----------------------------------------------------------

    def to_map(self) -> dict:
        """Topology snapshot as plain data (the UI/shell view; the house
        test pattern fabricates these)."""
        with self._lock:
            return {
                "max_volume_count": sum(
                    n.max_volumes for n in self._nodes.values()),
                "free_slots": self.free_slots(),
                "data_centers": [{
                    "id": dc.id,
                    "racks": [{
                        "id": r.id,
                        "nodes": [{
                            "url": n.url,
                            "public_url": n.public_url,
                            "volumes": [v.to_dict()
                                        for v in n.volumes.values()],
                            "ec_shards": [{
                                "id": vid,
                                "collection":
                                    n.ec_collections.get(vid, ""),
                                "ec_index_bits": int(bits),
                            } for vid, bits in n.ec_shards.items()],
                            "max_volumes": n.max_volumes,
                        } for n in r.nodes.values()],
                    } for r in dc.racks.values()],
                } for dc in self.data_centers.values()],
            }
