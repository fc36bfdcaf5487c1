"""proto <-> plain-dict bridges.

The in-memory model (topology, store heartbeats) speaks plain dicts —
the house test pattern fabricates those — so the wire layer converts at
the server boundary. Reference equivalent: the pb structs are used
directly throughout weed/topology; here the dict model predates the pb
layer and stays the source of truth.
"""

from __future__ import annotations

from typing import List

from seaweedfs_tpu_torch.pb import master_pb2
from seaweedfs_tpu_torch.storage.superblock import TTL


def ttl_to_int(ttl: str) -> int:
    return int.from_bytes(TTL.parse(ttl or "").to_bytes(), "big")


def ttl_from_int(v: int) -> str:
    return str(TTL.from_bytes(int(v).to_bytes(2, "big")))


def volume_info_to_pb(info: dict) -> master_pb2.VolumeInformationMessage:
    return master_pb2.VolumeInformationMessage(
        id=int(info["id"]),
        size=int(info.get("size", 0)),
        collection=info.get("collection", ""),
        file_count=int(info.get("file_count", 0)),
        delete_count=int(info.get("delete_count", 0)),
        deleted_byte_count=int(info.get("deleted_byte_count", 0)),
        read_only=bool(info.get("read_only", False)),
        replica_placement=int(info.get("replica_placement", 0)),
        version=int(info.get("version", 3)),
        ttl=ttl_to_int(info.get("ttl", "")),
        compact_revision=int(info.get("compact_revision", 0)),
        modified_at_second=int(info.get("modified_at_second", 0)))


def volume_info_from_pb(m: master_pb2.VolumeInformationMessage) -> dict:
    return {
        "id": m.id,
        "size": m.size,
        "collection": m.collection,
        "file_count": m.file_count,
        "delete_count": m.delete_count,
        "deleted_byte_count": m.deleted_byte_count,
        "read_only": m.read_only,
        "replica_placement": m.replica_placement,
        "version": m.version or 3,
        "ttl": ttl_from_int(m.ttl),
        "modified_at_second": m.modified_at_second,
    }


def ec_info_to_pb(info: dict) -> master_pb2.VolumeEcShardInformationMessage:
    return master_pb2.VolumeEcShardInformationMessage(
        id=int(info["id"]),
        collection=info.get("collection", ""),
        ec_index_bits=int(info["ec_index_bits"]))


def ec_info_from_pb(m) -> dict:
    return {"id": m.id, "collection": m.collection,
            "ec_index_bits": m.ec_index_bits}


def heartbeat_from_pb(hb: master_pb2.Heartbeat) -> dict:
    d = {
        "ip": hb.ip,
        "port": hb.port,
        "public_url": hb.public_url,
        "max_volume_count": hb.max_volume_count,
        "max_file_key": hb.max_file_key,
        "volumes": [volume_info_from_pb(v) for v in hb.volumes],
        "ec_shards": [ec_info_from_pb(e) for e in hb.ec_shards],
    }
    if hb.volume_heats:
        d["volume_heats"] = [
            {"id": h.id, "reads_window": h.reads_window, "ewma": h.ewma}
            for h in hb.volume_heats]
    return d


def heartbeat_to_pb(hb: dict, data_center: str = "",
                    rack: str = "") -> master_pb2.Heartbeat:
    # volume_heats stays absent unless -heat.track populated it: a
    # heat-disabled server's heartbeat serializes byte-identically to
    # the heat-less wire format
    return master_pb2.Heartbeat(
        ip=hb["ip"],
        port=hb["port"],
        public_url=hb.get("public_url", ""),
        max_volume_count=hb.get("max_volume_count", 0),
        max_file_key=hb.get("max_file_key", 0),
        data_center=data_center,
        rack=rack,
        volumes=[volume_info_to_pb(v) for v in hb.get("volumes", [])],
        ec_shards=[ec_info_to_pb(e) for e in hb.get("ec_shards", [])],
        volume_heats=[master_pb2.VolumeHeatMessage(
            id=int(h["id"]),
            reads_window=int(h.get("reads_window", 0)),
            ewma=float(h.get("ewma", 0.0)))
            for h in hb.get("volume_heats", [])])


def topology_to_pb(topo_map: dict) -> master_pb2.TopologyInfo:
    """Topology.to_map() -> TopologyInfo proto (the shell's working view;
    reference weed/topology/topology_map.go)."""
    dcs: List[master_pb2.DataCenterInfo] = []
    for dc in topo_map.get("data_centers", []):
        racks = []
        for r in dc.get("racks", []):
            dns = []
            for n in r.get("nodes", []):
                vol_infos = [volume_info_to_pb(v) for v in n.get("volumes", [])]
                ec_infos = [ec_info_to_pb(e) for e in n.get("ec_shards", [])]
                dns.append(master_pb2.DataNodeInfo(
                    id=n["url"],
                    volume_count=len(vol_infos),
                    max_volume_count=n.get("max_volumes", 0),
                    free_volume_count=max(
                        0, n.get("max_volumes", 0) - len(vol_infos)),
                    active_volume_count=len(vol_infos),
                    volume_infos=vol_infos,
                    ec_shard_infos=ec_infos))
            racks.append(master_pb2.RackInfo(
                id=r["id"],
                volume_count=sum(d.volume_count for d in dns),
                max_volume_count=sum(d.max_volume_count for d in dns),
                free_volume_count=sum(d.free_volume_count for d in dns),
                data_node_infos=dns))
        dcs.append(master_pb2.DataCenterInfo(
            id=dc["id"],
            volume_count=sum(r.volume_count for r in racks),
            max_volume_count=sum(r.max_volume_count for r in racks),
            free_volume_count=sum(r.free_volume_count for r in racks),
            rack_infos=racks))
    return master_pb2.TopologyInfo(
        id="topo",
        volume_count=sum(d.volume_count for d in dcs),
        max_volume_count=sum(d.max_volume_count for d in dcs),
        free_volume_count=sum(d.free_volume_count for d in dcs),
        data_center_infos=dcs)
