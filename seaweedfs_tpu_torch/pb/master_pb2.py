"""``master_pb`` messages and the ``Seaweed`` service, as far as the port's
cluster path uses them.

Field names, numbers and kinds are those of
``seaweedfs_tpu/pb/proto/master.proto`` (its generated ``master_pb2``
descriptors are the reference a test holds this table against); the wire
runtime is ``pb/wire.py``.
"""

from seaweedfs_tpu_torch.pb.wire import REPEATED, SINGLE, message, resolve

PACKAGE = "master_pb"

# -- heartbeat -----------------------------------------------------------------

Heartbeat = message("Heartbeat", [
    ("ip", 1, "string"),
    ("port", 2, "uint32"),
    ("public_url", 3, "string"),
    ("max_volume_count", 4, "uint32"),
    ("max_file_key", 5, "uint64"),
    ("data_center", 6, "string"),
    ("rack", 7, "string"),
    ("admin_port", 8, "uint32"),
    ("volumes", 9, "message", REPEATED, "VolumeInformationMessage"),
    ("new_volumes", 10, "message", REPEATED,
     "VolumeShortInformationMessage"),
    ("deleted_volumes", 11, "message", REPEATED,
     "VolumeShortInformationMessage"),
    ("has_no_volumes", 12, "bool"),
    ("ec_shards", 13, "message", REPEATED,
     "VolumeEcShardInformationMessage"),
    ("new_ec_shards", 14, "message", REPEATED,
     "VolumeEcShardInformationMessage"),
    ("deleted_ec_shards", 15, "message", REPEATED,
     "VolumeEcShardInformationMessage"),
    ("has_no_ec_shards", 16, "bool"),
    ("volume_heats", 17, "message", REPEATED, "VolumeHeatMessage"),
])

VolumeHeatMessage = message("VolumeHeatMessage", [
    ("id", 1, "uint32"),
    ("reads_window", 2, "uint64"),
    ("ewma", 3, "float"),
])

HeartbeatResponse = message("HeartbeatResponse", [
    ("volume_size_limit", 1, "uint64"),
    ("leader", 2, "string"),
    ("metrics_address", 3, "string"),
    ("metrics_interval_seconds", 4, "uint32"),
])

VolumeInformationMessage = message("VolumeInformationMessage", [
    ("id", 1, "uint32"),
    ("size", 2, "uint64"),
    ("collection", 3, "string"),
    ("file_count", 4, "uint64"),
    ("delete_count", 5, "uint64"),
    ("deleted_byte_count", 6, "uint64"),
    ("read_only", 7, "bool"),
    ("replica_placement", 8, "uint32"),
    ("version", 9, "uint32"),
    ("ttl", 10, "uint32"),
    ("compact_revision", 11, "uint32"),
    ("modified_at_second", 12, "int64"),
])

VolumeShortInformationMessage = message("VolumeShortInformationMessage", [
    ("id", 1, "uint32"),
    ("collection", 3, "string"),
    ("replica_placement", 8, "uint32"),
    ("version", 9, "uint32"),
    ("ttl", 10, "uint32"),
])

VolumeEcShardInformationMessage = message(
    "VolumeEcShardInformationMessage", [
        ("id", 1, "uint32"),
        ("collection", 2, "string"),
        ("ec_index_bits", 3, "uint32"),
    ])

# -- client cache feed ---------------------------------------------------------

KeepConnectedRequest = message("KeepConnectedRequest", [
    ("name", 1, "string"),
    ("grpc_port", 2, "uint32"),
])

VolumeLocation = message("VolumeLocation", [
    ("url", 1, "string"),
    ("public_url", 2, "string"),
    ("new_vids", 3, "uint32", REPEATED),
    ("deleted_vids", 4, "uint32", REPEATED),
    ("leader", 5, "string"),
])

# -- lookup / assign -----------------------------------------------------------

LookupVolumeRequest = message("LookupVolumeRequest", [
    ("volume_ids", 1, "string", REPEATED),
    ("collection", 2, "string"),
])

Location = message("Location", [
    ("url", 1, "string"),
    ("public_url", 2, "string"),
])

LookupVolumeResponse = message("LookupVolumeResponse", [
    ("volume_id_locations", 1, "message", REPEATED, "VolumeIdLocation"),
])
LookupVolumeResponse.VolumeIdLocation = message("VolumeIdLocation", [
    ("volume_id", 1, "string"),
    ("locations", 2, "message", REPEATED, "Location"),
    ("error", 3, "string"),
])

AssignRequest = message("AssignRequest", [
    ("count", 1, "uint64"),
    ("replication", 2, "string"),
    ("collection", 3, "string"),
    ("ttl", 4, "string"),
    ("data_center", 5, "string"),
    ("rack", 6, "string"),
    ("data_node", 7, "string"),
    ("writable_volume_count", 8, "uint32"),
])

AssignResponse = message("AssignResponse", [
    ("fid", 1, "string"),
    ("url", 2, "string"),
    ("public_url", 3, "string"),
    ("count", 4, "uint64"),
    ("error", 5, "string"),
    ("auth", 6, "string"),
])

# -- topology dump (the shell's working view) ----------------------------------

_COUNTS = [
    ("id", 1, "string"),
    ("volume_count", 2, "uint64"),
    ("max_volume_count", 3, "uint64"),
    ("free_volume_count", 4, "uint64"),
    ("active_volume_count", 5, "uint64"),
]

DataNodeInfo = message("DataNodeInfo", _COUNTS + [
    ("volume_infos", 6, "message", REPEATED, "VolumeInformationMessage"),
    ("ec_shard_infos", 7, "message", REPEATED,
     "VolumeEcShardInformationMessage"),
])

RackInfo = message("RackInfo", _COUNTS + [
    ("data_node_infos", 6, "message", REPEATED, "DataNodeInfo"),
])

DataCenterInfo = message("DataCenterInfo", _COUNTS + [
    ("rack_infos", 6, "message", REPEATED, "RackInfo"),
])

TopologyInfo = message("TopologyInfo", _COUNTS + [
    ("data_center_infos", 6, "message", REPEATED, "DataCenterInfo"),
])

VolumeListRequest = message("VolumeListRequest", [])

VolumeListResponse = message("VolumeListResponse", [
    ("topology_info", 1, "message", SINGLE, "TopologyInfo"),
    ("volume_size_limit_mb", 2, "uint64"),
])

# -- EC lookup -----------------------------------------------------------------

LookupEcVolumeRequest = message("LookupEcVolumeRequest", [
    ("volume_id", 1, "uint32"),
])

LookupEcVolumeResponse = message("LookupEcVolumeResponse", [
    ("volume_id", 1, "uint32"),
    ("shard_id_locations", 2, "message", REPEATED, "EcShardIdLocation"),
])
LookupEcVolumeResponse.EcShardIdLocation = message("EcShardIdLocation", [
    ("shard_id", 1, "uint32"),
    ("locations", 2, "message", REPEATED, "Location"),
])

# -- statistics, collections, vacuum -------------------------------------------

StatisticsRequest = message("StatisticsRequest", [
    ("replication", 1, "string"),
    ("collection", 2, "string"),
    ("ttl", 3, "string"),
])
StatisticsResponse = message("StatisticsResponse", [
    ("total_size", 4, "uint64"),
    ("used_size", 5, "uint64"),
    ("file_count", 6, "uint64"),
])

Collection = message("Collection", [("name", 1, "string")])
CollectionListRequest = message("CollectionListRequest", [
    ("include_normal_volumes", 1, "bool"),
    ("include_ec_volumes", 2, "bool"),
])
CollectionListResponse = message("CollectionListResponse", [
    ("collections", 1, "message", REPEATED, "Collection"),
])
CollectionDeleteRequest = message("CollectionDeleteRequest", [
    ("name", 1, "string"),
])
CollectionDeleteResponse = message("CollectionDeleteResponse", [])

VacuumVolumeRequest = message("VacuumVolumeRequest", [
    ("garbage_threshold", 1, "float"),
])
VacuumVolumeResponse = message("VacuumVolumeResponse", [])

# -- config / admin lock -------------------------------------------------------

GetMasterConfigurationRequest = message("GetMasterConfigurationRequest", [])

GetMasterConfigurationResponse = message("GetMasterConfigurationResponse", [
    ("metrics_address", 1, "string"),
    ("metrics_interval_seconds", 2, "uint32"),
])

_LOCK_REQUEST = [
    ("previous_token", 1, "int64"),
    ("previous_lock_time", 2, "int64"),
    ("lock_name", 3, "string"),
]

LeaseAdminTokenRequest = message("LeaseAdminTokenRequest", _LOCK_REQUEST)

LeaseAdminTokenResponse = message("LeaseAdminTokenResponse", [
    ("token", 1, "int64"),
    ("lock_ts_ns", 2, "int64"),
])

ReleaseAdminTokenRequest = message("ReleaseAdminTokenRequest",
                                   _LOCK_REQUEST)

ReleaseAdminTokenResponse = message("ReleaseAdminTokenResponse", [])

resolve(globals(), PACKAGE)

# service -> [(method, request, response, client streaming, server
# streaming)]; only the methods the port serves
SERVICES = {
    "Seaweed": [
        ("SendHeartbeat", Heartbeat, HeartbeatResponse, True, True),
        ("KeepConnected", KeepConnectedRequest, VolumeLocation, True, True),
        ("LookupVolume", LookupVolumeRequest, LookupVolumeResponse,
         False, False),
        ("Assign", AssignRequest, AssignResponse, False, False),
        ("Statistics", StatisticsRequest, StatisticsResponse, False, False),
        ("CollectionList", CollectionListRequest, CollectionListResponse,
         False, False),
        ("CollectionDelete", CollectionDeleteRequest,
         CollectionDeleteResponse, False, False),
        ("VolumeList", VolumeListRequest, VolumeListResponse, False, False),
        ("VacuumVolume", VacuumVolumeRequest, VacuumVolumeResponse,
         False, False),
        ("LookupEcVolume", LookupEcVolumeRequest, LookupEcVolumeResponse,
         False, False),
        ("GetMasterConfiguration", GetMasterConfigurationRequest,
         GetMasterConfigurationResponse, False, False),
        ("LeaseAdminToken", LeaseAdminTokenRequest,
         LeaseAdminTokenResponse, False, False),
        ("ReleaseAdminToken", ReleaseAdminTokenRequest,
         ReleaseAdminTokenResponse, False, False),
    ],
}
