"""``volume_server_pb`` messages and the ``VolumeServer`` service, as far as
the port's cluster path uses them.

Field names, numbers and kinds are those of the JAX package's generated
``volume_server_pb2`` descriptors (a test holds this table against them);
the wire runtime is ``pb/wire.py``.
"""

from seaweedfs_tpu_torch.pb.wire import REPEATED, SINGLE, message, resolve

PACKAGE = "volume_server_pb"

_VID = [("volume_id", 1, "uint32")]


def _empty(name):
    return message(name, [])


# -- volume lifecycle ----------------------------------------------------------

AllocateVolumeRequest = message("AllocateVolumeRequest", [
    ("volume_id", 1, "uint32"),
    ("collection", 2, "string"),
    ("preallocate", 3, "int64"),
    ("replication", 4, "string"),
    ("ttl", 5, "string"),
    ("memory_map_max_size_mb", 6, "uint32"),
])
AllocateVolumeResponse = _empty("AllocateVolumeResponse")

VolumeMountRequest = message("VolumeMountRequest", _VID)
VolumeMountResponse = _empty("VolumeMountResponse")
VolumeUnmountRequest = message("VolumeUnmountRequest", _VID)
VolumeUnmountResponse = _empty("VolumeUnmountResponse")
VolumeDeleteRequest = message("VolumeDeleteRequest", _VID)
VolumeDeleteResponse = _empty("VolumeDeleteResponse")
VolumeMarkReadonlyRequest = message("VolumeMarkReadonlyRequest", _VID)
VolumeMarkReadonlyResponse = _empty("VolumeMarkReadonlyResponse")
VolumeMarkWritableRequest = message("VolumeMarkWritableRequest", _VID)
VolumeMarkWritableResponse = _empty("VolumeMarkWritableResponse")

# -- file copy -----------------------------------------------------------------

ReadVolumeFileStatusRequest = message("ReadVolumeFileStatusRequest", _VID)
ReadVolumeFileStatusResponse = message("ReadVolumeFileStatusResponse", [
    ("volume_id", 1, "uint32"),
    ("idx_file_timestamp_seconds", 2, "uint64"),
    ("idx_file_size", 3, "uint64"),
    ("dat_file_timestamp_seconds", 4, "uint64"),
    ("dat_file_size", 5, "uint64"),
    ("file_count", 6, "uint64"),
    ("compaction_revision", 7, "uint32"),
    ("collection", 8, "string"),
])

CopyFileRequest = message("CopyFileRequest", [
    ("volume_id", 1, "uint32"),
    ("ext", 2, "string"),
    ("compaction_revision", 3, "uint32"),
    ("stop_offset", 4, "uint64"),
    ("collection", 5, "string"),
    ("is_ec_volume", 6, "bool"),
    ("ignore_source_file_not_found", 7, "bool"),
])
CopyFileResponse = message("CopyFileResponse", [
    ("file_content", 1, "bytes"),
])

VolumeCopyRequest = message("VolumeCopyRequest", [
    ("volume_id", 1, "uint32"),
    ("collection", 2, "string"),
    ("replication", 3, "string"),
    ("ttl", 4, "string"),
    ("source_data_node", 5, "string"),
])
VolumeCopyResponse = message("VolumeCopyResponse", [
    ("last_append_at_ns", 1, "uint64"),
])

# -- vacuum --------------------------------------------------------------------

VacuumVolumeCheckRequest = message("VacuumVolumeCheckRequest", _VID)
VacuumVolumeCheckResponse = message("VacuumVolumeCheckResponse", [
    ("garbage_ratio", 1, "double"),
])
VacuumVolumeCompactRequest = message("VacuumVolumeCompactRequest", [
    ("volume_id", 1, "uint32"),
    ("preallocate", 2, "int64"),
])
VacuumVolumeCompactResponse = _empty("VacuumVolumeCompactResponse")
VacuumVolumeCommitRequest = message("VacuumVolumeCommitRequest", _VID)
VacuumVolumeCommitResponse = message("VacuumVolumeCommitResponse", [
    ("is_read_only", 1, "bool"),
])
VacuumVolumeCleanupRequest = message("VacuumVolumeCleanupRequest", _VID)
VacuumVolumeCleanupResponse = _empty("VacuumVolumeCleanupResponse")

# -- collection and needle admin -----------------------------------------------

DeleteCollectionRequest = message("DeleteCollectionRequest", [
    ("collection", 1, "string"),
])
DeleteCollectionResponse = _empty("DeleteCollectionResponse")

BatchDeleteRequest = message("BatchDeleteRequest", [
    ("file_ids", 1, "string", REPEATED),
    ("skip_cookie_check", 2, "bool"),
])
DeleteResult = message("DeleteResult", [
    ("file_id", 1, "string"),
    ("status", 2, "int32"),
    ("error", 3, "string"),
    ("size", 4, "uint32"),
    ("version", 5, "uint32"),
])
BatchDeleteResponse = message("BatchDeleteResponse", [
    ("results", 1, "message", REPEATED, "DeleteResult"),
])

VolumeServerLeaveRequest = _empty("VolumeServerLeaveRequest")
VolumeServerLeaveResponse = _empty("VolumeServerLeaveResponse")

VolumeNeedleStatusRequest = message("VolumeNeedleStatusRequest", [
    ("volume_id", 1, "uint32"),
    ("needle_id", 2, "uint64"),
])
VolumeNeedleStatusResponse = message("VolumeNeedleStatusResponse", [
    ("needle_id", 1, "uint64"),
    ("cookie", 2, "uint32"),
    ("size", 3, "uint32"),
    ("last_modified", 4, "uint64"),
    ("crc", 5, "uint32"),
    ("ttl", 6, "string"),
])

VolumeConfigureRequest = message("VolumeConfigureRequest", [
    ("volume_id", 1, "uint32"),
    ("replication", 2, "string"),
])
VolumeConfigureResponse = message("VolumeConfigureResponse", [
    ("error", 1, "string"),
])

QueryRequest = message("QueryRequest", [
    ("from_file_ids", 1, "string", REPEATED),
    ("filter", 2, "message", SINGLE, "Filter"),
    ("selections", 3, "string", REPEATED),
])
QueryRequest.Filter = message("Filter", [
    ("field", 1, "string"),
    ("operand", 2, "string"),
    ("value", 3, "string"),
])
QueriedStripe = message("QueriedStripe", [
    ("records", 1, "bytes"),
])

# -- sync status, incremental copy and tail ------------------------------------

VolumeSyncStatusRequest = message("VolumeSyncStatusRequest", _VID)
VolumeSyncStatusResponse = message("VolumeSyncStatusResponse", [
    ("volume_id", 1, "uint32"),
    ("collection", 2, "string"),
    ("replication", 4, "string"),
    ("ttl", 5, "string"),
    ("tail_offset", 6, "uint64"),
    ("compact_revision", 7, "uint32"),
    ("idx_file_size", 8, "uint64"),
])
VolumeIncrementalCopyRequest = message("VolumeIncrementalCopyRequest", [
    ("volume_id", 1, "uint32"),
    ("since_ns", 2, "uint64"),
])
VolumeIncrementalCopyResponse = message("VolumeIncrementalCopyResponse", [
    ("file_content", 1, "bytes"),
])
VolumeTailSenderRequest = message("VolumeTailSenderRequest", [
    ("volume_id", 1, "uint32"),
    ("since_ns", 2, "uint64"),
    ("idle_timeout_seconds", 3, "uint32"),
])
VolumeTailSenderResponse = message("VolumeTailSenderResponse", [
    ("needle_header", 1, "bytes"),
    ("needle_body", 2, "bytes"),
    ("is_last_chunk", 3, "bool"),
])
VolumeTailReceiverRequest = message("VolumeTailReceiverRequest", [
    ("volume_id", 1, "uint32"),
    ("since_ns", 2, "uint64"),
    ("idle_timeout_seconds", 3, "uint32"),
    ("source_volume_server", 4, "string"),
])
VolumeTailReceiverResponse = _empty("VolumeTailReceiverResponse")

# -- tiers ---------------------------------------------------------------------

VolumeTierMoveDatToRemoteRequest = message(
    "VolumeTierMoveDatToRemoteRequest", [
        ("volume_id", 1, "uint32"),
        ("collection", 2, "string"),
        ("destination_backend_name", 3, "string"),
        ("keep_local_dat_file", 4, "bool"),
    ])
VolumeTierMoveDatToRemoteResponse = message(
    "VolumeTierMoveDatToRemoteResponse", [
        ("processed", 1, "int64"),
        ("processed_percentage", 2, "float"),
    ])
VolumeTierMoveDatFromRemoteRequest = message(
    "VolumeTierMoveDatFromRemoteRequest", [
        ("volume_id", 1, "uint32"),
        ("collection", 2, "string"),
        ("keep_remote_dat_file", 3, "bool"),
    ])
VolumeTierMoveDatFromRemoteResponse = message(
    "VolumeTierMoveDatFromRemoteResponse", [
        ("processed", 1, "int64"),
        ("processed_percentage", 2, "float"),
    ])

# -- erasure coding ------------------------------------------------------------

VolumeEcShardsGenerateRequest = message("VolumeEcShardsGenerateRequest", [
    ("volume_id", 1, "uint32"),
    ("collection", 2, "string"),
    ("encoder", 3, "string"),
    ("volume_ids", 4, "uint32", REPEATED),
])
VolumeEcShardsGenerateResponse = _empty("VolumeEcShardsGenerateResponse")

VolumeEcShardsRebuildRequest = message("VolumeEcShardsRebuildRequest", [
    ("volume_id", 1, "uint32"),
    ("collection", 2, "string"),
    ("encoder", 3, "string"),
])
VolumeEcShardsRebuildResponse = message("VolumeEcShardsRebuildResponse", [
    ("rebuilt_shard_ids", 1, "uint32", REPEATED),
])

VolumeEcShardsCopyRequest = message("VolumeEcShardsCopyRequest", [
    ("volume_id", 1, "uint32"),
    ("collection", 2, "string"),
    ("shard_ids", 3, "uint32", REPEATED),
    ("copy_ecx_file", 4, "bool"),
    ("source_data_node", 5, "string"),
    ("copy_ecj_file", 6, "bool"),
    ("copy_vif_file", 7, "bool"),
])
VolumeEcShardsCopyResponse = _empty("VolumeEcShardsCopyResponse")

_SHARDS = [
    ("volume_id", 1, "uint32"),
    ("collection", 2, "string"),
    ("shard_ids", 3, "uint32", REPEATED),
]
VolumeEcShardsDeleteRequest = message("VolumeEcShardsDeleteRequest",
                                      _SHARDS)
VolumeEcShardsDeleteResponse = _empty("VolumeEcShardsDeleteResponse")
VolumeEcShardsMountRequest = message("VolumeEcShardsMountRequest", _SHARDS)
VolumeEcShardsMountResponse = _empty("VolumeEcShardsMountResponse")
VolumeEcShardsUnmountRequest = message("VolumeEcShardsUnmountRequest", [
    ("volume_id", 1, "uint32"),
    ("shard_ids", 3, "uint32", REPEATED),
])
VolumeEcShardsUnmountResponse = _empty("VolumeEcShardsUnmountResponse")

VolumeEcShardReadRequest = message("VolumeEcShardReadRequest", [
    ("volume_id", 1, "uint32"),
    ("shard_id", 2, "uint32"),
    ("offset", 3, "int64"),
    ("size", 4, "int64"),
    ("file_key", 5, "uint64"),
])
VolumeEcShardReadResponse = message("VolumeEcShardReadResponse", [
    ("data", 1, "bytes"),
    ("is_deleted", 2, "bool"),
])

VolumeEcBlobDeleteRequest = message("VolumeEcBlobDeleteRequest", [
    ("volume_id", 1, "uint32"),
    ("collection", 2, "string"),
    ("file_key", 3, "uint64"),
    ("version", 4, "uint32"),
])
VolumeEcBlobDeleteResponse = _empty("VolumeEcBlobDeleteResponse")

VolumeEcShardsToVolumeRequest = message("VolumeEcShardsToVolumeRequest", [
    ("volume_id", 1, "uint32"),
    ("collection", 2, "string"),
])
VolumeEcShardsToVolumeResponse = _empty("VolumeEcShardsToVolumeResponse")

# -- scrub control plane -------------------------------------------------------

VolumeScrubStartRequest = message("VolumeScrubStartRequest", [
    ("volume_ids", 1, "uint32", REPEATED),
    ("throttle_mbps", 2, "float"),
    ("full", 3, "bool"),
])
VolumeScrubStartResponse = message("VolumeScrubStartResponse", [
    ("started", 1, "bool"),
])
VolumeScrubPauseRequest = _empty("VolumeScrubPauseRequest")
VolumeScrubPauseResponse = message("VolumeScrubPauseResponse", [
    ("paused", 1, "bool"),
])
VolumeScrubStatusRequest = _empty("VolumeScrubStatusRequest")
VolumeScrubStatusResponse = message("VolumeScrubStatusResponse", [
    ("state", 1, "string"),
    ("bytes_scanned", 2, "uint64"),
    ("needles_verified", 3, "uint64"),
    ("stripes_verified", 4, "uint64"),
    ("corruptions_found", 5, "uint64"),
    ("corruptions_repaired", 6, "uint64"),
    ("unrecoverable", 7, "uint64"),
    ("current_volume_id", 8, "uint32"),
    ("passes_completed", 9, "uint64"),
    ("last_pass_unix", 10, "double"),
    ("scan_lag_seconds", 11, "double"),
])

# -- status --------------------------------------------------------------------

DiskStatus = message("DiskStatus", [
    ("dir", 1, "string"),
    ("all", 2, "uint64"),
    ("used", 3, "uint64"),
    ("free", 4, "uint64"),
])
MemStatus = message("MemStatus", [
    ("heap", 1, "uint64"),
])
VolumeServerStatusRequest = _empty("VolumeServerStatusRequest")
VolumeServerStatusResponse = message("VolumeServerStatusResponse", [
    ("disk_statuses", 1, "message", REPEATED, "DiskStatus"),
    ("memory_status", 2, "message", SINGLE, "MemStatus"),
])

VolumeStatusRequest = message("VolumeStatusRequest", _VID)
VolumeStatusResponse = message("VolumeStatusResponse", [
    ("is_read_only", 1, "bool"),
])

resolve(globals(), PACKAGE)


def _unary(name):
    g = globals()
    return (name, g[f"{name}Request"], g[f"{name}Response"], False, False)


def _server_streaming(name, response=None):
    g = globals()
    return (name, g[f"{name}Request"], response or g[f"{name}Response"],
            False, True)


# service -> [(method, request, response, client streaming, server
# streaming)]; only the methods the port serves
SERVICES = {
    "VolumeServer": [
        _unary("AllocateVolume"),
        _unary("VolumeMount"),
        _unary("VolumeUnmount"),
        _unary("VolumeDelete"),
        _unary("VolumeMarkReadonly"),
        _unary("VolumeMarkWritable"),
        _unary("ReadVolumeFileStatus"),
        _server_streaming("CopyFile"),
        _unary("VolumeCopy"),
        _unary("VacuumVolumeCheck"),
        _unary("VacuumVolumeCompact"),
        _unary("VacuumVolumeCommit"),
        _unary("VacuumVolumeCleanup"),
        _unary("DeleteCollection"),
        _unary("BatchDelete"),
        _unary("VolumeServerLeave"),
        _unary("VolumeNeedleStatus"),
        _unary("VolumeConfigure"),
        _server_streaming("Query", QueriedStripe),
        _unary("VolumeSyncStatus"),
        _server_streaming("VolumeIncrementalCopy"),
        _server_streaming("VolumeTailSender"),
        _unary("VolumeTailReceiver"),
        _server_streaming("VolumeTierMoveDatToRemote"),
        _server_streaming("VolumeTierMoveDatFromRemote"),
        _unary("VolumeEcShardsGenerate"),
        _unary("VolumeEcShardsRebuild"),
        _unary("VolumeEcShardsCopy"),
        _unary("VolumeEcShardsDelete"),
        _unary("VolumeEcShardsMount"),
        _unary("VolumeEcShardsUnmount"),
        ("VolumeEcShardRead", VolumeEcShardReadRequest,
         VolumeEcShardReadResponse, False, True),
        _unary("VolumeEcBlobDelete"),
        _unary("VolumeEcShardsToVolume"),
        _unary("VolumeServerStatus"),
        _unary("VolumeStatus"),
        _unary("VolumeScrubStart"),
        _unary("VolumeScrubPause"),
        _unary("VolumeScrubStatus"),
    ],
}
