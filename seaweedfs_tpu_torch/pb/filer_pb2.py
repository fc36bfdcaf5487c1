"""``filer_pb`` messages and the ``SeaweedFiler`` service.

Field names, numbers and kinds are those of
``seaweedfs_tpu/pb/proto/filer.proto`` (its generated ``filer_pb2``
descriptors are the reference a test holds this table against); the wire
runtime is ``pb/wire.py``. ``Entry.extended`` and
``LookupVolumeResponse.locations_map`` are map fields (dicts);
``FileId.cookie`` is a ``fixed32``. ``ListEntries``,
``SubscribeMetadata`` and ``SubscribeLocalMetadata`` stream from the
server and ``KeepConnected`` streams both ways, on ``rpc.py``.
"""

from seaweedfs_tpu_torch.pb.wire import REPEATED, SINGLE, message, resolve

PACKAGE = "filer_pb"

FileId = message("FileId", [
    ("volume_id", 1, "uint32"),
    ("file_key", 2, "uint64"),
    ("cookie", 3, "fixed32"),
])

FileChunk = message("FileChunk", [
    ("file_id", 1, "string"),
    ("offset", 2, "int64"),
    ("size", 3, "uint64"),
    ("mtime", 4, "int64"),
    ("e_tag", 5, "string"),
    ("source_file_id", 6, "string"),
    ("fid", 7, "message", SINGLE, "FileId"),
    ("source_fid", 8, "message", SINGLE, "FileId"),
    ("cipher_key", 9, "bytes"),
    ("is_compressed", 10, "bool"),
    ("is_chunk_manifest", 11, "bool"),
])

FileChunkManifest = message("FileChunkManifest", [
    ("chunks", 1, "message", REPEATED, "FileChunk"),
])

FuseAttributes = message("FuseAttributes", [
    ("file_size", 1, "uint64"),
    ("mtime", 2, "int64"),
    ("file_mode", 3, "uint32"),
    ("uid", 4, "uint32"),
    ("gid", 5, "uint32"),
    ("crtime", 6, "int64"),
    ("mime", 7, "string"),
    ("replication", 8, "string"),
    ("collection", 9, "string"),
    ("ttl_sec", 10, "int32"),
    ("user_name", 11, "string"),
    ("group_name", 12, "string", REPEATED),
    ("symlink_target", 13, "string"),
    ("md5", 14, "bytes"),
])

Entry = message("Entry", [
    ("name", 1, "string"),
    ("is_directory", 2, "bool"),
    ("chunks", 3, "message", REPEATED, "FileChunk"),
    ("attributes", 4, "message", SINGLE, "FuseAttributes"),
    ("extended", 5, "map", "string", "bytes"),
    ("hard_link_id", 7, "bytes"),
    ("hard_link_counter", 8, "int32"),
])

FullEntry = message("FullEntry", [
    ("dir", 1, "string"),
    ("entry", 2, "message", SINGLE, "Entry"),
])

LookupDirectoryEntryRequest = message("LookupDirectoryEntryRequest", [
    ("directory", 1, "string"),
    ("name", 2, "string"),
])

LookupDirectoryEntryResponse = message("LookupDirectoryEntryResponse", [
    ("entry", 1, "message", SINGLE, "Entry"),
])

ListEntriesRequest = message("ListEntriesRequest", [
    ("directory", 1, "string"),
    ("prefix", 2, "string"),
    ("start_from_file_name", 3, "string"),
    ("inclusive_start_from", 4, "bool"),
    ("limit", 5, "uint32"),
])

ListEntriesResponse = message("ListEntriesResponse", [
    ("entry", 1, "message", SINGLE, "Entry"),
])

CreateEntryRequest = message("CreateEntryRequest", [
    ("directory", 1, "string"),
    ("entry", 2, "message", SINGLE, "Entry"),
    ("o_excl", 3, "bool"),
    ("is_from_other_cluster", 4, "bool"),
    ("signatures", 5, "int32", REPEATED),
])

CreateEntryResponse = message("CreateEntryResponse", [
    ("error", 1, "string"),
])

UpdateEntryRequest = message("UpdateEntryRequest", [
    ("directory", 1, "string"),
    ("entry", 2, "message", SINGLE, "Entry"),
    ("is_from_other_cluster", 3, "bool"),
    ("signatures", 4, "int32", REPEATED),
])

UpdateEntryResponse = message("UpdateEntryResponse", [])

AppendToEntryRequest = message("AppendToEntryRequest", [
    ("directory", 1, "string"),
    ("entry_name", 2, "string"),
    ("chunks", 3, "message", REPEATED, "FileChunk"),
])

AppendToEntryResponse = message("AppendToEntryResponse", [])

DeleteEntryRequest = message("DeleteEntryRequest", [
    ("directory", 1, "string"),
    ("name", 2, "string"),
    ("is_delete_data", 4, "bool"),
    ("is_recursive", 5, "bool"),
    ("ignore_recursive_error", 6, "bool"),
    ("is_from_other_cluster", 7, "bool"),
    ("signatures", 8, "int32", REPEATED),
])

DeleteEntryResponse = message("DeleteEntryResponse", [
    ("error", 1, "string"),
])

AtomicRenameEntryRequest = message("AtomicRenameEntryRequest", [
    ("old_directory", 1, "string"),
    ("old_name", 2, "string"),
    ("new_directory", 3, "string"),
    ("new_name", 4, "string"),
])

AtomicRenameEntryResponse = message("AtomicRenameEntryResponse", [])

AssignVolumeRequest = message("AssignVolumeRequest", [
    ("count", 1, "int32"),
    ("collection", 2, "string"),
    ("replication", 3, "string"),
    ("ttl_sec", 4, "int32"),
    ("data_center", 5, "string"),
    ("path", 6, "string"),
])

AssignVolumeResponse = message("AssignVolumeResponse", [
    ("file_id", 1, "string"),
    ("url", 2, "string"),
    ("public_url", 3, "string"),
    ("count", 4, "int32"),
    ("auth", 5, "string"),
    ("collection", 6, "string"),
    ("replication", 7, "string"),
    ("error", 8, "string"),
])

LookupVolumeRequest = message("LookupVolumeRequest", [
    ("volume_ids", 1, "string", REPEATED),
])

Locations = message("Locations", [
    ("locations", 1, "message", REPEATED, "Location"),
])

Location = message("Location", [
    ("url", 1, "string"),
    ("public_url", 2, "string"),
])

LookupVolumeResponse = message("LookupVolumeResponse", [
    ("locations_map", 1, "map", "string", "Locations"),
])

Collection = message("Collection", [
    ("name", 1, "string"),
])

CollectionListRequest = message("CollectionListRequest", [
    ("include_normal_volumes", 1, "bool"),
    ("include_ec_volumes", 2, "bool"),
])

CollectionListResponse = message("CollectionListResponse", [
    ("collections", 1, "message", REPEATED, "Collection"),
])

DeleteCollectionRequest = message("DeleteCollectionRequest", [
    ("collection", 1, "string"),
])

DeleteCollectionResponse = message("DeleteCollectionResponse", [])

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

GetFilerConfigurationRequest = message("GetFilerConfigurationRequest", [])

GetFilerConfigurationResponse = message("GetFilerConfigurationResponse", [
    ("masters", 1, "string", REPEATED),
    ("replication", 2, "string"),
    ("collection", 3, "string"),
    ("max_mb", 4, "uint32"),
    ("dir_buckets", 5, "string"),
    ("cipher", 7, "bool"),
])

EventNotification = message("EventNotification", [
    ("old_entry", 1, "message", SINGLE, "Entry"),
    ("new_entry", 2, "message", SINGLE, "Entry"),
    ("delete_chunks", 3, "bool"),
    ("new_parent_path", 4, "string"),
    ("is_from_other_cluster", 5, "bool"),
    ("signatures", 6, "int32", REPEATED),
])

SubscribeMetadataRequest = message("SubscribeMetadataRequest", [
    ("client_name", 1, "string"),
    ("path_prefix", 2, "string"),
    ("since_ns", 3, "int64"),
    ("signature", 4, "int32"),
])

SubscribeMetadataResponse = message("SubscribeMetadataResponse", [
    ("directory", 1, "string"),
    ("event_notification", 2, "message", SINGLE, "EventNotification"),
    ("ts_ns", 3, "int64"),
])

KeepConnectedRequest = message("KeepConnectedRequest", [
    ("name", 1, "string"),
    ("grpc_port", 2, "uint32"),
    ("resources", 3, "string", REPEATED),
])

KeepConnectedResponse = message("KeepConnectedResponse", [])

LocateBrokerRequest = message("LocateBrokerRequest", [
    ("resource", 1, "string"),
])

LocateBrokerResponse = message("LocateBrokerResponse", [
    ("found", 1, "bool"),
    ("resources", 2, "message", REPEATED, "Resource"),
])

LocateBrokerResponse.Resource = message("Resource", [
    ("grpc_addresses", 1, "string"),
    ("resource_count", 2, "int32"),
])

KvGetRequest = message("KvGetRequest", [
    ("key", 1, "bytes"),
])

KvGetResponse = message("KvGetResponse", [
    ("value", 1, "bytes"),
    ("error", 2, "string"),
])

KvPutRequest = message("KvPutRequest", [
    ("key", 1, "bytes"),
    ("value", 2, "bytes"),
])

KvPutResponse = message("KvPutResponse", [
    ("error", 1, "string"),
])

resolve(globals(), PACKAGE)

# service -> [(method, request, response, client streaming, server
# streaming)]
SERVICES = {
    "SeaweedFiler": [
        ("LookupDirectoryEntry", LookupDirectoryEntryRequest,
         LookupDirectoryEntryResponse, False, False),
        ("ListEntries", ListEntriesRequest, ListEntriesResponse, False, True),
        ("CreateEntry", CreateEntryRequest, CreateEntryResponse, False, False),
        ("UpdateEntry", UpdateEntryRequest, UpdateEntryResponse, False, False),
        ("AppendToEntry", AppendToEntryRequest,
         AppendToEntryResponse, False, False),
        ("DeleteEntry", DeleteEntryRequest, DeleteEntryResponse, False, False),
        ("AtomicRenameEntry", AtomicRenameEntryRequest,
         AtomicRenameEntryResponse, False, False),
        ("AssignVolume", AssignVolumeRequest,
         AssignVolumeResponse, False, False),
        ("LookupVolume", LookupVolumeRequest,
         LookupVolumeResponse, False, False),
        ("CollectionList", CollectionListRequest,
         CollectionListResponse, False, False),
        ("DeleteCollection", DeleteCollectionRequest,
         DeleteCollectionResponse, False, False),
        ("Statistics", StatisticsRequest, StatisticsResponse, False, False),
        ("GetFilerConfiguration", GetFilerConfigurationRequest,
         GetFilerConfigurationResponse, False, False),
        ("SubscribeMetadata", SubscribeMetadataRequest,
         SubscribeMetadataResponse, False, True),
        ("SubscribeLocalMetadata", SubscribeMetadataRequest,
         SubscribeMetadataResponse, False, True),
        ("KeepConnected", KeepConnectedRequest,
         KeepConnectedResponse, True, True),
        ("LocateBroker", LocateBrokerRequest,
         LocateBrokerResponse, False, False),
        ("KvGet", KvGetRequest, KvGetResponse, False, False),
        ("KvPut", KvPutRequest, KvPutResponse, False, False),
    ],
}
