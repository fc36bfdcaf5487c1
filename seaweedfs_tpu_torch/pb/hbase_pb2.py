"""``hbase_pb`` messages: the region-server RPC subset the filer's hbase
store speaks (``filer/stores/hbase_store.py``).

Field names, numbers, labels, kinds and ``[default = ...]`` values are
those of the JAX package's ``seaweedfs_tpu/pb/hbase_pb2.py`` descriptor
(``pb/proto/hbase.proto``, a proto2 file; a test holds this table
against it); the wire runtime is ``pb/wire.py`` in its proto2 mode.
"""

from seaweedfs_tpu_torch.pb.wire import (REPEATED, REQUIRED, enum_type,
                                         message, resolve)

PACKAGE = "hbase_pb"


def _proto2(name, fields):
    return message(name, fields, syntax="proto2")


# -- connection setup (RPC.proto) ---------------------------------------------

UserInformation = _proto2("UserInformation", [
    ("effective_user", 1, "string", REQUIRED),
    ("real_user", 2, "string"),
])

ConnectionHeader = _proto2("ConnectionHeader", [
    ("user_info", 1, "message", None, "UserInformation"),
    ("service_name", 2, "string"),
    ("cell_block_codec_class", 3, "string"),
    ("cell_block_compressor_class", 4, "string"),
])

CellBlockMeta = _proto2("CellBlockMeta", [
    ("length", 1, "uint32"),
])

ExceptionResponse = _proto2("ExceptionResponse", [
    ("exception_class_name", 1, "string"),
    ("stack_trace", 2, "string"),
    ("hostname", 3, "string"),
    ("port", 4, "int32"),
    ("do_not_retry", 5, "bool"),
])

RequestHeader = _proto2("RequestHeader", [
    ("call_id", 1, "uint32"),
    ("method_name", 3, "string"),
    ("request_param", 4, "bool"),
    ("cell_block_meta", 5, "message", None, "CellBlockMeta"),
    ("priority", 6, "uint32"),
])

ResponseHeader = _proto2("ResponseHeader", [
    ("call_id", 1, "uint32"),
    ("exception", 2, "message", None, "ExceptionResponse"),
    ("cell_block_meta", 3, "message", None, "CellBlockMeta"),
])

# -- shared types (HBase.proto / Cell.proto) ----------------------------------

RegionSpecifier = _proto2("RegionSpecifier", [
    ("type", 1, "enum", REQUIRED, "RegionSpecifier.RegionSpecifierType"),
    ("value", 2, "bytes", REQUIRED),
])
RegionSpecifier.RegionSpecifierType = enum_type("RegionSpecifierType", {
    "REGION_NAME": 1, "ENCODED_REGION_NAME": 2})

NameBytesPair = _proto2("NameBytesPair", [
    ("name", 1, "string", REQUIRED),
    ("value", 2, "bytes"),
])

CellType = enum_type("CellType", {
    "MINIMUM": 0, "PUT": 4, "DELETE": 8, "DELETE_FAMILY_VERSION": 10,
    "DELETE_COLUMN": 12, "DELETE_FAMILY": 14, "MAXIMUM": 255})

Cell = _proto2("Cell", [
    ("row", 1, "bytes"),
    ("family", 2, "bytes"),
    ("qualifier", 3, "bytes"),
    ("timestamp", 4, "uint64"),
    ("cell_type", 5, "enum", None, "CellType"),
    ("value", 6, "bytes"),
    ("tags", 7, "bytes"),
])

# -- Get (Client.proto) -------------------------------------------------------

Column = _proto2("Column", [
    ("family", 1, "bytes", REQUIRED),
    ("qualifier", 2, "bytes", REPEATED),
])

Get = _proto2("Get", [
    ("row", 1, "bytes", REQUIRED),
    ("column", 2, "message", REPEATED, "Column"),
    ("attribute", 3, "message", REPEATED, "NameBytesPair"),
    ("max_versions", 6, "uint32", None, None, 1),
    ("cache_blocks", 7, "bool", None, None, True),
    ("existence_only", 10, "bool", None, None, False),
])

Result = _proto2("Result", [
    ("cell", 1, "message", REPEATED, "Cell"),
    ("associated_cell_count", 2, "int32"),
    ("exists", 3, "bool"),
    ("stale", 4, "bool", None, None, False),
    ("partial", 5, "bool", None, None, False),
])

GetRequest = _proto2("GetRequest", [
    ("region", 1, "message", REQUIRED, "RegionSpecifier"),
    ("get", 2, "message", REQUIRED, "Get"),
])

GetResponse = _proto2("GetResponse", [
    ("result", 1, "message", None, "Result"),
])

# -- Mutate (Client.proto) ----------------------------------------------------

MutationProto = _proto2("MutationProto", [
    ("row", 1, "bytes"),
    ("mutate_type", 2, "enum", None, "MutationProto.MutationType"),
    ("column_value", 3, "message", REPEATED, "MutationProto.ColumnValue"),
    ("timestamp", 4, "uint64"),
    ("attribute", 5, "message", REPEATED, "NameBytesPair"),
    ("durability", 6, "enum", None, "MutationProto.Durability", 0),
])
MutationProto.Durability = enum_type("Durability", {
    "USE_DEFAULT": 0, "SKIP_WAL": 1, "ASYNC_WAL": 2, "SYNC_WAL": 3,
    "FSYNC_WAL": 4})
MutationProto.MutationType = enum_type("MutationType", {
    "APPEND": 0, "INCREMENT": 1, "PUT": 2, "DELETE": 3})
MutationProto.DeleteType = enum_type("DeleteType", {
    "DELETE_ONE_VERSION": 0, "DELETE_MULTIPLE_VERSIONS": 1,
    "DELETE_FAMILY": 2, "DELETE_FAMILY_VERSION": 3})
MutationProto.ColumnValue = _proto2("ColumnValue", [
    ("family", 1, "bytes", REQUIRED),
    ("qualifier_value", 2, "message", REPEATED,
     "MutationProto.ColumnValue.QualifierValue"),
])
MutationProto.ColumnValue.QualifierValue = _proto2("QualifierValue", [
    ("qualifier", 1, "bytes"),
    ("value", 2, "bytes"),
    ("timestamp", 3, "uint64"),
    ("delete_type", 4, "enum", None, "MutationProto.DeleteType"),
    ("tags", 5, "bytes"),
])

MutateRequest = _proto2("MutateRequest", [
    ("region", 1, "message", REQUIRED, "RegionSpecifier"),
    ("mutation", 2, "message", REQUIRED, "MutationProto"),
])

MutateResponse = _proto2("MutateResponse", [
    ("result", 1, "message", None, "Result"),
    ("processed", 2, "bool"),
])

# -- Scan (Client.proto) ------------------------------------------------------

Scan = _proto2("Scan", [
    ("column", 1, "message", REPEATED, "Column"),
    ("attribute", 2, "message", REPEATED, "NameBytesPair"),
    ("start_row", 3, "bytes"),
    ("stop_row", 4, "bytes"),
    ("max_versions", 6, "uint32", None, None, 1),
    ("cache_blocks", 7, "bool", None, None, True),
    ("caching", 17, "uint32"),
])

ScanRequest = _proto2("ScanRequest", [
    ("region", 1, "message", None, "RegionSpecifier"),
    ("scan", 2, "message", None, "Scan"),
    ("scanner_id", 3, "uint64"),
    ("number_of_rows", 4, "uint32"),
    ("close_scanner", 5, "bool"),
    ("next_call_seq", 6, "uint64"),
    ("client_handles_partials", 7, "bool"),
    ("client_handles_heartbeats", 8, "bool"),
    ("renew", 10, "bool"),
])

ScanResponse = _proto2("ScanResponse", [
    ("cells_per_result", 1, "uint32", REPEATED),
    ("scanner_id", 2, "uint64"),
    ("more_results", 3, "bool"),
    ("ttl", 4, "uint32"),
    ("results", 5, "message", REPEATED, "Result"),
    ("stale", 6, "bool"),
    ("more_results_in_region", 8, "bool"),
    ("heartbeat_message", 9, "bool"),
])

resolve(globals(), PACKAGE)
