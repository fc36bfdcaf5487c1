"""Query engine: S3-Select-style filter and projection over stored JSON
(reference weed/query/json/query_json.go, server/volume_grpc_query.go);
the port of ``seaweedfs_tpu.query``."""

from seaweedfs_tpu_torch.query.json_query import (  # noqa: F401
    Query, filter_json, get_path, query_json_line, query_json_lines,
)
