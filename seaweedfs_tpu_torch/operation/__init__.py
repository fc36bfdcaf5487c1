"""Client-side operations: file ids, assign, upload, submit, lookup,
download, delete (reference weed/operation)."""

from seaweedfs_tpu_torch.operation.file_id import (FileId, format_fid,
                                                   parse_fid)
from seaweedfs_tpu_torch.operation.operations import (Assignment, assign,
                                                      delete_file,
                                                      delete_files, download,
                                                      lookup, submit, upload,
                                                      upload_data)

__all__ = ["FileId", "parse_fid", "format_fid", "Assignment", "assign",
           "upload", "upload_data", "submit", "download", "lookup",
           "delete_file", "delete_files"]
