"""Read entry content from the source cluster
(reference: weed/replication/source/filer_source.go)."""

from __future__ import annotations

from seaweedfs_tpu_torch.filer import http_client as filer_http
from seaweedfs_tpu_torch.filer.filerstore import join_path


class FilerSource:
    def __init__(self, filer_url: str):
        self.filer_url = filer_url

    def read_entry_data(self, directory: str, name: str) -> bytes:
        _, data, _ = filer_http.get(self.filer_url,
                                    join_path(directory, name))
        return data
