"""Replicator: turn one filer EventNotification into sink operations
(reference: weed/replication/replicator.go:17-90)."""

from __future__ import annotations

from seaweedfs_tpu_torch.filer.filerstore import join_path, split_path
from seaweedfs_tpu_torch.pb import filer_pb2
from seaweedfs_tpu_torch.replication.sinks import ReplicationSink
from seaweedfs_tpu_torch.replication.source import FilerSource


class Replicator:
    def __init__(self, source: FilerSource, sink: ReplicationSink,
                 path_filter: str = "/"):
        self.source = source
        self.sink = sink
        self.path_filter = path_filter

    def _in_scope(self, path: str) -> bool:
        return path.startswith(self.path_filter)

    def replicate(self, key: str,
                  event: filer_pb2.EventNotification) -> None:
        """`key` is the event's full entry path — the notification-queue
        key produced by filer_notify.event_key (for renames, the OLD
        path), reference replicator.go. Parent-directory keys are NOT
        accepted; tailers convert with event_key first."""
        import posixpath
        old, new = event.old_entry, event.new_entry
        directory = posixpath.dirname(key.rstrip("/") or "/") or "/"
        old_path = join_path(directory, old.name) if old.name else ""
        new_dir = event.new_parent_path or directory
        new_path = join_path(new_dir, new.name) if new.name else ""

        if old.name and not new.name:                      # delete
            if self._in_scope(old_path):
                self.sink.delete_entry(old_path, old.is_directory)
            return
        if old.name and new.name and old_path != new_path:  # rename
            if self._in_scope(old_path):
                self.sink.delete_entry(old_path, old.is_directory)
            if self._in_scope(new_path):
                self._write(new_path, new)
            return
        if new.name and self._in_scope(new_path):           # create/update
            self._write(new_path, new)

    def _write(self, path: str, entry: filer_pb2.Entry) -> None:
        data = None
        if not entry.is_directory and entry.chunks:
            d, n = split_path(path)
            data = self.source.read_entry_data(d, n)
        self.sink.create_entry(path, entry, data)
