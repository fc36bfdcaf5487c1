"""Metadata event log: every namespace mutation is appended as an
EventNotification and kept replayable — powering subscriptions,
replication and filer.sync (reference: weed/filer/filer_notify.go:18-148;
the reference persists flushed segments through its own chunk store
under /topics/.system/log, here they land as local files under the
filer's log dir — same dated layout, same framing).
"""

from __future__ import annotations

import calendar
import os
import time
from typing import Callable, List, Optional

from seaweedfs_tpu_torch.pb import filer_pb2
from seaweedfs_tpu_torch.util.log_buffer import LogBuffer, LogEntry


def matches_prefix(rec: filer_pb2.SubscribeMetadataResponse,
                   prefix: str) -> bool:
    """Does the event touch a path under `prefix`? — the one filter
    applied at subscription yield sites, like the reference's
    eachEventNotificationFn (filer_grpc_server_sub_meta.go)."""
    ev = rec.event_notification
    base = rec.directory.rstrip("/")
    for name in (ev.new_entry.name, ev.old_entry.name):
        if name and f"{base}/{name}".startswith(prefix):
            return True
    if ev.new_parent_path and \
            f"{ev.new_parent_path.rstrip('/')}/{ev.new_entry.name}" \
            .startswith(prefix):
        return True
    # events carrying no entry (bare markers): match on directory
    if not ev.new_entry.name and not ev.old_entry.name:
        return rec.directory.startswith(prefix)
    return False


def event_key(directory: str, ev: filer_pb2.EventNotification) -> str:
    """The canonical notification key for an event: the ENTRY's full
    path under its (old) parent directory — renames keyed by the OLD
    path (reference filer_notify.go fullpath). The ONE definition used
    by the live filer publish path, filer.sync tailers, and
    fs.meta.notify so consumers can partition/dedup consistently."""
    import posixpath
    name = (ev.old_entry.name if ev.HasField("old_entry")
            else ev.new_entry.name if ev.HasField("new_entry")
            else "")
    return posixpath.join(directory, name) if name else directory


def _segment_name(ts_ns: int) -> str:
    t = time.gmtime(ts_ns / 1e9)
    return os.path.join(time.strftime("%Y-%m-%d", t),
                        time.strftime("%H-%M", t) + ".segment")


class MetaLog:
    def __init__(self, log_dir: Optional[str], flush_seconds: float = 2.0):
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        self.buffer = LogBuffer(flush_seconds=flush_seconds,
                                flush_fn=self._flush if log_dir else None)
        # fires for every appended event, AFTER the record is in the
        # buffer — the listing cache's invalidation seam:
        # the event log itself drives cache drops, on the local log
        # (reason "local") and on the meta-aggregator's peer log
        # (reason "peer") alike. None (the default) costs one check.
        self.on_append: Optional[Callable[
            [str, filer_pb2.EventNotification], None]] = None

    # -- write ----------------------------------------------------------------

    def append_event(self, directory: str,
                     event: filer_pb2.EventNotification,
                     ts_ns: Optional[int] = None) -> int:
        rec = filer_pb2.SubscribeMetadataResponse(
            directory=directory, event_notification=event)
        ts = self.buffer.add(rec.SerializeToString(),
                             key_hash=hash(directory) & 0x7FFFFFFF,
                             ts_ns=ts_ns)
        if self.on_append is not None:
            # ordering contract: the event is RECORDED before any
            # cache drops, so a reader that re-lists after observing
            # the invalidation also finds the event in the log
            self.on_append(directory, event)
        return ts

    def _flush(self, start_ts: int, stop_ts: int, blob: bytes) -> None:
        path = os.path.join(self.log_dir, _segment_name(start_ts))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "ab") as f:
            f.write(blob)

    # -- read -----------------------------------------------------------------

    def _disk_entries(self, since_ns: int) -> List[LogEntry]:
        if not self.log_dir or not os.path.isdir(self.log_dir):
            return []
        # A segment named <day>/<HH-MM> holds batches whose first entry
        # falls in that minute; a batch spans at most flush_seconds, so
        # nothing in it can be later than minute start + 60s + flush
        # window. Skip (don't even open) segments entirely before
        # since_ns — keeps SubscribeMetadata's poll O(new segments),
        # not O(full history).
        margin_ns = int((61 + self.buffer.flush_seconds) * 1e9)
        out: List[LogEntry] = []
        for day in sorted(os.listdir(self.log_dir)):
            daydir = os.path.join(self.log_dir, day)
            if not os.path.isdir(daydir):
                continue
            try:
                day_start = calendar.timegm(
                    time.strptime(day, "%Y-%m-%d")) * 1_000_000_000
            except ValueError:
                day_start = None
            if day_start is not None and \
                    day_start + 86_400_000_000_000 + margin_ns <= since_ns:
                continue
            for seg in sorted(os.listdir(daydir)):
                if day_start is not None:
                    try:
                        h, m = seg.split(".")[0].split("-")
                        seg_start = day_start + \
                            (int(h) * 3600 + int(m) * 60) * 1_000_000_000
                        if seg_start + margin_ns <= since_ns:
                            continue
                    except ValueError:
                        pass
                with open(os.path.join(daydir, seg), "rb") as f:
                    for e in LogEntry.unpack_stream(f.read()):
                        if e.ts_ns > since_ns:
                            out.append(e)
        return out

    def read_events_since(
            self, since_ns: int
    ) -> List[filer_pb2.SubscribeMetadataResponse]:
        """Disk segments + in-memory buffer, deduped by ts, ordered.

        Deliberately UNFILTERED: streaming loops must see every record
        so their cursor advances — prefix filtering happens at the
        yield site (server/filer.py _advance_and_filter) where the
        scanned timestamps are still visible. A reader-side prefix
        filter here once made prefix subscribers spin at 100% CPU."""
        earliest = self.buffer.earliest_in_memory()
        if earliest is not None and earliest <= since_ns:
            # the in-memory buffer (pending + retained flushed batches)
            # reaches back past the cursor: every entry > since_ns is
            # in memory, so skip the disk segments entirely. Without
            # this, each poll of a streaming subscriber re-reads and
            # re-unpacks the current minute segment from disk — O(n^2)
            # across a busy minute (the reference draws the same
            # memory-vs-disk boundary, filer/filer_notify_read.go).
            entries = self.buffer.read_since(since_ns)
        else:
            seen = set()
            entries = []
            for e in self._disk_entries(since_ns) + \
                    self.buffer.read_since(since_ns):
                if e.ts_ns in seen:
                    continue
                seen.add(e.ts_ns)
                entries.append(e)
            entries.sort(key=lambda e: e.ts_ns)
        out = []
        for e in entries:
            rec = filer_pb2.SubscribeMetadataResponse()
            rec.ParseFromString(e.data)
            rec.ts_ns = e.ts_ns
            out.append(rec)
        return out

    def wait_for_data(self, after_ts_ns: int, timeout: float) -> bool:
        return self.buffer.wait_for_data(after_ts_ns, timeout)

    def close(self):
        self.buffer.close()
