"""Embedded log-structured key-value engine ("weedkv").

The counterpart of ``LogKV`` in ``seaweedfs_tpu.filer.stores.kv_store``,
which the reference's LevelDB store (weed/filer/leveldb/leveldb_store.go)
stands behind there:

- an append-only record log (put/delete records, CRC-framed) split into
  segments, replayed at open with torn-tail tolerance;
- an in-memory index of key -> (segment, offset, length) with a
  bisect-sorted key list for ordered prefix scans;
- size-triggered compaction that rewrites live records into a fresh
  segment and drops the garbage, crash-safe via write-then-swap.

Segment files are byte-compatible with the JAX package's: a directory one
writes, the other opens. The port runs it under the kv needle map
(``storage/needle_map.KvNeedleMap``, the volume server's ``-index kv``)
and under ``KvFilerStore``, the filer's ``-store weedkv``: its keys are
``b"e" + dir + b"\\x00" + name -> Entry bytes`` (the dir-prefix-scan
layout of the reference's LevelDB keys, leveldb_store.go genKey) and
``b"k" + key`` for the KV API.
"""

from __future__ import annotations

import bisect
import os
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from seaweedfs_tpu_torch.filer.filerstore import (FilerStore, NotFound,
                                                  normalize_path)
from seaweedfs_tpu_torch.pb import filer_pb2
from seaweedfs_tpu_torch.util import wlog

_log = wlog.logger("filer.kv")

_HEADER = struct.Struct(">BII")  # op, key len, value len
_CRC = struct.Struct(">I")
_OP_PUT, _OP_DEL = 1, 2


class LogKV:
    """The engine: durable ordered KV over append-only segment logs."""

    COMPACT_MIN_BYTES = 4 << 20

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.RLock()
        # __len__/stats may peek lock-free (GIL-atomic dict len); all
        # mutation flows through the requires(self._lock) helpers below
        self._index: Dict[bytes, Tuple[int, int, int]] = {}  # guarded_by(self._lock, writes)
        self._sorted: List[bytes] = []  # guarded_by(self._lock)
        self._fds: Dict[int, int] = {}  # guarded_by(self._lock)   segment id -> read fd
        self._active_id = 0  # guarded_by(self._lock)
        self._active_fd = -1  # guarded_by(self._lock)
        self._active_off = 0  # guarded_by(self._lock)
        self._live_bytes = 0  # guarded_by(self._lock)
        self._total_bytes = 0  # guarded_by(self._lock, writes)
        self._replay()
        self._open_active()

    # -- segments -------------------------------------------------------------

    def _seg_path(self, seg_id: int) -> str:
        return os.path.join(self.dir, f"{seg_id:06d}.wlog")

    def _segment_ids(self) -> List[int]:
        ids = []
        for name in os.listdir(self.dir):
            if name.endswith(".wlog"):
                try:
                    ids.append(int(name[:-5]))
                except ValueError:
                    continue
        return sorted(ids)

    def _replay(self) -> None:  # requires(self._lock)
        for seg_id in self._segment_ids():
            path = self._seg_path(seg_id)
            size = os.path.getsize(path)
            fd = os.open(path, os.O_RDONLY)
            self._fds[seg_id] = fd
            off = 0
            valid_until = 0
            while off + _HEADER.size <= size:
                header = os.pread(fd, _HEADER.size, off)
                if len(header) < _HEADER.size:
                    break
                op, klen, vlen = _HEADER.unpack(header)
                rec_len = _HEADER.size + klen + vlen + _CRC.size
                if op not in (_OP_PUT, _OP_DEL) or off + rec_len > size:
                    break
                body = os.pread(fd, klen + vlen + _CRC.size,
                                off + _HEADER.size)
                key = body[:klen]
                (crc,) = _CRC.unpack(body[klen + vlen:])
                if crc != zlib.crc32(header + body[:klen + vlen]):
                    break  # torn tail
                if op == _OP_PUT:
                    self._index_put(
                        key, (seg_id, off + _HEADER.size + klen, vlen))
                else:
                    self._index_del(key)
                off += rec_len
                valid_until = off
            if valid_until < size:
                # torn tail from a crash mid-append: cut it, or new
                # records appended after the garbage would be lost on
                # the NEXT replay (it stops at the first bad record)
                os.truncate(path, valid_until)
            self._total_bytes += valid_until
            self._active_id = max(self._active_id, seg_id)
        self._live_bytes = sum(
            _HEADER.size + len(k) + loc[2] + _CRC.size
            for k, loc in self._index.items())

    def _open_active(self) -> None:  # requires(self._lock)
        if not self._fds:
            self._active_id = 1
        path = self._seg_path(self._active_id)
        self._active_fd = os.open(path, os.O_WRONLY | os.O_CREAT)
        self._active_off = os.fstat(self._active_fd).st_size
        if self._active_id not in self._fds:
            self._fds[self._active_id] = os.open(path, os.O_RDONLY)
        # a replay may have found a torn tail: drop it
        # (records after valid_until were never indexed)

    # -- index ---------------------------------------------------------------

    def _index_put(self, key: bytes, loc: Tuple[int, int, int]) -> None:  # requires(self._lock)
        if key not in self._index:
            bisect.insort(self._sorted, key)
        else:
            old = self._index[key]
            self._live_bytes -= _HEADER.size + len(key) + old[2] + _CRC.size
        self._index[key] = loc
        self._live_bytes += _HEADER.size + len(key) + loc[2] + _CRC.size

    def _index_del(self, key: bytes) -> None:  # requires(self._lock)
        old = self._index.pop(key, None)
        if old is not None:
            i = bisect.bisect_left(self._sorted, key)
            if i < len(self._sorted) and self._sorted[i] == key:
                del self._sorted[i]
            self._live_bytes -= _HEADER.size + len(key) + old[2] + _CRC.size

    # -- write path ----------------------------------------------------------

    def _append(self, op: int, key: bytes, value: bytes) -> int:  # requires(self._lock)
        header = _HEADER.pack(op, len(key), len(value))
        crc = zlib.crc32(header + key + value)
        rec = header + key + value + _CRC.pack(crc)
        off = self._active_off
        os.pwrite(self._active_fd, rec, off)
        self._active_off += len(rec)
        self._total_bytes += len(rec)
        return off

    def put(self, key: bytes, value: bytes) -> None:
        with self._lock:
            off = self._append(_OP_PUT, key, value)
            self._index_put(
                key, (self._active_id, off + _HEADER.size + len(key),
                      len(value)))
            self._maybe_compact()

    def delete(self, key: bytes) -> None:
        with self._lock:
            if key not in self._index:
                return
            self._append(_OP_DEL, key, b"")
            self._index_del(key)
            self._maybe_compact()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            loc = self._index.get(key)
            if loc is None:
                return None
            seg_id, off, vlen = loc
            return os.pread(self._fds[seg_id], vlen, off)

    def scan(self, prefix: bytes, start: bytes = b"",
             inclusive: bool = True) -> Iterator[Tuple[bytes, bytes]]:
        """Ordered (key, value) pairs with the prefix, from start."""
        with self._lock:
            lo = bisect.bisect_left(self._sorted, max(prefix, start)
                                    if start else prefix)
            keys = []
            for i in range(lo, len(self._sorted)):
                k = self._sorted[i]
                if not k.startswith(prefix):
                    break
                if start and not inclusive and k == start:
                    continue
                keys.append(k)
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v

    def delete_prefix(self, prefix: bytes) -> int:
        with self._lock:
            doomed = [k for k, _ in self.scan(prefix)]
            for k in doomed:
                self._append(_OP_DEL, k, b"")
                self._index_del(k)
            self._maybe_compact()
            return len(doomed)

    # -- compaction ----------------------------------------------------------

    def _maybe_compact(self) -> None:  # requires(self._lock)
        if self._total_bytes < self.COMPACT_MIN_BYTES or \
                self._total_bytes < 2 * max(self._live_bytes, 1):
            return
        self.compact()

    def compact(self) -> None:
        """Rewrite live records into a fresh segment; drop the rest.
        Crash-safe: the new segment is fully written + fsynced before
        old segments are removed, and replay naturally takes the
        newest record per key."""
        with self._lock:
            new_id = self._active_id + 1
            path = self._seg_path(new_id)
            wfd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
            off = 0
            new_locs: Dict[bytes, Tuple[int, int, int]] = {}
            for key in self._sorted:
                seg_id, voff, vlen = self._index[key]
                value = os.pread(self._fds[seg_id], vlen, voff)
                header = _HEADER.pack(_OP_PUT, len(key), len(value))
                rec = header + key + value + _CRC.pack(
                    zlib.crc32(header + key + value))
                os.pwrite(wfd, rec, off)
                new_locs[key] = (new_id, off + _HEADER.size + len(key),
                                 vlen)
                off += len(rec)
            os.fsync(wfd)
            os.close(wfd)
            old_ids = list(self._fds)
            os.close(self._active_fd)
            self._fds[new_id] = os.open(path, os.O_RDONLY)
            self._index.update(new_locs)
            self._active_id = new_id
            self._active_fd = os.open(path, os.O_WRONLY)
            self._active_off = off
            self._total_bytes = off
            self._live_bytes = off
            for seg_id in old_ids:
                os.close(self._fds.pop(seg_id))
                os.remove(self._seg_path(seg_id))
            _log.info("kv %s: compacted to segment %d (%d keys, %d bytes)",
                      self.dir, new_id, len(self._index), off)

    # -- lifecycle -----------------------------------------------------------

    def sync(self) -> None:
        with self._lock:
            os.fsync(self._active_fd)

    def close(self) -> None:
        with self._lock:
            if self._active_fd >= 0:
                os.fsync(self._active_fd)
                os.close(self._active_fd)
                self._active_fd = -1
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()

    def __len__(self) -> int:
        return len(self._index)


class KvFilerStore(FilerStore):
    """FilerStore over LogKV (the "leveldb-class" embedded backend)."""

    name = "weedkv"

    def __init__(self, directory: str):
        self.kv = LogKV(directory)
        self._txn = threading.RLock()

    @staticmethod
    def _entry_key(directory: str, name: str) -> bytes:
        return b"e" + normalize_path(directory).encode() + b"\x00" + \
            name.encode()

    def insert_entry(self, directory, entry):
        self.kv.put(self._entry_key(directory, entry.name),
                    entry.SerializeToString())

    update_entry = insert_entry

    def find_entry(self, directory, name):
        blob = self.kv.get(self._entry_key(directory, name))
        if blob is None:
            raise NotFound(f"{directory}/{name}")
        e = filer_pb2.Entry()
        e.ParseFromString(blob)
        return e

    def delete_entry(self, directory, name):
        self.kv.delete(self._entry_key(directory, name))

    def delete_folder_children(self, directory):
        d = normalize_path(directory).encode()
        self.kv.delete_prefix(b"e" + d + b"\x00")
        if d != b"/":
            self.kv.delete_prefix(b"e" + d + b"/")
        else:
            self.kv.delete_prefix(b"e/")

    def list_directory_entries(self, directory, start_name="",
                               inclusive=False, limit=1024, prefix=""):
        base = b"e" + normalize_path(directory).encode() + b"\x00"
        start = base + start_name.encode() if start_name else b""
        out: List[filer_pb2.Entry] = []
        for k, v in self.kv.scan(base + prefix.encode(), start=start,
                                 inclusive=inclusive):
            e = filer_pb2.Entry()
            e.ParseFromString(v)
            out.append(e)
            if len(out) >= limit:
                break
        return out

    def begin_transaction(self):
        self._txn.acquire()

    def commit_transaction(self):
        self._txn.release()

    def rollback_transaction(self):
        self._txn.release()

    def kv_put(self, key, value):
        self.kv.put(b"k" + bytes(key), bytes(value))

    def kv_get(self, key):
        return self.kv.get(b"k" + bytes(key))

    def close(self):
        self.kv.close()
