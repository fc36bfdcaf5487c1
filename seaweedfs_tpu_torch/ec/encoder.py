"""EC encode / rebuild / decode over volume files.

The same files, byte for byte, as ``seaweedfs_tpu.ec.encoder`` and the
reference weed/storage/erasure_coding/ec_encoder.go + ec_decoder.go.

Each 10-block row is encoded as a ``[10, chunk]`` (large rows) or
``[rows, 10, small]`` (small rows) uint8 slab and parity comes from one
GF(2^8) linear map (``ops.rs_code``), on the card one kernel launch per
slab. Slabs are read from disk straight into pinned host buffers
(``ReedSolomon.host_buffer``), so the copy to the card is a true async
DMA, and a depth-2 pipeline overlaps the card's work on slab i with the
disk IO of slabs i-1 and i+1. Data shards never pass through the codec:
the code is systematic, so they are padded copies of .dat slices.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from seaweedfs_tpu_torch.ops.rs_code import (
    DATA_SHARDS, TOTAL_SHARDS, ReedSolomon)
from seaweedfs_tpu_torch.storage import idx as idx_codec
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import actual_size

LARGE_BLOCK_SIZE = 1 << 30  # 1GB
SMALL_BLOCK_SIZE = 1 << 20  # 1MB
DEFAULT_CHUNK = 16 << 20       # codec slab, host backend
DEFAULT_CHUNK_CUDA = 64 << 20  # codec slab, card: chip_smoke.py sweeps
                               # 16/64/256 MiB (PERF.md)


def shard_file_name(base_name: str, shard_id: int) -> str:
    return f"{base_name}.ec{shard_id:02d}"


def default_chunk_for(backend: str) -> int:
    return DEFAULT_CHUNK_CUDA if backend == "cuda" else DEFAULT_CHUNK


# --- encode -----------------------------------------------------------------

def write_ec_files(base_name: str, backend: str = "cuda",
                   large_block: int = LARGE_BLOCK_SIZE,
                   small_block: int = SMALL_BLOCK_SIZE,
                   chunk: Optional[int] = None) -> None:
    """Generate .ec00-.ec13 from <base>.dat.

    Rows are consumed exactly like the reference encoder
    (ec_encoder.go:194-231): large rows while MORE than 10*large_block
    remains, then zero-padded small rows.
    """
    if chunk is None:
        chunk = default_chunk_for(backend)
    rs = ReedSolomon(backend=backend)
    dat_size = os.path.getsize(base_name + ".dat")
    outputs = [open(shard_file_name(base_name, i), "wb")
               for i in range(TOTAL_SHARDS)]
    pipe = _EncodePipeline()
    try:
        with open(base_name + ".dat", "rb") as dat:
            remaining = dat_size
            processed = 0
            while remaining > large_block * DATA_SHARDS:
                _encode_large_row(rs, dat, processed, large_block, outputs,
                                  chunk, pipe)
                remaining -= large_block * DATA_SHARDS
                processed += large_block * DATA_SHARDS
            if remaining > 0:
                n_rows = -(-remaining // (small_block * DATA_SHARDS))
                _encode_small_rows(rs, dat, processed, small_block, n_rows,
                                   outputs, chunk, pipe)
        pipe.drain()
    finally:
        for f in outputs:
            f.close()


def _read_padded(f, offset: int, buf: np.ndarray) -> None:
    """Fill the 1-D uint8 ``buf`` in place from ``f`` at ``offset``.
    Buffers come uninitialised from the pinned pool and are reused, so
    the tail past EOF is zeroed here every time (GF maps send 0 to 0:
    zero padding encodes to zero parity, as the reference pads)."""
    f.seek(offset)
    got = f.readinto(memoryview(buf))
    if got < len(buf):
        buf[got:] = 0


# Encode dispatches in flight at once. Depth 2 is double buffering: while
# the card computes parity for slab i, the host writes slab i-1's shards
# and reads slab i+1 from disk.
PIPELINE_DEPTH = 2


class _EncodePipeline:
    """Bounded in-flight queue of (pending result, writeback)."""

    def __init__(self, depth: int = PIPELINE_DEPTH):
        self._inflight: Deque[Tuple] = deque()
        self._depth = max(1, depth)

    def submit(self, handle, writeback) -> None:
        self._inflight.append((handle, writeback))
        while len(self._inflight) >= self._depth:
            self._retire_one()

    def _retire_one(self) -> None:
        handle, writeback = self._inflight.popleft()
        writeback(handle.result())

    def drain(self) -> None:
        while self._inflight:
            self._retire_one()


def _encode_large_row(rs: ReedSolomon, dat, row_offset: int, block_size: int,
                      outputs: List, chunk: int,
                      pipe: _EncodePipeline) -> None:
    """One large row: shard i gets dat[row_offset + i*block : +block]
    (padded); parity comes chunk by chunk so a 1GB row never needs 10GB
    resident."""
    for c in range(0, block_size, chunk):
        clen = min(chunk, block_size - c)
        staged = rs.host_buffer((DATA_SHARDS, clen))
        data = staged.numpy()
        for i in range(DATA_SHARDS):
            _read_padded(dat, row_offset + i * block_size + c, data[i])
        handle = rs.encode_async(staged)
        for i in range(DATA_SHARDS):
            outputs[i].write(data[i])

        def write_parity(parity, outputs=outputs):
            for p in range(parity.shape[0]):
                outputs[DATA_SHARDS + p].write(parity[p])

        pipe.submit(handle, write_parity)


def _encode_small_rows(rs: ReedSolomon, dat, start_offset: int,
                       small_block: int, n_rows: int, outputs: List,
                       chunk: int, pipe: _EncodePipeline) -> None:
    """Tail small rows, batched: consecutive rows are contiguous in the
    .dat, so a span of B rows is a ``[B, 10, small]`` view and parity for
    all of them is one codec call (the kernel takes the batch dimension
    as it is, no transpose)."""
    row_bytes = small_block * DATA_SHARDS
    rows_per_batch = max(1, chunk // row_bytes)
    for r0 in range(0, n_rows, rows_per_batch):
        rows = min(rows_per_batch, n_rows - r0)
        staged = rs.host_buffer((rows * row_bytes,))
        _read_padded(dat, start_offset + r0 * row_bytes, staged.numpy())
        staged = staged.view(rows, DATA_SHARDS, small_block)
        data = staged.numpy()
        handle = rs.encode_async(staged)
        for i in range(DATA_SHARDS):
            outputs[i].write(np.ascontiguousarray(data[:, i, :]))

        def write_parity(parity, outputs=outputs):
            for p in range(parity.shape[1]):
                outputs[DATA_SHARDS + p].write(
                    np.ascontiguousarray(parity[:, p, :]))

        pipe.submit(handle, write_parity)


def write_sorted_file_from_idx(base_name: str, ext: str = ".ecx") -> None:
    """Replay <base>.idx, write the *live* needle set key-sorted as .ecx
    (reference WriteSortedFileFromIdx, ec_encoder.go:27-54)."""
    with open(base_name + ".idx", "rb") as f:
        live = idx_codec.final_live_entries(
            idx_codec.parse_index_bytes(f.read()))
    with open(base_name + ext, "wb") as out:
        out.write(idx_codec.entries_to_bytes(
            live["key"], live["offset"], live["size"]))


# --- rebuild ----------------------------------------------------------------

def rebuild_ec_files(base_name: str, backend: str = "cuda",
                     chunk: Optional[int] = None,
                     wanted: Optional[List[int]] = None) -> List[int]:
    """Regenerate missing .ecNN from >=10 present ones.

    ``wanted`` restricts which missing shards get rebuilt (decode to a
    volume needs only the data shards). Returns the generated shard ids
    (reference generateMissingEcFiles, ec_encoder.go:88-118).
    """
    if chunk is None:
        chunk = default_chunk_for(backend)
    present = [i for i in range(TOTAL_SHARDS)
               if os.path.exists(shard_file_name(base_name, i))]
    missing = [i for i in (range(TOTAL_SHARDS) if wanted is None else wanted)
               if i not in present]
    if not missing:
        return []
    if len(present) < DATA_SHARDS:
        raise ValueError(
            f"cannot rebuild: only {len(present)} shards present")
    rs = ReedSolomon(backend=backend)
    sources = present[:DATA_SHARDS]
    shard_size = os.path.getsize(shard_file_name(base_name, sources[0]))
    ins = {i: open(shard_file_name(base_name, i), "rb") for i in sources}
    outs = {i: open(shard_file_name(base_name, i), "wb") for i in missing}
    pipe = _EncodePipeline()
    try:
        for c in range(0, shard_size, chunk):
            clen = min(chunk, shard_size - c)
            staged = rs.host_buffer((DATA_SHARDS, clen))
            src = staged.numpy()
            for row, i in enumerate(sources):
                _read_padded(ins[i], c, src[row])
            handle = rs.reconstruct_some_async(sources, missing, staged)

            def write_rebuilt(out, outs=outs):
                for row, i in enumerate(missing):
                    outs[i].write(out[row])

            pipe.submit(handle, write_rebuilt)
        pipe.drain()
    finally:
        for f in ins.values():
            f.close()
        for f in outs.values():
            f.close()
    return missing


# --- decode back to a volume ------------------------------------------------

def _read_ec_volume_version(base_name: str) -> int:
    """The original superblock lives in the first bytes of .ec00."""
    with open(shard_file_name(base_name, 0), "rb") as f:
        header = f.read(8)
    if len(header) < 8:
        raise ValueError("ec00 shard too short for a superblock")
    return header[0]


def find_dat_file_size(base_name: str,
                       index_base_name: Optional[str] = None) -> int:
    """Recover the original .dat size from the max .ecx entry end
    (reference ec_decoder.go:45-70)."""
    version = _read_ec_volume_version(base_name)
    with open((index_base_name or base_name) + ".ecx", "rb") as f:
        arr = idx_codec.parse_index_bytes(f.read())
    live = arr["size"] >= 0
    ends = arr["offset"][live] + actual_size(
        arr["size"][live].astype(np.int64), version)
    return max(8, int(ends.max(initial=0)))  # at least the superblock


def write_dat_file(base_name: str, dat_size: int,
                   large_block: int = LARGE_BLOCK_SIZE,
                   small_block: int = SMALL_BLOCK_SIZE,
                   chunk: Optional[int] = None,
                   backend: str = "cuda") -> None:
    """Re-interleave .ec00-.ec09 rows back into <base>.dat (reference
    WriteDatFile, ec_decoder.go:153-195). Pure host IO: ``backend`` only
    picks the chunk size, as for encode and rebuild."""
    if chunk is None:
        chunk = default_chunk_for(backend)
    inputs = [open(shard_file_name(base_name, i), "rb")
              for i in range(DATA_SHARDS)]
    buf = np.empty(min(chunk, max(large_block, small_block)), dtype=np.uint8)
    try:
        with open(base_name + ".dat", "wb") as dat:
            shard_off = 0
            remaining = dat_size
            while remaining > 0:
                block = large_block if remaining > large_block * DATA_SHARDS \
                    else small_block
                for f in inputs:
                    for c in range(0, block, chunk):
                        view = buf[:min(chunk, block - c)]
                        _read_padded(f, shard_off + c, view)
                        dat.write(view)
                shard_off += block
                remaining -= block * DATA_SHARDS
            dat.truncate(dat_size)
    finally:
        for f in inputs:
            f.close()


def rebuild_ecx_file(base_name: str) -> None:
    """Replay the .ecj journal into the sorted .ecx (tombstone in place),
    then drop the journal (reference RebuildEcxFile,
    ec_volume_delete.go:51-98)."""
    ecj_path = base_name + ".ecj"
    if not os.path.exists(ecj_path):
        return
    with open(ecj_path, "rb") as j:
        journal = j.read()
    with open(base_name + ".ecx", "r+b") as ecx:
        keys = idx_codec.parse_index_bytes(ecx.read())["key"]
        for jo in range(0, len(journal) - len(journal) % 8, 8):
            key = int.from_bytes(journal[jo:jo + 8], "big")
            i = int(np.searchsorted(keys, np.uint64(key)))
            if i < len(keys) and int(keys[i]) == key:
                ecx.seek(i * t.NEEDLE_MAP_ENTRY_SIZE + t.NEEDLE_ID_SIZE +
                         t.OFFSET_SIZE)
                ecx.write((t.TOMBSTONE_SIZE & 0xFFFFFFFF).to_bytes(4, "big"))
    os.remove(ecj_path)


def write_idx_file_from_ec_index(base_name: str) -> None:
    """.idx = .ecx copied + tombstone entries for every .ecj id
    (reference WriteIdxFileFromEcIndex, ec_decoder.go:18-43)."""
    with open(base_name + ".ecx", "rb") as f:
        ecx = f.read()
    ecj_path = base_name + ".ecj"
    journal = b""
    if os.path.exists(ecj_path):
        with open(ecj_path, "rb") as j:
            journal = j.read()
    with open(base_name + ".idx", "wb") as out:
        out.write(ecx)
        for jo in range(0, len(journal) - len(journal) % t.NEEDLE_ID_SIZE,
                        t.NEEDLE_ID_SIZE):
            key = int.from_bytes(journal[jo:jo + t.NEEDLE_ID_SIZE], "big")
            out.write(idx_codec.entry_to_bytes(key, 0, t.TOMBSTONE_SIZE))
