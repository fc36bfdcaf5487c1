"""EC file formats: shard names, block geometry, .ecx/.ecj and the
decode of shards back into a .dat.

The same files, byte for byte, as ``seaweedfs_tpu.ec.encoder`` and the
reference weed/storage/erasure_coding/ec_encoder.go + ec_decoder.go.
The parity itself comes from the fleet (``ec/fleet.py``), the one engine
of the port's EC batch work: ``write_ec_files`` and ``rebuild_ec_files``
run one volume through it.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from seaweedfs_tpu_torch.ops.rs_code import DATA_SHARDS
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
    """Generate .ec00-.ec13 from <base>.dat: a fleet of one volume."""
    from seaweedfs_tpu_torch.ec import fleet
    fleet.fleet_write_ec_files([base_name], backend=backend,
                               large_block=large_block,
                               small_block=small_block, chunk=chunk)


def _read_padded(f, offset: int, buf: np.ndarray) -> None:
    """Fill the 1-D uint8 ``buf`` in place from ``f`` at ``offset``.
    Buffers come uninitialised from the pinned pool and are reused, so
    the tail past EOF is zeroed here every time (GF maps send 0 to 0:
    zero padding encodes to zero parity, as the reference pads)."""
    f.seek(offset)
    got = f.readinto(memoryview(buf))
    if got < len(buf):
        buf[got:] = 0


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
    """Regenerate missing .ecNN from >=10 present ones, a fleet of one
    volume (``fleet.fleet_rebuild_ec_files``). Returns the generated
    shard ids."""
    from seaweedfs_tpu_torch.ec import fleet
    return fleet.fleet_rebuild_ec_files([base_name], backend=backend,
                                        chunk=chunk,
                                        wanted=wanted)[base_name]


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
