"""A mesh of cards and the sharded EC programs over it.

The counterpart of ``seaweedfs_tpu.parallel.mesh``. One process drives
every card of the mesh, as JAX's single controller does: a batch
``data[B, R, N]`` is laid out like JAX's ``P('dp', None, 'sp')``, block
``(i, j)`` (rows ``i*B/dp ..``, lanes ``j*N/sp ..``) on card ``(i, j)``, and
each card runs the ``gf_linear`` kernel on its own block. The GF map is per
byte column, so encode and rebuild need no collectives. What JAX reduces
with a ``psum`` is summed here after the per-card results reach the host,
and its ``ppermute`` is a peer copy ``tensor.to(devices[(i + shift) %
dp])``. There is no ``torch.distributed`` and no NCCL ring.

A mesh of ``torch.device("cpu")`` entries runs the same code on the
kernels' plain versions: the tests build one of 8 to hold the dp/sp split,
the lane offsets and the combining of results against JAX's 8-device CPU
mesh.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from seaweedfs_tpu_torch.ops import gf_compare, gf_kernel
from seaweedfs_tpu_torch.ops.rs_code import (
    DATA_SHARDS, TOTAL_SHARDS, ReedSolomon, coding_matrix)


class Mesh:
    """A ``[dp, sp]`` grid of torch devices. ``dp`` is the volume-batch
    axis, ``sp`` the lane axis; ``shape["dp"]``/``shape["sp"]`` as on a
    JAX mesh."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        if not self.devices or not self.devices[0] or \
                len({len(row) for row in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty [dp, sp] grid")
        self.shape = {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def flat(self) -> List[torch.device]:
        return [d for row in self.devices for d in row]

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, " \
            f"devices={[str(d) for d in self.flat]})"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over ``devices`` (default: every CUDA device), factored (dp,
    sp) as the JAX package does: sp is the largest power of two with
    ``4 * sp**2 <= n`` that divides n, dp the rest."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n == 0:
        raise ValueError("make_mesh: no devices")
    sp = 1
    while sp * 2 * sp * 2 <= n and n % (sp * 2) == 0:
        sp *= 2
    return Mesh([devices[i * sp:(i + 1) * sp] for i in range(n // sp)])


class ShardedBatch:
    """A ``[B, R, N]`` uint8 batch held over a mesh: ``blocks[i][j]`` is
    the ``[B/dp, R, N/sp]`` block on ``mesh.devices[i][j]``.
    ``np.asarray`` gathers it to the host."""

    def __init__(self, mesh: Mesh, blocks: List[List[torch.Tensor]]):
        self.mesh = mesh
        self.blocks = blocks

    @property
    def shape(self) -> Tuple[int, int, int]:
        first = self.blocks[0][0]
        return (first.shape[0] * len(self.blocks), first.shape[1],
                sum(b.shape[2] for b in self.blocks[0]))

    def numpy(self) -> np.ndarray:
        return torch.cat([torch.cat([b.cpu() for b in row], dim=2)
                          for row in self.blocks], dim=0).numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)


def shard_batch(mesh: Mesh, data: np.ndarray) -> ShardedBatch:
    """Lay a ``[B, R, N]`` host batch out over the mesh. B must divide by
    dp and N by sp, as JAX's sharding requires."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    data = np.asarray(data, dtype=np.uint8)
    b, _, n = data.shape
    if b % dp or n % sp:
        raise ValueError(f"batch {data.shape} does not split over "
                         f"dp={dp}, sp={sp}")
    b, n = b // dp, n // sp
    return ShardedBatch(mesh, [
        [torch.from_numpy(np.ascontiguousarray(
            data[i * b:(i + 1) * b, :, j * n:(j + 1) * n])).to(dev)
         for j, dev in enumerate(row)]
        for i, row in enumerate(mesh.devices)])


@functools.lru_cache(maxsize=64)
def decode_matrix(present: Tuple[int, ...],
                  missing: Tuple[int, ...]) -> np.ndarray:
    """The GF(2^8) map from shards present[:10] to shards ``missing``,
    cached per signature."""
    return ReedSolomon(backend="cpu").decode_matrix(present, missing)


def _parity_map(device) -> gf_kernel.GfMatrix:
    return gf_kernel.prepare_matrix(coding_matrix()[DATA_SHARDS:], device)


def sharded_encode(mesh: Mesh, data) -> ShardedBatch:
    """Encode a ``[B, 10, N]`` batch of volume rows across the mesh: one
    ``gf_linear`` launch per card on its own block."""
    x = data if isinstance(data, ShardedBatch) else shard_batch(mesh, data)
    return ShardedBatch(mesh, [
        [gf_kernel.gf_linear(_parity_map(blk.device), blk) for blk in row]
        for row in x.blocks])


def rotate_shards(mesh: Mesh, shards, shift: int = 1) -> ShardedBatch:
    """Move every dp-row of blocks ``shift`` places along dp (a peer copy
    per block): the on-mesh balancedEcDistribution of the reference
    (shell/command_ec_encode.go:248-264), so that no card keeps all the
    shards of the volumes it encoded. With dp = 1 it is the identity."""
    x = shards if isinstance(shards, ShardedBatch) \
        else shard_batch(mesh, shards)
    dp = mesh.shape["dp"]
    shift %= dp
    blocks: List[List[torch.Tensor]] = [[] for _ in range(dp)]
    for i in range(dp):
        dest = (i + shift) % dp
        blocks[dest] = [blk.to(mesh.devices[dest][j])
                        for j, blk in enumerate(x.blocks[i])]
    return ShardedBatch(mesh, blocks)


def ec_pipeline_step(mesh: Mesh, data, drop: Tuple[int, int] = (3, 11)):
    """Encode, lose the two shards ``drop``, rebuild them from the
    survivors, and count the rebuilt bytes that differ from the lost
    ones, on every card of the mesh. Returns (parity, rebuilt,
    mismatches): two ShardedBatch and the count summed over the cards,
    which must be 0."""
    x = data if isinstance(data, ShardedBatch) else shard_batch(mesh, data)
    present = [i for i in range(TOTAL_SHARDS) if i not in drop]
    dec = decode_matrix(tuple(present), tuple(drop))
    n_total = x.shape[2]
    parity, rebuilt = [], []
    mismatches = 0
    for row in x.blocks:
        prow, rrow = [], []
        for j, blk in enumerate(row):
            p = gf_kernel.gf_linear(_parity_map(blk.device), blk)
            full = torch.cat([blk, p], dim=1)
            r = gf_kernel.gf_linear(
                gf_kernel.prepare_matrix(dec, blk.device),
                full[:, present[:DATA_SHARDS]])
            limits = torch.full(r.shape[:2], n_total, dtype=torch.int32,
                                device=blk.device)
            counts, _ = gf_compare.gf_compare(
                r, full[:, list(drop)], limits, j * blk.shape[2])
            mismatches += int(counts.sum())
            prow.append(p)
            rrow.append(r)
        parity.append(prow)
        rebuilt.append(rrow)
    return ShardedBatch(mesh, parity), ShardedBatch(mesh, rebuilt), \
        mismatches


# -- many volumes over the mesh ---------------------------------------------

def volume_shard_matrix(dat_path: str, small_block: int) -> np.ndarray:
    """A volume's .dat as its shard-content matrix ``[10,
    n_rows*small_block]``: row r of the .dat is its shards' r-th blocks,
    so stacking rows per shard gives the bytes of .ec00-.ec09."""
    raw = np.fromfile(dat_path, dtype=np.uint8)
    row_bytes = DATA_SHARDS * small_block
    n_rows = -(-len(raw) // row_bytes)   # 0 rows for an empty .dat
    padded = np.zeros(n_rows * row_bytes, dtype=np.uint8)
    padded[: len(raw)] = raw
    rows = padded.reshape(n_rows, DATA_SHARDS, small_block)
    return np.ascontiguousarray(
        np.moveaxis(rows, 0, 1)).reshape(DATA_SHARDS, n_rows * small_block)


def sharded_write_ec_files(mesh: Mesh, base_names: Sequence[str],
                           small_block: int = 1 << 20) -> None:
    """Encode MANY volumes over the mesh and write each volume's
    .ec00-.ec13, byte for byte ``write_ec_files``' (volumes under 10
    large blocks). The JAX package's name for one pass of the unified
    mesh scheduler (``mesh_fleet.mesh_write_ec_files``), which it is."""
    from seaweedfs_tpu_torch.parallel import mesh_fleet

    mesh_fleet.mesh_write_ec_files(base_names, mesh=mesh,
                                   small_block=small_block)


# -- one fleet scheduler per card ---------------------------------------------

def round_robin_by_size(base_names: Sequence[str],
                        n_shards: int) -> List[List[str]]:
    """Deal volumes to ``n_shards`` buckets, largest .dat first, each to
    the currently lightest bucket (the LPT deal), so the per-card
    schedulers finish together."""
    sizes = {b: os.path.getsize(b + ".dat") for b in base_names}
    order = sorted(base_names, key=lambda b: (-sizes[b], b))
    buckets: List[List[str]] = [[] for _ in range(max(1, n_shards))]
    loads = [0] * len(buckets)
    for b in order:
        i = loads.index(min(loads))
        buckets[i].append(b)
        loads[i] += sizes[b] or 1  # empty volumes still cost a slot
    return buckets


def fleet_write_ec_files_sharded(base_names: Sequence[str],
                                 devices: Optional[Sequence] = None,
                                 mesh: Optional[Mesh] = None,
                                 backend: str = "cuda",
                                 **fleet_kw) -> None:
    """ONE port fleet scheduler per card, each bound to its card
    (``fleet_write_ec_files(device=)``), with the volumes dealt by size
    so the schedulers finish together. Encode has no cross-volume math,
    so they share nothing but the disk. On "cpu" the volumes are dealt
    over a couple of host schedulers instead."""
    from seaweedfs_tpu_torch.ec import fleet as fleet_mod

    if not base_names:
        return
    if devices is None:
        if backend == "cuda":
            devices = (mesh.flat if mesh is not None else
                       [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]) or [None]
        else:
            devices = [None] * max(1, min(len(base_names),
                                          (os.cpu_count() or 2) // 2))
    shards = [s for s in round_robin_by_size(base_names, len(devices)) if s]
    if backend != "cuda":
        devices = [None] * len(shards)
    errors: List[BaseException] = []

    def run(names: List[str], dev) -> None:
        try:
            fleet_mod.fleet_write_ec_files(names, backend=backend,
                                           device=dev, **fleet_kw)
        except BaseException as e:
            errors.append(e)

    # lint: thread-ok(one scheduler thread per card for the whole pass; no request context)
    threads = [threading.Thread(target=run, args=(names, dev),
                                name=f"fleet-shard-{i}")
               for i, (names, dev) in enumerate(zip(shards, devices))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
