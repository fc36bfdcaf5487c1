"""The EC data plane over a mesh of cards.

The counterpart of ``seaweedfs_tpu.parallel``. Axes of a ``Mesh``:

  dp   volume-batch axis: independent volumes' spans side by side.
  sp   lane axis: one span's byte columns split across cards; GF maps are
       per byte column, so this axis needs no collectives to encode.

One process drives every card (``parallel/mesh.py``): what JAX sums with
``psum`` is summed on the host, and its ``ppermute`` is a peer copy.
``mesh_fleet`` is the unified scheduler whose fused buckets span the whole
mesh, with the ``pod_*`` fallback ladder to the per-card fleets.
"""

from seaweedfs_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedBatch,
    make_mesh,
    shard_batch,
    sharded_encode,
    sharded_write_ec_files,
    ec_pipeline_step,
    rotate_shards,
    volume_shard_matrix,
    round_robin_by_size,
    fleet_write_ec_files_sharded,
)
from seaweedfs_tpu_torch.parallel.mesh_fleet import (
    MeshError,
    MeshDispatchTimeout,
    MeshUnavailable,
    MeshVerifyMismatch,
    mesh_write_ec_files,
    mesh_verify_ec_files,
    mesh_rebuild_ec_files,
    pod_write_ec_files,
    pod_verify_ec_files,
    sharded_reconstruct,
)

__all__ = ["Mesh", "ShardedBatch", "make_mesh", "shard_batch",
           "sharded_encode", "sharded_write_ec_files",
           "ec_pipeline_step", "rotate_shards", "volume_shard_matrix",
           "round_robin_by_size", "fleet_write_ec_files_sharded",
           "MeshError", "MeshDispatchTimeout", "MeshUnavailable",
           "MeshVerifyMismatch", "mesh_write_ec_files",
           "mesh_verify_ec_files", "mesh_rebuild_ec_files",
           "pod_write_ec_files", "pod_verify_ec_files",
           "sharded_reconstruct"]
