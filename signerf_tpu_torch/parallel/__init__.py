"""Data and tensor parallelism over cards on `torch.distributed` (the port
of `signerf_tpu/parallel`'s meshes)."""

from signerf_tpu_torch.parallel.mesh import (
    DataMesh,
    MeshShape,
    init_mesh,
    launched,
    mesh_from_spec,
    production_shape,
    rank_seed,
    run,
    spawn,
)

__all__ = ["DataMesh", "MeshShape", "init_mesh", "launched", "mesh_from_spec", "production_shape", "rank_seed", "run",
           "spawn"]
