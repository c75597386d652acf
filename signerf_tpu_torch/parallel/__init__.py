"""Data parallelism over cards on `torch.distributed` (the port of
`signerf_tpu/parallel`'s data mesh; the tensor axis is not ported)."""

from signerf_tpu_torch.parallel.mesh import (
    DataMesh,
    init_mesh,
    launched,
    mesh_from_spec,
    rank_seed,
    run,
    spawn,
)

__all__ = ["DataMesh", "init_mesh", "launched", "mesh_from_spec", "rank_seed", "run", "spawn"]
