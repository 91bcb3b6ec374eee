"""The data-parallel runtime on ``torch.distributed`` (counterpart of
``medseg/parallel``): the mesh and its collectives (``mesh``), the process
group and per-rank data sharding (``runtime``)."""

from medseg_torch.parallel.mesh import (
    Mesh,
    all_reduce_gradients,
    make_mesh,
    psum_metric_counts,
    replicate,
    shard_batch,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "replicate",
    "all_reduce_gradients",
    "psum_metric_counts",
]
