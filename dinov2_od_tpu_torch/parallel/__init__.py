"""Data and Megatron tensor parallelism over torch.distributed process
groups (counterpart of dinov2_od_tpu/parallel/)."""

from .collectives import (
    all_reduce,
    copy_to_model,
    reduce_from_model,
    reduce_gradients,
)
from .sharding import (
    Mesh,
    batch_sharding,
    check_tp_compatible,
    create_mesh,
    gather_params,
    model_size,
    shard_params,
)

__all__ = [
    "Mesh", "all_reduce", "batch_sharding", "check_tp_compatible",
    "copy_to_model", "create_mesh", "gather_params", "model_size",
    "reduce_from_model", "reduce_gradients", "shard_params",
]
