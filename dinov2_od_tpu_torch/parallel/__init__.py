"""Data, context (ring) and Megatron tensor parallelism over
torch.distributed process groups (counterpart of dinov2_od_tpu/parallel/)."""

from .collectives import (
    all_reduce,
    copy_to_model,
    gather_tokens,
    reduce_from_model,
    reduce_gradients,
    ring_shift,
    shard_tokens,
)
from .sharding import (
    Mesh,
    batch_sharding,
    check_tp_compatible,
    context_size,
    create_mesh,
    gather_params,
    model_size,
    shard_params,
)

__all__ = [
    "Mesh", "all_reduce", "batch_sharding", "check_tp_compatible",
    "context_size", "copy_to_model", "create_mesh", "gather_params",
    "gather_tokens", "model_size", "reduce_from_model", "reduce_gradients",
    "ring_shift", "shard_params", "shard_tokens",
]
