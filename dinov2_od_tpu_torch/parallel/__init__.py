"""The multi-process start-up, and data, context (ring), pipeline and
Megatron tensor parallelism over torch.distributed process groups
(counterpart of dinov2_od_tpu/parallel/)."""

from .collectives import (
    all_reduce,
    copy_to_model,
    gather_tokens,
    reduce_from_model,
    reduce_gradients,
    ring_shift,
    shard_tokens,
)
from .multihost import host_shard_indices, initialize_multihost
from .sharding import (
    Mesh,
    auto_mesh,
    batch_sharding,
    check_tp_compatible,
    context_size,
    create_mesh,
    gather_params,
    model_size,
    shard_params,
)

__all__ = [
    "Mesh", "all_reduce", "auto_mesh", "batch_sharding",
    "check_tp_compatible", "context_size", "copy_to_model", "create_mesh",
    "gather_params", "gather_tokens", "host_shard_indices",
    "initialize_multihost", "model_size", "reduce_from_model",
    "reduce_gradients", "ring_shift", "shard_params", "shard_tokens",
]
