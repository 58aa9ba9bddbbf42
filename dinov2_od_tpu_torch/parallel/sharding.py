"""The process mesh and the Megatron partition rules (counterpart of
dinov2_od_tpu/parallel/sharding.py).

A ('data', 'model') mesh of processes, laid out as the JAX package lays
out its devices: rank r sits at data index r // tp and model index
r % tp. The 'data' axis splits the batch (DP); the 'model' axis holds
Megatron tensor-parallel shards (TP), with the JAX package's rules by leaf
name:

- column-parallel (output dim sharded): the q/k/v/fc1 kernels, their bias
  and lora_B, and the deformable value projection (`value_kernel`,
  `value_bias`);
- row-parallel (input dim sharded): the proj/fc2/out kernels, their
  lora_A, and the deformable `output_kernel`;
- everything else replicated, among them the LoRA factors on the other
  side of each split, the row-parallel biases, the deformable offset and
  weight projections, LayerNorm and LayerScale vectors and the embeddings.

Where GSPMD places the collectives in JAX, the port's modules call them by
hand (parallel/collectives.py): each tensor-parallel module takes and
returns replicated activations, sums its row-parallel output over the
model group once, and reduces its input's gradient there once. Leaves
that stay replicated but feed only this rank's heads or columns
(`partial_grad`) get partial gradients, which the train step sums over
the model group.

The caller starts torch.distributed (`init_process_group` with the
backend, address, world size and rank) before `create_mesh`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshConfig

Params = Dict[str, Any]

# Column-parallel linears: output dim sharded over 'model'.
_COL_PARALLEL = ("q", "k", "v", "fc1")
# Row-parallel linears: input dim sharded over 'model'. "out" is the
# decoder attention's output projection; "proj" the backbone's.
_ROW_PARALLEL = ("proj", "fc2", "out")
# Deformable-attention leaves (parent "deform").
_DEFORM_COL = ("value_kernel", "value_bias")
_DEFORM_ROW = ("output_kernel",)
# Replicated deformable projections that each rank slices to its heads.
_DEFORM_HEAD_SLICED = ("offsets_kernel", "offsets_bias", "weights_kernel",
                       "weights_bias")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the ('data', 'model') mesh and the process
    groups of its two axes. `backend` is the process groups' backend:
    "nccl" for one card a rank, "gloo" for ranks that share a card or run
    on the CPU (parallel/collectives.py stages CUDA tensors through the
    host for it)."""

    data_size: int
    model_size: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any
    backend: str
    cfg: MeshConfig = MeshConfig()


def model_size(mesh: Optional[Mesh]) -> int:
    """The tensor-parallel degree; 1 without a mesh."""
    return 1 if mesh is None else mesh.model_size


def create_mesh(model_parallel_size: int = 1,
                cfg: MeshConfig = MeshConfig()) -> Mesh:
    """This process's mesh over the started torch.distributed world: the
    world reshaped to [world / tp, tp] (the JAX package's
    `np.asarray(devices).reshape(n // tp, tp)`), one data group per
    column and one model group per row. Every rank must call it, in the
    same order as any other group creation."""
    world, rank = dist.get_world_size(), dist.get_rank()
    tp = model_parallel_size
    if tp < 1 or world % tp:
        raise ValueError(f"{world} processes not divisible by "
                         f"model_parallel_size={tp}")
    grid = np.arange(world).reshape(world // tp, tp)
    data_groups = [dist.new_group(grid[:, m].tolist()) for m in range(tp)]
    model_groups = [dist.new_group(grid[d].tolist())
                    for d in range(world // tp)]
    d, m = divmod(rank, tp)
    return Mesh(data_size=world // tp, model_size=tp, data_index=d,
                model_index=m, data_group=data_groups[m],
                model_group=model_groups[d], backend=dist.get_backend(),
                cfg=cfg)


def shard_dim(path: Tuple[str, ...]) -> Optional[int]:
    """The dim (counted from the right, as the JAX rules are) that the leaf
    at `path` shards over the model axis; None when it is replicated."""
    parent = path[-2] if len(path) >= 2 else ""
    name = path[-1]
    if parent == "deform":
        if name in _DEFORM_COL:
            return -1
        return -2 if name in _DEFORM_ROW else None
    if parent in _COL_PARALLEL:
        if name in ("kernel", "kernel_q", "bias", "w_scale", "lora_B"):
            return -1
        return None  # lora_A replicated (rank is tiny)
    if parent in _ROW_PARALLEL:
        return -2 if name in ("kernel", "kernel_q", "lora_A") else None
    return None


def partial_grad(path: Tuple[str, ...]) -> bool:
    """A replicated leaf whose gradient each rank holds only its share of:
    the LoRA factor on the replicated side of a split linear (its product
    runs over this rank's columns or rows only) and the deformable offset
    and weight projections (each rank takes its heads' columns)."""
    parent = path[-2] if len(path) >= 2 else ""
    name = path[-1]
    if parent in _COL_PARALLEL:
        return name == "lora_A"
    if parent in _ROW_PARALLEL:
        return name == "lora_B"
    return parent == "deform" and name in _DEFORM_HEAD_SLICED


def map_with_path(fn, tree: Params, path=()) -> Params:
    """fn(path, leaf) over the leaves of nested dicts; None stays None."""
    return {k: (map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
                else (None if v is None else fn(path + (k,), v)))
            for k, v in tree.items()}


def leaf_paths(tree: Params, path=()) -> list:
    """The paths of the non-None leaves of nested dicts, in the order of
    train/state.py's `tree_leaves`."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaf_paths(v, path + (k,))
        elif v is not None:
            out.append(path + (k,))
    return out


def local_slice(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous share of a dim of size n over the model
    axis."""
    w = n // mesh.model_size
    return slice(mesh.model_index * w, (mesh.model_index + 1) * w)


def shard_params(params: Params, mesh: Mesh) -> Params:
    """This rank's shard of a full param tree: each sharded leaf sliced
    (and copied, contiguous) at the rank's model index; replicated leaves
    as they are."""
    def shard(path, leaf):
        d = shard_dim(path)
        if d is None or mesh.model_size == 1:
            return leaf
        return leaf[(slice(None),) * (leaf.dim() + d)
                    + (local_slice(leaf.shape[d], mesh),)].clone()

    return map_with_path(shard, params)


def gather_params(shards: Params, mesh: Mesh) -> Params:
    """The full tree back from every rank's shard (the inverse of
    `shard_params`), on every rank of the model group: sharded leaves
    all-gathered and concatenated, replicated ones this rank's. For tests
    and comparisons."""
    from .collectives import all_gather

    def gather(path, leaf):
        d = shard_dim(path)
        if d is None or mesh.model_size == 1:
            return leaf
        return torch.cat(all_gather(leaf.detach(), mesh.model_group,
                                    mesh.backend), dim=d)

    return map_with_path(gather, shards)


def check_tp_compatible(detector_cfg, model_parallel_size: int) -> None:
    """Head counts and sharded dims must divide the model axis, as the JAX
    package requires; the SwiGLU FFN is not split yet."""
    if model_parallel_size <= 1:
        return
    tp = model_parallel_size
    bb, dec = detector_cfg.backbone, detector_cfg.decoder
    for what, heads in (("backbone", bb.num_heads), ("decoder", dec.num_heads)):
        if heads % tp != 0:
            raise ValueError(
                f"{what} num_heads={heads} not divisible by "
                f"model_parallel_size={tp}")
    for what, dim in (
        ("backbone hidden_dim", bb.hidden_dim),
        ("backbone mlp_dim", bb.mlp_dim),
        ("decoder hidden_dim", dec.hidden_dim),
        ("decoder dim_feedforward", dec.dim_feedforward),
    ):
        if dim % tp != 0:
            raise ValueError(
                f"{what}={dim} not divisible by model_parallel_size={tp}")
    if bb.ffn_type == "swiglu":
        raise NotImplementedError(
            "tensor parallelism of the SwiGLU FFN (ViT-g) is not ported yet "
            "(ROADMAP.md): its fc1 output holds two halves to split apart")


def batch_sharding(batch: Dict[str, torch.Tensor],
                   mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of a global batch: the leading dim split over the
    data axis (every rank of a model group gets the same images)."""
    out = {}
    for key, x in batch.items():
        n = x.shape[0]
        if n % mesh.data_size:
            raise ValueError(f"batch {n} not divisible by the data axis "
                             f"{mesh.data_size}")
        w = n // mesh.data_size
        out[key] = x[mesh.data_index * w:(mesh.data_index + 1) * w]
    return out


def keep_mask(shape, keep: float, generator: torch.Generator, device,
              mesh: Optional[Mesh] = None,
              shard_dim: Optional[int] = None) -> torch.Tensor:
    """A dropout keep-mask of `shape` drawn from `generator`. Under a mesh
    it is drawn at the global shape (dim 0, the batch, times the data size,
    and `shard_dim`, a dim split over the model axis, times the model size)
    and this rank's part is cut out of it, so with every rank's generator
    seeded alike the ranks together drop exactly what one process would."""
    if mesh is None or (mesh.data_size == 1 and shard_dim is None):
        return torch.rand(shape, generator=generator, device=device) < keep
    full = list(shape)
    full[0] *= mesh.data_size
    if shard_dim is not None:
        full[shard_dim] *= mesh.model_size
    mask = torch.rand(full, generator=generator, device=device) < keep
    mask = mask.narrow(0, mesh.data_index * shape[0], shape[0])
    if shard_dim is not None:
        mask = mask.narrow(shard_dim, mesh.model_index * shape[shard_dim],
                           shape[shard_dim])
    return mask
