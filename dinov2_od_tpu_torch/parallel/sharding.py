"""The process mesh and the Megatron partition rules (counterpart of
dinov2_od_tpu/parallel/sharding.py).

A ('data', 'model') mesh of processes, laid out as the JAX package lays
out its devices: rank r sits at data index r // tp and model index
r % tp. With `MeshConfig.context_parallel_size` > 0 the mesh has three
axes, ('data', 'context', 'model'), rank r at (r // (cp tp),
(r // tp) % cp, r % tp). The 'data' axis splits the batch (DP); the
'context' axis splits the backbone's tokens over a ring (CP,
ops/ring_attention.py); the 'model' axis holds Megatron tensor-parallel
shards (TP), with the JAX package's rules by leaf name:

- column-parallel (output dim sharded): the q/k/v/fc1 kernels, their bias
  and lora_B, and the deformable value projection (`value_kernel`,
  `value_bias`);
- row-parallel (input dim sharded): the proj/fc2/out kernels, their
  lora_A, and the deformable `output_kernel`;
- int8 trees (models/quantize.py): `kernel_q` shards as `kernel` does,
  and stays K-major in its shard; `w_scale` shards with the output dim of
  a column-parallel linear and stays replicated on a row-parallel one;
- everything else replicated, among them the LoRA factors on the other
  side of each split, the row-parallel biases, the deformable offset and
  weight projections, LayerNorm and LayerScale vectors and the embeddings.

The SwiGLU FFN's fc1 output is two halves, x1 and x2 (`silu(x1) * x2`),
so its column shard is this rank's slice of each half (the leaf viewed
as [..., 2, M]), not a contiguous slice of 2M, which would pair one
rank's gates with another's values. The split is read off the tree: the
backbone's fc1 is twice as wide as its fc2 is deep.

Legacy context parallelism (`MeshConfig.context_parallel`) runs the ring
over the two-axis mesh's model axis: the mesh then has no tensor shards
(`model_size` 1) and a ring of `model_parallel_size` ranks. On either
layout params stay replicated over the ring, as in JAX.

Where GSPMD places the collectives in JAX, the port's modules call them by
hand (parallel/collectives.py): each tensor-parallel module takes and
returns replicated activations, sums its row-parallel output over the
model group once, and reduces its input's gradient there once. Leaves
that stay replicated but feed only this rank's heads or columns
(`partial_grad`) get partial gradients, which the train step sums over
the model group; under context parallelism every leaf the backbone's
sharded tokens reach (`context_partial`) gets this rank's tokens' share,
which it sums over the context group.

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
    """This process's place in the mesh and the process groups of its
    axes. `backend` is the process groups' backend: "nccl" for one card a
    rank, "gloo" for ranks that share a card or run on the CPU
    (parallel/collectives.py stages CUDA tensors through the host for
    it). `model_size` is the tensor-parallel degree and `context_size`
    the ring's (1 without context parallelism; `context_group` is then
    None)."""

    data_size: int
    model_size: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any
    backend: str
    cfg: MeshConfig = MeshConfig()
    context_size: int = 1
    context_index: int = 0
    context_group: Any = None

    @property
    def seq_axis(self) -> Optional[str]:
        """The name of the axis the ring runs over: 'context' on the
        three-axis mesh, the model axis in legacy mode; None without
        context parallelism."""
        if self.context_size == 1:
            return None
        return (self.cfg.model_axis if self.cfg.context_parallel
                else self.cfg.context_axis)


def model_size(mesh: Optional[Mesh]) -> int:
    """The tensor-parallel degree; 1 without a mesh."""
    return 1 if mesh is None else mesh.model_size


def context_size(mesh: Optional[Mesh]) -> int:
    """The context-parallel ring's size; 1 without a mesh."""
    return 1 if mesh is None else mesh.context_size


def create_mesh(model_parallel_size: int = 1,
                cfg: MeshConfig = MeshConfig()) -> Mesh:
    """This process's mesh over the started torch.distributed world, as
    the JAX package shapes its devices: [world / tp, tp] (data, model), or
    [world / (cp tp), cp, tp] (data, context, model) when
    cfg.context_parallel_size = cp > 0; one process group per line of
    each axis. Under cfg.context_parallel the model axis of the two-axis
    grid is the ring. Every rank must call it, in the same order as any
    other group creation."""
    world, rank = dist.get_world_size(), dist.get_rank()
    size = model_parallel_size
    cp = cfg.context_parallel_size
    inner = size * max(cp, 1)
    if size < 1 or world % inner:
        what = (f"context_parallel_size={cp} x " if cp else "")
        raise ValueError(f"{world} processes not divisible by {what}"
                         f"model_parallel_size={size}")
    grid = np.arange(world).reshape(world // inner, max(cp, 1), size)

    def groups(lines):
        return {tuple(line): dist.new_group(list(line)) for line in lines}

    d, c, m = (int(i[0]) for i in np.nonzero(grid == rank))
    data = groups(grid[:, ci, mi].tolist() for ci in range(grid.shape[1])
                  for mi in range(size))
    ctx = (groups(grid[di, :, mi].tolist() for di in range(grid.shape[0])
                  for mi in range(size)) if cp > 1 else {})
    model = groups(grid[di, ci].tolist() for di in range(grid.shape[0])
                   for ci in range(grid.shape[1]))
    data_group = data[tuple(grid[:, c, m].tolist())]
    model_group = model[tuple(grid[d, c].tolist())]
    common = dict(data_size=grid.shape[0], data_index=d,
                  data_group=data_group, backend=dist.get_backend(), cfg=cfg)
    if cfg.context_parallel:
        # Legacy: the model axis carries tokens, and no tensor shards.
        return Mesh(model_size=1, model_index=0, model_group=None,
                    context_size=size, context_index=m,
                    context_group=model_group if size > 1 else None,
                    **common)
    return Mesh(model_size=size, model_index=m, model_group=model_group,
                context_size=max(cp, 1), context_index=c,
                context_group=(ctx[tuple(grid[d, :, m].tolist())]
                               if cp > 1 else None),
                **common)


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


def context_partial(path: Tuple[str, ...]) -> bool:
    """Under context parallelism, a leaf whose gradient each rank of the
    ring holds only its tokens' share of: every backbone leaf used before
    the tokens are gathered (the embeddings and the blocks). The final
    LayerNorm, the projection and the decoder run whole on every rank of
    the ring, on the gathered tokens, so their gradients are whole."""
    return path[0] == "backbone" and path[1] not in ("ln_f", "projection")


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


def _width(leaves: Params, names, dim: int) -> Optional[int]:
    for name in names:
        if leaves.get(name) is not None:
            return leaves[name].shape[dim]
    return None


def _swiglu(tree: Params) -> bool:
    """Whether the tree's backbone FFN is SwiGLU: its fc1 twice as wide
    (2M) as its fc2 is deep (M), read from whichever of their leaves the
    tree holds (a gradient tree holds only the LoRA factors)."""
    blocks = tree.get("backbone", {}).get("blocks", {})
    if "fc1" not in blocks:
        return False
    out = _width(blocks["fc1"], ("kernel", "kernel_q", "lora_B", "bias",
                                 "w_scale"), -1)
    inp = _width(blocks.get("fc2", {}), ("kernel", "kernel_q", "lora_A"), -2)
    if out is None:
        return False
    if inp is None:
        raise ValueError("the tree holds fc1 leaves but no fc2 leaf to "
                         "tell a SwiGLU FFN from a dense one")
    return out == 2 * inp


def _halves(path: Tuple[str, ...], swiglu: bool) -> bool:
    """A leaf whose sharded (last) dim holds SwiGLU's two halves."""
    return (swiglu and path[0] == "backbone" and len(path) >= 2
            and path[-2] == "fc1" and shard_dim(path) == -1)


def shard_params(params: Params, mesh: Mesh) -> Params:
    """This rank's shard of a full param tree: each sharded leaf sliced
    (and copied, contiguous, an int8 kernel_q K-major) at the rank's model
    index, SwiGLU's fc1 leaves half by half; replicated leaves as they
    are."""
    from ..models.quantize import k_major

    swiglu = _swiglu(params)

    def shard(path, leaf):
        d = shard_dim(path)
        if d is None or mesh.model_size == 1:
            return leaf
        if _halves(path, swiglu):
            two = leaf.unflatten(-1, (2, leaf.shape[-1] // 2))
            out = two[..., local_slice(two.shape[-1], mesh)].flatten(-2)
        else:
            out = leaf[(slice(None),) * (leaf.dim() + d)
                       + (local_slice(leaf.shape[d], mesh),)]
        return k_major(out) if path[-1] == "kernel_q" else out.clone(
            memory_format=torch.contiguous_format)

    return map_with_path(shard, params)


def gather_params(shards: Params, mesh: Mesh) -> Params:
    """The full tree back from every rank's shard (the inverse of
    `shard_params`), on every rank of the model group: sharded leaves
    all-gathered and concatenated (SwiGLU's fc1 half by half),
    replicated ones this rank's. For tests and comparisons."""
    from ..models.quantize import k_major
    from .collectives import all_gather

    swiglu = _swiglu(shards)

    def gather(path, leaf):
        d = shard_dim(path)
        if d is None or mesh.model_size == 1:
            return leaf
        parts = all_gather(leaf.detach(), mesh.model_group, mesh.backend)
        if _halves(path, swiglu):
            out = torch.cat([t.unflatten(-1, (2, t.shape[-1] // 2))
                             for t in parts], dim=-1).flatten(-2)
        else:
            out = torch.cat(parts, dim=d)
        return k_major(out) if path[-1] == "kernel_q" else out

    return map_with_path(gather, shards)


def check_tp_compatible(detector_cfg, model_parallel_size: int) -> None:
    """Head counts and sharded dims must divide the model axis, as the JAX
    package requires."""
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
