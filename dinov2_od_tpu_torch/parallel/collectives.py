"""The collectives that GSPMD inserts for the JAX package, placed by hand.

- `copy_to_model`: identity forward, gradient summed over the model group
  backward; it stands at the input of every tensor-parallel module, whose
  sharded compute gives each rank only its share of the input's gradient.
- `reduce_from_model`: summed over the model group forward, identity
  backward; it ends every row-parallel product, before the replicated
  bias is added once.
- `ring_shift`: a tensor sent to the next rank of the context ring and
  received from the previous one (`jax.lax.ppermute` with
  perm = [(j, j + 1 mod n)]); ring attention rotates K and V with it.
- `stage_exchange`: a tensor sent to another stage of the pipeline and
  one received from another (`jax.lax.ppermute` over the stage axis,
  each transfer posted only where the schedule needs it); `stage_sum`:
  the sum over the stage group (the pipeline's `psum` of the last
  stage's outputs).
- `shard_tokens` / `gather_tokens`: the backbone's tokens split over the
  context ring and all-gathered back. The gather's backward keeps this
  rank's rows of the cotangent: every rank of the ring runs the decoder
  on the same gathered tokens, so each holds the whole cotangent.
- `fsdp_gather_tree` / `fsdp_gather_stack`: under FSDP, each leaf that
  `shard_params` cut over the data axis all-gathered over the data group
  where the model uses it (ZeRO-3's gather on use, parallel/sharding.py
  `Mesh.fsdp_layout`); the gather's backward reduce-scatters (sums) the
  cotangent over the same group, so this rank gets its shard of the
  data-summed gradient.
- The MoE FFN's routing under a mesh (ops/moe.py): `ring_counts`, a
  shard's [B, E] slot claims of one top-k round gathered over the
  context ring (the claims of the ranks before this one and the row's
  total); `sum_over_batch`, the top-1 counts summed over the data group
  and the ring, which split the global batch's tokens (no gradient);
  `reduce_from_ring`, the router probabilities' sums over the ring,
  identity backward (each rank's gradient its own tokens').
- `reduce_gradients`: after the backward, the context group's sum of the
  gradients of the leaves its ranks each saw a share of the tokens of
  (parallel/sharding.py `backbone_partial`), the stage group's sum of
  the gradients each stage holds its share of (the same leaves), the
  model group's sum of the partial gradients of replicated leaves
  (`partial_grad`), then the data group's sum of every gradient (the
  loss is each rank's share of a sum over the global batch, over the
  global box count) but those of leaves cut over the data axis, which
  the gather's reduce-scatter summed already. The model group's and the
  data group's sums commute: the ranks of a model group hold the same
  data shard.

The mesh's backend decides the transport. NCCL takes CUDA tensors as they
are. Gloo reduces host buffers, so a CUDA tensor (ranks that share one
card) or one of another dtype is copied to a host buffer, reduced or sent
there and copied back: fp32 for floating dtypes (bf16 partial sums are
added in fp32 and rounded once, and a bf16 tensor crosses a ring
exactly), int64 for integer and bool ones (image ids, labels and uint8
pixels cross exactly).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from . import sharding


def _wire(t: torch.Tensor) -> torch.dtype:
    """The dtype of a gloo host buffer for `t`."""
    return torch.float32 if t.dtype.is_floating_point else torch.int64


def _staged(t: torch.Tensor, backend: str) -> bool:
    return backend == "gloo" and (t.is_cuda or t.dtype != _wire(t))


def all_reduce(t: torch.Tensor, group, backend: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or another `op`) of `t` over `group`, as a new tensor of
    t's dtype and device."""
    if _staged(t, backend):
        buf = t.detach().to("cpu", _wire(t)).contiguous()
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(t.device, t.dtype)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_coalesced_(tensors: List[torch.Tensor], group,
                          backend: str) -> None:
    """Sum each tensor over `group` in place, all of them in one fp32
    all-reduce."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = all_reduce(flat, group, backend)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def all_gather(t: torch.Tensor, group, backend: str) -> List[torch.Tensor]:
    """Every group member's `t` (same shape on all), in group rank order,
    on t's device."""
    n = dist.get_world_size(group)
    src = (t.to("cpu", _wire(t)) if backend == "gloo"
           else t).contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return [x.to(t.device, t.dtype) for x in out]


def reduce_scatter(t: torch.Tensor, dim: int, group, backend: str
                   ) -> torch.Tensor:
    """t summed over `group` and cut along `dim` into the group's size of
    contiguous parts: this member's part, in t's dtype and device."""
    n = dist.get_world_size(group)
    x = t.detach().movedim(dim, 0)
    staged = _staged(t, backend)
    src = (x.to("cpu", _wire(t)) if staged else x).contiguous()
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    rs = (getattr(dist, "reduce_scatter_single", None)
          or dist.reduce_scatter_tensor)
    rs(out, src, group=group)
    return out.to(t.device, t.dtype).movedim(0, dim).contiguous()


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return torch.cat(all_gather(shard.detach(), mesh.data_group,
                                    mesh.backend), dim=dim)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return reduce_scatter(g, ctx.dim, m.data_group, m.backend), None, None


def _fsdp_leaf(t: torch.Tensor, path, mesh, stacked: bool) -> torch.Tensor:
    layout = sharding.fsdp_layout_of(path, mesh)
    if layout is None:
        return t
    shape, dim = layout
    if stacked and dim == -len(shape):
        return t  # a depth cut: `fsdp_gather_stack` gathered it whole
    if t.shape[dim] * mesh.data_size != shape[dim]:
        raise ValueError(f"{'/'.join(path)}: {tuple(t.shape)} is no data "
                         f"shard of {shape} on dim {dim}")
    if path[-1] == "kernel_q":
        # Gathered as its transpose, so the whole kernel stays K-major.
        return _FsdpGather.apply(t.mT, -3 - dim, mesh).mT
    return _FsdpGather.apply(t, dim, mesh)


def fsdp_gather_tree(tree, path: tuple, mesh, stacked: bool = False):
    """`tree` (the subtree, or the leaf, at `path` of a tree that
    `shard_params` cut) with every leaf cut over the data axis gathered
    whole; under autograd its gradient is reduce-scattered back over the
    data group. `stacked`: `tree` is one layer of a stacked subtree
    (`index_params`), whose depth-cut leaves `fsdp_gather_stack` gathered
    before the slice. `tree` itself without FSDP."""
    if not sharding.fsdp(mesh):
        return tree
    if isinstance(tree, dict):
        return {k: fsdp_gather_tree(v, path + (k,), mesh, stacked)
                for k, v in tree.items()}
    return None if tree is None else _fsdp_leaf(tree, path, mesh, stacked)


def fsdp_gather_stack(stack, path: tuple, mesh):
    """A stacked subtree (`[depth, ...]` leaves) at `path` with the leaves
    whose FSDP cut is the depth axis (2-D stacked leaves: JAX's rule
    takes their dim -2) gathered whole, once: no layer's slice holds a
    shard of them. The other leaves as they are, for
    `fsdp_gather_tree(..., stacked=True)` a layer at a time."""
    if not sharding.fsdp(mesh):
        return stack

    def depth_cut(p, t):
        layout = sharding.fsdp_layout_of(path + p, mesh)
        if layout is None or layout[1] != -len(layout[0]):
            return t
        return _fsdp_leaf(t, path + p, mesh, stacked=False)

    return sharding.map_with_path(depth_cut, stack)


class _CopyToModel(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return all_reduce(g, m.model_group, m.backend), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh.model_group, mesh.backend)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """x as it is; its gradient summed over the model group."""
    if sharding.model_size(mesh) == 1:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the model group; its gradient as it is."""
    if sharding.model_size(mesh) == 1:
        return x
    return _ReduceFromModel.apply(x, mesh)


class _ReduceFromRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh.context_group, mesh.backend)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_ring(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the context ring; its gradient as it is."""
    if sharding.context_size(mesh) == 1:
        return x
    return _ReduceFromRing.apply(x, mesh)


def sum_over_batch(t: torch.Tensor, mesh) -> torch.Tensor:
    """t (no gradient) summed over the data group and the context ring:
    the ranks that hold the global batch's tokens between them."""
    t = t.detach()
    if sharding.data_place(mesh)[0] > 1:
        t = all_reduce(t, mesh.data_group, mesh.backend)
    if sharding.context_size(mesh) > 1:
        t = all_reduce(t, mesh.context_group, mesh.backend)
    return t


def ring_counts(local: torch.Tensor, mesh):
    """(the sum of `local` over the ring ranks before this one, its sum
    over the whole ring): one all-gather over the context group. For the
    MoE routing's [B, E] slot claims of a round (gloo carries them as
    int64)."""
    parts = torch.stack(all_gather(local, mesh.context_group, mesh.backend))
    return parts[:mesh.context_index].sum(0), parts.sum(0)


def ring_shift(t: torch.Tensor, mesh, offset: int = 1) -> torch.Tensor:
    """`t` of the rank `offset` places back on the context ring, as this
    rank sends its own `offset` places on: group rank i sends to
    (i + offset) mod n and receives from (i - offset) mod n (offset -1 is
    the shift's transpose, its backward). Both transfers are posted before
    either is waited on (a blocking send before the receive would
    deadlock every rank on a large tensor). NCCL moves CUDA tensors as
    they are; gloo moves host buffers, fp32 for any other dtype (exact
    for bf16)."""
    n = mesh.context_size
    if n == 1:
        return t
    group, i = mesh.context_group, mesh.context_index
    dst = dist.get_global_rank(group, (i + offset) % n)
    src = dist.get_global_rank(group, (i - offset) % n)
    staged = _staged(t, mesh.backend)
    send = (t.detach().to("cpu", _wire(t)) if staged
            else t.detach()).contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group),
            dist.P2POp(dist.irecv, recv, src, group)]):
        req.wait()
    return recv.to(t.device, t.dtype) if staged else recv


def stage_exchange(send, to: int, like, frm: int, mesh):
    """Send `send` to world rank `to` and receive a tensor shaped as `like`
    from world rank `frm` over the stage group; either may be None, and
    that transfer is then not posted. Both are posted before either is
    waited on, as in `ring_shift`. Returns the received tensor on like's
    device, in its dtype, or None. In a pipeline of one stage the
    transfer is to itself: a copy."""
    if mesh.stage_size == 1:
        return None if like is None else send.detach().clone()
    ref = send if send is not None else like
    if ref is None:
        return None
    staged = _staged(ref, mesh.backend)
    ops, recv = [], None
    if send is not None:
        buf = (send.detach().to("cpu", _wire(send)) if staged
               else send.detach()).contiguous()
        ops.append(dist.P2POp(dist.isend, buf, to, mesh.stage_group))
    if like is not None:
        recv = torch.empty(like.shape,
                           dtype=_wire(like) if staged else like.dtype,
                           device="cpu" if staged else like.device)
        ops.append(dist.P2POp(dist.irecv, recv, frm, mesh.stage_group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if recv is None:
        return None
    return recv.to(like.device, like.dtype) if staged else recv


def stage_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """`t` summed over the stage group (as it is in a pipeline of one
    stage)."""
    if mesh.stage_size == 1:
        return t
    return all_reduce(t, mesh.stage_group, mesh.backend)


class _ShardTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n_tokens = mesh, x.shape[1]
        w = x.shape[1] // mesh.context_size
        return x[:, mesh.context_index * w:(mesh.context_index + 1) * w]

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        full = g.new_zeros((g.shape[0], ctx.n_tokens) + g.shape[2:])
        w = g.shape[1]
        full[:, m.context_index * w:(m.context_index + 1) * w] = g
        return full, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return torch.cat(all_gather(x.detach(), mesh.context_group,
                                    mesh.backend), dim=1)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        w = g.shape[1] // m.context_size
        return g[:, m.context_index * w:(m.context_index + 1) * w], None


def shard_tokens(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's contiguous rows of x `[B, S, ...]` (S a multiple of the
    ring's size); its gradient scattered back into zeros."""
    if sharding.context_size(mesh) == 1:
        return x
    return _ShardTokens.apply(x, mesh)


def gather_tokens(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every ring rank's rows of x `[B, S / n, ...]`, in ring order; its
    gradient this rank's rows of the cotangent (not summed)."""
    if sharding.context_size(mesh) == 1:
        return x
    return _GatherTokens.apply(x, mesh)


def reduce_gradients(grads: List[torch.Tensor], paths: list, mesh) -> None:
    """In place: the context group's sum of the gradients of the leaves
    whose tokens it split (`sharding.backbone_partial`), the stage group's
    sum of the gradients each stage holds its share of (the same leaves),
    the model group's sum of the partial
    gradients of replicated leaves (`sharding.partial_grad`, looked up at
    call time), then the data group's sum of every gradient but those of
    leaves cut over the data axis (FSDP: the gather's backward summed
    them). `paths` are the leaves' paths in the param tree, one per
    gradient."""
    if mesh.context_size > 1:
        all_reduce_coalesced_(
            [g for g, p in zip(grads, paths) if sharding.backbone_partial(p)],
            mesh.context_group, mesh.backend)
    if mesh.stage_size > 1:
        all_reduce_coalesced_(
            [g for g, p in zip(grads, paths) if sharding.backbone_partial(p)],
            mesh.stage_group, mesh.backend)
    if mesh.model_size > 1:
        all_reduce_coalesced_(
            [g for g, p in zip(grads, paths) if sharding.partial_grad(p)],
            mesh.model_group, mesh.backend)
    if mesh.data_size > 1:
        all_reduce_coalesced_(
            [g for g, p in zip(grads, paths)
             if sharding.fsdp_layout_of(p, mesh) is None],
            mesh.data_group, mesh.backend)
