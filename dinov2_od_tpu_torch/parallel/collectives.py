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
- `shard_tokens` / `gather_tokens`: the backbone's tokens split over the
  context ring and all-gathered back. The gather's backward keeps this
  rank's rows of the cotangent: every rank of the ring runs the decoder
  on the same gathered tokens, so each holds the whole cotangent.
- `reduce_gradients`: after the backward, the context group's sum of the
  gradients of the leaves its ranks each saw a share of the tokens of
  (parallel/sharding.py `context_partial`), the model group's sum of the
  partial gradients of replicated leaves (`partial_grad`), then the data
  group's sum of every gradient (the loss is each rank's share of a sum
  over the global batch, over the global box count).

The mesh's backend decides the transport. NCCL takes CUDA tensors as they
are. Gloo reduces host buffers, so a CUDA tensor (ranks that share one
card) or a non-fp32 one is copied to a host fp32 buffer, reduced or sent
there and copied back: bf16 partial sums are added in fp32 and rounded
once, and a bf16 tensor crosses a ring exactly.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from . import sharding


def _staged(t: torch.Tensor, backend: str) -> bool:
    return backend == "gloo" and (t.is_cuda or t.dtype != torch.float32)


def all_reduce(t: torch.Tensor, group, backend: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or another `op`) of `t` over `group`, as a new tensor of
    t's dtype and device."""
    if _staged(t, backend):
        buf = t.detach().to("cpu", torch.float32).contiguous()
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
    src = (t.to("cpu", torch.float32) if backend == "gloo"
           else t).contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return [x.to(t.device, t.dtype) for x in out]


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
    send = (t.detach().to("cpu", torch.float32) if staged
            else t.detach()).contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group),
            dist.P2POp(dist.irecv, recv, src, group)]):
        req.wait()
    return recv.to(t.device, t.dtype) if staged else recv


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
    whose tokens it split (`sharding.context_partial`), the model group's
    sum of the partial gradients of replicated leaves
    (`sharding.partial_grad`, looked up at call time), then the data
    group's sum of every gradient. `paths` are the leaves' paths in the
    param tree, one per gradient."""
    if mesh.context_size > 1:
        all_reduce_coalesced_(
            [g for g, p in zip(grads, paths) if sharding.context_partial(p)],
            mesh.context_group, mesh.backend)
    if mesh.model_size > 1:
        all_reduce_coalesced_(
            [g for g, p in zip(grads, paths) if sharding.partial_grad(p)],
            mesh.model_group, mesh.backend)
    if mesh.data_size > 1:
        all_reduce_coalesced_(grads, mesh.data_group, mesh.backend)
