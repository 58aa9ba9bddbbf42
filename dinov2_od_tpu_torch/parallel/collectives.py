"""The collectives that GSPMD inserts for the JAX package, placed by hand.

- `copy_to_model`: identity forward, gradient summed over the model group
  backward; it stands at the input of every tensor-parallel module, whose
  sharded compute gives each rank only its share of the input's gradient.
- `reduce_from_model`: summed over the model group forward, identity
  backward; it ends every row-parallel product, before the replicated
  bias is added once.
- `reduce_gradients`: after the backward, the model group's sum of the
  partial gradients of replicated leaves (parallel/sharding.py
  `partial_grad`), then the data group's sum of every gradient (the loss
  is each rank's share of a sum over the global batch, over the global box
  count).

The mesh's backend decides the transport. NCCL takes CUDA tensors as they
are. Gloo reduces host buffers, so a CUDA tensor (ranks that share one
card) or a non-fp32 one is copied to a host fp32 buffer, reduced there and
copied back: bf16 partial sums are added in fp32 and rounded once.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from . import sharding


def _staged(t: torch.Tensor, backend: str) -> bool:
    return backend == "gloo" and (t.is_cuda or t.dtype != torch.float32)


def all_reduce(t: torch.Tensor, group, backend: str) -> torch.Tensor:
    """The sum of `t` over `group`, as a new tensor of t's dtype and
    device."""
    if _staged(t, backend):
        buf = t.detach().to("cpu", torch.float32).contiguous()
        dist.all_reduce(buf, group=group)
        return buf.to(t.device, t.dtype)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
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


def reduce_gradients(grads: List[torch.Tensor], paths: list, mesh) -> None:
    """In place: the model group's sum of the partial gradients of
    replicated leaves (`sharding.partial_grad`, looked up at call time),
    then the data group's sum of every gradient. `paths` are the leaves'
    paths in the param tree, one per gradient."""
    if mesh.model_size > 1:
        all_reduce_coalesced_(
            [g for g, p in zip(grads, paths) if sharding.partial_grad(p)],
            mesh.model_group, mesh.backend)
    if mesh.data_size > 1:
        all_reduce_coalesced_(grads, mesh.data_group, mesh.backend)
