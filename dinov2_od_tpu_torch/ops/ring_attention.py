"""Ring attention: exact attention with the sequence sharded over the
context ring of a process mesh (counterpart of
dinov2_od_tpu/ops/ring_attention.py).

Each rank holds its `[B, S / n, H, dh]` shard of q, k and v. q stays; k
and v travel around the ring (parallel/collectives.py `ring_shift`), and
after i shifts a rank holds the shard that started on ring position
(my - i) mod n. The partial softmaxes of the n steps merge in
log-sum-exp form. Heads are independent, so under tensor parallelism
(CP x TP) the ring runs on this rank's heads as they are, and no
collective crosses the model axis.

Two inner loops (`impl`):

- 'flash': each ring step is one `flash_attention_lse` call (kernel B3's
  route: on a CUDA tensor the flat B1/B2 or the all-heads/blocked
  B4/B5 kernels, chosen by the local shape as `flash_attention` chooses;
  on a CPU tensor their plain versions). The backward is the JAX
  package's reverse-rotation VJP, a `torch.autograd.Function` that saves
  only (q, k, v, o, lse): it rotates k and v a second time, recomputes
  each step's forward and feeds the merge's cotangents, g_o_i = w_i g and
  g_lse_i = w_i ((o_i - o) . g) with w_i = exp(lse_i - lse), into
  `flash_attention_lse`'s own backward (a nonzero lse cotangent into the
  kernels' delta). dk and dv accumulate in fp32 buffers that rotate with
  the shards, so after n shifts each lands on its home rank.
- 'blockwise': the plain version, torch ops only: per ring step the
  shard's keys in sub-blocks of at most 512 with an online-softmax carry
  and a finite -1e30 mask, each sub-block under `torch.utils.checkpoint`;
  autograd runs through the rotation. CPU tensors only: a CUDA tensor
  never takes it.

'auto' is 'flash' on a CUDA tensor and 'blockwise' on a CPU one.

`valid_len` masks the keys at global positions >= valid_len (the pad
that makes S a multiple of the ring). A ring step whose whole shard lies
past it is skipped: no launch, no contribution (see `_kv_len`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import ring_shift
from .flash_attention import NEG_INF, flash_attention_lse

# Key sub-block width of the blockwise loop: one fp32 logits tile
# [B, H, Sq_loc, 512] at most.
_RING_BLOCK = 512


def _kv_len(src: int, sk: int, valid_len: Optional[int]):
    """The number of valid keys in the shard that started on ring position
    `src`: all `sk` left of valid_len, the remainder in the one shard that
    straddles it, and 0 right of it. The JAX package launches its kernel
    at kv_len 0 there too (dinov2_od_tpu/ops/ring_attention.py:146-149):
    every logit is -1e30, so the step's lse is about -1e30 * scale and its
    merge weight exp(lse_i - lse) is exactly 0, in the forward and in
    every gradient. The port skips that step instead (the kernels take
    kv_len >= 1), which gives the same values exactly."""
    if valid_len is None or (src + 1) * sk <= valid_len:
        return sk
    return max(valid_len - src * sk, 0)


def _merge(o, lse, o_i, lse_i):
    """The running (o, lse) merged with one step's partial, fp32: o the
    lse-weighted average of the normalised partials."""
    m = torch.maximum(lse, lse_i)
    a, b = torch.exp(lse - m), torch.exp(lse_i - m)
    denom = a + b
    o = (o * a[..., None] + o_i.float() * b[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


def _ring_forward(q, k, v, scale, mesh, valid_len):
    """(o fp32, lse fp32 [B, Sq, H], natural log) of the flash ring."""
    n, my = mesh.context_size, mesh.context_index
    sk = k.shape[1]
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:3], -torch.inf, dtype=torch.float32,
                     device=q.device)
    for i in range(n):
        kv_len = _kv_len((my - i) % n, sk, valid_len)
        if kv_len:
            o, lse = _merge(o, lse, *flash_attention_lse(
                q, k, v, scale=scale, kv_len=kv_len))
        if i < n - 1:
            k, v = ring_shift(k, mesh), ring_shift(v, mesh)
    return o, lse


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, mesh, valid_len):
        o, lse = _ring_forward(q, k, v, scale, mesh, valid_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.mesh, ctx.valid_len = scale, mesh, valid_len
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        mesh = ctx.mesh
        n, my = mesh.context_size, mesh.context_index
        sk = k.shape[1]
        g32 = g.float()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur = k, v
        for i in range(n):
            kv_len = _kv_len((my - i) % n, sk, ctx.valid_len)
            if kv_len:
                with torch.enable_grad():
                    qq, kk, vv = (t.detach().requires_grad_()
                                  for t in (q, k_cur, v_cur))
                    o_i, lse_i = flash_attention_lse(
                        qq, kk, vv, scale=ctx.scale, kv_len=kv_len)
                    w = torch.exp(lse_i.detach() - lse)
                    g_o = (g32 * w[..., None]).to(o_i.dtype)
                    g_lse = (g32 * (o_i.detach().float() - o)).sum(-1) * w
                    dq_i, dk_i, dv_i = torch.autograd.grad(
                        (o_i, lse_i), (qq, kk, vv), (g_o, g_lse))
                dq += dq_i.float()
                dk += dk_i.float()
                dv += dv_i.float()
            if i < n - 1:
                k_cur, v_cur = ring_shift(k_cur, mesh), ring_shift(v_cur, mesh)
            # The accumulators travel with the shards: after n shifts each
            # is back on the rank whose shard it holds the gradient of.
            dk, dv = ring_shift(dk, mesh), ring_shift(dv, mesh)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


class _RingShift(torch.autograd.Function):
    """`ring_shift` under autograd: the gradient shifts back."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return ring_shift(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, ctx.mesh, offset=-1), None


def _one_block(m, l, o, q, k_blk, v_blk, key_valid, scale: float):
    """Online-softmax update for one key sub-block."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
    if key_valid is not None:
        s = s.masked_fill(~key_valid, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    o = o * corr.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p.to(v_blk.dtype), v_blk).float()
    return m_new, l, o


def _ring_blockwise(q, k, v, scale, mesh, valid_len, block_size):
    n, my = mesh.context_size, mesh.context_index
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    # The fewest equal sub-blocks of at most `block_size` keys; k and v
    # padded once so every block is full (the pad keys are masked).
    n_sub = -(-sk // (block_size or _RING_BLOCK))
    block = -(-sk // n_sub)
    pad = n_sub * block - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    m = torch.full((b, h, sq), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for i in range(n):
        src = (my - i) % n
        for j in range(n_sub):
            pos = j * block + torch.arange(block, device=q.device)
            key_valid = None
            if pad or valid_len is not None:
                key_valid = pos < sk
                if valid_len is not None:
                    key_valid &= src * sk + pos < valid_len
            sl = slice(j * block, (j + 1) * block)
            m, l, o = checkpoint(_one_block, m, l, o, q, k[:, sl], v[:, sl],
                                 key_valid, scale, use_reentrant=False)
        if i < n - 1:
            k, v = _RingShift.apply(k, mesh), _RingShift.apply(v, mesh)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float, mesh, axis: Optional[str] = None,
                   head_axis: Optional[str] = None,
                   valid_len: Optional[int] = None,
                   block_size: Optional[int] = None,
                   impl: str = "auto") -> torch.Tensor:
    """Exact attention over the context ring's shards.

    Args:
      q, k, v: this rank's `[B, S / n, H_local, dh]` shards (equal on every
        rank of the ring, S the padded global length).
      mesh: the process mesh (parallel/sharding.py); the ring is its
        context group.
      axis: the ring's axis name, `mesh.seq_axis` (the default).
      head_axis: the axis the heads are split over under CP x TP; the ring
        runs on this rank's heads as they are, so it needs nothing of it.
      valid_len: keys at global positions >= valid_len are masked.
      block_size: the blockwise loop's key sub-block (None -> at most 512).
      impl: 'flash' | 'blockwise' | 'auto'.

    Returns:
      `[B, S / n, H_local, dh]` in q's dtype.
    """
    del head_axis  # heads are independent: nothing crosses the model axis
    if axis is not None and axis != mesh.seq_axis:
        raise ValueError(f"the mesh's ring runs over {mesh.seq_axis!r}, "
                         f"not {axis!r}")
    if not (q.shape == k.shape == v.shape):
        raise ValueError("ring attention takes q, k, v shards of one shape; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if impl == "auto":
        impl = "flash" if q.is_cuda else "blockwise"
    if impl == "flash":
        return _RingFlash.apply(q, k, v, scale, mesh, valid_len)
    if impl == "blockwise":
        if q.is_cuda:
            raise ValueError("the blockwise ring is the plain version, for "
                             "CPU tensors; a CUDA tensor takes impl='flash'")
        return _ring_blockwise(q, k, v, scale, mesh, valid_len, block_size)
    raise ValueError(f"unknown ring attention impl {impl!r}")


__all__ = ["ring_attention"]
