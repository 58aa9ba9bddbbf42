"""Multi-head attention entry point (counterpart of
dinov2_od_tpu/ops/attention.py).

- 'xla': plain einsum + fp32 softmax in torch ops, on any device, with
  optional attention-probability dropout; the decoder always takes it,
  as in the JAX package.
- 'flash': flash attention (ops/flash_attention.py), differentiable: the
  CUDA kernels on a CUDA tensor, their plain versions on a CPU tensor.
  It picks the kernel by shape as the JAX package does (flat B1/B2 for
  self-attention up to 1536 tokens with paired heads; otherwise all-heads
  B4f/B4b where a head's logits fit the TPU kernel's budget, blocked
  B5f/B5b where not). It never materialises the probabilities, so it
  cannot drop them.
- 'auto': 'flash' on a CUDA tensor for every attention the kernels
  support (head dim 64, any sequence lengths, Sq != Sk included: they
  mask their own ragged edges) when nothing is dropped, else 'xla' — on
  the CPU always 'xla', as JAX takes XLA off the TPU.

Tensor-parallel attention (`tp_axis`) needs no collective: each rank's
q, k and v already hold only its heads, and attention is independent per
head; the mesh only places an attention-dropout mask (drawn over every
head, sliced to this rank's). Ring attention (`impl='ring'`, `seq_axis`)
is not ported yet (ROADMAP.md) and raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.sharding import keep_mask
from .flash_attention import HEAD_DIM, NEG_INF, flash_attention


def _xla_attention(q, k, v, scale: float, dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   kv_valid_len: Optional[int] = None, mesh=None,
                   heads_sharded: bool = False):
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if kv_valid_len is not None and kv_valid_len < k.shape[1]:
        key_ids = torch.arange(k.shape[1], device=k.device)
        logits = logits.masked_fill(key_ids >= kv_valid_len, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and generator is not None:
        # nn.MultiheadAttention's dropout: probabilities dropped after the
        # softmax and rescaled by 1/keep, rows not renormalised.
        keep = 1.0 - dropout_rate
        mask = keep_mask(weights.shape, keep, generator, weights.device,
                         mesh, 1 if heads_sharded else None)
        weights = torch.where(mask, weights / keep,
                              torch.zeros_like(weights)).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _flash_eligible(q, k) -> bool:
    return (
        q.device.type == "cuda"
        and q.shape[-1] == HEAD_DIM
        and k.shape[-1] == HEAD_DIM
    )


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: str = "auto",
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    seq_axis: Optional[str] = None,
    tp_axis: Optional[str] = None,
    kv_valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over heads.

    Args:
      q: [B, Sq, H, Dh]; k, v: [B, Sk, H, Dh].
      impl: 'auto' | 'flash' | 'xla'.
      dropout_rate / generator: attention-probability dropout, active only
        when both are set, drawn from `generator` (on q's device).
      mesh / tp_axis: the process mesh, and the model axis when q, k, v
        hold this rank's heads only (tensor parallelism); attention runs on
        them as they are.
      kv_valid_len: keys at positions >= this are masked out.

    Returns:
      [B, Sq, H, Dh]
    """
    if impl == "ring" or seq_axis:
        raise NotImplementedError(
            "ring attention is not ported to PyTorch yet (ROADMAP.md, "
            "Queue A: parallel layouts)"
        )
    scale = 1.0 / (q.shape[-1] ** 0.5)
    use_dropout = dropout_rate > 0.0 and generator is not None
    if impl == "auto":
        impl = "flash" if _flash_eligible(q, k) and not use_dropout else "xla"
    if impl == "flash":
        if use_dropout:
            raise ValueError(
                "attention-probability dropout is not supported by the "
                "flash kernel; use impl='auto' or 'xla' with dropout"
            )
        return flash_attention(q, k, v, scale=scale, kv_len=kv_valid_len)
    if impl == "xla":
        return _xla_attention(q, k, v, scale,
                              dropout_rate if use_dropout else 0.0,
                              generator, kv_valid_len, mesh, bool(tp_axis))
    raise ValueError(f"unknown attention impl {impl!r}")
