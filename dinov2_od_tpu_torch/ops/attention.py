"""Multi-head attention entry point (counterpart of
dinov2_od_tpu/ops/attention.py).

- 'xla': plain einsum + fp32 softmax in torch ops, on any device, with
  optional attention-probability dropout; the decoder always takes it,
  as in the JAX package.
- 'flash': flash attention (ops/flash_attention.py), differentiable: the
  CUDA kernels on a CUDA tensor, their plain versions on a CPU tensor.
  It never materialises the probabilities, so it cannot drop them.
- 'auto': 'flash' on a CUDA tensor for every self-attention the kernel
  supports (head dim 64, any sequence length: it masks its own ragged
  edge) when nothing is dropped, else 'xla' — on the CPU always 'xla',
  as JAX takes XLA off the TPU.

Ring attention and tensor-parallel head sharding are not ported yet
(ROADMAP.md) and raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import HEAD_DIM, NEG_INF, flash_attention


def _xla_attention(q, k, v, scale: float, dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   kv_valid_len: Optional[int] = None):
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if kv_valid_len is not None and kv_valid_len < k.shape[1]:
        key_ids = torch.arange(k.shape[1], device=k.device)
        logits = logits.masked_fill(key_ids >= kv_valid_len, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and generator is not None:
        # nn.MultiheadAttention's dropout: probabilities dropped after the
        # softmax and rescaled by 1/keep, rows not renormalised.
        keep = 1.0 - dropout_rate
        mask = torch.rand(weights.shape, generator=generator,
                          device=weights.device) < keep
        weights = torch.where(mask, weights / keep,
                              torch.zeros_like(weights)).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _flash_eligible(q, k) -> bool:
    return (
        q.device.type == "cuda"
        and q.shape == k.shape
        and q.shape[-1] == HEAD_DIM
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
      kv_valid_len: keys at positions >= this are masked out.

    Returns:
      [B, Sq, H, Dh]
    """
    if impl == "ring" or mesh is not None or seq_axis or tp_axis:
        raise NotImplementedError(
            "ring attention and tensor-parallel attention are not ported "
            "to PyTorch yet (ROADMAP.md, Queue A: parallel layouts)"
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
                              generator, kv_valid_len)
    raise ValueError(f"unknown attention impl {impl!r}")
