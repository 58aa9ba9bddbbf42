"""Post-training int8 quantization (W8A8) for serving and for the frozen
prefix of training (counterpart of dinov2_od_tpu/models/quantize.py).

- Weights: symmetric per-output-channel int8, w_scale[o] =
  max(max_i |W[i, o]| * fp32(1/127), 1e-8), computed once.
- Activations: symmetric per-token dynamic int8 (ops/int8_gemm.py
  `quantize_acts`).
- The product: exact int8 x int8 -> int32, rescaled by x_scale * w_scale
  and the bias added in one fp32 fma, cast to x's dtype.

Only the six linears of each ViT block are quantized; patch and position
embeddings, LayerNorm, attention internals and the decoder stay in
floating point. The apply functions (models/layers.py `linear`,
models/vit.py) dispatch on "kernel_q" in a linear's params, so one
`detector_apply` serves fp32, bf16 and int8 trees.

Every int8 kernel is stored K-major. Wide-K linears (K >= 2048: each
block's fc2) on a CUDA tensor run the fused kernel B6 (ops/int8_gemm.py);
the others quantize with torch ops and multiply with `torch._int_mm`, as
the JAX package leaves that product to XLA's s8 dot.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops import int8_gemm
from ..ops.int8_gemm import quantize_acts as _quantize_acts

Params = Dict[str, Any]

_LINEARS = ("q", "k", "v", "proj", "fc1", "fc2")
_FUSED_MIN_K = 2048  # wide-K linears (each block's fc2) take B6


def k_major(w: torch.Tensor) -> torch.Tensor:
    """w `[..., K, N]` stored K-major: the same tensor, laid out [..., N, K]
    in memory."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_linear(p: Params) -> Params:
    """One linear's kernel (`[..., in, out]`, possibly stacked over depth)
    as symmetric per-output-channel int8. LoRA factors are dropped: the
    quantized linear is a single int8 GEMM.

    kernel_q is stored K-major (the same `[..., K, N]` tensor, laid out
    `[..., N, K]` in memory): wgmma reads s8 operands K-major only, so the
    fused kernel B6 takes it in place, and cuBLASLt's s8 GEMM, which runs
    the narrower linears, is ~5.6x faster on it than on a row-major one
    at ViT-B's shapes (PERF.md). Values and shapes are the JAX tree's."""
    w = p["kernel"].float()
    w_scale = torch.clamp_min(w.abs().amax(-2) * int8_gemm.INV_QMAX,
                              int8_gemm.EPS)
    w_q = torch.clamp(torch.round(w / w_scale[..., None, :]), -127.0, 127.0)
    return {"kernel_q": k_major(w_q.to(torch.int8)), "w_scale": w_scale,
            "bias": p["bias"]}


def _int8_matmul(x: torch.Tensor, kernel_q: torch.Tensor,
                 w_scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Forward of `int8_linear`: the fused kernel for an eligible wide-K
    linear on the card, else quantization, `_int_mm` and the epilogue."""
    k, n = x.shape[-1], kernel_q.shape[1]
    m = x.numel() // k
    if (k >= _FUSED_MIN_K and x.is_cuda
            and int8_gemm.int8_gemm_eligible(m, k, n)):
        return int8_gemm.fused_int8_linear(
            x, {"kernel_q": kernel_q, "w_scale": w_scale, "bias": bias})
    x_q, x_scale = _quantize_acts(x.reshape(m, k))
    out = int8_gemm.dequant_epilogue(int8_gemm.int_mm(x_q, kernel_q),
                                     x_scale, w_scale, bias, x.dtype)
    return out.reshape(*x.shape[:-1], n)


class _Int8LinearSTE(torch.autograd.Function):
    """int8 linear with the straight-through backward of the JAX package
    (`_int8_linear_bwd`): the quantize/dequantize round trips count as the
    identity, so dx flows through the dequantized weight in fp32; db is
    exact; kernel_q and w_scale get no gradient."""

    @staticmethod
    def forward(ctx, x, kernel_q, w_scale, bias):
        ctx.save_for_backward(kernel_q, w_scale)
        ctx.bias_dtype = bias.dtype
        return _int8_matmul(x, kernel_q, w_scale, bias)

    @staticmethod
    def backward(ctx, dy):
        kernel_q, w_scale = ctx.saved_tensors
        w_deq = kernel_q.float() * w_scale  # [K, N]
        dy32 = dy.float()
        dx = (dy32 @ w_deq.t()).to(dy.dtype)
        db = dy32.reshape(-1, dy.shape[-1]).sum(0).to(ctx.bias_dtype)
        return dx, None, None, db


def int8_linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """y = dequant(quant(x) @ kernel_q) + bias in x's dtype; differentiable
    in x and the bias through the straight-through estimator."""
    return _Int8LinearSTE.apply(x, p["kernel_q"], p["w_scale"], p["bias"])


def int8_qkv(x: torch.Tensor, bp: Params) -> torch.Tensor:
    """q, k and v as one int8 GEMM: per-output-channel kernels and scales
    concatenate losslessly (K-major, as `quantize_linear` stores them)."""
    names = ("q", "k", "v")
    return int8_linear(x, {
        "kernel_q": torch.cat([bp[n]["kernel_q"].t() for n in names]).t(),
        "w_scale": torch.cat([bp[n]["w_scale"] for n in names]),
        "bias": torch.cat([bp[n]["bias"] for n in names]),
    })


def quantize_blocks(blocks: Params) -> Params:
    """The six linears of a stacked block tree as int8; other leaves as
    they are."""
    return {name: (quantize_linear(sub) if name in _LINEARS else sub)
            for name, sub in blocks.items()}


def quantize_backbone_int8(params: Params) -> Params:
    """Quantize the backbone's per-block linears (stacked `[depth, ...]`).

    LoRA must be folded first (`fold_detector_lora` zeroes the factors):
    a nonzero factor raises, so a training tree cannot be quantized by
    mistake."""
    blocks = params["blocks"]
    for name in _LINEARS:
        bp = blocks[name]
        if "lora_B" in bp and bool((bp["lora_B"] != 0).any()):
            raise ValueError(
                f"block linear '{name}' has unfolded LoRA factors; "
                "call fold_detector_lora before quantizing")
    with torch.no_grad():
        return {**params, "blocks": quantize_blocks(blocks)}


def quantize_detector_int8(params: Params, cfg=None) -> Params:
    """int8-quantize the detector's backbone for serving; the decoder and
    the patch and position embeddings stay in floating point."""
    del cfg  # the JAX signature's; the tree says what to quantize
    return {**params, "backbone": quantize_backbone_int8(params["backbone"])}


__all__ = [
    "int8_linear", "int8_qkv", "k_major", "quantize_backbone_int8",
    "quantize_blocks", "quantize_detector_int8", "quantize_linear",
]
