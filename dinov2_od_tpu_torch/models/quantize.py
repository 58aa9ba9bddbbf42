"""Post-training int8 quantization (W8A8) for serving and for the frozen
prefix of training (counterpart of dinov2_od_tpu/models/quantize.py).

- Weights: symmetric per-output-channel int8, w_scale[o] =
  max(max_i |W[i, o]| * fp32(1/127), 1e-8), computed once.
- Activations: symmetric per-token dynamic int8 (ops/int8_gemm.py
  `quantize_acts`).
- The product: exact int8 x int8 -> int32, rescaled by x_scale * w_scale
  and the bias added in one fp32 fma, cast to x's dtype.

Only the six linears of each ViT block are quantized (q, k, v and proj
of a MoE block); patch and position embeddings, LayerNorm, attention
internals, the MoE routers and experts and the decoder stay in floating
point. The apply functions (models/layers.py `linear`,
models/vit.py) dispatch on "kernel_q" in a linear's params, so one
`detector_apply` serves fp32, bf16 and int8 trees.

Every int8 kernel is stored K-major. Wide-K linears (K >= 2048: each
block's fc2) on a CUDA tensor run the fused kernel B6 (ops/int8_gemm.py);
the others quantize with torch ops and multiply with `torch._int_mm`, as
the JAX package leaves that product to XLA's s8 dot.

Under tensor parallelism (a mesh with a model axis) B6 is off, as the
JAX package turns its fused kernel off there (ops/int8_gemm.py
`set_fused_enabled`), and every int8 linear takes the unfused path. A
row-parallel linear (proj, fc2) holds this rank's rows of kernel_q and
the input's matching columns: each token's absmax is taken over the model
group (an all-reduce of the max) before quantizing, so the codes are
those of one process, and the rank's s8 partial products, each rescaled
by x_scale * w_scale, are summed over the group before the bias. Its
w_scale, from the max over every rank's rows, is replicated
(`quantize_linear(..., mesh=)` all-reduces that max too).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

import torch.distributed as dist

from ..ops import int8_gemm
from ..ops.int8_gemm import quantize_acts as _quantize_acts
from ..parallel.collectives import all_reduce, reduce_from_model
from ..parallel.sharding import model_size

Params = Dict[str, Any]

_LINEARS = ("q", "k", "v", "proj", "fc1", "fc2")
_ROW_PARALLEL = ("proj", "fc2")  # K sharded over the model axis under TP
_FUSED_MIN_K = 2048  # wide-K linears (each block's fc2) take B6


def k_major(w: torch.Tensor) -> torch.Tensor:
    """w `[..., K, N]` stored K-major: the same tensor, laid out [..., N, K]
    in memory."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def _model_max(t: torch.Tensor, mesh) -> torch.Tensor:
    """t's elementwise max over the model group (t itself without TP)."""
    if model_size(mesh) == 1:
        return t
    return all_reduce(t, mesh.model_group, mesh.backend, dist.ReduceOp.MAX)


def quantize_linear(p: Params, mesh=None, row_parallel: bool = False
                    ) -> Params:
    """One linear's kernel (`[..., in, out]`, possibly stacked over depth)
    as symmetric per-output-channel int8. LoRA factors are dropped: the
    quantized linear is a single int8 GEMM. A row-parallel shard under
    `mesh` takes each channel's absmax over the model group, so its codes
    and w_scale are those of the whole kernel.

    kernel_q is stored K-major (the same `[..., K, N]` tensor, laid out
    `[..., N, K]` in memory): wgmma reads s8 operands K-major only, so the
    fused kernel B6 takes it in place, and cuBLASLt's s8 GEMM, which runs
    the narrower linears, is ~5.6x faster on it than on a row-major one
    at ViT-B's shapes (PERF.md). Values and shapes are the JAX tree's."""
    w = p["kernel"].float()
    amax = w.abs().amax(-2)
    if row_parallel:
        amax = _model_max(amax, mesh)
    w_scale = torch.clamp_min(amax * int8_gemm.INV_QMAX, int8_gemm.EPS)
    w_q = torch.clamp(torch.round(w / w_scale[..., None, :]), -127.0, 127.0)
    return {"kernel_q": k_major(w_q.to(torch.int8)), "w_scale": w_scale,
            "bias": p["bias"]}


def _int8_matmul(x: torch.Tensor, kernel_q: torch.Tensor,
                 w_scale: torch.Tensor, bias: torch.Tensor,
                 fused: bool = True) -> torch.Tensor:
    """Forward of `int8_linear`: the fused kernel for an eligible wide-K
    linear on the card (unless `fused` is off), else quantization,
    `_int_mm` and the epilogue."""
    k, n = x.shape[-1], kernel_q.shape[1]
    m = x.numel() // k
    if (fused and k >= _FUSED_MIN_K and x.is_cuda
            and int8_gemm.int8_gemm_eligible(m, k, n)):
        return int8_gemm.fused_int8_linear(
            x, {"kernel_q": kernel_q, "w_scale": w_scale, "bias": bias})
    x_q, x_scale = _quantize_acts(x.reshape(m, k))
    out = int8_gemm.dequant_epilogue(int8_gemm.int_mm(x_q, kernel_q),
                                     x_scale, w_scale, bias, x.dtype)
    return out.reshape(*x.shape[:-1], n)


def _ste_dx(dy: torch.Tensor, kernel_q: torch.Tensor,
            w_scale: torch.Tensor) -> torch.Tensor:
    """The straight-through dx: dy through the dequantized kernel, fp32."""
    return (dy.float() @ (kernel_q.float() * w_scale).t()).to(dy.dtype)


class _Int8LinearSTE(torch.autograd.Function):
    """int8 linear with the straight-through backward of the JAX package
    (`_int8_linear_bwd`): the quantize/dequantize round trips count as the
    identity, so dx flows through the dequantized weight in fp32; db is
    exact; kernel_q and w_scale get no gradient."""

    @staticmethod
    def forward(ctx, x, kernel_q, w_scale, bias, fused):
        ctx.save_for_backward(kernel_q, w_scale)
        ctx.bias_dtype = bias.dtype
        return _int8_matmul(x, kernel_q, w_scale, bias, fused)

    @staticmethod
    def backward(ctx, dy):
        kernel_q, w_scale = ctx.saved_tensors
        db = dy.float().reshape(-1, dy.shape[-1]).sum(0).to(ctx.bias_dtype)
        return _ste_dx(dy, kernel_q, w_scale), None, None, db, None


def int8_linear(x: torch.Tensor, p: Params, fused: bool = True
                ) -> torch.Tensor:
    """y = dequant(quant(x) @ kernel_q) + bias in x's dtype; differentiable
    in x and the bias through the straight-through estimator. `fused`
    False keeps B6 off (tensor parallelism)."""
    return _Int8LinearSTE.apply(x, p["kernel_q"], p["w_scale"], p["bias"],
                                fused)


class _Int8RowParallelSTE(torch.autograd.Function):
    """This rank's share of a row-parallel int8 linear, fp32, before the
    sum over the model group: the codes of x against the group's absmax,
    their s8 product with this rank's kernel rows, rescaled. The backward
    is the straight-through one of `_Int8LinearSTE`."""

    @staticmethod
    def forward(ctx, x, kernel_q, w_scale, mesh):
        ctx.save_for_backward(kernel_q, w_scale)
        ctx.dtype = x.dtype
        k, n = x.shape[-1], kernel_q.shape[1]
        x32 = x.reshape(-1, k).float()
        x_scale = torch.clamp_min(
            _model_max(x32.abs().amax(-1, keepdim=True), mesh)
            * int8_gemm.INV_QMAX, int8_gemm.EPS)
        codes = torch.clamp(torch.round(x32 / x_scale), -127.0, 127.0)
        acc = int8_gemm.int_mm(codes.to(torch.int8), kernel_q)
        out = acc * (x_scale * w_scale)
        return out.reshape(*x.shape[:-1], n)

    @staticmethod
    def backward(ctx, dy):
        kernel_q, w_scale = ctx.saved_tensors
        return _ste_dx(dy, kernel_q, w_scale).to(ctx.dtype), None, None, None


def int8_row_parallel(x: torch.Tensor, p: Params, mesh) -> torch.Tensor:
    """A row-parallel int8 linear under tensor parallelism (B6 off): x
    holds this rank's input columns, p this rank's kernel_q rows and the
    replicated w_scale and bias; the rescaled partial products summed over
    the model group, then the bias, in x's dtype."""
    part = _Int8RowParallelSTE.apply(x, p["kernel_q"], p["w_scale"], mesh)
    return (reduce_from_model(part, mesh) + p["bias"].float()).to(x.dtype)


def int8_qkv(x: torch.Tensor, bp: Params, fused: bool = True
             ) -> torch.Tensor:
    """q, k and v as one int8 GEMM: per-output-channel kernels and scales
    concatenate losslessly (K-major, as `quantize_linear` stores them)."""
    names = ("q", "k", "v")
    return int8_linear(x, {
        "kernel_q": torch.cat([bp[n]["kernel_q"].t() for n in names]).t(),
        "w_scale": torch.cat([bp[n]["w_scale"] for n in names]),
        "bias": torch.cat([bp[n]["bias"] for n in names]),
    }, fused)


def quantize_blocks(blocks: Params, mesh=None) -> Params:
    """The linears of a stacked block tree as int8 (this rank's shards
    under `mesh`); other leaves, a MoE block's experts and router
    included, as they are."""
    return {name: (quantize_linear(sub, mesh, name in _ROW_PARALLEL)
                   if name in _LINEARS else sub)
            for name, sub in blocks.items()}


def quantize_backbone_int8(params: Params) -> Params:
    """Quantize the backbone's per-block linears (stacked `[depth, ...]`)
    in "blocks" and, under the MoE FFN, in "moe_blocks" (q, k, v and proj
    there: the experts stay in floating point).

    LoRA must be folded first (`fold_detector_lora` zeroes the factors):
    a nonzero factor raises, so a training tree cannot be quantized by
    mistake."""
    out = dict(params)
    for stack in ("blocks", "moe_blocks"):
        if stack not in params:
            continue
        blocks = params[stack]
        for name in _LINEARS:
            bp = blocks.get(name, {})
            if "lora_B" in bp and bool((bp["lora_B"] != 0).any()):
                raise ValueError(
                    f"block linear '{name}' has unfolded LoRA factors; "
                    "call fold_detector_lora before quantizing")
        with torch.no_grad():
            out[stack] = quantize_blocks(blocks)
    return out


def quantize_detector_int8(params: Params, cfg=None) -> Params:
    """int8-quantize the detector's backbone for serving; the decoder and
    the patch and position embeddings stay in floating point."""
    del cfg  # the JAX signature's; the tree says what to quantize
    return {**params, "backbone": quantize_backbone_int8(params["backbone"])}


__all__ = [
    "int8_linear", "int8_qkv", "int8_row_parallel", "k_major",
    "quantize_backbone_int8",
    "quantize_blocks", "quantize_detector_int8", "quantize_linear",
]
