"""DINOv2 ViT backbone with LoRA adapters (counterpart of
dinov2_od_tpu/models/vit.py).

The param tree is the JAX package's: per-block leaves stacked on a
leading depth axis, linear kernels `[in, out]`, the patch embedding an
HWIO `[p, p, 3, D]` kernel used as a `(py, px, c)`-ordered patch GEMM.

- Patchify as reshape + GEMM (stride == kernel size).
- Pre-norm blocks with LayerScale; q/k/v as one fused `[D, 3D]` GEMM whose
  output the attention kernel reads in place through three strided views.
- The block loop splits at the LoRA boundary, as the JAX package's does:
  blocks below the last `lora_last_n_blocks` have nothing to train, so
  they run under `torch.no_grad()` (the counterpart of JAX's
  stop_gradient: no stored activations, no attention backward) and skip
  the LoRA compute; the adapted suffix runs with autograd.
- No sequence padding: the attention kernel masks its own ragged edge.

- int8 params (models/quantize.py) are dispatched on "kernel_q": q/k/v as
  one int8 GEMM whose output the attention kernel reads in place, and
  `prefix_int8` quantizes the no-grad prefix's linears inside the step.

- Megatron tensor parallelism under a mesh (parallel/): each block's q, k,
  v and fc1 are column-parallel (the rank's heads' q, k and v still one
  fused GEMM), proj and fc2 row-parallel with one all-reduce each and the
  bias added after it; attention runs on the rank's `num_heads / tp`
  heads. LoRA follows its base linear: B sharded with a column-parallel
  kernel, A with a row-parallel one.

The dense `mlp` and `swiglu` FFNs are ported (SwiGLU not under tensor
parallelism); MoE raises NotImplementedError (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..config import BackboneConfig
from ..ops.attention import multi_head_attention
from ..parallel.collectives import copy_to_model, reduce_from_model
from ..parallel.sharding import model_size
from .layers import (
    compute_dtype,
    index_params,
    layer_norm,
    layernorm_init,
    linear,
    lora_init,
    lora_linear,
    stack_params,
    torch_linear_init,
    trunc_normal_init,
)
from .quantize import int8_qkv, quantize_blocks

Params = Dict[str, Any]


def _check_supported(cfg: BackboneConfig) -> None:
    if cfg.ffn_type not in ("mlp", "swiglu"):
        raise NotImplementedError(
            f"ffn_type={cfg.ffn_type!r} is not ported yet (ROADMAP.md: MoE)"
        )


def _init_block(gen, cfg: BackboneConfig, device) -> Params:
    d, m, r = cfg.hidden_dim, cfg.mlp_dim, cfg.lora_r
    fc1_out = 2 * m if cfg.ffn_type == "swiglu" else m

    def adapted(i, o):
        p = torch_linear_init(gen, i, o, device)
        p.update(lora_init(gen, i, o, r, device))
        return p

    block = {
        "ln1": layernorm_init(d, device),
        "q": adapted(d, d),
        "k": adapted(d, d),
        "v": adapted(d, d),
        "proj": adapted(d, d),
        "ls1": torch.full((d,), cfg.layerscale_init, device=device),
        "ln2": layernorm_init(d, device),
        "ls2": torch.full((d,), cfg.layerscale_init, device=device),
        "fc1": adapted(d, fc1_out),
        "fc2": adapted(m, d),
    }
    return block


def init_backbone_params(gen: torch.Generator, cfg: BackboneConfig,
                         device) -> Params:
    """Random backbone params from `gen`, in the JAX package's tree."""
    _check_supported(cfg)
    d = cfg.hidden_dim
    blocks = [_init_block(gen, cfg, device) for _ in range(cfg.depth)]
    params: Params = {
        "patch_embed": {
            "kernel": trunc_normal_init(
                gen, (cfg.patch_size, cfg.patch_size, 3, d), device
            ),
            "bias": torch.zeros((d,), device=device),
        },
        "cls_token": trunc_normal_init(gen, (1, 1, d), device),
        "pos_embed": trunc_normal_init(gen, (1, cfg.seq_len, d), device),
        "ln_f": layernorm_init(d, device),
        "blocks": stack_params(blocks),
    }
    if cfg.target_dim is not None and cfg.target_dim != d:
        params["projection"] = torch_linear_init(gen, d, cfg.target_dim,
                                                 device)
    return params


def _eff_kernel(p: Params, alpha: float, dtype, mode: str) -> torch.Tensor:
    """Folded (W + alpha*A@B) or the raw base kernel."""
    w = p["kernel"]
    if mode == "fold" and "lora_A" in p:
        w = w + alpha * (p["lora_A"] @ p["lora_B"])
    return w.to(dtype)


def _maybe_lora(x, p: Params, cfg: BackboneConfig, active: bool = True):
    if "kernel_q" in p or not active:  # int8: LoRA folded by contract
        return linear(x, p)
    if cfg.lora_mode == "fold" and "lora_A" in p:
        w = _eff_kernel(p, cfg.lora_alpha, x.dtype, "fold")
        return x @ w + p["bias"].to(x.dtype)
    return lora_linear(x, p, cfg.lora_alpha)


def _qkv(x, bp: Params, cfg: BackboneConfig, lora_active: bool):
    """q, k and v as one `[B, N, 3D]` buffer from one fused GEMM."""
    if "kernel_q" in bp["q"]:  # int8 params: LoRA folded by contract
        return int8_qkv(x, bp)
    alpha = cfg.lora_alpha
    mode = cfg.lora_mode if lora_active else "skip"
    names = ("q", "k", "v")
    w_qkv = torch.cat([_eff_kernel(bp[p], alpha, x.dtype, mode)
                       for p in names], dim=1)
    b_qkv = torch.cat([bp[p]["bias"] for p in names]).to(x.dtype)
    qkv = x @ w_qkv + b_qkv
    if mode not in ("fold", "skip") and "lora_A" in bp["q"]:
        # Fused LoRA: x @ [A_q|A_k|A_v], then one block-diagonal B GEMM.
        a_qkv = torch.cat([bp[p]["lora_A"] for p in names], dim=1)
        b_diag = torch.block_diag(*[bp[p]["lora_B"] for p in names])
        qkv = qkv + alpha * ((x @ a_qkv.to(x.dtype)) @ b_diag.to(x.dtype))
    return qkv


def _row_parallel(x, p: Params, cfg: BackboneConfig, active: bool, mesh):
    """proj / fc2: `_maybe_lora` without a mesh; under one, this rank's
    rows of the kernel and of lora_A give a partial sum (LoRA's included:
    (x_r A_r) B summed over ranks is (x A) B), reduced over the model group
    once, then the replicated bias."""
    if model_size(mesh) == 1:
        return _maybe_lora(x, p, cfg, active)
    mode = cfg.lora_mode if active else "skip"
    y = x @ _eff_kernel(p, cfg.lora_alpha, x.dtype, mode)
    if mode not in ("fold", "skip") and "lora_A" in p:
        y = y + cfg.lora_alpha * ((x @ p["lora_A"].to(x.dtype))
                                  @ p["lora_B"].to(x.dtype))
    return reduce_from_model(y, mesh) + p["bias"].to(x.dtype)


def _attention(x, bp: Params, cfg: BackboneConfig, attn_impl: str,
               lora_active: bool, mesh=None):
    b, n, d = x.shape
    tp = model_size(mesh)
    h, dh = cfg.num_heads // tp, d // cfg.num_heads
    qkv = _qkv(copy_to_model(x, mesh), bp, cfg, lora_active)
    # Three strided [B, N, H, dh] views of the one qkv buffer (this rank's
    # heads under tensor parallelism).
    q, k, v = (t.view(b, n, h, dh) for t in qkv.chunk(3, dim=-1))
    out = multi_head_attention(
        q, k, v, impl=attn_impl, mesh=mesh,
        tp_axis=mesh.cfg.model_axis if tp > 1 else None,
    ).reshape(b, n, h * dh)
    return _row_parallel(out, bp["proj"], cfg, lora_active, mesh)


def _ffn(x, bp: Params, cfg: BackboneConfig, lora_active: bool, mesh=None):
    h = _maybe_lora(copy_to_model(x, mesh), bp["fc1"], cfg, lora_active)
    if cfg.ffn_type == "swiglu":
        x1, x2 = h.chunk(2, dim=-1)
        h = F.silu(x1) * x2
    else:
        h = F.gelu(h, approximate="tanh" if cfg.gelu_approximate else "none")
    return _row_parallel(h, bp["fc2"], cfg, lora_active, mesh)


def _block_apply(x, bp: Params, cfg: BackboneConfig, attn_impl: str,
                 lora_active: bool, mesh=None):
    """Pre-norm ViT block with LayerScale."""
    x = x + bp["ls1"].to(x.dtype) * _attention(
        layer_norm(x, bp["ln1"]), bp, cfg, attn_impl, lora_active, mesh
    )
    x = x + bp["ls2"].to(x.dtype) * _ffn(
        layer_norm(x, bp["ln2"]), bp, cfg, lora_active, mesh
    )
    return x


def backbone_apply(
    params: Params,
    cfg: BackboneConfig,
    pixel_values: torch.Tensor,
    *,
    attn_impl: str = "auto",
    mesh=None,
) -> torch.Tensor:
    """Run the backbone.

    Args:
      pixel_values: [B, H, W, 3] float images (NHWC).
      mesh: a process mesh (parallel/) whose model axis splits the blocks
        (params: this rank's shard, `shard_params`); None runs whole.

    Returns:
      [B, seq, out_dim] features; seq = patches (+1 CLS unless
      cfg.drop_cls_token). Final LayerNorm applied, then the optional
      projection to target_dim.
    """
    _check_supported(cfg)
    if model_size(mesh) > 1 and (cfg.prefix_int8
                                 or "kernel_q" in params["blocks"]["q"]):
        # As the JAX package turns B6 off under TP (ops/int8_gemm.py).
        raise NotImplementedError(
            "int8 layers under tensor parallelism are not ported yet "
            "(ROADMAP.md)")
    dtype = compute_dtype(cfg.dtype)
    x = pixel_values.to(dtype)

    b, hh, ww, c = x.shape
    p = cfg.patch_size
    gh, gw = hh // p, ww // p
    x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, gh * gw, p * p * c)
    kernel = params["patch_embed"]["kernel"].to(dtype).reshape(
        p * p * c, cfg.hidden_dim
    )
    x = x @ kernel + params["patch_embed"]["bias"].to(dtype)

    cls = params["cls_token"].to(dtype).expand(b, 1, cfg.hidden_dim)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(dtype)

    # The prefix below the last `lora_last_n_blocks` blocks runs without
    # autograd and without its LoRA factors (zero by construction there).
    k = max(0, cfg.depth - cfg.lora_last_n_blocks)
    if 0 < k < cfg.depth:
        with torch.no_grad():
            prefix = params["blocks"]
            if cfg.prefix_int8:
                # The prefix is pure inference, so the W8A8 scheme applies
                # in training too: its six linears quantize here, from the
                # stacked (possibly bf16) kernels of the first k blocks.
                prefix = quantize_blocks(index_params(prefix, slice(0, k)))
            for i in range(k):
                x = _block_apply(x, index_params(prefix, i), cfg,
                                 attn_impl, False, mesh)
        for i in range(k, cfg.depth):
            x = _block_apply(x, index_params(params["blocks"], i), cfg,
                             attn_impl, True, mesh)
    else:
        for i in range(cfg.depth):
            x = _block_apply(x, index_params(params["blocks"], i), cfg,
                             attn_impl, cfg.lora_last_n_blocks > 0, mesh)

    x = layer_norm(x, params["ln_f"])
    if "projection" in params:
        x = linear(x, params["projection"])
    if cfg.drop_cls_token:
        x = x[:, 1:]
    return x
