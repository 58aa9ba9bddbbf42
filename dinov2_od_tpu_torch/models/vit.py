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
  the LoRA compute; the adapted suffix runs with autograd, each block
  under `torch.utils.checkpoint` with `use_remat` (recomputed in the
  backward, as JAX's `jax.checkpoint`: the attention forward runs again
  there).
- `lora_mode="fold"` trains through W + alpha * A @ B, built each call
  and cast to the activation dtype: one GEMM a linear, and the gradients
  of A and B come through the fold.
- No sequence padding on one process: the attention kernel masks its own
  ragged edge.

- int8 params (models/quantize.py) are dispatched on "kernel_q": q/k/v as
  one int8 GEMM whose output the attention kernel reads in place, and
  `prefix_int8` quantizes the no-grad prefix's linears inside the step.

- Megatron tensor parallelism under a mesh (parallel/): each block's q, k,
  v and fc1 are column-parallel (the rank's heads' q, k and v still one
  fused GEMM), proj and fc2 row-parallel with one all-reduce each and the
  bias added after it; attention runs on the rank's `num_heads / tp`
  heads. LoRA follows its base linear: B sharded with a column-parallel
  kernel, A with a row-parallel one. SwiGLU's fc1 shard holds the rank's
  slice of each half (parallel/sharding.py), so `silu(x1) * x2` pairs
  as on one process. int8 layers take the unfused path (B6 off, as in
  JAX); a row-parallel int8 linear quantizes against the model group's
  absmax (models/quantize.py `int8_row_parallel`).
- Context parallelism (`attn_impl="ring"` with a mesh and its `seq_axis`):
  after the embeddings the tokens are padded once to a multiple of the
  ring's size and each rank keeps its contiguous `[B, S_pad / n, D]`
  rows through every block (LayerNorm, the MLP and LayerScale are
  token-local; attention is the ring, ops/ring_attention.py, with the
  pad's keys masked), so a rank's backbone activations are 1/n of the
  whole. The rows are gathered and the pad dropped before the final
  norm. Padded rows never reach a real one (their keys are masked) and
  get a zero cotangent, so outputs and gradients are exact (the JAX
  package's pad-once argument).

- The MoE FFN (ffn_type "moe", ops/moe.py) in the sparse-upcycling layout
  of the JAX package: the frozen prefix keeps its dense FFN in
  params["blocks"] (where pretrained weights load and prefix_int8
  applies), the adapted last `lora_last_n_blocks` blocks hold a router
  and E experts in params["moe_blocks"] (`moe_boundary`; full-depth MoE
  has no "blocks"). `backbone_apply` then returns (features, moe_aux),
  the router's load-balance loss summed in fp32 over the MoE blocks and
  divided by their number. MoE under a mesh or the ring raises: expert
  parallelism is ROADMAP.md Queue A item 7.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import BackboneConfig
from ..ops.attention import multi_head_attention
from ..ops.moe import moe_ffn
from ..parallel.collectives import (
    copy_to_model,
    gather_tokens,
    reduce_from_model,
    shard_tokens,
)
from ..parallel.sharding import context_size, model_size
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
from .quantize import (
    int8_linear,
    int8_qkv,
    int8_row_parallel,
    quantize_blocks,
)

Params = Dict[str, Any]


def check_backbone_supported(cfg: BackboneConfig, mesh=None,
                             attn_impl: str = "auto") -> None:
    """Raise for an FFN type the port does not know, and for the MoE FFN
    under a mesh or ring attention."""
    if cfg.ffn_type not in ("mlp", "swiglu", "moe"):
        raise ValueError(f"unknown ffn_type {cfg.ffn_type!r}")
    if cfg.ffn_type == "moe" and (mesh is not None or attn_impl == "ring"):
        raise NotImplementedError(
            "ffn_type='moe' under a mesh or ring attention (expert "
            "parallelism) is not ported yet (ROADMAP.md Queue A item 7, "
            "MoE x EP)")


def moe_boundary(cfg: BackboneConfig) -> int:
    """The first MoE block under ffn_type 'moe': the frozen prefix keeps
    the dense FFN, the adapted last `lora_last_n_blocks` blocks take the
    MoE FFN (lora_last_n_blocks = depth gives full-depth MoE)."""
    if cfg.lora_last_n_blocks <= 0:
        raise ValueError(
            "ffn_type='moe' requires lora_last_n_blocks > 0 (MoE lives in "
            "the adapted blocks; set lora_last_n_blocks = depth for "
            "full-depth MoE)")
    return max(0, cfg.depth - cfg.lora_last_n_blocks)


def _init_block(gen, cfg: BackboneConfig, device, moe: bool = False
                ) -> Params:
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
    }
    if moe:
        # Per-expert nn.Linear inits stacked on a leading E axis and a
        # router; no LoRA on the experts (they train whole).
        e = cfg.moe_num_experts
        fc1s = [torch_linear_init(gen, d, m, device) for _ in range(e)]
        fc2s = [torch_linear_init(gen, m, d, device) for _ in range(e)]
        block["moe"] = {
            "router_kernel": trunc_normal_init(gen, (d, e), device),
            "fc1_kernel": torch.stack([p["kernel"] for p in fc1s]),
            "fc1_bias": torch.stack([p["bias"] for p in fc1s]),
            "fc2_kernel": torch.stack([p["kernel"] for p in fc2s]),
            "fc2_bias": torch.stack([p["bias"] for p in fc2s]),
        }
    else:
        block["fc1"] = adapted(d, fc1_out)
        block["fc2"] = adapted(m, d)
    return block


def init_backbone_params(gen: torch.Generator, cfg: BackboneConfig,
                         device) -> Params:
    """Random backbone params from `gen`, in the JAX package's tree: the
    blocks stacked in "blocks", and under MoE the adapted suffix in
    "moe_blocks"."""
    check_backbone_supported(cfg)
    d = cfg.hidden_dim
    k = moe_boundary(cfg) if cfg.ffn_type == "moe" else cfg.depth
    blocks = [_init_block(gen, cfg, device, moe=i >= k)
              for i in range(cfg.depth)]
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
    }
    if k > 0:
        params["blocks"] = stack_params(blocks[:k])
    if k < cfg.depth:
        params["moe_blocks"] = stack_params(blocks[k:])
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


def _maybe_lora(x, p: Params, cfg: BackboneConfig, active: bool = True,
                mesh=None):
    if "kernel_q" in p:  # int8: LoRA folded by contract; B6 off under TP
        return int8_linear(x, p, fused=model_size(mesh) == 1)
    if not active:
        return linear(x, p)
    if cfg.lora_mode == "fold" and "lora_A" in p:
        w = _eff_kernel(p, cfg.lora_alpha, x.dtype, "fold")
        return x @ w + p["bias"].to(x.dtype)
    return lora_linear(x, p, cfg.lora_alpha)


def _qkv(x, bp: Params, cfg: BackboneConfig, lora_active: bool, mesh=None):
    """q, k and v as one `[B, N, 3D]` buffer from one fused GEMM."""
    if "kernel_q" in bp["q"]:  # int8 params: LoRA folded by contract
        return int8_qkv(x, bp, fused=model_size(mesh) == 1)
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
    if "kernel_q" in p:
        return int8_row_parallel(x, p, mesh)
    mode = cfg.lora_mode if active else "skip"
    y = x @ _eff_kernel(p, cfg.lora_alpha, x.dtype, mode)
    if mode not in ("fold", "skip") and "lora_A" in p:
        y = y + cfg.lora_alpha * ((x @ p["lora_A"].to(x.dtype))
                                  @ p["lora_B"].to(x.dtype))
    return reduce_from_model(y, mesh) + p["bias"].to(x.dtype)


def _attention(x, bp: Params, cfg: BackboneConfig, attn_impl: str,
               lora_active: bool, mesh=None, seq_axis=None, valid_len=None):
    b, n, d = x.shape
    tp = model_size(mesh)
    h, dh = cfg.num_heads // tp, d // cfg.num_heads
    qkv = _qkv(copy_to_model(x, mesh), bp, cfg, lora_active, mesh)
    # Three strided [B, N, H, dh] views of the one qkv buffer (this rank's
    # heads under tensor parallelism, its tokens under context
    # parallelism).
    q, k, v = (t.view(b, n, h, dh) for t in qkv.chunk(3, dim=-1))
    out = multi_head_attention(
        q, k, v, impl=attn_impl, mesh=mesh, seq_axis=seq_axis,
        tp_axis=mesh.cfg.model_axis if tp > 1 else None,
        kv_valid_len=valid_len,
    ).reshape(b, n, h * dh)
    return _row_parallel(out, bp["proj"], cfg, lora_active, mesh)


def _ffn(x, bp: Params, cfg: BackboneConfig, lora_active: bool, mesh=None):
    h = _maybe_lora(copy_to_model(x, mesh), bp["fc1"], cfg, lora_active,
                    mesh)
    if cfg.ffn_type == "swiglu":
        # This rank's slice of each half under TP (its fc1 shard's layout).
        x1, x2 = h.chunk(2, dim=-1)
        h = F.silu(x1) * x2
    else:
        h = F.gelu(h, approximate="tanh" if cfg.gelu_approximate else "none")
    return _row_parallel(h, bp["fc2"], cfg, lora_active, mesh)


def _block_apply(x, bp: Params, cfg: BackboneConfig, attn_impl: str,
                 lora_active: bool, mesh=None, seq_axis=None,
                 valid_len=None):
    """Pre-norm ViT block with LayerScale."""
    x = x + bp["ls1"].to(x.dtype) * _attention(
        layer_norm(x, bp["ln1"]), bp, cfg, attn_impl, lora_active, mesh,
        seq_axis, valid_len,
    )
    x = x + bp["ls2"].to(x.dtype) * _ffn(
        layer_norm(x, bp["ln2"]), bp, cfg, lora_active, mesh
    )
    return x


def _block_apply_moe(x, bp: Params, cfg: BackboneConfig, attn_impl: str,
                     lora_active: bool, mesh=None, seq_axis=None,
                     valid_len=None):
    """Pre-norm block with the MoE FFN (ops/moe.py): (x, its router's
    load-balance loss)."""
    x = x + bp["ls1"].to(x.dtype) * _attention(
        layer_norm(x, bp["ln1"]), bp, cfg, attn_impl, lora_active, mesh,
        seq_axis, valid_len,
    )
    ffn_out, aux = moe_ffn(
        layer_norm(x, bp["ln2"]), bp["moe"], top_k=cfg.moe_top_k,
        capacity_factor=cfg.moe_capacity_factor,
        activation=lambda h: F.gelu(
            h, approximate="tanh" if cfg.gelu_approximate else "none"),
    )
    return x + bp["ls2"].to(x.dtype) * ffn_out, aux


def interpolate_pos_embed(pos_embed: torch.Tensor, src_grid: int,
                          dst_grid: int) -> torch.Tensor:
    """Bicubic-resample patch position embeddings `[1, 1 + src^2, D]` to a
    new grid (the CLS position is passed through). Used by the HF
    importer when the target image size differs from the checkpoint's
    native 518 px / 37x37 grid.

    The JAX package resamples with `jax.image.resize(..., "bicubic")`,
    whose cubic kernel has a = -0.5. torch's plain bicubic uses a = -0.75;
    its antialiased path uses a = -0.5 (and, when shrinking, widens the
    kernel by the scale, as jax.image.resize does), so `antialias=True`
    is what matches."""
    if src_grid == dst_grid:
        return pos_embed
    cls_pos, patch_pos = pos_embed[:, :1], pos_embed[:, 1:]
    d = patch_pos.shape[-1]
    grid = patch_pos.reshape(1, src_grid, src_grid, d).permute(0, 3, 1, 2)
    resized = F.interpolate(grid.float(), size=(dst_grid, dst_grid),
                            mode="bicubic", align_corners=False,
                            antialias=True)
    resized = resized.permute(0, 2, 3, 1).reshape(1, dst_grid * dst_grid, d)
    return torch.cat([cls_pos, resized.to(pos_embed.dtype)], dim=1)


def backbone_apply(
    params: Params,
    cfg: BackboneConfig,
    pixel_values: torch.Tensor,
    *,
    attn_impl: str = "auto",
    mesh=None,
    seq_axis: Optional[str] = None,
    use_remat: bool = False,
) -> torch.Tensor:
    """Run the backbone.

    Args:
      pixel_values: [B, H, W, 3] float images (NHWC).
      attn_impl: the blocks' attention ('auto' | 'flash' | 'xla'), or
        'ring' for context parallelism over `mesh`'s ring `seq_axis`.
      mesh: a process mesh (parallel/) whose model axis splits the blocks
        (params: this rank's shard, `shard_params`) and, under 'ring',
        whose context ring splits the tokens; None runs whole.
      use_remat: under autograd, keep only each adapted block's input and
        recompute the block (its ring included) in the backward.

    Returns:
      [B, seq, out_dim] features; seq = patches (+1 CLS unless
      cfg.drop_cls_token). Final LayerNorm applied, then the optional
      projection to target_dim. Under ffn_type 'moe', (features,
      moe_aux): the MoE blocks' mean load-balance loss, fp32.
    """
    check_backbone_supported(cfg, mesh, attn_impl)
    ring = attn_impl == "ring"
    if ring and (mesh is None or seq_axis is None):
        raise ValueError("attn_impl='ring' requires mesh and seq_axis")
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

    seq = x.shape[1]
    valid_len = None
    if ring:
        # Pad once to a multiple of the ring, then keep this rank's rows.
        n = context_size(mesh)
        s_pad = -(-seq // n) * n
        if s_pad != seq:
            x = F.pad(x, (0, 0, 0, s_pad - seq))
            valid_len = seq
        x = shard_tokens(x, mesh)
    blk = dict(mesh=mesh, seq_axis=seq_axis, valid_len=valid_len)

    remat = use_remat and torch.is_grad_enabled()

    def adapted_fn(fn):
        if not remat:
            return fn
        return lambda *a, **kw: checkpoint(fn, *a, **kw, use_reentrant=False)

    adapted = adapted_fn(_block_apply)
    moe = cfg.ffn_type == "moe"
    # The prefix below the last `lora_last_n_blocks` blocks runs without
    # autograd and without its LoRA factors (zero by construction there).
    # Under MoE the prefix is all of params["blocks"] (dense FFNs) and the
    # suffix is params["moe_blocks"].
    k = (moe_boundary(cfg) if moe
         else max(0, cfg.depth - cfg.lora_last_n_blocks))
    moe_aux = None
    if moe or 0 < k < cfg.depth:
        if k > 0:
            with torch.no_grad():
                prefix = index_params(params["blocks"], slice(0, k))
                if cfg.prefix_int8:
                    # The prefix is pure inference, so the W8A8 scheme
                    # applies in training too: its six linears quantize
                    # here, from the stacked (possibly bf16) kernels.
                    prefix = quantize_blocks(prefix, mesh)
                for i in range(k):
                    x = _block_apply(x, index_params(prefix, i), cfg,
                                     attn_impl, False, **blk)
        if moe:
            moe_block = adapted_fn(_block_apply_moe)
            moe_aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(cfg.depth - k):
                x, aux = moe_block(x, index_params(params["moe_blocks"], i),
                                   cfg, attn_impl, True, **blk)
                moe_aux = moe_aux + aux
            moe_aux = moe_aux / (cfg.depth - k)
        else:
            for i in range(k, cfg.depth):
                x = adapted(x, index_params(params["blocks"], i), cfg,
                            attn_impl, True, **blk)
    else:
        for i in range(cfg.depth):
            x = adapted(x, index_params(params["blocks"], i), cfg,
                        attn_impl, cfg.lora_last_n_blocks > 0, **blk)

    if ring:
        x = gather_tokens(x, mesh)[:, :seq]
    x = layer_norm(x, params["ln_f"])
    if "projection" in params:
        x = linear(x, params["projection"])
    if cfg.drop_cls_token:
        x = x[:, 1:]
    return x if moe_aux is None else (x, moe_aux)
