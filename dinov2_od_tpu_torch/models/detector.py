"""The composed detector: DINOv2 backbone -> DETR decoder (counterpart of
dinov2_od_tpu/models/detector.py), with the serving-time param
transforms (LoRA folding and bf16 storage of the frozen backbone weights)
and the trainability policy: the decoder, the backbone projection and the
LoRA factors of the last `lora_last_n_blocks` blocks train, and under the
MoE FFN every router and expert leaf too; everything else is frozen.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import DetectorConfig
from .decoder import decoder_apply, init_decoder_params
from .layers import resolve_device
from .vit import backbone_apply, init_backbone_params

Params = Dict[str, Any]

_LINEARS = ("q", "k", "v", "proj", "fc1", "fc2")


def init_detector_params(gen: torch.Generator, cfg: DetectorConfig,
                         device="cuda") -> Params:
    """Random detector params drawn from `gen` (on the CPU), placed on
    `device`. CUDA unless the caller asks for the CPU; raises when CUDA
    is asked for and absent."""
    dev = resolve_device(device)
    return {
        "backbone": init_backbone_params(gen, cfg.backbone, dev),
        "decoder": init_decoder_params(gen, cfg.decoder, dev),
    }


def detector_apply(
    params: Params,
    cfg: DetectorConfig,
    pixel_values: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
    attn_impl: str = "auto",
    mesh=None,
    seq_axis: Optional[str] = None,
    use_remat: bool = False,
) -> Dict[str, Any]:
    """Full forward pass on pixel_values [B, H, W, 3] (NHWC).

    `generator` (on the params' device) drives the decoder's dropout when
    deterministic is False. Under `mesh` (parallel/) params are this
    rank's shard (`shard_params`), pixel_values this rank's batch slice,
    and the outputs are replicated over the model axis. With
    attn_impl="ring" and `seq_axis` the backbone's tokens are split over
    the mesh's context ring (models/vit.py); the decoder then runs whole
    on every rank of the ring, on the gathered features, and the outputs
    are replicated over the ring too. `use_remat`
    recomputes each adapted backbone block in the backward. Returns
    {"pred_logits": [B, Q, C], "pred_boxes": [B, Q, 4]}, plus
    "aux_outputs" in train mode when the decoder's aux_loss is set, and
    under the MoE FFN "moe_aux" (the router's load-balance loss, fp32;
    the train step adds moe_aux_weight times it to the objective)."""
    features = backbone_apply(
        params["backbone"], cfg.backbone, pixel_values, attn_impl=attn_impl,
        mesh=mesh, seq_axis=seq_axis, use_remat=use_remat,
    )
    moe_aux = None
    if cfg.backbone.ffn_type == "moe":
        features, moe_aux = features
    out = decoder_apply(params["decoder"], cfg.decoder, features,
                        generator=generator, deterministic=deterministic,
                        mesh=mesh)
    if moe_aux is not None:
        out["moe_aux"] = moe_aux
    return out


def _map_with_path(fn, tree: Params, path=()) -> Params:
    return {k: (_map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v))
            for k, v in tree.items()}


def trainable_mask(params: Params, cfg: DetectorConfig) -> Params:
    """The param tree with True at trainable leaves: every decoder leaf,
    the backbone projection, the backbone's stacked LoRA leaves (their
    non-adapted block rows are zeroed by `lora_block_multiplier`) and
    every leaf under a "moe" key (routers and experts: new capacity, with
    no pretrained weights to keep)."""
    del cfg  # the policy reads only the tree

    def mark(path, leaf):
        if path[0] == "decoder":
            return True
        return path[0] == "backbone" and (
            "projection" in path or "moe" in path
            or path[-1] in ("lora_A", "lora_B"))

    return _map_with_path(mark, params)


def lora_block_multiplier(params: Params, cfg: DetectorConfig) -> Params:
    """Per-leaf multiplier, broadcastable against the leaf: for every
    stacked lora_A / lora_B leaf a tensor that is 1 for the last
    `lora_last_n_blocks` rows and 0 for the earlier blocks; the float 1.0
    for every other leaf, which a caller may skip. Under the MoE FFN the
    dense prefix ("blocks") is never adapted (0 for its LoRA leaves) and
    every leaf of the MoE suffix ("moe_blocks") is (1.0)."""
    depth = cfg.backbone.depth
    first = max(0, depth - cfg.backbone.lora_last_n_blocks)
    moe = cfg.backbone.ffn_type == "moe"

    def mult(path, leaf):
        if path[0] != "backbone" or "moe_blocks" in path:
            return 1.0
        if moe and path[-1] in ("lora_A", "lora_B"):
            return torch.zeros((1,) * leaf.dim(), dtype=leaf.dtype,
                               device=leaf.device)
        if path[-1] in ("lora_A", "lora_B"):
            m = torch.zeros((depth,) + (1,) * (leaf.dim() - 1),
                            dtype=leaf.dtype, device=leaf.device)
            m[first:] = 1.0
            return m
        return 1.0

    return _map_with_path(mult, params)


def fold_detector_lora(params: Params, cfg: DetectorConfig) -> Params:
    """Fold LoRA deltas into the backbone base kernels for serving,
    W' = W + alpha * A @ B for the adapted (last `lora_last_n_blocks`)
    blocks, then zero the factors. Under the MoE FFN the dense prefix
    folds with weight 0 (its factors only zeroed) and every block of the
    MoE suffix with weight 1. Returns a new tree; the input is not
    changed."""
    alpha = cfg.backbone.lora_alpha
    depth = cfg.backbone.depth
    first = max(0, depth - cfg.backbone.lora_last_n_blocks)

    def fold_stack(blocks, adapted):
        blocks = dict(blocks)
        for lin in _LINEARS:
            if lin not in blocks or "lora_A" not in blocks[lin]:
                continue  # MoE blocks have no dense fc1 / fc2
            bp = dict(blocks[lin])
            kernel = bp["kernel"]
            delta = torch.einsum("lir,lro->lio", bp["lora_A"], bp["lora_B"])
            # Cast the fp32 delta to the kernel's storage dtype before the
            # add, so a bf16 kernel stays bf16.
            bp["kernel"] = kernel + (alpha * delta * adapted).to(kernel.dtype)
            bp["lora_A"] = torch.zeros_like(bp["lora_A"])
            bp["lora_B"] = torch.zeros_like(bp["lora_B"])
            blocks[lin] = bp
        return blocks

    backbone = dict(params["backbone"])
    if cfg.backbone.ffn_type == "moe":
        if "blocks" in backbone:
            backbone["blocks"] = fold_stack(backbone["blocks"], 0.0)
        backbone["moe_blocks"] = fold_stack(backbone["moe_blocks"], 1.0)
    else:
        adapted = torch.zeros((depth, 1, 1),
                              device=backbone["blocks"]["q"]["kernel"].device)
        adapted[first:] = 1.0
        backbone["blocks"] = fold_stack(backbone["blocks"], adapted)
    return {**params, "backbone": backbone}


def cast_frozen_weights(params: Params, cfg: DetectorConfig,
                        dtype=torch.bfloat16) -> Params:
    """Store the frozen backbone GEMM weights (block linears, patch
    embedding, CLS token and position embedding) in the compute dtype.
    The forward casts them to the activation dtype anyway; LoRA factors,
    the projection, LayerNorm/LayerScale vectors, the MoE routers and
    experts (trainable) and the decoder stay fp32."""
    def cast_stack(blocks):
        blocks = dict(blocks)
        for lin in _LINEARS:
            if lin in blocks:  # MoE blocks have no dense fc1 / fc2
                bp = dict(blocks[lin])
                bp["kernel"] = bp["kernel"].to(dtype)
                bp["bias"] = bp["bias"].to(dtype)
                blocks[lin] = bp
        return blocks

    backbone = dict(params["backbone"])
    for stack in ("blocks", "moe_blocks"):
        if stack in backbone:
            backbone[stack] = cast_stack(backbone[stack])
    backbone["patch_embed"] = {
        "kernel": backbone["patch_embed"]["kernel"].to(dtype),
        "bias": backbone["patch_embed"]["bias"].to(dtype),
    }
    backbone["cls_token"] = backbone["cls_token"].to(dtype)
    backbone["pos_embed"] = backbone["pos_embed"].to(dtype)
    return {**params, "backbone": backbone}


def count_params(params: Params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()
