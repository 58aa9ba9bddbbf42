"""Export the port's detector params to the PyTorch reference's
state-dict format (counterpart of dinov2_od_tpu/models/export_reference.py;
the inverse of models/import_reference.py).

Hands a checkpoint trained with the port back to the reference
implementation (dino_detector), or to any torch tooling that reads its
layout: HF Dinov2 backbone keys under `backbone.dino.*` with
LoraLinear-wrapped adapted blocks, `backbone.projection.*`, and the
DETRDecoder layout (packed torch MultiheadAttention in_proj, bbox MLP as
`bbox_embed.mlp.{0,2}`).

Every value is an fp32 CPU tensor: the frozen leaves that the port
stores in bf16 (models/detector.py `cast_frozen_weights`) are written as
fp32, which is exact, and cast back to bf16 by a bf16 run that imports
them. For the same tree the keys, shapes and values are the JAX
exporter's.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..config import DetectorConfig
from .import_reference import HF_BLOCK_LINEARS

Params = Dict[str, Any]


def _t(x: torch.Tensor) -> torch.Tensor:
    """A leaf as a contiguous fp32 CPU tensor of its own (not a view into
    a stacked leaf, which torch.save would write whole)."""
    return x.detach().to("cpu", torch.float32).clone(
        memory_format=torch.contiguous_format)


def _w(x: torch.Tensor) -> torch.Tensor:
    """An `[in, out]` kernel as a torch Linear weight `[out, in]`."""
    return _t(x.t())


def export_reference_state_dict(params: Params, cfg: DetectorConfig
                                ) -> Dict[str, torch.Tensor]:
    """Build a reference-format state dict of fp32 CPU tensors."""
    sd: Dict[str, torch.Tensor] = {}
    bb = params["backbone"]
    depth = cfg.backbone.depth
    adapted_from = max(0, depth - cfg.backbone.lora_last_n_blocks)

    # Embeddings (HWIO -> OIHW).
    sd["backbone.dino.embeddings.patch_embeddings.projection.weight"] = _t(
        bb["patch_embed"]["kernel"].permute(3, 2, 0, 1))
    sd["backbone.dino.embeddings.patch_embeddings.projection.bias"] = _t(
        bb["patch_embed"]["bias"])
    sd["backbone.dino.embeddings.cls_token"] = _t(bb["cls_token"])
    sd["backbone.dino.embeddings.position_embeddings"] = _t(bb["pos_embed"])
    # HF checkpoints carry a mask_token the reference never uses.
    sd["backbone.dino.embeddings.mask_token"] = torch.zeros(
        (1, cfg.backbone.hidden_dim))

    blocks = bb["blocks"]
    for i in range(depth):
        pre = f"backbone.dino.encoder.layer.{i}."
        adapted = i >= adapted_from
        for ours, hf in HF_BLOCK_LINEARS.items():
            bp = blocks[ours]
            w, b = _w(bp["kernel"][i]), _t(bp["bias"][i])
            if adapted and "lora_A" in bp:
                # LoraLinear wrapper layout (reference utils.py).
                sd[pre + hf + ".linear.weight"] = w
                sd[pre + hf + ".linear.bias"] = b
                sd[pre + hf + ".lora_A.weight"] = _w(bp["lora_A"][i])
                sd[pre + hf + ".lora_B.weight"] = _w(bp["lora_B"][i])
            else:
                sd[pre + hf + ".weight"] = w
                sd[pre + hf + ".bias"] = b
        sd[pre + "norm1.weight"] = _t(blocks["ln1"]["scale"][i])
        sd[pre + "norm1.bias"] = _t(blocks["ln1"]["bias"][i])
        sd[pre + "norm2.weight"] = _t(blocks["ln2"]["scale"][i])
        sd[pre + "norm2.bias"] = _t(blocks["ln2"]["bias"][i])
        sd[pre + "layer_scale1.lambda1"] = _t(blocks["ls1"][i])
        sd[pre + "layer_scale2.lambda1"] = _t(blocks["ls2"][i])
    sd["backbone.dino.layernorm.weight"] = _t(bb["ln_f"]["scale"])
    sd["backbone.dino.layernorm.bias"] = _t(bb["ln_f"]["bias"])

    if "projection" in bb:
        sd["backbone.projection.weight"] = _w(bb["projection"]["kernel"])
        sd["backbone.projection.bias"] = _t(bb["projection"]["bias"])

    dec = params["decoder"]
    sd["decoder.query_embed.weight"] = _t(dec["query_embed"])
    sd["decoder.class_embed.weight"] = _w(dec["class_embed"]["kernel"])
    sd["decoder.class_embed.bias"] = _t(dec["class_embed"]["bias"])
    sd["decoder.bbox_embed.mlp.0.weight"] = _w(dec["bbox_mlp"]["fc1"]["kernel"])
    sd["decoder.bbox_embed.mlp.0.bias"] = _t(dec["bbox_mlp"]["fc1"]["bias"])
    sd["decoder.bbox_embed.mlp.2.weight"] = _w(dec["bbox_mlp"]["fc2"]["kernel"])
    sd["decoder.bbox_embed.mlp.2.bias"] = _t(dec["bbox_mlp"]["fc2"]["bias"])

    if cfg.decoder.use_deformable:
        # The reference DETRDecoder declares an unused decoder-level
        # reference_points Linear (dead code). Emit zeros so strict
        # state-dict loads succeed.
        d = cfg.decoder.hidden_dim
        sd["decoder.reference_points.weight"] = torch.zeros((2, d))
        sd["decoder.reference_points.bias"] = torch.zeros((2,))

    layers = dec["layers"]

    def packed(attn, i):  # q, k, v -> torch MultiheadAttention's in_proj
        return (torch.cat([_w(attn[p]["kernel"][i]) for p in ("q", "k", "v")]),
                torch.cat([_t(attn[p]["bias"][i]) for p in ("q", "k", "v")]))

    for i in range(cfg.decoder.num_layers):
        pre = f"decoder.decoder.layers.{i}."
        sa = layers["self_attn"]
        (sd[pre + "self_attn.in_proj_weight"],
         sd[pre + "self_attn.in_proj_bias"]) = packed(sa, i)
        sd[pre + "self_attn.out_proj.weight"] = _w(sa["out"]["kernel"][i])
        sd[pre + "self_attn.out_proj.bias"] = _t(sa["out"]["bias"][i])
        for ln, torch_ln in (("ln1", "norm1"), ("ln2", "norm2"), ("ln3", "norm3")):
            sd[pre + torch_ln + ".weight"] = _t(layers[ln]["scale"][i])
            sd[pre + torch_ln + ".bias"] = _t(layers[ln]["bias"][i])
        sd[pre + "linear1.weight"] = _w(layers["fc1"]["kernel"][i])
        sd[pre + "linear1.bias"] = _t(layers["fc1"]["bias"][i])
        sd[pre + "linear2.weight"] = _w(layers["fc2"]["kernel"][i])
        sd[pre + "linear2.bias"] = _t(layers["fc2"]["bias"][i])
        if cfg.decoder.use_deformable:
            sd[pre + "reference_points_proj.weight"] = _w(
                layers["ref_proj"]["kernel"][i])
            sd[pre + "reference_points_proj.bias"] = _t(
                layers["ref_proj"]["bias"][i])
            dp = layers["deform"]
            for ours, torch_name in (
                ("offsets", "sampling_offsets"),
                ("weights", "attention_weights"),
                ("value", "value_proj"),
                ("output", "output_proj"),
            ):
                sd[pre + f"cross_attn.{torch_name}.weight"] = _w(
                    dp[f"{ours}_kernel"][i])
                sd[pre + f"cross_attn.{torch_name}.bias"] = _t(
                    dp[f"{ours}_bias"][i])
        else:
            ca = layers["cross_attn"]
            (sd[pre + "multihead_attn.in_proj_weight"],
             sd[pre + "multihead_attn.in_proj_bias"]) = packed(ca, i)
            sd[pre + "multihead_attn.out_proj.weight"] = _w(ca["out"]["kernel"][i])
            sd[pre + "multihead_attn.out_proj.bias"] = _t(ca["out"]["bias"][i])
    return sd


def save_reference_checkpoint(path: str, params: Params, cfg: DetectorConfig
                              ) -> str:
    """torch.save the exported state dict to `path`."""
    torch.save(export_reference_state_dict(params, cfg), path)
    return path
