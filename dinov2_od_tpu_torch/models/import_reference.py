"""Import a full reference checkpoint (DINOv2ObjectDetector state_dict)
into the port's params (counterpart of
dinov2_od_tpu/models/import_reference.py): the trained-model migration
path for users switching from the PyTorch reference.

Handles the reference's state-dict layout (dino_detector/models/*):

- `backbone.dino.*`: HF Dinov2 keys, except LoRA-wrapped blocks where each
  Linear became LoraLinear: `X.weight` -> `X.linear.weight` plus
  `X.lora_A.weight` [r, in] and `X.lora_B.weight` [out, r].
- `backbone.projection.*`: optional projection head.
- `decoder.query_embed.weight`, `decoder.class_embed.*`,
  `decoder.bbox_embed.mlp.{0,2}.*`.
- Standard path: torch nn.TransformerDecoder layers with packed
  `self_attn.in_proj_weight` [3D, D] and `multihead_attn.*`.
- Deformable path: per-layer self_attn (packed), reference_points_proj,
  cross_attn.{sampling_offsets,attention_weights,value_proj,output_proj}.
  The reference ties all deformable layers to one instance, so every
  layers.{i}.* entry carries the same tensors; import with
  DecoderConfig(tie_layer_weights=True) for its model, or untied (each
  layer still receives those values).

The result is the tree the JAX package's importer returns, leaf for leaf,
in fp32 on the template's device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from ..config import DetectorConfig
from .import_torch import _device_of, _load_state_dict, _to_device
from .import_torch import load_dinov2_backbone_params
from .layers import stack_params

Params = Dict[str, Any]


def _unwrap_lora_keys(sd: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Flatten LoraLinear wrapper keys back to plain Linear keys, pulling
    the factors out under synthetic '<name>#lora_A/B' keys."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.endswith(".linear.weight"):
            out[k.replace(".linear.weight", ".weight")] = v
        elif k.endswith(".linear.bias"):
            out[k.replace(".linear.bias", ".bias")] = v
        elif k.endswith(".lora_A.weight"):
            out[k.replace(".lora_A.weight", "#lora_A")] = v
        elif k.endswith(".lora_B.weight"):
            out[k.replace(".lora_B.weight", "#lora_B")] = v
        else:
            out[k] = v
    return out


# The HF Dinov2 names of each block linear, by the port's leaf name
# (models/export_reference.py writes them too).
HF_BLOCK_LINEARS = {
    "q": "attention.attention.query",
    "k": "attention.attention.key",
    "v": "attention.attention.value",
    "proj": "attention.output.dense",
    "fc1": "mlp.fc1",
    "fc2": "mlp.fc2",
}


def load_reference_detector_params(
    checkpoint, cfg: DetectorConfig, template: Params
) -> Params:
    """Map a reference DINOv2ObjectDetector state dict (a mapping, a file
    or a directory, see import_torch._load_state_dict) onto the port's
    param tree."""
    sd = _load_state_dict(checkpoint)
    # The reference trainer may prefix with 'module.' (DDP).
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items() if k.startswith("module.")}
    sd = _unwrap_lora_keys(sd)

    backbone_sd = {
        k[len("backbone.dino."):]: v
        for k, v in sd.items()
        if k.startswith("backbone.dino.") and "#lora" not in k
    }
    params: Params = {
        "backbone": load_dinov2_backbone_params(
            backbone_sd, cfg.backbone, template["backbone"]
        )
    }
    device = _device_of(template)

    # LoRA factors from the wrapped blocks (torch [r, in] / [out, r] ->
    # [in, r] / [r, out]). Blocks without adapters get ZERO factors, not
    # the template's, so the imported forward equals the torch model's
    # exactly even where the template had a random A.
    blocks = dict(params["backbone"]["blocks"])
    depth = cfg.backbone.depth
    for ours, hf in HF_BLOCK_LINEARS.items():
        bp = dict(blocks[ours])
        if "lora_A" not in bp:
            continue
        lora_a = torch.zeros((depth,) + bp["lora_A"].shape[1:])
        lora_b = torch.zeros((depth,) + bp["lora_B"].shape[1:])
        for i in range(depth):
            ka = f"backbone.dino.encoder.layer.{i}.{hf}#lora_A"
            kb = f"backbone.dino.encoder.layer.{i}.{hf}#lora_B"
            if ka in sd:
                lora_a[i] = sd[ka].t()  # [r,in] -> [in,r]
                lora_b[i] = sd[kb].t()  # [out,r] -> [r,out]
        bp["lora_A"] = lora_a.to(device)
        bp["lora_B"] = lora_b.to(device)
        blocks[ours] = bp
    params["backbone"]["blocks"] = blocks

    def t(k):  # torch Linear weight -> [in, out]
        return sd[k].t().contiguous()

    def a(k):
        return sd[k]

    if "backbone.projection.weight" in sd and "projection" in template["backbone"]:
        params["backbone"]["projection"] = _to_device({
            "kernel": t("backbone.projection.weight"),
            "bias": a("backbone.projection.bias"),
        }, device)

    # ------------------------------------------------------------------
    # Decoder
    # ------------------------------------------------------------------
    dec: Params = {
        "query_embed": a("decoder.query_embed.weight"),
        "class_embed": {
            "kernel": t("decoder.class_embed.weight"),
            "bias": a("decoder.class_embed.bias"),
        },
        "bbox_mlp": {
            "fc1": {"kernel": t("decoder.bbox_embed.mlp.0.weight"),
                    "bias": a("decoder.bbox_embed.mlp.0.bias")},
            "fc2": {"kernel": t("decoder.bbox_embed.mlp.2.weight"),
                    "bias": a("decoder.bbox_embed.mlp.2.bias")},
        },
    }

    def packed_attention(prefix: str) -> Params:
        """torch MultiheadAttention: in_proj [3D, D] packed q/k/v."""
        w = sd[prefix + ".in_proj_weight"]
        b = sd[prefix + ".in_proj_bias"]
        wq, wk, wv = w.chunk(3)
        bq, bk, bv = b.chunk(3)
        return {
            "q": {"kernel": wq.t().contiguous(), "bias": bq.contiguous()},
            "k": {"kernel": wk.t().contiguous(), "bias": bk.contiguous()},
            "v": {"kernel": wv.t().contiguous(), "bias": bv.contiguous()},
            "out": {"kernel": t(prefix + ".out_proj.weight"),
                    "bias": a(prefix + ".out_proj.bias")},
        }

    layers = []
    for i in range(cfg.decoder.num_layers):
        pre = f"decoder.decoder.layers.{i}."
        lp: Params = {
            "self_attn": packed_attention(pre + "self_attn"),
            "ln1": {"scale": a(pre + "norm1.weight"), "bias": a(pre + "norm1.bias")},
            "ln2": {"scale": a(pre + "norm2.weight"), "bias": a(pre + "norm2.bias")},
            "ln3": {"scale": a(pre + "norm3.weight"), "bias": a(pre + "norm3.bias")},
            "fc1": {"kernel": t(pre + "linear1.weight"), "bias": a(pre + "linear1.bias")},
            "fc2": {"kernel": t(pre + "linear2.weight"), "bias": a(pre + "linear2.bias")},
        }
        if cfg.decoder.use_deformable:
            lp["ref_proj"] = {
                "kernel": t(pre + "reference_points_proj.weight"),
                "bias": a(pre + "reference_points_proj.bias"),
            }
            lp["deform"] = {
                "offsets_kernel": t(pre + "cross_attn.sampling_offsets.weight"),
                "offsets_bias": a(pre + "cross_attn.sampling_offsets.bias"),
                "weights_kernel": t(pre + "cross_attn.attention_weights.weight"),
                "weights_bias": a(pre + "cross_attn.attention_weights.bias"),
                "value_kernel": t(pre + "cross_attn.value_proj.weight"),
                "value_bias": a(pre + "cross_attn.value_proj.bias"),
                "output_kernel": t(pre + "cross_attn.output_proj.weight"),
                "output_bias": a(pre + "cross_attn.output_proj.bias"),
            }
        else:
            lp["cross_attn"] = packed_attention(pre + "multihead_attn")
        layers.append(lp)

    dec["layers"] = stack_params(layers)
    params["decoder"] = _to_device(dec, device)
    return params
