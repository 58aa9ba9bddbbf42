"""HF PyTorch DINOv2 checkpoint -> the port's backbone params
(counterpart of dinov2_od_tpu/models/import_torch.py).

Nothing is downloaded: the importer reads a *local* HF checkpoint, a
directory holding `model.safetensors` or `pytorch_model.bin`, a bare
state-dict file, or an in-memory state dict (of tensors or numpy arrays).

Key mapping (HF Dinov2Model state dict -> the param tree; torch Linear
weights are [out, in] and become [in, out]):

  embeddings.cls_token                      -> cls_token
  embeddings.patch_embeddings.projection.*  -> patch_embed (OIHW -> HWIO)
  embeddings.position_embeddings            -> pos_embed (bicubic-resampled
                                               to the configured grid)
  encoder.layer.{i}.norm1/norm2             -> blocks.ln1/ln2
  encoder.layer.{i}.attention.attention.query/key/value -> blocks.q/k/v
  encoder.layer.{i}.attention.output.dense  -> blocks.proj
  encoder.layer.{i}.layer_scale1/2.lambda1  -> blocks.ls1/ls2
  encoder.layer.{i}.mlp.fc1/fc2             -> blocks.fc1/fc2   (MLP)
  encoder.layer.{i}.mlp.weights_in/out      -> blocks.fc1/fc2   (SwiGLU)
  layernorm.*                               -> ln_f

LoRA factors and the projection head are not in HF checkpoints; they
keep the template's values (A default-init, B zero, so the imported
model's forward is the pretrained backbone's).

Every leaf is cast to fp32 on the CPU (a bf16 or fp16 checkpoint
included: the casts are exact), the position embeddings are resampled
there, and the tree is then placed on the template's device. The port's
bf16 storage (models/detector.py `cast_frozen_weights`) applies after
the import.

Under the MoE FFN (sparse upcycling) the checkpoint's blocks below
`moe_boundary` fill "blocks" as above; each block of the MoE suffix
fills "moe_blocks" with its attention and norms, and every one of its E
experts starts as a copy of the block's dense fc1 / fc2, while the
router (and the LoRA factors) keep the template's values. With ample
capacity every token then reaches its experts, whose renormalised gates
sum to 1, so the upcycled block computes the dense block. A SwiGLU
checkpoint cannot be upcycled and raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import BackboneConfig
from .layers import stack_params
from .vit import interpolate_pos_embed, moe_boundary

Params = Dict[str, Any]

_PREFIXES = ("dinov2.", "dino.", "backbone.dino.")


def _to_tensor(v) -> torch.Tensor:
    """A state-dict value as a CPU tensor, floating point as fp32."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
    else:
        arr = np.asarray(v)
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16 (a JAX export)
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.float() if t.is_floating_point() else t


def _load_state_dict(path_or_sd) -> Dict[str, torch.Tensor]:
    """Accept a state dict, a checkpoint file, or an HF model directory."""
    if isinstance(path_or_sd, Mapping):
        sd = path_or_sd
    else:
        path = str(path_or_sd)
        if os.path.isdir(path):
            for cand in ("model.safetensors", "pytorch_model.bin"):
                f = os.path.join(path, cand)
                if os.path.exists(f):
                    path = f
                    break
            else:
                raise FileNotFoundError(
                    f"no model.safetensors / pytorch_model.bin under {path}"
                )
        if path.endswith(".safetensors"):
            from safetensors.torch import load_file

            sd = load_file(path)
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
    return {k: _to_tensor(v) for k, v in sd.items()}


def _device_of(tree) -> torch.device:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def load_dinov2_backbone_params(
    checkpoint, cfg: BackboneConfig, template: Params
) -> Params:
    """Build backbone params from an HF DINOv2 checkpoint.

    Args:
      checkpoint: path / directory / state dict (see _load_state_dict).
      cfg: target backbone config (grid size may differ from the
        checkpoint's; position embeddings are resampled).
      template: randomly-initialized backbone params (source of the LoRA
        factors, the optional projection head and the device).

    Returns:
      params with the template's structure, fp32, on the template's
      device.
    """
    sd = _load_state_dict(checkpoint)
    # Tolerate a 'dinov2.' / 'dino.' prefix (wrapped checkpoints).
    for prefix in _PREFIXES:
        if any(k.startswith(prefix) for k in sd):
            sd = {
                k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)
            }
            break

    def t(key):  # torch Linear weight -> [in, out]
        return sd[key].t().contiguous()

    def a(key):
        return sd[key]

    pos = a("embeddings.position_embeddings")  # [1, 1+N_src, D]
    src_grid = int(round((pos.shape[1] - 1) ** 0.5))
    moe = cfg.ffn_type == "moe"
    boundary = moe_boundary(cfg) if moe else cfg.depth
    if moe and "encoder.layer.0.mlp.weights_in.weight" in sd:
        raise ValueError(
            "MoE expert upcycling requires an MLP (gelu) DINOv2 "
            "checkpoint; this one uses SwiGLU FFNs (weights_in/out)")
    swiglu = cfg.ffn_type == "swiglu"
    fc1, fc2 = ("weights_in", "weights_out") if swiglu else ("fc1", "fc2")
    blocks, moe_blocks = [], []
    for i in range(cfg.depth):
        pre = f"encoder.layer.{i}."

        def lin(name):
            return {"kernel": t(pre + name + ".weight"),
                    "bias": a(pre + name + ".bias")}

        block = {
            "ln1": {"scale": a(pre + "norm1.weight"), "bias": a(pre + "norm1.bias")},
            "q": lin("attention.attention.query"),
            "k": lin("attention.attention.key"),
            "v": lin("attention.attention.value"),
            "proj": lin("attention.output.dense"),
            "ls1": a(pre + "layer_scale1.lambda1"),
            "ln2": {"scale": a(pre + "norm2.weight"), "bias": a(pre + "norm2.bias")},
            "ls2": a(pre + "layer_scale2.lambda1"),
        }
        ffn = {"fc1": lin("mlp." + fc1), "fc2": lin("mlp." + fc2)}
        if i < boundary:
            blocks.append({**block, **ffn})
        else:
            # Every expert starts as a copy of the block's dense FFN.
            e = cfg.moe_num_experts
            block["moe"] = {
                f"{name}_{leaf}": ffn[name][leaf].expand(
                    e, *ffn[name][leaf].shape).contiguous()
                for name in ("fc1", "fc2") for leaf in ("kernel", "bias")}
            moe_blocks.append(block)
    imported = {
        "patch_embed": {
            # OIHW -> HWIO
            "kernel": a("embeddings.patch_embeddings.projection.weight")
            .permute(2, 3, 1, 0).contiguous(),
            "bias": a("embeddings.patch_embeddings.projection.bias"),
        },
        "cls_token": a("embeddings.cls_token"),
        "pos_embed": interpolate_pos_embed(pos, src_grid, cfg.grid_size),
        "ln_f": {"scale": a("layernorm.weight"), "bias": a("layernorm.bias")},
    }
    # Stacked over depth: the dense blocks, and under MoE the suffix.
    for stack, got in (("blocks", blocks), ("moe_blocks", moe_blocks)):
        if got:
            imported[stack] = stack_params(got)
    params: Params = dict(template)
    params.update(_to_device(imported, _device_of(template)))
    # Graft the template's LoRA factors (and MoE routers) back in.
    for stack in ("blocks", "moe_blocks"):
        for name, tmpl in template.get(stack, {}).items():
            if not isinstance(tmpl, dict):
                continue
            for key in ("lora_A", "lora_B", "router_kernel"):
                if key in tmpl:
                    params[stack][name][key] = tmpl[key]
    return params
