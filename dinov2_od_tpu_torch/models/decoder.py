"""DETR decoder: learned object queries + (standard | deformable) layers
(counterpart of dinov2_od_tpu/models/decoder.py).

Layers are stacked on a leading axis as in the JAX param tree and run as
a Python loop. Post-norm residual blocks (LayerNorm eps 1e-5) with a ReLU
FFN; the self-attention always takes the plain einsum path ('xla'), as in
the JAX package. Heads: class logits Linear and a 2-layer box MLP with
sigmoid, both fp32. Train mode (deterministic=False with a generator)
drops the residual branches, the FFN hidden layer and the self-attention
probabilities, each with its own draw, and returns `aux_outputs` when
`aux_loss` is set.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..config import DecoderConfig
from ..ops.attention import multi_head_attention
from ..ops.deformable import (
    DeformableParams,
    deformable_attention,
    factor_spatial_shape,
    init_deformable_params,
)
from .layers import (
    compute_dtype,
    dropout,
    index_params,
    layer_norm,
    layernorm_init,
    linear,
    stack_params,
    torch_linear_init,
    xavier_linear_init,
)

Params = Dict[str, Any]


def _init_self_attn(gen, d: int, device) -> Params:
    return {name: xavier_linear_init(gen, d, d, device)
            for name in ("q", "k", "v", "out")}


def _init_layer(gen, cfg: DecoderConfig, device) -> Params:
    d, f = cfg.hidden_dim, cfg.dim_feedforward
    p: Params = {
        "self_attn": _init_self_attn(gen, d, device),
        "ln1": layernorm_init(d, device),
        "ln2": layernorm_init(d, device),
        "ln3": layernorm_init(d, device),
        "fc1": torch_linear_init(gen, d, f, device),
        "fc2": torch_linear_init(gen, f, d, device),
    }
    if cfg.use_deformable:
        p["ref_proj"] = torch_linear_init(gen, d, 2, device)
        p["deform"] = init_deformable_params(
            gen, d, cfg.num_heads, cfg.n_points, device
        )
    else:
        p["cross_attn"] = _init_self_attn(gen, d, device)
    return p


def init_decoder_params(gen: torch.Generator, cfg: DecoderConfig,
                        device) -> Params:
    """Random decoder params from `gen`, in the JAX package's tree."""
    d = cfg.hidden_dim
    n_unique = 1 if cfg.tie_layer_weights else cfg.num_layers
    layers = [_init_layer(gen, cfg, device) for _ in range(n_unique)]
    if cfg.tie_layer_weights:
        layers = layers * cfg.num_layers
    query = torch.empty((cfg.num_queries, d)).normal_(generator=gen)
    return {
        # torch nn.Embedding default: N(0, 1).
        "query_embed": query.to(device),
        "layers": stack_params(layers),
        "class_embed": torch_linear_init(gen, d, cfg.num_classes, device),
        "bbox_mlp": {
            "fc1": torch_linear_init(gen, d, d // 2, device),
            "fc2": torch_linear_init(gen, d // 2, 4, device),
        },
    }


def _attention_block(tgt, memory, p: Params, num_heads: int,
                     drop_rate: float = 0.0,
                     generator: Optional[torch.Generator] = None):
    """Multi-head attention of tgt over memory (memory is tgt for the
    self-attention), plain einsum path, with probability dropout when a
    generator is given."""
    b, q, d = tgt.shape
    s = memory.shape[1]
    dh = d // num_heads
    qh = linear(tgt, p["q"]).reshape(b, q, num_heads, dh)
    kh = linear(memory, p["k"]).reshape(b, s, num_heads, dh)
    vh = linear(memory, p["v"]).reshape(b, s, num_heads, dh)
    out = multi_head_attention(qh, kh, vh, impl="xla", dropout_rate=drop_rate,
                               generator=generator).reshape(b, q, d)
    return linear(out, p["out"])


def _layer_apply(tgt, memory, lp: Params, cfg: DecoderConfig,
                 spatial_shape: Tuple[int, int],
                 generator: Optional[torch.Generator], deterministic: bool):
    """One post-norm decoder layer."""
    dr = cfg.dropout
    gen = None if deterministic else generator

    def drop(x):
        return dropout(x, dr, gen, deterministic)

    sa = _attention_block(tgt, tgt, lp["self_attn"], cfg.num_heads, dr, gen)
    tgt = layer_norm(tgt + drop(sa), lp["ln1"], eps=1e-5)

    if cfg.use_deformable:
        ref = torch.sigmoid(linear(tgt, lp["ref_proj"]))  # [B, Q, 2]
        ca = deformable_attention(
            tgt, ref, memory, spatial_shape,
            DeformableParams(**lp["deform"]), cfg.num_heads, cfg.n_points,
        )
    else:
        ca = _attention_block(tgt, memory, lp["cross_attn"], cfg.num_heads)
    tgt = layer_norm(tgt + drop(ca), lp["ln2"], eps=1e-5)

    h = drop(torch.relu(linear(tgt, lp["fc1"])))
    h = linear(h, lp["fc2"])
    return layer_norm(tgt + drop(h), lp["ln3"], eps=1e-5)


def decoder_apply(
    params: Params,
    cfg: DecoderConfig,
    memory: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> Dict[str, Any]:
    """Decode object queries against backbone features.

    Args:
      memory: [B, S, D] backbone features.
      generator: dropout's random source (on memory's device); train-mode
        dropout needs it and deterministic=False.

    Returns:
      {"pred_logits": [B, Q, num_classes], "pred_boxes": [B, Q, 4] cxcywh
       in [0, 1]}, both fp32, plus "aux_outputs" (a list of such dicts for
      layers 0..L-2) when cfg.aux_loss and not deterministic.
    """
    b, s, d = memory.shape
    memory = memory.to(compute_dtype(cfg.dtype))
    spatial_shape = factor_spatial_shape(s)
    tgt = params["query_embed"][None].to(memory.dtype).expand(
        b, cfg.num_queries, d
    )
    collect = cfg.aux_loss and not deterministic
    inter = []
    for i in range(cfg.num_layers):
        tgt = _layer_apply(tgt, memory, index_params(params["layers"], i), cfg,
                           spatial_shape, generator, deterministic)
        if collect and i < cfg.num_layers - 1:
            inter.append(tgt)

    def heads(x):
        logits = linear(x, params["class_embed"])
        h = torch.relu(linear(x, params["bbox_mlp"]["fc1"]))
        boxes = torch.sigmoid(linear(h, params["bbox_mlp"]["fc2"]))
        return {"pred_logits": logits.float(), "pred_boxes": boxes.float()}

    out = heads(tgt)
    if collect:
        out["aux_outputs"] = [heads(x) for x in inter]
    return out
