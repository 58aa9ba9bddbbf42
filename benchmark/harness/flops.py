"""Operations and bytes of the detector's work, counted from shapes, and
the card's published peaks: the yardstick of `mfu.*` and
`attn_roofline.*`.

Model FLOPs count each multiply-add as 2 and only the work the model
needs: no recomputation, no padded images, no kernel's own scratch. The
peaks are NVIDIA's data sheet for one H100 SXM at 700 W, dense.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, n_bytes: float, peak: float = PEAK_BF16_FLOPS
            ) -> Tuple[float, str]:
    """(least seconds, what bounds them): operations at the peak rate or
    bytes at the HBM rate, whichever takes longer."""
    t_ops, t_bytes = flops / peak, n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations")


def attention_fwd(b: int, h: int, s: int, dh: int, item: int = 2
                  ) -> Tuple[float, float]:
    """(flops, bytes) of one attention forward over [b, s, h, dh]: q, k,
    v and o once, the fp32 log-sum-exp once; two products of 2 s^2 dh a
    (batch, head)."""
    n_bytes = 4 * s * b * h * dh * item + b * h * s * 4
    return 4.0 * b * h * s * s * dh, n_bytes


def attention_bwd(b: int, h: int, s: int, dh: int, item: int = 2
                  ) -> Tuple[float, float]:
    """(flops, bytes) of one attention backward: q, k, v and dO read once,
    the fp32 log-sum-exp and delta read once, dq, dk and dv written once;
    five products (s, dp, dv, dk, dq) of 2 s^2 dh a (batch, head)."""
    n_bytes = 7 * s * b * h * dh * item + 2 * b * h * s * 4
    return 10.0 * b * h * s * s * dh, n_bytes


def _linear(rows: float, k: int, n: int) -> float:
    return 2.0 * rows * k * n


def vit_block_flops(cfg: dict, images: float, lora: bool = False) -> float:
    """Forward FLOPs of one ViT block over `images` images (with its LoRA
    products where `lora`)."""
    d, s = cfg["hidden_size"], seq_len(cfg)
    m = int(d * cfg["mlp_ratio"])
    rows = images * s
    f = (_linear(rows, d, 3 * d) + _linear(rows, d, d)
         + _linear(rows, d, m) + _linear(rows, m, d))
    f += 4.0 * images * s * s * d  # q k^T and p v over all heads
    if lora:
        r = cfg["lora_r"]
        f += sum(_linear(rows, i, r) + _linear(rows, r, o)
                 for i, o in ((d, d), (d, d), (d, d), (d, d), (d, m), (m, d)))
    return f


def seq_len(cfg: dict) -> int:
    return (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1


def backbone_flops(cfg: dict, images: float, lora: bool) -> float:
    """Forward FLOPs of the backbone: patch embedding, the blocks (LoRA on
    the adapted ones where `lora`), the projection to the decoder width."""
    d, p = cfg["hidden_size"], cfg["patch_size"]
    patches = seq_len(cfg) - 1
    f = _linear(images * patches, p * p * 3, d)
    depth, n = cfg["num_hidden_layers"], cfg["lora_last_n_blocks"]
    f += (depth - n) * vit_block_flops(cfg, images)
    f += n * vit_block_flops(cfg, images, lora)
    if cfg["decoder_hidden_dim"] != d:
        f += _linear(images * seq_len(cfg), d, cfg["decoder_hidden_dim"])
    return f


def decoder_flops(cfg: dict, images: float) -> float:
    """Forward FLOPs of the decoder and heads: per layer self-attention
    over the queries, deformable cross-attention (offset and weight
    projections, the value projection over every feature token, bilinear
    sampling of 4 corners a point, the output projection), the FFN; then
    the class head and the box MLP."""
    d, q = cfg["decoder_hidden_dim"], cfg["num_queries"]
    f_ffn, heads, pts = cfg["decoder_ffn_dim"], cfg["decoder_heads"], \
        cfg["n_points"]
    rows = images * q
    tokens = images * (seq_len(cfg) - 1)
    per_layer = (4 * _linear(rows, d, d) + 4.0 * images * q * q * d
                 + _linear(rows, d, 2)
                 + _linear(rows, d, heads * pts * 2)
                 + _linear(rows, d, heads * pts)
                 + _linear(tokens, d, d)
                 + 2.0 * rows * pts * 4 * d + 2.0 * rows * pts * d
                 + _linear(rows, d, d)
                 + _linear(rows, d, f_ffn) + _linear(rows, f_ffn, d))
    heads_f = (_linear(rows, d, cfg["num_classes"]) + _linear(rows, d, d // 2)
               + _linear(rows, d // 2, 4))
    return cfg["decoder_layers"] * per_layer + heads_f


def train_flops(cfg: dict, images: float) -> float:
    """Model FLOPs of `images` images through the fine-tuning step: the
    forward; the backward of the decoder, heads and projection (input and
    weight gradients, 2x their forward); of the adapted blocks the input
    gradient of each frozen linear (1x; none for the first adapted
    block's q, k and v, whose input takes no gradient), the LoRA factors'
    gradients (2x their products) and 2x the attention products (dq, dk,
    dv without the recomputed logits)."""
    d, s = cfg["hidden_size"], seq_len(cfg)
    m = int(d * cfg["mlp_ratio"])
    r, n = cfg["lora_r"], cfg["lora_last_n_blocks"]
    rows = images * s
    fwd = backbone_flops(cfg, images, lora=True) + decoder_flops(cfg, images)
    bwd = 2.0 * decoder_flops(cfg, images)
    if cfg["decoder_hidden_dim"] != d:
        bwd += 2.0 * _linear(rows, d, cfg["decoder_hidden_dim"])
    frozen = (_linear(rows, d, 3 * d) + _linear(rows, d, d)
              + _linear(rows, d, m) + _linear(rows, m, d))
    lora_f = sum(_linear(rows, i, r) + _linear(rows, r, o)
                 for i, o in ((d, d), (d, d), (d, d), (d, d), (d, m), (m, d)))
    attn = 4.0 * images * s * s * d
    bwd += n * (frozen + 2.0 * lora_f + 2.0 * attn) - _linear(rows, d, 3 * d)
    return fwd + bwd


def attention_work(cfg: dict, images: int, train: bool) -> Dict[str, float]:
    """The least seconds of the backbone's attention over `images` images
    (a batch): a forward a block, and in training a backward on each
    adapted block; at the bf16 peak and the HBM rate."""
    h = cfg["num_attention_heads"]
    dh = cfg["hidden_size"] // h
    s = seq_len(cfg)
    f_ops, f_bytes = attention_fwd(images, h, s, dh)
    t = cfg["num_hidden_layers"] * bound_s(f_ops, f_bytes)[0]
    if train:
        b_ops, b_bytes = attention_bwd(images, h, s, dh)
        t += cfg["lora_last_n_blocks"] * bound_s(b_ops, b_bytes)[0]
    return {"bound_s": t}
