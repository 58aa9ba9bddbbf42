"""The detector in plain PyTorch: a DINOv2 ViT with LoRA on its last
blocks, a deformable DETR decoder and the detection heads.

It reads the param tree the benchmark made (the port's keys: stacked
`[depth, ...]` block leaves, kernels `[in, out]`) and computes in float32
with TF32 off, or, for the control, one precision lower (`Precision`).
It imports nothing of the program: every formula is written out here
from the published descriptions (DINOv2: pre-norm blocks with
LayerScale; LoRA: W x + alpha B A x; Deformable DETR: sampling offsets
and weights from the query, bilinear sampling of a single-scale value
map; DETR: post-norm decoder layers, a linear class head and a 3-layer
box MLP whose first two layers are one hidden ReLU layer here, as in the
configuration).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Tree = Dict[str, object]

FP8_MAX = 448.0  # largest finite float8 e4m3 value


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude maps to FP8_MAX), back in float32."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """How the reference multiplies: 'fp32' (exact float32), 'bf16' (both
    operands rounded to bfloat16) or 'fp8' (both rounded to float8 e4m3,
    one scale a tensor); the backbone's and the decoder's products each
    have their own. Accumulation is float32 in every case."""

    def __init__(self, backbone: str = "fp32", decoder: str = "fp32"):
        self.backbone, self.decoder = backbone, decoder

    @staticmethod
    def _round(t: torch.Tensor, mode: str) -> torch.Tensor:
        if mode == "fp32":
            return t
        if mode == "bf16":
            return t.to(torch.bfloat16).float()
        if mode == "fp8":
            return _fp8(t)
        raise ValueError(mode)

    def mm(self, a: torch.Tensor, b: torch.Tensor, part: str) -> torch.Tensor:
        mode = getattr(self, part)
        return self._round(a, mode) @ self._round(b, mode)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor,
               part: str) -> torch.Tensor:
        mode = getattr(self, part)
        return torch.einsum(eq, self._round(a, mode), self._round(b, mode))


FP32 = Precision()
# One step below the configurations' precisions: the bf16 backbone's
# products in fp8, the fp32 decoder's in bf16 (the control).
LOWER = Precision(backbone="fp8", decoder="bf16")


@contextlib.contextmanager
def fp32_matmuls():
    """Float32 products in float32: TF32 off for the body, as it was
    after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def layer_norm(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), f32(p["scale"]), f32(p["bias"]),
                        eps)


def _row(tree, i):
    """Block i of a stacked tree."""
    return {k: _row(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def dense(x, p, prec: Precision, part: str, lora_alpha: float = 0.0):
    """x W + b, plus alpha (x A) B where lora_alpha is given."""
    y = prec.mm(x, f32(p["kernel"]), part) + f32(p["bias"])
    if lora_alpha and "lora_A" in p:
        y = y + lora_alpha * prec.mm(prec.mm(x, f32(p["lora_A"]), part),
                                     f32(p["lora_B"]), part)
    return y


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def vit_block(x, bp, cfg: dict, prec: Precision, lora: bool):
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    dh = d // heads
    alpha = cfg["lora_alpha"] if lora else 0.0
    b, n, _ = x.shape
    h = layer_norm(x, bp["ln1"], cfg["layer_norm_eps"])
    q, k, v = (dense(h, bp[name], prec, "backbone", alpha)
               .reshape(b, n, heads, dh) for name in ("q", "k", "v"))
    logits = prec.einsum("bqhd,bkhd->bhqk", q, k, "backbone") / math.sqrt(dh)
    attn = prec.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v,
                       "backbone").reshape(b, n, d)
    x = x + f32(bp["ls1"]) * dense(attn, bp["proj"], prec, "backbone", alpha)
    h = layer_norm(x, bp["ln2"], cfg["layer_norm_eps"])
    h = dense(h, bp["fc1"], prec, "backbone", alpha)
    h = F.gelu(h, approximate="tanh" if cfg["gelu_approximate"] else "none")
    return x + f32(bp["ls2"]) * dense(h, bp["fc2"], prec, "backbone", alpha)


def backbone(params, cfg: dict, images: torch.Tensor, prec: Precision,
             grad_blocks: bool = False) -> torch.Tensor:
    """[B, H, W, 3] normalised float images -> [B, patches, out] features.
    The last `lora_last_n_blocks` blocks carry LoRA and, with
    `grad_blocks`, run under autograd; the blocks before them never do."""
    p = cfg["patch_size"]
    d = cfg["hidden_size"]
    b, hh, ww, c = images.shape
    gh, gw = hh // p, ww // p
    x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, gh * gw, p * p * c)
    pe = params["patch_embed"]
    with torch.no_grad():
        x = prec.mm(x, f32(pe["kernel"]).reshape(p * p * c, d),
                    "backbone") + f32(pe["bias"])
        x = torch.cat([f32(params["cls_token"]).expand(b, 1, d), x], dim=1)
        x = x + f32(params["pos_embed"])
    depth = cfg["num_hidden_layers"]
    first = depth - cfg["lora_last_n_blocks"]
    blocks = params["blocks"]
    for i in range(depth):
        lora = i >= first
        with torch.set_grad_enabled(lora and grad_blocks):
            x = vit_block(x, _row(blocks, i), cfg, prec, lora)
    x = layer_norm(x, params["ln_f"], cfg["layer_norm_eps"])
    if "projection" in params:
        x = dense(x, params["projection"], prec, "backbone")
    return x[:, 1:]


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class Dropout:
    """Dropout masks drawn as the configuration's training draws them: a
    uniform draw of the tensor's shape from the step's generator, kept
    where below 1 - rate, the kept values scaled by 1 / (1 - rate); the
    draws in the order the layer applies them. Without a generator it
    is the identity."""

    def __init__(self, rate: float, generator: Optional[torch.Generator]):
        self.rate, self.gen = rate, generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.gen is None or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def spatial_shape(n: int) -> Tuple[int, int]:
    """The (h, w) grid of n tokens: square when n is a square, else the
    factor pair nearest to it with h <= w."""
    r = int(math.isqrt(n))
    for h in range(r, 0, -1):
        if n % h == 0:
            return h, n // h
    return r, r


def deformable(tgt, ref, memory, p, cfg: dict, prec: Precision):
    """Single-scale deformable attention: each head samples its value map
    at n_points locations clip(ref + offset, 0, 1), bilinearly, and sums
    them under softmax weights."""
    b, q, d = tgt.shape
    heads, points = cfg["decoder_heads"], cfg["n_points"]
    dh = d // heads
    hh, ww = spatial_shape(memory.shape[1])
    off = (prec.mm(tgt, f32(p["offsets_kernel"]), "decoder")
           + f32(p["offsets_bias"])).reshape(b, q, heads, points, 2)
    wts = torch.softmax((prec.mm(tgt, f32(p["weights_kernel"]), "decoder")
                         + f32(p["weights_bias"])).reshape(
                             b, q, heads, points), dim=-1)
    val = (prec.mm(memory, f32(p["value_kernel"]), "decoder")
           + f32(p["value_bias"])).reshape(b, hh * ww, heads, dh)
    val = val.permute(0, 2, 1, 3)  # [B, H, HW, dh]
    loc = torch.clamp(ref[:, :, None, None, :] + off, 0.0, 1.0)
    px, py = loc[..., 0] * (ww - 1), loc[..., 1] * (hh - 1)
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    x0, y0 = x0.long(), y0.long()
    out = torch.zeros(b, q, heads, points, dh, device=tgt.device)
    for dx, dy in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi = (x0 + dx).clamp(0, ww - 1)
        yi = (y0 + dy).clamp(0, hh - 1)
        w = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
        idx = (yi * ww + xi).permute(0, 2, 1, 3).reshape(b, heads, q * points)
        g = torch.gather(val, 2, idx[..., None].expand(-1, -1, -1, dh))
        g = g.reshape(b, heads, q, points, dh).permute(0, 2, 1, 3, 4)
        out = out + w[..., None] * g
    out = (out * wts[..., None]).sum(dim=3).reshape(b, q, d)
    return prec.mm(out, f32(p["output_kernel"]), "decoder") + f32(
        p["output_bias"])


def self_attention(tgt, p, cfg: dict, prec: Precision, drop: Dropout):
    b, q, d = tgt.shape
    heads = cfg["decoder_heads"]
    dh = d // heads
    qh, kh, vh = (dense(tgt, p[n], prec, "decoder").reshape(b, q, heads, dh)
                  for n in ("q", "k", "v"))
    logits = prec.einsum("bqhd,bkhd->bhqk", qh, kh, "decoder") / math.sqrt(dh)
    w = drop(torch.softmax(logits, dim=-1))
    out = prec.einsum("bhqk,bkhd->bqhd", w, vh, "decoder").reshape(b, q, d)
    return dense(out, p["out"], prec, "decoder")


def decoder(params, cfg: dict, memory: torch.Tensor, prec: Precision,
            generator: Optional[torch.Generator] = None
            ) -> Dict[str, torch.Tensor]:
    """Object queries decoded against [B, S, D] features: pred_logits
    [B, Q, C] and pred_boxes [B, Q, 4] (cx, cy, w, h in [0, 1]). With a
    generator, train-mode dropout in each layer: attention probabilities,
    then the self-attention, cross-attention, hidden FFN and FFN
    outputs."""
    drop = Dropout(cfg["dropout"], generator)
    b = memory.shape[0]
    tgt = f32(params["query_embed"])[None].expand(b, -1, -1)
    layers = params["layers"]
    for i in range(cfg["decoder_layers"]):
        lp = _row(layers, i)
        sa = self_attention(tgt, lp["self_attn"], cfg, prec, drop)
        tgt = layer_norm(tgt + drop(sa), lp["ln1"], 1e-5)
        ref = torch.sigmoid(dense(tgt, lp["ref_proj"], prec, "decoder"))
        ca = deformable(tgt, ref, memory, lp["deform"], cfg, prec)
        tgt = layer_norm(tgt + drop(ca), lp["ln2"], 1e-5)
        h = drop(torch.relu(dense(tgt, lp["fc1"], prec, "decoder")))
        h = dense(h, lp["fc2"], prec, "decoder")
        tgt = layer_norm(tgt + drop(h), lp["ln3"], 1e-5)
    logits = dense(tgt, params["class_embed"], prec, "decoder")
    h = torch.relu(dense(tgt, params["bbox_mlp"]["fc1"], prec, "decoder"))
    boxes = torch.sigmoid(dense(h, params["bbox_mlp"]["fc2"], prec,
                                "decoder"))
    return {"pred_logits": logits, "pred_boxes": boxes}


def normalize(images_u8: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> float32 (x / 255 - mean) / std."""
    x = images_u8.float() / 255.0
    return (x - torch.as_tensor(mean, device=x.device)) / torch.as_tensor(
        std, device=x.device)


def detector(params, cfg: dict, images: torch.Tensor, prec: Precision,
             generator=None, grad_blocks: bool = False):
    feats = backbone(params["backbone"], cfg, images, prec, grad_blocks)
    return decoder(params["decoder"], cfg, feats, prec, generator)


def topk(logits: torch.Tensor, boxes: torch.Tensor, size_hw, k: int
         ) -> List[torch.Tensor]:
    """Per image, the k best (query, class) pairs by sigmoid score: rows
    of (score, label, x, y, w, h), the box in pixels of an image of
    `size_hw`, corner and extent."""
    b, q, c = logits.shape
    scores = torch.sigmoid(logits).reshape(b, q * c)
    s, idx = torch.topk(scores, min(k, q * c), dim=1)
    qi, label = idx // c, idx % c
    bx = torch.gather(boxes, 1, qi[..., None].expand(-1, -1, 4))
    h, w = size_hw
    scale = torch.tensor([w, h, w, h], device=bx.device, dtype=bx.dtype)
    cx, cy, bw, bh = (bx * scale).unbind(-1)
    xywh = torch.stack([cx - bw / 2, cy - bh / 2, bw, bh], dim=-1)
    return torch.cat([s[..., None], label[..., None].float(), xywh], dim=-1)
