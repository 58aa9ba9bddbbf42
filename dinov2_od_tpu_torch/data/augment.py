"""Train-time augmentation on the device (counterpart of
dinov2_od_tpu/data/augment.py): horizontal flip, scale/translate jitter
and colour jitter, run inside the train step on the batch's device.

The random draws are split from the arithmetic:
- `draw_augment` draws every per-image factor (flip mask, zoom scale,
  translation, brightness / contrast / saturation) from an explicit
  `torch.Generator`, on the generator's device, without a host sync;
- `apply_augment` applies given draws to (x01, boxes, valid).
So one set of draws can go through the card and through a plain CPU run,
and the JAX package's own draws through the port's arithmetic.

The arithmetic is the JAX package's:
- the zoom is a separable bilinear (tent) resample as two batched
  matmuls with per-image [H, H] and [W, W] weights, black outside the
  input: output pixel i reads input coordinate u = (i + 0.5 - t) / s - 0.5;
- boxes (cxcywh, normalised) follow x' = s * x + t / size and are
  clipped to [0, 1]; a box whose clipped width or height is not above
  `min_box_size` loses its valid bit;
- colour jitter scales brightness, then contrast about the image's mean
  gray, then saturation toward each pixel's gray (Rec. 601 luma), and
  clips to [0, 1].

Images are [B, H, W, 3] float in [0, 1] (un-normalised RGB); boxes
[B, G, 4] cxcywh in [0, 1]; valid [B, G] bool. Every augmentation is
static on the config: a disabled one draws nothing and adds no op.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import AugmentConfig
from ..ops.boxes import box_cxcywh_to_xyxy, box_xyxy_to_cxcywh

# Rec. 601 luma, the torchvision grayscale convention.
LUMA = (0.299, 0.587, 0.114)

Draws = Dict[str, torch.Tensor]


def _uniform(gen, n: int, lo: float, hi: float, device) -> torch.Tensor:
    u = torch.rand(n, generator=gen, device=device)
    return lo + (hi - lo) * u


def draw_augment(gen: Optional[torch.Generator], cfg: AugmentConfig,
                 batch: int, height: int, width: int, device) -> Draws:
    """Per-image draws of the enabled augmentations, in a fixed order
    (flip, zoom, x and y placement, brightness, contrast, saturation):
    "flip" [B] bool; "scale", "tx", "ty" [B] (tx, ty in pixels, uniform
    between 0 and size * (1 - scale)); "bright", "contrast", "sat" [B]."""
    d: Draws = {}
    if cfg.hflip_prob > 0:
        d["flip"] = torch.rand(batch, generator=gen,
                               device=device) < cfg.hflip_prob
    if cfg.scale_jitter > 0:
        s = _uniform(gen, batch, 1.0 - cfg.scale_jitter,
                     1.0 + cfg.scale_jitter, device)
        d["scale"] = s
        d["tx"] = width * (1.0 - s) * torch.rand(batch, generator=gen,
                                                 device=device)
        d["ty"] = height * (1.0 - s) * torch.rand(batch, generator=gen,
                                                  device=device)
    if cfg.color_jitter > 0:
        lo, hi = 1.0 - cfg.color_jitter, 1.0 + cfg.color_jitter
        for k in ("bright", "contrast", "sat"):
            d[k] = _uniform(gen, batch, lo, hi, device)
    return d


def resample_matrix(n: int, scale: torch.Tensor,
                    translate: torch.Tensor) -> torch.Tensor:
    """[B, n_out, n_in] bilinear weights W[i, j] = max(0, 1 - |u_i - j|)
    for one axis; an output pixel whose input coordinate falls outside
    gets a zero row (black fill)."""
    i = torch.arange(n, dtype=torch.float32, device=scale.device)
    u = (i[None, :] + 0.5 - translate[:, None]) / scale[:, None] - 0.5
    return torch.clamp(1.0 - (u[:, :, None] - i[None, None, :]).abs(),
                       min=0.0)


def apply_scale_translate(images, boxes, valid, s, tx, ty,
                          min_box_size: float):
    """Zoom each image by s[B] about its origin and shift it by (tx, ty)
    pixels: the images through two batched matmuls (rows, then columns),
    the boxes through the same affine map, clipped."""
    _, h, w, _ = images.shape
    wy = resample_matrix(h, s, ty)
    wx = resample_matrix(w, s, tx)
    tmp = torch.einsum("bij,bjwc->biwc", wy, images)
    images = torch.einsum("bkw,bhwc->bhkc", wx, tmp)

    xyxy = box_cxcywh_to_xyxy(boxes)
    sx = s[:, None]
    # Times the reciprocal, as CUDA divides by a host scalar: the card and
    # a CPU run then give the same boxes to the bit.
    shift_x, shift_y = (tx * (1.0 / w))[:, None], (ty * (1.0 / h))[:, None]
    x0 = torch.clamp(xyxy[..., 0] * sx + shift_x, 0.0, 1.0)
    y0 = torch.clamp(xyxy[..., 1] * sx + shift_y, 0.0, 1.0)
    x1 = torch.clamp(xyxy[..., 2] * sx + shift_x, 0.0, 1.0)
    y1 = torch.clamp(xyxy[..., 3] * sx + shift_y, 0.0, 1.0)
    boxes = box_xyxy_to_cxcywh(torch.stack([x0, y0, x1, y1], dim=-1))
    keep = (boxes[..., 2] > min_box_size) & (boxes[..., 3] > min_box_size)
    return images, boxes, valid & keep


def apply_hflip(images, boxes, flip):
    """Mirror the images with flip[B] set, and their boxes' centres."""
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    cx = torch.where(flip[:, None], 1.0 - boxes[..., 0], boxes[..., 0])
    return images, torch.cat([cx[..., None], boxes[..., 1:]], dim=-1)


def apply_color_jitter(images, bright, contrast, sat):
    """Brightness, contrast about the mean gray, saturation toward each
    pixel's gray, then a clip to [0, 1]."""
    col = lambda f: f[:, None, None, None]
    luma = torch.tensor(LUMA, dtype=torch.float32, device=images.device)
    x = images * col(bright)
    gray = torch.einsum("bhwc,c->bhw", x, luma)[..., None]
    mean = gray.mean(dim=(1, 2, 3), keepdim=True)
    x = mean + (x - mean) * col(contrast)
    x = gray + (x - gray) * col(sat)
    return torch.clamp(x, 0.0, 1.0)


def apply_augment(x01: torch.Tensor, boxes: torch.Tensor,
                  valid: torch.Tensor, draws: Draws, cfg: AugmentConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The augmentations of `draws` (from `draw_augment`) in the JAX
    package's order: flip, zoom, colour."""
    if "flip" in draws:
        x01, boxes = apply_hflip(x01, boxes, draws["flip"])
    if "scale" in draws:
        x01, boxes, valid = apply_scale_translate(
            x01, boxes, valid, draws["scale"], draws["tx"], draws["ty"],
            cfg.min_box_size)
    if "bright" in draws:
        x01 = apply_color_jitter(x01, draws["bright"], draws["contrast"],
                                 draws["sat"])
    return x01, boxes, valid


def augment_batch(gen: Optional[torch.Generator], x01: torch.Tensor,
                  boxes: torch.Tensor, valid: torch.Tensor,
                  cfg: AugmentConfig):
    """Draw from `gen` and apply: (x01, boxes, valid) augmented."""
    b, h, w, _ = x01.shape
    draws = draw_augment(gen, cfg, b, h, w, x01.device)
    return apply_augment(x01, boxes, valid, draws, cfg)
