"""Box coordinate conversions and (G)IoU (counterpart of
dinov2_od_tpu/ops/boxes.py), for any leading batch dims and
differentiable. As in the JAX package, a zero union or enclosing area is
not guarded: degenerate boxes give the same inf or NaN there as here."""

from __future__ import annotations

from typing import Tuple

import torch


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2). Shape [..., 4]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h). Shape [..., 4]."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack(
        [(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], dim=-1
    )


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes. [..., 4] -> [...]."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IoU and union of every pair: [..., N, 4] x [..., M, 4] ->
    ([..., N, M], [..., N, M])."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    intersection = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - intersection
    return intersection / union, union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor
                        ) -> torch.Tensor:
    """Pairwise GIoU = IoU - (enclosing - union) / enclosing:
    [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    iou, union = pairwise_box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    enclosing = wh[..., 0] * wh[..., 1]
    return iou - (enclosing - union) / enclosing


def elementwise_generalized_box_iou(boxes1: torch.Tensor,
                                    boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU of aligned pairs, [..., 4] x [..., 4] -> [...]: the diagonal
    of `generalized_box_iou` without the N x N matrix."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    intersection = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - intersection
    iou = intersection / union
    lt_e = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_e = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_e = (rb_e - lt_e).clamp(min=0.0)
    enclosing = wh_e[..., 0] * wh_e[..., 1]
    return iou - (enclosing - union) / enclosing
