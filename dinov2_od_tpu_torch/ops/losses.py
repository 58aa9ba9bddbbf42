"""Set-prediction losses: focal classification + L1 + GIoU on matched
pairs (counterpart of dinov2_od_tpu/ops/losses.py).

Targets are padded to fixed GT slots with a validity mask; the match is a
[B, G] query-per-GT map. Every sum is normalised by the number of valid
GT boxes, clamped to >= 1; under a mesh that number is summed over the
data group first, so it counts the global batch as the JAX package's
does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..config import LossConfig, MatcherConfig
from ..parallel.collectives import all_reduce
from .boxes import box_cxcywh_to_xyxy, elementwise_generalized_box_iou
from .matching import MatchResult, hungarian_match


def sigmoid_focal_bce(logits: torch.Tensor, targets_onehot: torch.Tensor,
                      alpha: float, gamma: float) -> torch.Tensor:
    """Elementwise alpha_t * (1 - p_t)^gamma * BCE(logits, targets)."""
    logits = logits.float()
    prob = torch.sigmoid(logits)
    bce = (logits.clamp(min=0.0) - logits * targets_onehot
           + torch.log1p(torch.exp(-logits.abs())))
    p_t = prob * targets_onehot + (1.0 - prob) * (1.0 - targets_onehot)
    focal_weight = (1.0 - p_t) ** gamma
    alpha_weight = (alpha * targets_onehot
                    + (1.0 - alpha) * (1.0 - targets_onehot))
    return alpha_weight * focal_weight * bce


def loss_labels(pred_logits: torch.Tensor, gt_labels: torch.Tensor,
                match: MatchResult, num_boxes: torch.Tensor,
                num_classes: int, alpha: float = 0.25,
                gamma: float = 2.0) -> torch.Tensor:
    """Focal classification loss over all queries: unmatched queries
    target the all-zero "no object" row, matched ones their GT label."""
    b, q, _ = pred_logits.shape
    # Unmatched GT slots scatter into a trash column q, sliced off.
    query_of_gt = match.query_of_gt.long()
    scatter_q = torch.where(match.match_valid, query_of_gt,
                            torch.full_like(query_of_gt, q))
    padded = torch.full((b, q + 1), num_classes, dtype=torch.long,
                        device=pred_logits.device)
    padded.scatter_(1, scatter_q, gt_labels.long())
    onehot = F.one_hot(padded[:, :q], num_classes + 1)[..., :num_classes]
    loss = sigmoid_focal_bce(pred_logits, onehot.float(), alpha, gamma)
    return loss.sum() / num_boxes


def loss_boxes(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor,
               match: MatchResult,
               num_boxes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """L1 and 1 - GIoU over matched (query, GT) pairs."""
    gather_q = match.query_of_gt.long().clamp(0, pred_boxes.shape[1] - 1)
    src = torch.gather(pred_boxes, 1,
                       gather_q[..., None].expand(-1, -1, 4))  # [B, G, 4]
    mask = match.match_valid.float()
    l1 = (src - gt_boxes).abs().sum(-1) * mask
    giou = elementwise_generalized_box_iou(box_cxcywh_to_xyxy(src),
                                           box_cxcywh_to_xyxy(gt_boxes))
    # Mask before summing so padded slots contribute exactly 0.
    return {"loss_bbox": l1.sum() / num_boxes,
            "loss_giou": ((1.0 - giou) * mask).sum() / num_boxes}


def set_criterion(
    pred_logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    matcher_cfg: MatcherConfig = MatcherConfig(),
    loss_cfg: LossConfig = LossConfig(),
    num_classes: int = 91,
    match: Optional[MatchResult] = None,
    return_match: bool = False,
    mesh=None,
):
    """Match (unless `match` is given), then the weighted losses.

    Under `mesh` the batch is this rank's slice and the losses are its
    share of the global batch's (its sums over the global box count).

    Returns a dict of 'loss_ce', 'loss_bbox', 'loss_giou' (weighted),
    their '*_unweighted' values, 'num_boxes' and 'loss' (the weighted
    sum); (dict, MatchResult) when return_match."""
    if match is None:
        match = hungarian_match(pred_logits, pred_boxes, gt_labels, gt_boxes,
                                gt_valid, matcher_cfg)
    num_boxes = gt_valid.float().sum()
    if mesh is not None and mesh.data_size > 1:
        num_boxes = all_reduce(num_boxes, mesh.data_group, mesh.backend)
    num_boxes = num_boxes.clamp(min=1.0)
    ce = loss_labels(pred_logits, gt_labels, match, num_boxes, num_classes,
                     loss_cfg.focal_alpha, loss_cfg.focal_gamma)
    box = loss_boxes(pred_boxes, gt_boxes, match, num_boxes)
    out = {
        "loss_ce": loss_cfg.weight_ce * ce,
        "loss_bbox": loss_cfg.weight_bbox * box["loss_bbox"],
        "loss_giou": loss_cfg.weight_giou * box["loss_giou"],
        "loss_ce_unweighted": ce,
        "loss_bbox_unweighted": box["loss_bbox"],
        "loss_giou_unweighted": box["loss_giou"],
        "num_boxes": num_boxes,
    }
    out["loss"] = out["loss_ce"] + out["loss_bbox"] + out["loss_giou"]
    if return_match:
        return out, match
    return out
