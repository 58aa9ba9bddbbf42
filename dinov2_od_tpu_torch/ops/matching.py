"""Batched set-prediction matching (counterpart of
dinov2_od_tpu/ops/matching.py): the cost matrix on the device, then the
exact assignment on the host (ops/hungarian.py) or the auction on the
device (ops/auction.py), as `MatcherConfig.assignment` routes it.

Focal classification cost + L1 box cost + GIoU cost, optimally assigned
per image against the image's own predictions (the original PyTorch
matcher's batch-0 slicing bug is fixed unless `replicate_batch0_bug`).
Targets are padded to a fixed number of GT slots with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import MatcherConfig
from ..utils.profiling import annotate
from .auction import auction_assign
from .boxes import box_cxcywh_to_xyxy, generalized_box_iou
from .hungarian import hungarian_assign_batched

# Cost of padded GT slots and the clip of every real cost: it dominates
# any real cost (|real| <~ cost_bbox*4 + cost_giou*2 + cost_class*~20).
PAD_COST = 1e4

# Calls of each solver and the auction's rounds since the last reset, for
# callers that check which route the matcher took.
solver_stats = {"jv": 0, "auction": 0, "auction_rounds": 0}


def reset_solver_stats() -> None:
    for k in solver_stats:
        solver_stats[k] = 0


class MatchResult(NamedTuple):
    """query_of_gt [B, G] int64, -1 for invalid or unmatched slots;
    match_valid [B, G] bool, True where a valid slot got a query."""

    query_of_gt: torch.Tensor
    match_valid: torch.Tensor


def matching_cost_matrix(
    pred_logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    cfg: MatcherConfig,
) -> torch.Tensor:
    """Matching cost, batched over images.

    Args:
      pred_logits: [B, Q, C] raw class logits.
      pred_boxes: [B, Q, 4] cxcywh.
      gt_labels: [B, G] int labels (any value in padded slots).
      gt_boxes: [B, G, 4] cxcywh.
      gt_valid: [B, G] bool.

    Returns:
      [B, Q, G] fp32 cost, NaN replaced and clipped to +-PAD_COST; padded
      GT columns hold PAD_COST.
    """
    num_classes = pred_logits.shape[-1]
    prob = torch.sigmoid(pred_logits.float())
    alpha, gamma = cfg.focal_alpha, cfg.focal_gamma
    # (1 - prob) before the epsilon, as the JAX package and the original
    # matcher order it: log1p(-prob + 1e-8) would round the epsilon away
    # at prob == 1 in fp32 and give -inf.
    neg_cost = (1.0 - alpha) * (prob ** gamma) * (-torch.log((1.0 - prob)
                                                            + 1e-8))
    pos_cost = alpha * ((1.0 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    labels = gt_labels.long().clamp(0, num_classes - 1)
    idx = labels[:, None, :].expand(-1, prob.shape[1], -1)  # [B, Q, G]
    cost_class = (torch.gather(pos_cost, 2, idx)
                  - torch.gather(neg_cost, 2, idx))

    pb = pred_boxes.float()
    gb = gt_boxes.float()
    cost_bbox = (pb[:, :, None, :] - gb[:, None, :, :]).abs().sum(-1)
    cost_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pb),
                                     box_cxcywh_to_xyxy(gb))
    cost = (cfg.cost_class * cost_class + cfg.cost_bbox * cost_bbox
            + cfg.cost_giou * cost_giou)
    cost = torch.nan_to_num(cost, nan=PAD_COST).clamp(-PAD_COST, PAD_COST)
    return torch.where(gt_valid[:, None, :], cost,
                       torch.full_like(cost, PAD_COST))


@torch.no_grad()
def hungarian_match(
    pred_logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    cfg: MatcherConfig = MatcherConfig(),
) -> MatchResult:
    """Batched optimal matching; no gradient flows through it. The call is
    the `step.match` span of a profiled run (the train step's matcher
    phase, inside its `step.criterion`).

    Args:
      pred_logits: [B, Q, C]; pred_boxes: [B, Q, 4] cxcywh.
      gt_labels: [B, G]; gt_boxes: [B, G, 4]; gt_valid: [B, G] bool.
    """
    with annotate("step.match"):
        num_queries, num_gt = pred_logits.shape[1], gt_labels.shape[1]
        solver = cfg.assignment
        if solver == "auto":
            # Threshold on the padded GT count (the augmenting paths JV may
            # need), not max(Q, G): at sparse GT the exact solve is cheap.
            solver = "auction" if num_gt >= cfg.auction_threshold else "jv"
        if solver not in ("jv", "auction"):
            raise ValueError(f"unknown assignment {cfg.assignment!r}")
        if cfg.replicate_batch0_bug:
            # The original matcher sliced its batch-flattened cost matrix
            # C[:num_queries], i.e. image 0's rows, for every image.
            pred_logits = pred_logits[:1].expand_as(pred_logits)
            pred_boxes = pred_boxes[:1].expand_as(pred_boxes)
        cost = matching_cost_matrix(pred_logits, pred_boxes, gt_labels,
                                    gt_boxes, gt_valid, cfg)
        solver_stats[solver] += 1
        if solver == "auction":
            query_of_gt = _auction_match(cost, gt_valid, num_queries, num_gt)
        else:
            query_of_gt = hungarian_assign_batched(cost, gt_valid)
        return MatchResult(query_of_gt=query_of_gt,
                           match_valid=(query_of_gt >= 0) & gt_valid)


def auction_problem(cost_qg: torch.Tensor, gt_valid: torch.Tensor,
                    num_queries: int, num_gt: int):
    """The auction's problem from the matching cost [B, Q, G]: queries
    (all real) bid for GT-slot columns, the smaller, all-valid side
    bidding into spare columns keeps contention low (ops/auction.py).

    Returns (cost [B, Q, max(Q, G)], row_valid [B, Q], col_pad
    [B, max(Q, G)], scale_phases): `auction_assign`'s arguments."""
    b = cost_qg.shape[0]
    n = max(num_queries, num_gt)
    cost_qn = torch.full((b, num_queries, n), PAD_COST,
                         device=cost_qg.device, dtype=torch.float32)
    cost_qn[:, :, :num_gt] = cost_qg
    # Clip the padding to just above each image's real cost range: eps is
    # relative to the range, so pads left at PAD_COST would inflate the
    # slack ~100x. "Real" leaves out PAD_COST-substituted entries
    # (NaN-poisoned predictions), which would inflate it for every query.
    real = gt_valid[:, None, :] & (cost_qg < PAD_COST / 2)
    real_max = torch.where(real, cost_qg, -torch.inf).amax(dim=(1, 2))
    real_max = torch.where(torch.isfinite(real_max), real_max, 0.0)
    col_pad = torch.ones((b, n), dtype=torch.bool, device=cost_qg.device)
    col_pad[:, :num_gt] = ~gt_valid
    # Square with all rows valid has maximal contention; eps-scaling is
    # sound there. Q < G keeps the provable single phase.
    return (torch.minimum(cost_qn, real_max[:, None, None] + 1.0),
            torch.ones((b, num_queries), dtype=torch.bool,
                       device=cost_qg.device),
            col_pad, num_queries == n)


def _auction_match(cost_qg: torch.Tensor, gt_valid: torch.Tensor,
                   num_queries: int, num_gt: int) -> torch.Tensor:
    """query_of_gt [B, G] from the auction."""
    cost, row_valid, col_pad, square = auction_problem(
        cost_qg, gt_valid, num_queries, num_gt)
    query_of_col, rounds = auction_assign(cost, row_valid, col_pad,
                                          scale_phases=square)
    solver_stats["auction_rounds"] += rounds
    # A query parked on an invalid slot's column is no match.
    return torch.where(gt_valid, query_of_col[:, :num_gt], -1)
