"""Detection post-processing (counterpart of
dinov2_od_tpu/evaluation/postprocess.py).

The selection (sigmoid, top-k over all (query, class) pairs, box
conversion and rescaling) runs on the device; the host only formats the
compact top-k result. Boxes are rescaled to original pixels and class 0
is kept unless `parity_mode` reproduces the reference's behaviour.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops.boxes import box_cxcywh_to_xyxy


def select_topk_detections(
    pred_logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    orig_sizes: torch.Tensor,
    max_detections: int = 100,
    parity_mode: bool = False,
):
    """Top-k detections over all (query, class) pairs, per image.

    Args:
      pred_logits: [B, Q, C]; pred_boxes: [B, Q, 4] cxcywh in [0, 1].
      orig_sizes: [B, 2] (height, width) original pixel sizes.

    Returns:
      scores [B, K], labels [B, K] (contiguous, int64), boxes_xywh
      [B, K, 4] (COCO xywh; original pixels unless parity_mode).
    """
    b, q, c = pred_logits.shape
    scores_all = torch.sigmoid(pred_logits.float())
    if parity_mode:
        scores_all = scores_all.clone()
        scores_all[:, :, 0] = -1.0
    flat = scores_all.reshape(b, q * c)
    k = min(max_detections, q * c)
    top_scores, top_idx = torch.topk(flat, k, dim=1)
    top_query = top_idx // c
    top_label = top_idx % c

    boxes_xyxy = box_cxcywh_to_xyxy(pred_boxes.float())
    sel = torch.gather(boxes_xyxy, 1, top_query[..., None].expand(b, k, 4))
    if not parity_mode:
        hw = orig_sizes.float()  # [B, 2] (h, w)
        scale = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], dim=-1)
        sel = sel * scale[:, None, :]
    xywh = torch.cat([sel[..., :2], sel[..., 2:] - sel[..., :2]], dim=-1)
    return top_scores, top_label, xywh


def format_detections(
    scores,
    labels,
    boxes,
    image_ids,
    label_to_cat_id: Dict[int, int],
    score_threshold: float = 0.05,
    parity_mode: bool = False,
) -> List[dict]:
    """Host-side formatting of selected top-k detections ([B, K] scores
    and labels, [B, K, 4] xywh boxes) into COCO result dicts."""
    ids, cats, bx, s = select_above_threshold(
        scores, labels, boxes, image_ids, label_to_cat_id,
        score_threshold=score_threshold, parity_mode=parity_mode,
    )
    return [
        {"image_id": ii, "category_id": cc, "bbox": bb, "score": ss}
        for ii, cc, bb, ss in zip(
            ids.tolist(), cats.tolist(), bx.tolist(), s.tolist()
        )
    ]


def select_above_threshold(
    scores,
    labels,
    boxes,
    image_ids,
    label_to_cat_id: Dict[int, int],
    score_threshold: float = 0.05,
    parity_mode: bool = False,
):
    """The selection format_detections applies, as flat numpy arrays:
    (image_ids [N], category_ids [N], boxes [N, 4] xywh, scores [N])."""
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    boxes = np.asarray(boxes)
    img_ids = np.asarray(image_ids)

    keep = scores > score_threshold
    ids = np.broadcast_to(img_ids.reshape(-1, 1), scores.shape)[keep]
    s = scores[keep]
    lab = labels[keep].astype(np.int64)
    bx = boxes[keep]
    if parity_mode or not label_to_cat_id:
        cats = lab  # the contiguous index
    else:
        hi = int(max(lab.max(initial=0), max(label_to_cat_id))) + 1
        lut = np.arange(hi, dtype=np.int64)  # identity for unknown labels
        for k, v in label_to_cat_id.items():
            if 0 <= k < hi:
                lut[k] = v
        cats = lut[np.clip(lab, 0, hi - 1)]
    return ids, cats, bx, s


def postprocess_detections(
    pred_logits,
    pred_boxes,
    image_ids,
    orig_sizes,
    label_to_cat_id: Dict[int, int],
    score_threshold: float = 0.05,
    max_detections: int = 100,
    parity_mode: bool = False,
) -> List[dict]:
    """A batch of raw outputs (tensors or numpy arrays, [B, Q, C] logits,
    [B, Q, 4] boxes, [B, 2] sizes) as COCO result dicts; the top-k on the
    logits' device. score_threshold is the reference's 0.05. The eval
    loop's path fuses the top-k into the step instead
    (train/step.py `make_eval_topk_step`)."""
    scores, labels, boxes = select_topk_detections(
        torch.as_tensor(pred_logits), torch.as_tensor(pred_boxes),
        torch.as_tensor(orig_sizes), max_detections=max_detections,
        parity_mode=parity_mode)
    return format_detections(
        scores.cpu().numpy(), labels.cpu().numpy(), boxes.cpu().numpy(),
        image_ids, label_to_cat_id, score_threshold=score_threshold,
        parity_mode=parity_mode)
