"""The configuration's fine-tuning step in plain PyTorch, NumPy and SciPy:
forward in train mode, Hungarian matching, the DETR set loss, backward
through the decoder, the projection and the LoRA factors of the last
blocks, global-norm clipping, L2 weight decay and Adam.

Matching (DETR with the Deformable DETR focal cost): cost = w_class *
(focal cost of the GT class) + w_bbox * L1(cxcywh) - w_giou * GIoU,
solved exactly per image by `scipy.optimize.linear_sum_assignment`.
Loss: sigmoid focal loss over every (query, class) with matched queries
targeting their GT class, plus L1 and 1 - GIoU of matched pairs, each
summed and divided by the number of GT boxes. Optimizer (optax's chain):
clip the gradients' global norm to `gradient_clip_val`, add
`weight_decay * param`, then Adam (0.9, 0.999, eps 1e-8 outside the
square root) at `learning_rate`. The LoRA factors of the blocks below the
adapted ones get no gradient and no update.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from . import model as M

B1, B2, EPS = 0.9, 0.999, 1e-8
PAD_COST = 1e4


def xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def giou_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GIoU of every pair of xyxy boxes: [N, 4] x [M, 4] -> [N, M]."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = _area(a)[:, None] + _area(b)[None, :] - inter
    lt_c = torch.minimum(a[:, None, :2], b[None, :, :2])
    rb_c = torch.maximum(a[:, None, 2:], b[None, :, 2:])
    hull = (rb_c - lt_c).clamp(min=0).prod(-1)
    return inter / union - (hull - union) / hull


def giou_aligned(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GIoU of aligned pairs of xyxy boxes: [N, 4] x [N, 4] -> [N]."""
    lt = torch.maximum(a[:, :2], b[:, :2])
    rb = torch.minimum(a[:, 2:], b[:, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = _area(a) + _area(b) - inter
    hull = (torch.maximum(a[:, 2:], b[:, 2:])
            - torch.minimum(a[:, :2], b[:, :2])).clamp(min=0).prod(-1)
    return inter / union - (hull - union) / hull


def match(logits, boxes, labels, gt_boxes, valid, cfg: dict) -> np.ndarray:
    """query_of_gt [B, G] (-1 where no query), the minimum-cost
    assignment of each image's valid GT boxes to its queries."""
    mc = cfg["matcher"]
    a, g = mc["focal_alpha"], mc["focal_gamma"]
    out = np.full(tuple(labels.shape), -1, np.int64)
    with torch.no_grad():
        prob = torch.sigmoid(logits.float())
        neg = (1 - a) * prob ** g * -torch.log(1 - prob + 1e-8)
        pos = a * (1 - prob) ** g * -torch.log(prob + 1e-8)
        for i in range(labels.shape[0]):
            gts = torch.nonzero(valid[i]).flatten()
            if gts.numel() == 0:
                continue
            lab = labels[i, gts].long()
            cost = (mc["cost_class"] * (pos[i][:, lab] - neg[i][:, lab])
                    + mc["cost_bbox"] * torch.cdist(boxes[i].float(),
                                                    gt_boxes[i, gts].float(),
                                                    p=1)
                    - mc["cost_giou"] * giou_pairwise(
                        xyxy(boxes[i].float()), xyxy(gt_boxes[i, gts])))
            cost = torch.nan_to_num(cost, nan=PAD_COST).clamp(-PAD_COST,
                                                               PAD_COST)
            gt_idx, q_idx = linear_sum_assignment(cost.T.cpu().numpy())
            out[i, gts.cpu().numpy()[gt_idx]] = q_idx
    return out


def set_loss(logits, boxes, labels, gt_boxes, valid, query_of_gt,
             cfg: dict) -> torch.Tensor:
    lc = cfg["loss"]
    b, q, c = logits.shape
    n = valid.float().sum().clamp(min=1.0)
    qg = torch.as_tensor(query_of_gt, device=logits.device)
    matched = qg >= 0
    target = torch.zeros_like(logits)
    bi, gi = torch.nonzero(matched, as_tuple=True)
    target[bi, qg[bi, gi], labels[bi, gi].long()] = 1.0
    p = torch.sigmoid(logits)
    bce = torch.nn.functional.binary_cross_entropy_with_logits(
        logits, target, reduction="none")
    p_t = p * target + (1 - p) * (1 - target)
    a = lc["focal_alpha"]
    focal = ((a * target + (1 - a) * (1 - target))
             * (1 - p_t) ** lc["focal_gamma"] * bce).sum() / n
    src = boxes[bi, qg[bi, gi]]
    tgt = gt_boxes[bi, gi].float()
    l1 = (src - tgt).abs().sum() / n
    lg = (1 - giou_aligned(xyxy(src), xyxy(tgt))).sum() / n
    return lc["weight_ce"] * focal + lc["weight_bbox"] * l1 + \
        lc["weight_giou"] * lg


def trainable_paths(params, cfg: dict) -> List[tuple]:
    """The leaves fine-tuning moves: every decoder leaf, the backbone's
    projection and its LoRA factors."""
    out = []

    def walk(t, path):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif path[0] == "decoder" or "projection" in path or \
                    k in ("lora_A", "lora_B"):
                out.append(path + (k,))
    walk(params, ())
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _lora_mask(path, leaf, cfg: dict) -> Optional[torch.Tensor]:
    """1 on the adapted blocks' rows of a stacked LoRA leaf, 0 below."""
    if path[-1] not in ("lora_A", "lora_B"):
        return None
    m = torch.zeros((leaf.shape[0],) + (1,) * (leaf.dim() - 1),
                    device=leaf.device)
    m[cfg["num_hidden_layers"] - cfg["lora_last_n_blocks"]:] = 1.0
    return m


def train_steps(params, cfg: dict, batches: List[Dict[str, torch.Tensor]],
                dropout_seeds: List[int], prec: M.Precision,
                mean, std) -> dict:
    """Runs len(batches) steps from `params` (not changed; float32 copies
    of the trainable leaves are trained) and returns each step's loss,
    every trainable leaf's first gradient as Adam receives it (clipped,
    weight decay added) and its change over all the steps, as norms
    keyed by path, and each leaf's raw first gradient norm."""
    oc = cfg["optimizer"]
    paths = trainable_paths(params, cfg)
    # Fresh containers down every trainable path, float32 leaves.
    work = _copy_dicts(params)
    p0 = {}
    for path in paths:
        t = _get(params, path).detach().float().clone()
        p0[path] = t
        _set(work, path, t.clone().requires_grad_(True))
    mu = {p: torch.zeros_like(p0[p]) for p in paths}
    nu = {p: torch.zeros_like(p0[p]) for p in paths}
    losses, g1, g1_raw = [], {}, {}
    for step, (batch, seed) in enumerate(zip(batches, dropout_seeds)):
        gen = torch.Generator(device=batch["images"].device).manual_seed(seed)
        x = M.normalize(batch["images"], mean, std)
        out = M.detector(work, cfg, x, prec, generator=gen, grad_blocks=True)
        qg = match(out["pred_logits"], out["pred_boxes"], batch["labels"],
                   batch["boxes"], batch["valid"], cfg)
        loss = set_loss(out["pred_logits"], out["pred_boxes"],
                        batch["labels"], batch["boxes"], batch["valid"], qg,
                        cfg)
        leaves = [_get(work, p) for p in paths]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gs = []
            for p, leaf, g in zip(paths, leaves, grads):
                g = torch.zeros_like(leaf) if g is None else g
                m = _lora_mask(p, leaf, cfg)
                gs.append(g if m is None else g * m)
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in gs]))
            clip = oc["gradient_clip_val"]
            factor = 1.0 if float(norm) < clip else clip / float(norm)
            bc1 = 1.0 - B1 ** (step + 1)
            bc2 = 1.0 - B2 ** (step + 1)
            for p, leaf, g in zip(paths, leaves, gs):
                if step == 0:
                    g1_raw[p] = float(torch.linalg.vector_norm(g))
                g = g * factor + oc["weight_decay"] * leaf
                if step == 0:
                    g1[p] = float(torch.linalg.vector_norm(g))
                mu[p] = B1 * mu[p] + (1 - B1) * g
                nu[p] = B2 * nu[p] + (1 - B2) * g * g
                upd = -oc["learning_rate"] * (mu[p] / bc1) / (
                    torch.sqrt(nu[p] / bc2) + EPS)
                m = _lora_mask(p, leaf, cfg)
                leaf.add_(upd if m is None else upd * m)
        del out, loss, grads
    change = {p: float(torch.linalg.vector_norm(
        _get(work, p).detach() - p0[p])) for p in paths}
    return {"losses": losses, "grad1": g1, "grad1_raw": g1_raw,
            "change": change}


def _copy_dicts(tree):
    return {k: _copy_dicts(v) if isinstance(v, dict) else v
            for k, v in tree.items()}
