"""COCO mAP evaluation, bbox protocol, in numpy (counterpart of
dinov2_od_tpu/evaluation/coco_metrics.py).

The reference computes its metrics with pycocotools (dino_detector/
utils.py:243-276); this is the COCOeval bbox protocol without it:
- IoU thresholds 0.50:0.05:0.95, recall thresholds 0:0.01:1.00;
- area ranges all / small (< 32^2) / medium / large; maxDets 1/10/100;
- greedy per-detection matching in score order, crowd GT as ignore
  regions with IoU against the detection's area;
- the precision envelope and 101-point interpolation; AP is the mean
  over non-negative precisions; the twelve COCOeval.summarize stats.

The IoU + greedy matching inner loop runs in C++ (csrc/host/coco_eval.cc
through evaluation/native.py) when that library builds, as in the JAX
package; the numpy loop here is the reference implementation, the path
where it does not build, and the one `use_native=False` asks for. After
an evaluation `CocoEvaluator.matcher` says which one ran.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np

from . import native

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
AREA_KEYS = list(AREA_RNG)
MAX_DETS = (1, 10, 100)


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xywh boxes; crowd GT uses detection area as union
    (pycocotools maskUtils.iou semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(
        np.minimum(dx2[:, None], gx2[None, :])
        - np.maximum(dx1[:, None], gx1[None, :]),
        0,
        None,
    )
    ih = np.clip(
        np.minimum(dy2[:, None], gy2[None, :])
        - np.maximum(dy1[:, None], gy1[None, :]),
        0,
        None,
    )
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :], d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _greedy_match_from_ious(ious, dt_areas, gt_ig, gt_crowd, area_rng):
    """Greedy per-detection matching given a precomputed IoU table.

    `ious` columns must already be in sorted-GT order (non-ignored first);
    `gt_ig`/`gt_crowd` likewise.
    Returns (dtm [T, n_dt] matched-gt-index+1, dt_ignore [T, n_dt] bool).
    """
    t_count = len(IOU_THRS)
    n_d, n_g = ious.shape
    dtm = np.zeros((t_count, n_d), dtype=np.int64)
    gtm = np.zeros((t_count, n_g), dtype=np.int64)
    dt_ig = np.zeros((t_count, n_d), dtype=bool)

    for ti, thr in enumerate(IOU_THRS):
        for di in range(n_d):
            best_iou = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(n_g):
                if gtm[ti, gi] > 0 and not gt_crowd[gi]:
                    continue
                # Non-ignored candidates exhausted once we reach ignored GT
                # while already holding a non-ignored match.
                if m > -1 and not gt_ig[m] and gt_ig[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dt_ig[ti, di] = gt_ig[m]
            dtm[ti, di] = m + 1
            gtm[ti, m] = di + 1

    # Unmatched detections outside the area range are ignored.
    out_of_rng = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
    dt_ig = dt_ig | ((dtm == 0) & out_of_rng[None, :])
    return dtm, dt_ig


class CocoEvaluator:
    """COCO bbox evaluation against a ground-truth annotation file.

    Structured like pycocotools COCOeval at COCO scale: GT arrays are
    prepared once in __init__; per category, detections for all images go
    through one matching pass that computes each (image, category) IoU
    table once and reuses it across all 4 area ranges; the 3 maxDets are handled
    in accumulate by per-image column truncation. A naive
    (area x maxDet x image) loop re-does the IoU+matching work 12x — on
    val5k that is the difference between seconds and many minutes.

    use_native: None matches in C++ where the library builds, else in
    numpy; True asks for C++ (raising where it does not build); False for
    numpy. `matcher` is "native" or "numpy" after an evaluation.
    """

    def __init__(self, annotation_file: str,
                 use_native: Optional[bool] = None):
        self.use_native = use_native
        self.matcher: Optional[str] = None
        with open(annotation_file) as f:
            gt = json.load(f)
        self.cat_ids = [c["id"] for c in gt.get("categories", [])]
        self.img_ids = [im["id"] for im in gt.get("images", [])]
        by_img_cat = defaultdict(list)
        for ann in gt.get("annotations", []):
            if "bbox" not in ann:
                continue
            by_img_cat[(ann["image_id"], ann["category_id"])].append(ann)
        # Prepared per-(img, cat) GT arrays: (boxes [N,4], crowd [N], area [N]).
        self._gt_by_img_cat = {}
        for key, anns in by_img_cat.items():
            self._gt_by_img_cat[key] = (
                np.asarray([a["bbox"] for a in anns], np.float64).reshape(-1, 4),
                np.asarray([a.get("iscrowd", 0) for a in anns], np.int32),
                np.asarray(
                    [a.get("area", a["bbox"][2] * a["bbox"][3]) for a in anns],
                    np.float64,
                ),
            )

    _EMPTY_GT = (
        np.zeros((0, 4), np.float64),
        np.zeros(0, np.int32),
        np.zeros(0, np.float64),
    )

    def _match_category(self, cat_id, dt_by_img_cat, use_native: bool):
        """Match every image of one category across all area ranges.

        Returns None if the category has no GT and no detections, else
        (dt_scores [N] concatenated in img_ids order, score-desc per image,
         dt_rank [N] within-image rank,
         dtm [n_area, n_thr, N], dt_ig [n_area, n_thr, N],
         num_gt [n_area]).
        """
        md_cap = MAX_DETS[-1]
        imgs = [
            i for i in self.img_ids
            if (i, cat_id) in self._gt_by_img_cat or (i, cat_id) in dt_by_img_cat
        ]
        if not imgs:
            return None

        dt_boxes_l, dt_scores_l, gt_parts = [], [], []
        for img_id in imgs:
            dts = dt_by_img_cat.get((img_id, cat_id))
            if dts is None:
                boxes = np.zeros((0, 4), np.float64)
                scores = np.zeros(0, np.float64)
            elif isinstance(dts, tuple):
                # Array-native group (evaluate_arrays): already
                # (boxes [N,4], scores [N]) float64 views.
                boxes, scores = dts
            else:
                boxes = np.asarray(
                    [d["bbox"] for d in dts], np.float64
                ).reshape(-1, 4)
                scores = np.asarray([d["score"] for d in dts], np.float64)
            order = np.argsort(-scores, kind="stable")[:md_cap]
            dt_boxes_l.append(boxes[order])
            dt_scores_l.append(scores[order])
            gt_parts.append(self._gt_by_img_cat.get((img_id, cat_id), self._EMPTY_GT))

        dt_lens = np.asarray([len(b) for b in dt_boxes_l], np.int64)
        gt_lens = np.asarray([len(g[0]) for g in gt_parts], np.int64)
        dt_off = np.concatenate([[0], np.cumsum(dt_lens)])
        gt_off = np.concatenate([[0], np.cumsum(gt_lens)])
        dt_boxes = (
            np.concatenate(dt_boxes_l) if len(dt_boxes_l)
            else np.zeros((0, 4), np.float64)
        )
        dt_scores = np.concatenate(dt_scores_l) if dt_scores_l else np.zeros(0)
        gt_boxes = np.concatenate([g[0] for g in gt_parts])
        gt_crowd = np.concatenate([g[1] for g in gt_parts])
        gt_area = np.concatenate([g[2] for g in gt_parts])
        area_rngs = np.asarray([AREA_RNG[k] for k in AREA_KEYS], np.float64)

        if use_native:
            dtm, dt_ig, num_gt = native.match_category_native(
                dt_boxes, dt_off, gt_boxes, gt_crowd, gt_area, gt_off,
                IOU_THRS, area_rngs,
            )
        else:
            n_area, n_thr = len(AREA_KEYS), len(IOU_THRS)
            total_dt = int(dt_off[-1])
            dtm = np.zeros((n_area, n_thr, total_dt), np.int64)
            dt_ig = np.zeros((n_area, n_thr, total_dt), bool)
            num_gt = np.zeros(n_area, np.int64)
            for ii in range(len(imgs)):
                d0, d1 = int(dt_off[ii]), int(dt_off[ii + 1])
                g0, g1 = int(gt_off[ii]), int(gt_off[ii + 1])
                if d1 == d0 and g1 == g0:
                    continue
                crowd = gt_crowd[g0:g1].astype(bool)
                # IoU table once per image, reused by every area range.
                ious = bbox_iou_xywh(dt_boxes[d0:d1], gt_boxes[g0:g1], crowd)
                d_areas = dt_boxes[d0:d1, 2] * dt_boxes[d0:d1, 3]
                for ai, rng in enumerate(area_rngs):
                    ig = (
                        crowd
                        | (gt_area[g0:g1] < rng[0])
                        | (gt_area[g0:g1] > rng[1])
                    )
                    num_gt[ai] += int((~ig).sum())
                    g_order = np.argsort(ig, kind="stable")
                    m, i = _greedy_match_from_ious(
                        ious[:, g_order], d_areas, ig[g_order],
                        crowd[g_order], rng,
                    )
                    dtm[ai, :, d0:d1] = m
                    dt_ig[ai, :, d0:d1] = i

        rank = np.arange(len(dt_scores)) - np.repeat(dt_off[:-1], dt_lens)
        return dt_scores, rank, dtm, dt_ig, num_gt

    def evaluate(self, results: Sequence[dict]) -> Dict[str, float]:
        """Run the full protocol on detection result dicts
        ({image_id, category_id, bbox xywh, score})."""
        dt_by_img_cat = defaultdict(list)
        for r in results:
            dt_by_img_cat[(r["image_id"], r["category_id"])].append(r)
        return self._evaluate_grouped(dt_by_img_cat)

    def evaluate_arrays(
        self, image_ids, category_ids, boxes, scores
    ) -> Dict[str, float]:
        """Run the full protocol on flat detection arrays
        (image_ids [N], category_ids [N], boxes [N, 4] xywh, scores [N]
        — the output of postprocess.select_above_threshold). Identical
        result to evaluate() on the equivalent dicts, without building
        or re-parsing N python dicts: one lexsort groups detections into
        per-(image, category) array views."""
        image_ids = np.asarray(image_ids).astype(np.int64)
        category_ids = np.asarray(category_ids).astype(np.int64)
        boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
        scores = np.asarray(scores, np.float64)
        order = np.lexsort((image_ids, category_ids))
        ii, cc = image_ids[order], category_ids[order]
        b, s = boxes[order], scores[order]
        groups: Dict = {}
        if len(ii):
            cuts = np.flatnonzero((ii[1:] != ii[:-1]) | (cc[1:] != cc[:-1])) + 1
            starts = np.concatenate([[0], cuts])
            ends = np.concatenate([cuts, [len(ii)]])
            for st, en in zip(starts.tolist(), ends.tolist()):
                groups[(int(ii[st]), int(cc[st]))] = (b[st:en], s[st:en])
        return self._evaluate_grouped(groups)

    def _evaluate_grouped(self, dt_by_img_cat) -> Dict[str, float]:
        use_native = (native.available() if self.use_native is None
                      else self.use_native)
        self.matcher = "native" if use_native else "numpy"
        n_cat = len(self.cat_ids)
        n_area = len(AREA_KEYS)
        n_thr = len(IOU_THRS)
        n_rec = len(REC_THRS)
        n_md = len(MAX_DETS)

        precision = -np.ones((n_thr, n_rec, n_cat, n_area, n_md))
        recall = -np.ones((n_thr, n_cat, n_area, n_md))

        for ci, cat_id in enumerate(self.cat_ids):
            matched = self._match_category(cat_id, dt_by_img_cat, use_native)
            if matched is None:
                continue
            dt_scores, rank, dtm, dt_ig, num_gt = matched
            for mi, max_det in enumerate(MAX_DETS):
                keep = rank < max_det
                scores_k = dt_scores[keep]
                order = np.argsort(-scores_k, kind="mergesort")
                for ai in range(n_area):
                    if num_gt[ai] == 0:
                        continue
                    self._accumulate_cell(
                        dtm[ai][:, keep][:, order],
                        dt_ig[ai][:, keep][:, order],
                        int(num_gt[ai]),
                        precision, recall, ci, ai, mi,
                    )

        self.precision = precision
        self.recall = recall
        return self.summarize()

    @staticmethod
    def _accumulate_cell(dtm, dt_ig, num_gt, precision, recall, ci, ai, mi):
        """pycocotools COCOeval.accumulate for one (cat, area, maxDet).

        dtm/dt_ig: [n_thr, nd], columns sorted by global descending score.
        """
        tps = (dtm > 0) & ~dt_ig
        fps = (dtm == 0) & ~dt_ig
        tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_sum = np.cumsum(fps, axis=1).astype(np.float64)

        nd = tp_sum.shape[1]
        rc = tp_sum / num_gt
        pr = tp_sum / np.maximum(tp_sum + fp_sum, np.spacing(1))
        recall[:, ci, ai, mi] = rc[:, -1] if nd else 0.0

        if nd == 0:
            precision[:, :, ci, ai, mi] = 0.0
            return
        # Precision envelope (monotone non-increasing from the right),
        # then 101-point interpolation at the recall thresholds.
        env = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
        for ti in range(len(IOU_THRS)):
            inds = np.searchsorted(rc[ti], REC_THRS, side="left")
            q = np.zeros(len(REC_THRS))
            valid = inds < nd
            q[valid] = env[ti, inds[valid]]
            precision[ti, :, ci, ai, mi] = q

    def _summ(self, ap: bool, iou: Optional[float] = None,
              area: str = "all", max_det: int = 100) -> float:
        ai = AREA_KEYS.index(area)
        mi = MAX_DETS.index(max_det)
        if ap:
            s = self.precision[:, :, :, ai, mi]
            if iou is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
        else:
            s = self.recall[:, :, ai, mi]
            if iou is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou))[0]]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> Dict[str, float]:
        """All twelve COCOeval.summarize stats: the six AP stats the
        reference extracts (utils.py:267-274) plus the six AR stats
        (pycocotools cocoeval.py summarizeDets stats[6:12]) from the
        recall tensor evaluate() already accumulates."""
        return {
            "AP": self._summ(True),
            "AP50": self._summ(True, iou=0.5),
            "AP75": self._summ(True, iou=0.75),
            "APs": self._summ(True, area="small"),
            "APm": self._summ(True, area="medium"),
            "APl": self._summ(True, area="large"),
            "AR1": self._summ(False, max_det=1),
            "AR10": self._summ(False, max_det=10),
            "AR100": self._summ(False),
            "ARs": self._summ(False, area="small"),
            "ARm": self._summ(False, area="medium"),
            "ARl": self._summ(False, area="large"),
        }


def compute_coco_metrics(
    results: Sequence[dict], annotation_file: str
) -> Dict[str, float]:
    """Drop-in equivalent of the reference compute_coco_metrics
    (utils.py:243-276)."""
    return CocoEvaluator(annotation_file).evaluate(results)
