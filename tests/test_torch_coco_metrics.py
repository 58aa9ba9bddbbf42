"""The port's COCO evaluator (dinov2_od_tpu_torch/evaluation/coco_metrics.py,
numpy only) against the JAX package's `CocoEvaluator` on the scenes of
tests/test_coco_eval.py, a randomized scene of tests/test_coco_eval_fuzz.py
and a synthetic dataset's own annotations. Tolerance: every one of the
twelve summary stats equal within 1e-12 (the same float64 protocol; the
JAX evaluator may take its C matching kernel, the port its numpy loop).
"""

import json

import numpy as np
import pytest

from dinov2_od_tpu.data.synthetic import write_coco_dataset as jax_write
from dinov2_od_tpu.evaluation.coco_metrics import CocoEvaluator as JaxEvaluator

from dinov2_od_tpu_torch.evaluation.coco_metrics import (
    CocoEvaluator,
    bbox_iou_xywh,
    compute_coco_metrics,
)
from dinov2_od_tpu_torch.evaluation.postprocess import select_above_threshold

KEYS = ("AP", "AP50", "AP75", "APs", "APm", "APl",
        "AR1", "AR10", "AR100", "ARs", "ARm", "ARl")


def _ann(ann_id, img_id, cat_id, bbox, iscrowd=0):
    return {"id": ann_id, "image_id": img_id, "category_id": cat_id,
            "bbox": bbox, "area": bbox[2] * bbox[3], "iscrowd": iscrowd}


def _det(img_id, cat_id, bbox, score):
    return {"image_id": img_id, "category_id": cat_id, "bbox": bbox,
            "score": score}


ONE = [_ann(1, 1, 7, [100, 100, 50, 50])]
TWO_CATS = [{"id": 7, "name": "a"}, {"id": 9, "name": "b"}]
TIE = [_det(1, 7, [10, 10, 20, 20], 0.5), _det(1, 7, [400, 400, 20, 20], 0.5)]

# name: (annotations, results, images or None, categories or None)
SCENES = {
    "perfect": (ONE, [_det(1, 7, [100, 100, 50, 50], 0.9)], None, None),
    "no_detections": (ONE, [], None, None),
    "tp_then_fp": (ONE, [_det(1, 7, [100, 100, 50, 50], 0.9),
                         _det(1, 7, [300, 300, 50, 50], 0.8)], None, None),
    "fp_then_tp": (ONE, [_det(1, 7, [300, 300, 50, 50], 0.9),
                         _det(1, 7, [100, 100, 50, 50], 0.8)], None, None),
    "partial_iou": ([_ann(1, 1, 7, [0, 0, 10, 10])],
                    [_det(1, 7, [0, 0, 10, 6], 0.9)], None, None),
    "crowd_ignored": ([_ann(1, 1, 7, [100, 100, 50, 50]),
                       _ann(2, 1, 7, [300, 300, 100, 100], iscrowd=1)],
                      [_det(1, 7, [100, 100, 50, 50], 0.9),
                       _det(1, 7, [300, 300, 90, 90], 0.8)], None, None),
    "wrong_category": (ONE, [_det(1, 9, [100, 100, 50, 50], 0.9)], None,
                       TWO_CATS),
    "duplicate": (ONE, [_det(1, 7, [100, 100, 50, 50], 0.9),
                        _det(1, 7, [101, 101, 50, 50], 0.8)], None, None),
    "two_images_two_cats": ([_ann(1, 1, 7, [10, 10, 50, 50]),
                             _ann(2, 2, 9, [20, 20, 40, 40])],
                            [_det(1, 7, [10, 10, 50, 50], 0.9)],
                            [{"id": 1}, {"id": 2}], TWO_CATS),
    "maxdets": (ONE, [_det(1, 7, [300 + i, 300, 10, 10], 0.99 - i * 0.001)
                      for i in range(100)]
                + [_det(1, 7, [100, 100, 50, 50], 0.5)], None, None),
    "score_ties": ([_ann(1, 1, 7, [10, 10, 20, 20])], TIE, None, None),
    "score_ties_reversed": ([_ann(1, 1, 7, [10, 10, 20, 20])], TIE[::-1],
                            None, None),
    "area_boundary": ([_ann(1, 1, 7, [10, 10, 32, 32])],
                      [_det(1, 7, [10, 10, 32, 32], 0.9)], None, None),
    "crowd_absorbs": ([_ann(1, 1, 7, [10, 10, 100, 100], iscrowd=1),
                       _ann(2, 1, 7, [300, 300, 20, 20])],
                      [_det(1, 7, [300, 300, 20, 20], 0.9),
                       _det(1, 7, [12, 12, 50, 50], 0.8),
                       _det(1, 7, [40, 40, 60, 60], 0.7)], None, None),
    "out_of_area": ([_ann(1, 1, 7, [10, 10, 20, 20])],
                    [_det(1, 7, [10, 10, 20, 20], 0.9),
                     _det(1, 7, [300, 10, 150, 150], 0.95)], None, None),
    "maxdet_per_image": ([_ann(1, 1, 7, [10, 10, 20, 20]),
                          _ann(2, 2, 7, [10, 10, 20, 20])],
                         [_det(2, 7, [10, 10, 20, 20], 0.05)]
                         + [_det(1, 7, [400, 400, 5, 5], 0.9 - k * 0.001)
                            for k in range(150)]
                         + [_det(1, 7, [10, 10, 20, 20], 0.99)],
                         [{"id": 1}, {"id": 2}], None),
    "unknown_category": ([_ann(1, 1, 7, [10, 10, 20, 20])],
                         [_det(1, 7, [10, 10, 20, 20], 0.9),
                          _det(1, 99, [10, 10, 20, 20], 0.9)], None, None),
    "gt_sort": ([_ann(1, 1, 7, [10, 10, 200, 200]),
                 _ann(2, 1, 7, [500, 10, 20, 20])],
                [_det(1, 7, [10, 10, 200, 200], 0.9),
                 _det(1, 7, [500, 10, 20, 20], 0.8)], None, None),
}


def _write(tmp_path, annotations, images=None, categories=None):
    gt = {"images": images or [{"id": 1, "width": 640, "height": 480}],
          "annotations": annotations,
          "categories": categories or [{"id": 7, "name": "thing"}]}
    p = tmp_path / "gt.json"
    p.write_text(json.dumps(gt))
    return str(p)


def _assert_equal(got, want):
    assert set(got) == set(KEYS) == set(want)
    for k in KEYS:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_evaluator_matches_jax(tmp_path, scene):
    anns, results, images, cats = SCENES[scene]
    gt_file = _write(tmp_path, anns, images, cats)
    got = compute_coco_metrics(results, gt_file)
    _assert_equal(got, JaxEvaluator(gt_file).evaluate(results))
    if scene == "score_ties":  # insertion order decides a tie (mergesort)
        assert got["AP50"] == pytest.approx(1.0)
    if scene == "score_ties_reversed":
        assert got["AP50"] == pytest.approx(0.5)


def test_random_scene_and_arrays_match_jax(tmp_path):
    """A randomized scene (crowds, ties, empty categories, area edges):
    `evaluate` and `evaluate_arrays` equal JAX's, and the recall tensor
    too."""
    from test_coco_eval_fuzz import _random_scene

    gt, results = _random_scene(np.random.default_rng(123))
    ann = tmp_path / "gt.json"
    ann.write_text(json.dumps(gt))
    ref_ev = JaxEvaluator(str(ann))
    want = ref_ev.evaluate(results)
    ev = CocoEvaluator(str(ann))
    _assert_equal(ev.evaluate(results), want)
    np.testing.assert_array_equal(ev.recall, ref_ev.recall)
    np.testing.assert_array_equal(ev.precision, ref_ev.precision)
    ids = np.asarray([r["image_id"] for r in results])
    cats = np.asarray([r["category_id"] for r in results])
    boxes = np.asarray([r["bbox"] for r in results]).reshape(-1, 4)
    scores = np.asarray([r["score"] for r in results])
    _assert_equal(CocoEvaluator(str(ann)).evaluate_arrays(ids, cats, boxes,
                                                          scores), want)


def test_synthetic_dataset_end_to_end(tmp_path):
    """A synthetic dataset's own GT as detections: AP 1 in both; then
    jittered boxes and random scores through the array path, as the loop
    formats them (select_above_threshold)."""
    _, ann_file = jax_write(str(tmp_path), num_images=6, seed=3)
    with open(ann_file) as f:
        gt = json.load(f)
    res = [_det(a["image_id"], a["category_id"], a["bbox"], 0.95)
           for a in gt["annotations"]]
    got = compute_coco_metrics(res, ann_file)
    assert got["AP"] == 1.0 and got["AP50"] == 1.0
    _assert_equal(got, JaxEvaluator(ann_file).evaluate(res))

    rng = np.random.default_rng(0)
    boxes = np.asarray([a["bbox"] for a in gt["annotations"]])
    boxes = boxes + rng.normal(0, 6, boxes.shape)
    scores = rng.uniform(0.0, 1.0, len(boxes))
    labels = np.asarray([a["category_id"] // 10 - 1
                         for a in gt["annotations"]])
    ids = np.asarray([a["image_id"] for a in gt["annotations"]])
    lut = {i: 10 * (i + 1) for i in range(6)}
    # One detection a row, as [N, K=1] top-k arrays.
    flat = select_above_threshold(scores[:, None], labels[:, None],
                                  boxes[:, None], ids, lut,
                                  score_threshold=0.2)
    assert 0 < len(flat[0]) < len(ids)
    res = [_det(int(i), int(c), b.tolist(), float(s))
           for i, c, b, s in zip(*flat)]
    _assert_equal(CocoEvaluator(ann_file).evaluate_arrays(*flat),
                  JaxEvaluator(ann_file).evaluate(res))


def test_iou_xywh():
    dt = np.array([[0.0, 0.0, 10, 6]])
    gt = np.array([[0.0, 0.0, 10, 10]])
    np.testing.assert_allclose(bbox_iou_xywh(dt, gt, np.array([0])), [[0.6]])
    np.testing.assert_allclose(bbox_iou_xywh(dt, gt, np.array([1])), [[1.0]])
