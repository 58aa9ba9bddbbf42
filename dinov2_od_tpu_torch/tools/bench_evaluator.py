"""CocoEvaluator at COCO val5k scale on synthetic predictions
(counterpart of tools/bench_evaluator.py).

A full evaluation of 5,000 images x 80 classes with 100 detections an
image (500k detections; `synth` draws the JAX tool's GT and detections
from the same seed) should take seconds of host time. This times the
port's `CocoEvaluator`: its init (JSON parse and GT preparation) and
`evaluate`, with the C++ matcher (csrc/host/coco_eval.cc) and with the
numpy one, and checks the two give the same twelve metrics.

    python -m dinov2_od_tpu_torch.tools.bench_evaluator [--images 5000]

The evaluator runs on the host (numpy and C++): the tool takes no
device. Prints the JAX tool's lines (sizes, init and evaluate seconds,
the metrics) per matcher, then one JSON line: images, gt, detections,
init_s, and evaluate_s and metrics by matcher, and whether the metrics
of the matchers are equal.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def synth(n_img=5000, n_cat=80, anns_per_img=7, dets_per_img=100, seed=0):
    """(GT dict, detection dicts): the JAX tool's draws, call for call."""
    rng = np.random.default_rng(seed)
    images = [{"id": i} for i in range(n_img)]
    cats = [{"id": c + 1, "name": f"c{c}"} for c in range(n_cat)]
    anns, dets = [], []
    aid = 0
    for i in range(n_img):
        n_gt = rng.poisson(anns_per_img)
        gt_boxes = []
        for _ in range(n_gt):
            x, y = rng.uniform(0, 500, 2)
            w, h = rng.uniform(4, 140, 2)
            c = int(rng.integers(1, n_cat + 1))
            aid += 1
            anns.append({
                "id": aid, "image_id": i, "category_id": c,
                "bbox": [x, y, w, h], "area": w * h,
                "iscrowd": int(rng.random() < 0.02),
            })
            gt_boxes.append((x, y, w, h, c))
        # Detections: 60% jittered GT (TP-ish), rest random (FP).
        for _ in range(dets_per_img):
            if gt_boxes and rng.random() < 0.6:
                x, y, w, h, c = gt_boxes[int(rng.integers(len(gt_boxes)))]
                j = rng.normal(0, 6, 4)
                bbox = [x + j[0], y + j[1], max(2, w + j[2]), max(2, h + j[3])]
            else:
                x, y = rng.uniform(0, 500, 2)
                w, h = rng.uniform(4, 140, 2)
                c = int(rng.integers(1, n_cat + 1))
                bbox = [x, y, w, h]
            dets.append({
                "image_id": i, "category_id": int(c),
                "bbox": [float(b) for b in bbox],
                "score": float(rng.random()),
            })
    return {"images": images, "annotations": anns, "categories": cats}, dets


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images", type=int, default=5000)
    return p.parse_args(argv)


def run(args, out=None) -> dict:
    from ..evaluation.coco_metrics import CocoEvaluator

    out = out or sys.stdout
    gt, dets = synth(n_img=args.images)
    print(f"synthetic: {len(gt['images'])} imgs, {len(gt['annotations'])} "
          f"GT, {len(dets)} detections", file=out, flush=True)
    rec = {"images": len(gt["images"]), "gt": len(gt["annotations"]),
           "detections": len(dets), "init_s": {}, "evaluate_s": {},
           "metrics": {}}
    fd, path = tempfile.mkstemp(suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(gt, f)
        for matcher in ("native", "numpy"):
            t0 = time.perf_counter()
            ev = CocoEvaluator(path, use_native=matcher == "native")
            t1 = time.perf_counter()
            metrics = ev.evaluate(dets)
            t2 = time.perf_counter()
            print(f"[{matcher}] init (JSON parse + GT prep): {t1 - t0:.2f}s",
                  file=out)
            print(f"[{matcher}] evaluate:                    {t2 - t1:.2f}s",
                  file=out)
            print(metrics, file=out, flush=True)
            rec["init_s"][matcher] = t1 - t0
            rec["evaluate_s"][matcher] = t2 - t1
            rec["metrics"][matcher] = metrics
    finally:
        os.unlink(path)
    rec["metrics_equal"] = len({json.dumps(m, sort_keys=True)
                                for m in rec["metrics"].values()}) == 1
    print(json.dumps(rec), file=out, flush=True)
    return rec


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
