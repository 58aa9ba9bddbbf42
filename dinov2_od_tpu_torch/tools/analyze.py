"""Result analysis and visualization (counterpart of
dinov2_od_tpu/tools/analyze.py).

    python -m dinov2_od_tpu_torch.tools.analyze \
        --metrics_file outputs/metrics_epoch_49.json \
        --predictions_file outputs/predictions_epoch_49.json \
        --val_images D/images --annotations D/annotations.json
    python -m dinov2_od_tpu_torch.tools.analyze --run_eval \
        --checkpoint outputs/final_model --val_images ... \
        --val_annotations ... [--device cpu]

Capability-equivalent of the reference's standalone analyze_results.py:
the metrics table and a bar chart, prediction statistics with a
confidence histogram and the class distribution, per-image bounding-box
visualizations, and a --run_eval passthrough that runs the port's
training CLI's evaluation in process (on `--device`, the CLI's default
cuda unless given). Class names resolve from the ground-truth
annotations when given (the reference hardcodes an 80-class COCO map,
which mislabels contiguous-id predictions; that map is the fallback only
for bare COCO results). matplotlib and Pillow are imported only where a
chart or a visualization is drawn; without matplotlib the tables still
print.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter, defaultdict
from typing import Dict, List, Optional

import numpy as np

COCO_CLASSES = {
    1: "person", 2: "bicycle", 3: "car", 4: "motorcycle", 5: "airplane",
    6: "bus", 7: "train", 8: "truck", 9: "boat", 10: "traffic light",
    11: "fire hydrant", 12: "stop sign", 13: "parking meter", 14: "bench",
    15: "bird", 16: "cat", 17: "dog", 18: "horse", 19: "sheep", 20: "cow",
    21: "elephant", 22: "bear", 23: "zebra", 24: "giraffe", 25: "backpack",
    26: "umbrella", 27: "handbag", 28: "tie", 29: "suitcase", 30: "frisbee",
    31: "skis", 32: "snowboard", 33: "sports ball", 34: "kite",
    35: "baseball bat", 36: "baseball glove", 37: "skateboard",
    38: "surfboard", 39: "tennis racket", 40: "bottle", 41: "wine glass",
    42: "cup", 43: "fork", 44: "knife", 45: "spoon", 46: "bowl",
    47: "banana", 48: "apple", 49: "sandwich", 50: "orange", 51: "broccoli",
    52: "carrot", 53: "hot dog", 54: "pizza", 55: "donut", 56: "cake",
    57: "chair", 58: "couch", 59: "potted plant", 60: "bed",
    61: "dining table", 62: "toilet", 63: "tv", 64: "laptop", 65: "mouse",
    66: "remote", 67: "keyboard", 68: "cell phone", 69: "microwave",
    70: "oven", 71: "toaster", 72: "sink", 73: "refrigerator", 74: "book",
    75: "clock", 76: "vase", 77: "scissors", 78: "teddy bear",
    79: "hair drier", 80: "toothbrush",
}


def _class_names(annotation_file: Optional[str]) -> Dict[int, str]:
    if annotation_file and os.path.exists(annotation_file):
        with open(annotation_file) as f:
            cats = json.load(f).get("categories", [])
        return {c["id"]: c.get("name", str(c["id"])) for c in cats}
    return COCO_CLASSES


def analyze_metrics(metrics_file: str) -> Optional[Dict[str, float]]:
    """Print the metrics table and save a bar chart next to the file."""
    try:
        with open(metrics_file) as f:
            metrics = json.load(f)
    except Exception as e:  # noqa: BLE001
        print(f"Error loading metrics file: {e}", file=sys.stderr)
        return None

    print("\n===== MODEL PERFORMANCE METRICS =====")
    stat_descs = (
        ("AP", "Average Precision"), ("AP50", "AP at IoU=0.5"),
        ("AP75", "AP at IoU=0.75"), ("APs", "AP small"),
        ("APm", "AP medium"), ("APl", "AP large"),
        ("AR1", "Average Recall, 1 det"), ("AR10", "AR, 10 dets"),
        ("AR100", "AR, 100 dets"), ("ARs", "AR small"),
        ("ARm", "AR medium"), ("ARl", "AR large"),
    )
    for key, desc in stat_descs:
        # AR stats absent in metrics files written before round 5.
        if key.startswith("AR") and key not in metrics:
            continue
        print(f"{key} ({desc}): {metrics.get(key, float('nan')):.4f}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        keys = ["AP", "AP50", "AP75", "APs", "APm", "APl"]
        vals = [max(metrics.get(k, 0.0), 0.0) for k in keys]
        plt.figure(figsize=(10, 6))
        plt.bar(keys, vals)
        plt.ylim(0, 1.0)
        plt.ylabel("Score")
        plt.title("COCO Evaluation Metrics")
        for i, v in enumerate(vals):
            plt.text(i, v + 0.02, f"{v:.3f}", ha="center")
        out = os.path.join(os.path.dirname(metrics_file) or ".", "metrics_chart.png")
        plt.savefig(out)
        plt.close()
        print(f"\nMetrics chart saved to: {out}")
    except Exception as e:  # noqa: BLE001
        print(f"(chart skipped: {e})", file=sys.stderr)
    return metrics


def prediction_stats(predictions: List[dict], out_dir: str,
                     names: Dict[int, str]) -> None:
    """Prediction statistics + confidence histogram + class distribution."""
    print("\n===== PREDICTION STATISTICS =====")
    print(f"Total predictions: {len(predictions)}")
    by_image = defaultdict(list)
    for p in predictions:
        by_image[p["image_id"]].append(p)
    print(f"Number of images with predictions: {len(by_image)}")
    if not predictions:
        return
    per_img = [len(v) for v in by_image.values()]
    confs = [p["score"] for p in predictions]
    print(f"Average predictions per image: {np.mean(per_img):.1f}")
    print(f"Mean confidence score: {np.mean(confs):.4f}")
    print(f"Median confidence score: {np.median(confs):.4f}")

    counts = Counter(p["category_id"] for p in predictions)
    print("\nTop-20 predicted classes:")
    for cat_id, n in counts.most_common(20):
        print(f"  {names.get(cat_id, str(cat_id))}: {n}")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(10, 6))
        plt.hist(confs, bins=20, alpha=0.7)
        plt.xlabel("Confidence Score"); plt.ylabel("Count")
        plt.title("Distribution of Prediction Confidence Scores")
        plt.savefig(os.path.join(out_dir, "confidence_histogram.png"))
        plt.close()

        top = counts.most_common(20)
        plt.figure(figsize=(12, 6))
        plt.bar([names.get(c, str(c)) for c, _ in top], [n for _, n in top])
        plt.xticks(rotation=75, ha="right")
        plt.ylabel("Count"); plt.title("Top-20 Predicted Classes")
        plt.tight_layout()
        plt.savefig(os.path.join(out_dir, "class_distribution.png"))
        plt.close()
    except Exception as e:  # noqa: BLE001
        print(f"(plots skipped: {e})", file=sys.stderr)


def visualize_predictions(
    predictions_file: str,
    images_dir: str,
    num_samples: int = 5,
    score_threshold: float = 0.5,
    annotation_file: Optional[str] = None,
    seed: int = 0,
) -> None:
    """Draw predicted boxes on sample images -> viz_<image_id>.png."""
    with open(predictions_file) as f:
        predictions = json.load(f)
    out_dir = os.path.dirname(predictions_file) or "."
    names = _class_names(annotation_file)
    prediction_stats(predictions, out_dir, names)

    by_image = defaultdict(list)
    for p in predictions:
        if p["score"] >= score_threshold:
            by_image[p["image_id"]].append(p)
    if not by_image or not images_dir:
        return

    # File-name lookup: COCO zero-padded stems or annotation file names.
    file_by_id = {}
    if annotation_file and os.path.exists(annotation_file):
        with open(annotation_file) as f:
            for im in json.load(f).get("images", []):
                file_by_id[im["id"]] = im["file_name"]

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt
    from PIL import Image

    rng = np.random.default_rng(seed)
    ids = list(by_image)
    rng.shuffle(ids)
    for img_id in ids[:num_samples]:
        fname = file_by_id.get(img_id, f"{img_id:012d}.jpg")
        path = os.path.join(images_dir, fname)
        if not os.path.exists(path):
            for ext in (".png", ".jpeg", ".jpg"):
                alt = os.path.join(images_dir, f"{img_id:012d}{ext}")
                if os.path.exists(alt):
                    path = alt
                    break
            else:
                continue
        img = Image.open(path).convert("RGB")
        fig, ax = plt.subplots(1, figsize=(10, 10))
        ax.imshow(img)
        for p in by_image[img_id]:
            x, y, w, h = p["bbox"]
            ax.add_patch(
                patches.Rectangle((x, y), w, h, linewidth=2,
                                  edgecolor="red", facecolor="none")
            )
            ax.text(
                x, max(y - 4, 0),
                f"{names.get(p['category_id'], p['category_id'])} "
                f"{p['score']:.2f}",
                color="white", fontsize=9,
                bbox={"facecolor": "red", "alpha": 0.7, "pad": 1},
            )
        ax.axis("off")
        out = os.path.join(out_dir, f"viz_{img_id}.png")
        plt.savefig(out, bbox_inches="tight")
        plt.close(fig)
        print(f"saved {out}")


def run_evaluation(args) -> int:
    """--run_eval passthrough to the port's training CLI (the reference's
    analyze_results.py shells out via subprocess; this calls in
    process)."""
    from ..train.cli import main as train_main

    cli = ["--only_evaluate", "--output_dir", args.output_dir]
    if args.val_images:
        cli += ["--val_images", args.val_images,
                "--val_annotations", args.val_annotations]
    if args.test_images:
        cli += ["--testdev_images", args.test_images]
    if args.checkpoint:
        cli += ["--checkpoint", args.checkpoint]
    if args.lightweight:
        cli += ["--lightweight"]
    if args.device:
        cli += ["--device", args.device]
    return train_main(cli)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Analyze COCO detection results")
    p.add_argument("--metrics_file", type=str, default="")
    p.add_argument("--predictions_file", type=str, default="")
    p.add_argument("--test_images", type=str, default="")
    p.add_argument("--val_images", type=str, default="")
    p.add_argument("--val_annotations", type=str, default="")
    p.add_argument("--annotations", type=str, default="",
                   help="GT annotations for class names / file names")
    p.add_argument("--num_samples", type=int, default=5)
    p.add_argument("--score_threshold", type=float, default=0.5)
    p.add_argument("--run_eval", action="store_true")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--lightweight", action="store_true")
    p.add_argument("--device", type=str, default="",
                   help="--run_eval: the training CLI's --device (its "
                        "default, cuda, when not given)")
    args = p.parse_args(argv)

    if args.run_eval:
        rc = run_evaluation(args)
        if rc != 0:
            return rc
    if args.metrics_file:
        analyze_metrics(args.metrics_file)
    if args.predictions_file:
        visualize_predictions(
            args.predictions_file,
            args.test_images or args.val_images,
            args.num_samples,
            args.score_threshold,
            args.annotations or args.val_annotations,
        )
    if not (args.run_eval or args.metrics_file or args.predictions_file):
        p.error("nothing to do: pass --metrics_file, --predictions_file, or --run_eval")
    return 0


if __name__ == "__main__":
    sys.exit(main())
