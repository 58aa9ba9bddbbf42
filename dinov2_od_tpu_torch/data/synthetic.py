"""Synthetic detection data: coloured rectangles on noise (the port's own
copy of `make_sample`, `make_batch` and `write_coco_dataset` from
dinov2_od_tpu/data/synthetic.py, with the same numpy generator calls, so
one seed gives the same arrays and the same files).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

# A small palette of distinguishable colours; label = palette index.
_PALETTE = np.array(
    [
        [220, 40, 40],
        [40, 200, 60],
        [50, 80, 230],
        [230, 210, 50],
        [180, 60, 200],
        [40, 210, 210],
    ],
    dtype=np.float32,
)

NUM_SYNTHETIC_CLASSES = len(_PALETTE)


def make_sample(
    rng: np.random.Generator,
    image_size: int = 224,
    max_objects: int = 4,
    min_objects: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One image with rectangles: image [H, W, 3] float32 in [0, 1], boxes
    [K, 4] normalised cxcywh, labels [K] int32 (palette index)."""
    h = w = image_size
    img = rng.uniform(0.0, 0.15, size=(h, w, 3)).astype(np.float32)
    k = int(rng.integers(min_objects, max_objects + 1))
    boxes, labels = [], []
    for _ in range(k):
        bw = rng.uniform(0.15, 0.45)
        bh = rng.uniform(0.15, 0.45)
        cx = rng.uniform(bw / 2, 1 - bw / 2)
        cy = rng.uniform(bh / 2, 1 - bh / 2)
        label = int(rng.integers(0, len(_PALETTE)))
        x0, x1 = int((cx - bw / 2) * w), int((cx + bw / 2) * w)
        y0, y1 = int((cy - bh / 2) * h), int((cy + bh / 2) * h)
        img[y0:y1, x0:x1] = _PALETTE[label] / 255.0
        boxes.append([cx, cy, bw, bh])
        labels.append(label)
    return img, np.asarray(boxes, np.float32), np.asarray(labels, np.int32)


def make_batch(
    rng: np.random.Generator,
    batch_size: int,
    image_size: int = 224,
    max_boxes: int = 8,
    max_objects: int = 4,
) -> Dict[str, np.ndarray]:
    """Padded, masked batch in the train step's format (numpy)."""
    images = np.zeros((batch_size, image_size, image_size, 3), np.float32)
    boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
    labels = np.zeros((batch_size, max_boxes), np.int32)
    valid = np.zeros((batch_size, max_boxes), bool)
    for i in range(batch_size):
        img, bx, lb = make_sample(rng, image_size, max_objects=max_objects)
        images[i] = img
        n = min(len(lb), max_boxes)
        boxes[i, :n] = bx[:n]
        labels[i, :n] = lb[:n]
        valid[i, :n] = True
    return {"images": images, "boxes": boxes, "labels": labels, "valid": valid}


def write_coco_dataset(
    out_dir: str,
    num_images: int = 16,
    image_size: int = 224,
    seed: int = 0,
    max_objects: int = 4,
    fmt: str = "png",
    quality: int = 90,
) -> Tuple[str, str]:
    """Write a COCO-format dataset (PNG or JPEG images + annotations JSON).

    Category ids are deliberately non-contiguous (10, 20, ...) to exercise
    the contiguous-label remapping the reference performs
    (dataset.py:35, :96-99).

    fmt="jpg" with image_size~640 approximates real COCO inputs (JPEG,
    640-class resolution); boxes are normalised, so any source size
    trains the same after the loader's resize. The same seed writes the
    same files as the JAX package's copy.

    Returns:
      (images_dir, annotation_file)
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    images_dir = os.path.join(out_dir, "images")
    os.makedirs(images_dir, exist_ok=True)

    coco = {
        "images": [],
        "annotations": [],
        "categories": [
            {"id": 10 * (i + 1), "name": f"color_{i}"}
            for i in range(len(_PALETTE))
        ],
    }
    ann_id = 1
    for img_id in range(1, num_images + 1):
        img, boxes, labels = make_sample(rng, image_size, max_objects=max_objects)
        ext = "jpg" if fmt in ("jpg", "jpeg") else "png"
        fname = f"{img_id:012d}.{ext}"
        pil_img = Image.fromarray((img * 255).astype(np.uint8))
        if ext == "jpg":
            pil_img.save(os.path.join(images_dir, fname), quality=quality)
        else:
            pil_img.save(os.path.join(images_dir, fname))
        coco["images"].append(
            {
                "id": img_id,
                "file_name": fname,
                "width": image_size,
                "height": image_size,
            }
        )
        for b, l in zip(boxes, labels):
            cx, cy, bw, bh = (float(v) for v in b)
            x = (cx - bw / 2) * image_size
            y = (cy - bh / 2) * image_size
            coco["annotations"].append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": 10 * (int(l) + 1),
                    "bbox": [x, y, bw * image_size, bh * image_size],
                    "area": bw * image_size * bh * image_size,
                    "iscrowd": 0,
                }
            )
            ann_id += 1

    ann_file = os.path.join(out_dir, "annotations.json")
    with open(ann_file, "w") as f:
        json.dump(coco, f)
    return images_dir, ann_file
