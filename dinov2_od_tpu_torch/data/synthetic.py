"""Synthetic detection data: coloured rectangles on noise (the port's own
copy of `make_sample` and `make_batch` from dinov2_od_tpu/data/synthetic.py,
with the same numpy generator calls, so one seed gives the same arrays).
"""

from __future__ import annotations

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
