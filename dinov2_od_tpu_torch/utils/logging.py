"""Logging and TensorBoard (counterpart of dinov2_od_tpu/utils/logging.py),
the reference's observability surface (dino_detector/utils.py:279-384):
a timestamped file and console logger, a SummaryWriter under
<log_dir>/tensorboard/<timestamp>_<experiment> when TensorBoard is
installed (scalar logging is off without it), scalar and image helpers.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, Optional

import numpy as np


def setup_logger(
    save_dir: str, log_file: Optional[str] = "train.log", level=logging.INFO,
    prefix: str = "",
) -> logging.Logger:
    """The package's logger: to <save_dir>/<timestamp>_<log_file> and the
    console, or to the console alone when `log_file` is None (a rank
    other than 0 of a multi-process run); `prefix` starts each console
    line."""
    logger = logging.getLogger("dinov2_od_tpu_torch")
    logger.setLevel(level)
    logger.handlers.clear()

    log_path = None
    if log_file is not None:
        os.makedirs(save_dir, exist_ok=True)
        timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        log_path = os.path.join(save_dir, f"{timestamp}_{log_file}")
        fh = logging.FileHandler(log_path)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
        logger.addHandler(fh)

    ch = logging.StreamHandler()
    ch.setFormatter(logging.Formatter(
        f"{prefix}%(asctime)s - %(levelname)s - %(message)s"))
    logger.addHandler(ch)

    logger.info("Logging initialized: %s", log_path or "console only")
    return logger


def setup_tensorboard(save_dir: str, experiment_name: Optional[str] = None):
    """SummaryWriter under <save_dir>/tensorboard/<timestamp>[_<name>]
    (reference utils.py:317-341). Returns None if tensorboard is absent."""
    timestamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    sub = f"{timestamp}_{experiment_name}" if experiment_name else timestamp
    log_dir = os.path.join(save_dir, "tensorboard", sub)
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:  # noqa: BLE001
        logging.getLogger("dinov2_od_tpu_torch").warning(
            "tensorboard unavailable; scalar logging disabled"
        )
        return None
    writer = SummaryWriter(log_dir=log_dir)
    print(f"TensorBoard logs will be saved to: {log_dir}")
    return writer


def log_metrics(writer, metrics: Dict, global_step: int, prefix: str = ""):
    if writer is None:
        return
    for name, value in metrics.items():
        try:
            writer.add_scalar(f"{prefix}{name}", float(np.asarray(value)), global_step)
        except (TypeError, ValueError):
            continue


def draw_boxes(
    image: np.ndarray,
    boxes_cxcywh: np.ndarray,
    valid=None,
    color=(1.0, 0.0, 0.0),
    thickness: int = 2,
) -> np.ndarray:
    """Rasterize normalized cxcywh boxes onto an [H, W, 3] float image.

    The reference left bbox overlay as a TODO (utils.py:379-381); this
    implements it with pure numpy (no PIL round-trip in the train loop).
    """
    img = image.copy()
    h, w = img.shape[:2]
    boxes = np.asarray(boxes_cxcywh).reshape(-1, 4)
    if valid is None:
        valid = np.ones(len(boxes), bool)
    for box, ok in zip(boxes, np.asarray(valid).reshape(-1)):
        if not ok:
            continue
        cx, cy, bw, bh = box
        x0 = int(np.clip((cx - bw / 2) * w, 0, w - 1))
        x1 = int(np.clip((cx + bw / 2) * w, 0, w - 1))
        y0 = int(np.clip((cy - bh / 2) * h, 0, h - 1))
        y1 = int(np.clip((cy + bh / 2) * h, 0, h - 1))
        t = thickness
        img[y0 : y0 + t, x0 : x1 + 1] = color
        img[max(y1 - t + 1, 0) : y1 + 1, x0 : x1 + 1] = color
        img[y0 : y1 + 1, x0 : x0 + t] = color
        img[y0 : y1 + 1, max(x1 - t + 1, 0) : x1 + 1] = color
    return img


def log_images(
    writer,
    images: np.ndarray,
    global_step: int = 0,
    tag: str = "images",
    gt_boxes: np.ndarray = None,
    gt_valid: np.ndarray = None,
    pred_boxes: np.ndarray = None,
    pred_scores: np.ndarray = None,
    score_threshold: float = 0.5,
):
    """Log up to 8 images [B, H, W, 3], optionally with GT (red) and
    prediction (green) box overlays (reference utils.py:360-384; overlay
    was an unimplemented TODO there)."""
    if writer is None:
        return
    images = np.asarray(images, np.float32)
    if images.ndim != 4:
        writer.add_image(tag, images.transpose(2, 0, 1), global_step)
        return
    n = min(len(images), 8)
    drawn = []
    for i in range(n):
        img = images[i]
        # Undo normalization for display if values are outside [0, 1].
        if img.min() < -0.01 or img.max() > 1.01:
            lo, hi = img.min(), img.max()
            img = (img - lo) / max(hi - lo, 1e-6)
        if gt_boxes is not None:
            img = draw_boxes(
                img, gt_boxes[i],
                None if gt_valid is None else gt_valid[i],
                color=(1.0, 0.1, 0.1),
            )
        if pred_boxes is not None:
            keep = (
                np.asarray(pred_scores[i]) > score_threshold
                if pred_scores is not None
                else None
            )
            img = draw_boxes(img, pred_boxes[i], keep, color=(0.1, 1.0, 0.1))
        drawn.append(img)
    # SummaryWriter wants NCHW.
    writer.add_images(tag, np.stack(drawn).transpose(0, 3, 1, 2), global_step)
