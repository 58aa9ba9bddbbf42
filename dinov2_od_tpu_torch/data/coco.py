"""COCO dataset parsing with static-shape padded targets (counterpart of
dinov2_od_tpu/data/coco.py).

Semantics mirror the reference datasets (dino_detector/dataset.py):
- raw COCO JSON parsed directly (no pycocotools), image_id -> annotations;
- category_id remapped to a contiguous 0-based label in the order of the
  JSON `categories` list;
- boxes converted to normalised cxcywh; crowd, degenerate (w/h <= 0),
  tiny (< 0.001) and out-of-range-centre boxes dropped;
- the annotation-free test variant lists image files and takes ids from
  filename stems.

Per-image targets are padded to `max_boxes` with a validity mask. Images
are ImageNet-normalised by default (`normalize=False` for the reference's
behaviour); with `output_dtype="uint8"` the raw bytes go to the device
and the train step normalises there.

Decode backends, as in the JAX package:
- 'pil': the reference's pixels, a full Pillow load and a bilinear
  resize (parity runs use it);
- 'cv2': OpenCV's reduced-scale decode (IMREAD_REDUCED_*) and its
  bilinear resize; raises where cv2 does not import (JAX falls back to
  Pillow there, under the name cv2);
- 'auto' (the CLI's default, as in JAX; the dataset classes default to
  'pil'): resolved once a process, in JAX's order, to the
  native libjpeg decoder (data/native_decode.py) where it builds, else
  cv2 where it imports, else Pillow, and logged;
  `resolved_decode_backend()` names it. Under 'native' a file that is not
  a JPEG, or one the decoder rejects (CMYK, corrupt), is decoded with
  cv2 or Pillow instead.
The native and cv2 pixels are not Pillow's (another resampling).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, List, Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
DECODE_BACKENDS = ("auto", "cv2", "pil")

logger = logging.getLogger(__name__)
_resolve_lock = threading.Lock()
_resolved: Optional[str] = None
_cv2_module = None


def _cv2():
    """OpenCV at one thread a decode, or False where it does not import."""
    global _cv2_module
    if _cv2_module is None:
        try:
            import cv2

            # One decode per loader thread; intra-op threads fight the pool.
            cv2.setNumThreads(1)
            _cv2_module = cv2
        except ImportError:
            _cv2_module = False
    return _cv2_module


def resolved_decode_backend() -> str:
    """What 'auto' decodes with in this process: 'native' where the
    libjpeg decoder builds and loads, else 'cv2' where OpenCV imports,
    else 'pil'. Resolved on the first call and logged."""
    global _resolved
    with _resolve_lock:
        if _resolved is None:
            from . import native_decode

            try:
                native_decode.get_lib()
                _resolved = "native"
            except RuntimeError as e:
                lines = str(e).strip().splitlines()
                logger.warning("native JPEG decoder unavailable: %s", next(
                    (x for x in lines if "error" in x), lines[-1]))
                _resolved = "cv2" if _cv2() else "pil"
            logger.info("decode_backend 'auto' resolved to %r", _resolved)
        return _resolved


def resolve_decode_backend(backend: str) -> str:
    """The backend a dataset decodes with: 'native', 'cv2' or 'pil'."""
    if backend not in DECODE_BACKENDS:
        raise ValueError(f"decode_backend must be one of {DECODE_BACKENDS}; "
                         f"got {backend!r}")
    if backend == "auto":
        return resolved_decode_backend()
    if backend == "cv2" and not _cv2():
        raise ImportError("decode_backend='cv2' needs OpenCV (cv2), which "
                          "does not import here; use 'auto' or 'pil'")
    return backend


def decode_pil(path: str, image_size: int) -> np.ndarray:
    """Full Pillow load + bilinear resize: uint8 [S, S, 3]."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize(
            (image_size, image_size), Image.Resampling.BILINEAR
        )
        return np.asarray(im, np.uint8)


def decode_cv2(path: str, image_size: int) -> np.ndarray:
    """libjpeg's scaled decode through cv2's IMREAD_REDUCED flags (the
    largest power-of-two reduction that stays at or above the target),
    then cv2's bilinear resize: uint8 [S, S, 3] RGB. A file cv2 cannot
    decode goes to Pillow."""
    import io

    from PIL import Image

    cv2 = _cv2()
    with open(path, "rb") as f:
        buf = f.read()
    try:  # header-only size peek: a lazy open reads no pixel data
        with Image.open(io.BytesIO(buf)) as im:
            w, h = im.size
    except Exception:  # noqa: BLE001 - cv2 may still decode what PIL cannot
        w = h = image_size * 8
    factor = 1
    while factor < 8 and min(w, h) // (factor * 2) >= image_size:
        factor *= 2
    flags = {
        1: cv2.IMREAD_COLOR,
        2: cv2.IMREAD_REDUCED_COLOR_2,
        4: cv2.IMREAD_REDUCED_COLOR_4,
        8: cv2.IMREAD_REDUCED_COLOR_8,
    }
    arr = cv2.imdecode(np.frombuffer(buf, np.uint8), flags[factor])
    if arr is None:
        return decode_pil(path, image_size)
    code = cv2.COLOR_GRAY2RGB if arr.ndim == 2 else cv2.COLOR_BGR2RGB
    arr = cv2.cvtColor(arr, code)
    return cv2.resize(arr, (image_size, image_size),
                      interpolation=cv2.INTER_LINEAR)


def decode_native(path: str, image_size: int) -> np.ndarray:
    """The libjpeg decoder for a JPEG; a file that is not one, or that
    the decoder rejects, goes to cv2 where it imports, else Pillow."""
    if path.lower().endswith((".jpg", ".jpeg")):
        from . import native_decode

        out = native_decode.decode_one(path, image_size)
        if out is not None:
            return out
    if _cv2():
        return decode_cv2(path, image_size)
    return decode_pil(path, image_size)


_DECODERS = {"pil": decode_pil, "cv2": decode_cv2, "native": decode_native}


def decode_image(path: str, image_size: int, backend: str) -> np.ndarray:
    """uint8 [S, S, 3] RGB by a resolved backend ('native', 'cv2', 'pil')."""
    return _DECODERS[backend](path, image_size)


def _convert(image_u8: np.ndarray, output_dtype: str,
             normalize: bool) -> np.ndarray:
    if output_dtype == "uint8":
        return image_u8
    image = image_u8.astype(np.float32) / 255.0
    if normalize:
        image = (image - IMAGENET_MEAN) / IMAGENET_STD
    return image


class CocoDetectionDataset:
    """COCO images + annotations -> padded training examples."""

    def __init__(
        self,
        images_dir: str,
        annotation_file: str,
        image_size: int = 224,
        max_boxes: int = 100,
        normalize: bool = True,
        indices: Optional[List[int]] = None,
        output_dtype: str = "float32",
        decode_backend: str = "pil",
    ):
        self.backend = resolve_decode_backend(decode_backend)
        self.images_dir = images_dir
        self.coco_path = annotation_file
        self.image_size = image_size
        self.max_boxes = max_boxes
        self.normalize = normalize
        self.output_dtype = output_dtype
        self.decode_backend = decode_backend

        with open(annotation_file) as f:
            coco = json.load(f)
        self.images = {img["id"]: img for img in coco["images"]}
        self.annotations: Dict[int, list] = {}
        for ann in coco["annotations"]:
            self.annotations.setdefault(ann["image_id"], []).append(ann)
        self.image_ids = list(self.images.keys())
        if indices is not None:
            self.image_ids = [self.image_ids[i] for i in indices]
        self.cat_id_to_label = {
            cat["id"]: idx for idx, cat in enumerate(coco["categories"])
        }
        self.label_to_cat_id = {v: k for k, v in self.cat_id_to_label.items()}
        self.num_classes = len(self.cat_id_to_label)

    def __len__(self) -> int:
        return len(self.image_ids)

    def get_example(self, idx: int) -> Dict[str, np.ndarray]:
        img_id = self.image_ids[idx]
        info = self.images[img_id]
        image_u8 = decode_image(
            os.path.join(self.images_dir, info["file_name"]), self.image_size,
            self.backend)
        height = info.get("height") or image_u8.shape[0]
        width = info.get("width") or image_u8.shape[1]

        boxes, labels = [], []
        for ann in self.annotations.get(img_id, []):
            if "bbox" not in ann or ann.get("iscrowd", 0) != 0:
                continue
            x, y, w, h = ann["bbox"]
            if w <= 0 or h <= 0:
                continue
            cx = (x + w / 2) / width
            cy = (y + h / 2) / height
            nw, nh = w / width, h / height
            if nw < 0.001 or nh < 0.001 or not (0 < cx < 1 and 0 < cy < 1):
                continue
            boxes.append([cx, cy, nw, nh])
            labels.append(self.cat_id_to_label.get(ann["category_id"], 0))

        n = min(len(boxes), self.max_boxes)
        out_boxes = np.zeros((self.max_boxes, 4), np.float32)
        out_labels = np.zeros((self.max_boxes,), np.int32)
        out_valid = np.zeros((self.max_boxes,), bool)
        if n:
            out_boxes[:n] = np.asarray(boxes[:n], np.float32)
            out_labels[:n] = np.asarray(labels[:n], np.int32)
            out_valid[:n] = True

        return {
            "images": _convert(image_u8, self.output_dtype, self.normalize),
            "boxes": out_boxes,
            "labels": out_labels,
            "valid": out_valid,
            "image_id": np.int64(img_id),
            "orig_size": np.asarray([height, width], np.int32),
        }


class CocoTestDataset:
    """Annotation-free evaluation dataset (reference dataset.py:116-193)."""

    def __init__(
        self,
        images_dir: str,
        annotation_file: Optional[str] = None,
        image_size: int = 224,
        normalize: bool = True,
        indices: Optional[List[int]] = None,
        output_dtype: str = "float32",
        decode_backend: str = "pil",
    ):
        self.backend = resolve_decode_backend(decode_backend)
        self.images_dir = images_dir
        self.image_size = image_size
        self.normalize = normalize
        self.output_dtype = output_dtype
        self.decode_backend = decode_backend
        self.coco_path = (
            annotation_file
            if annotation_file and os.path.exists(annotation_file)
            else None
        )
        if self.coco_path:
            with open(self.coco_path) as f:
                coco = json.load(f)
            self.images = {img["id"]: img for img in coco["images"]}
            self.image_ids = list(self.images.keys())
            self.cat_id_to_label = {
                c["id"]: i for i, c in enumerate(coco.get("categories", []))
            }
        else:
            files = sorted(
                f for f in os.listdir(images_dir)
                if f.lower().endswith((".png", ".jpg", ".jpeg"))
            )
            self.image_ids = [int(os.path.splitext(f)[0]) for f in files]
            self.images = {
                i: {"file_name": f, "id": i}
                for i, f in zip(self.image_ids, files)
            }
            self.cat_id_to_label = {}
        if indices is not None:
            self.image_ids = [self.image_ids[i] for i in indices]
        self.label_to_cat_id = {v: k for k, v in self.cat_id_to_label.items()}

    def __len__(self) -> int:
        return len(self.image_ids)

    def get_example(self, idx: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        img_id = self.image_ids[idx]
        path = os.path.join(self.images_dir, self.images[img_id]["file_name"])
        with Image.open(path) as im:
            width, height = im.size
        image_u8 = decode_image(path, self.image_size, self.backend)
        return {
            "images": _convert(image_u8, self.output_dtype, self.normalize),
            "image_id": np.int64(img_id),
            "orig_size": np.asarray([height, width], np.int32),
        }
