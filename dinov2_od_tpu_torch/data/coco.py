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

Decoding is the reference's: a full Pillow load and a bilinear resize
(`decode_backend="pil"`). The JAX package's faster backends, 'auto' (its
native libjpeg-turbo decoder) and 'cv2', are not ported yet (ROADMAP.md)
and raise.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def check_decode_backend(backend: str) -> None:
    if backend != "pil":
        raise NotImplementedError(
            f"decode_backend={backend!r} is not ported yet (ROADMAP.md, "
            f"Queue A item 5: data/native_decode.py and the cv2 path); "
            f"use 'pil'")


def decode_pil(path: str, image_size: int) -> np.ndarray:
    """Full Pillow load + bilinear resize: uint8 [S, S, 3]."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize(
            (image_size, image_size), Image.Resampling.BILINEAR
        )
        return np.asarray(im, np.uint8)


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
        check_decode_backend(decode_backend)
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
        image_u8 = decode_pil(
            os.path.join(self.images_dir, info["file_name"]), self.image_size)
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
        check_decode_backend(decode_backend)
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
        image_u8 = decode_pil(path, self.image_size)
        return {
            "images": _convert(image_u8, self.output_dtype, self.normalize),
            "image_id": np.int64(img_id),
            "orig_size": np.asarray([height, width], np.int32),
        }
