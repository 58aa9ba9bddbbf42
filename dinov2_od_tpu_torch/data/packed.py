"""Packed (pre-decoded) dataset: decode once, train from a memmap
(counterpart of dinov2_od_tpu/data/packed.py, in its on-disk format, so a
directory either package packed loads in the other).

`pack_dataset` decodes and resizes every image once and writes flat
binary arrays; `PackedDataset` then serves batches with one fancy-index
copy per field, with no decode and no per-example Python in the loop.

Layout of a packed directory (format_version 1):
  images.u8.npy   [N, S, S, 3] uint8 (raw, unnormalised; a .npy memmap)
  boxes.npy       [N, max_boxes, 4] float32 (normalised cxcywh)
  labels.npy      [N, max_boxes] int32 (contiguous 0-based)
  valid.npy       [N, max_boxes] bool
  image_ids.npy   [N] int64
  orig_sizes.npy  [N, 2] int32 (height, width)
  meta.json       shapes, the label <-> category map, the source paths

Normalisation stays on the device (train/step.py `prep_images` takes the
uint8 feed); `output_dtype="float32"` converts and ImageNet-normalises on
the host.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from .coco import IMAGENET_MEAN, IMAGENET_STD

_FORMAT_VERSION = 1


def pack_dataset(
    dataset,
    out_dir: str,
    num_workers: int = 4,
    flush_every: int = 512,
) -> str:
    """Decode every example of `dataset` (CocoDetectionDataset-like, must
    yield uint8 images) into packed memmaps under `out_dir`.

    Returns `out_dir`. Work is streamed: at most `flush_every` decoded
    images are held in RAM, so packing a full COCO train split is
    constant-memory.
    """
    from concurrent.futures import ThreadPoolExecutor

    n = len(dataset)
    if n == 0:
        raise ValueError("cannot pack an empty dataset")
    first = dataset.get_example(0)
    if first["images"].dtype != np.uint8:
        raise ValueError(
            "pack_dataset requires a uint8-decoding dataset "
            "(output_dtype='uint8'); packing normalized floats would "
            "quadruple the file and bake the normalization in"
        )
    size = first["images"].shape[0]
    max_boxes = first["boxes"].shape[0]

    os.makedirs(out_dir, exist_ok=True)
    images = np.lib.format.open_memmap(
        os.path.join(out_dir, "images.u8.npy"),
        mode="w+", dtype=np.uint8, shape=(n, size, size, 3),
    )
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    labels = np.zeros((n, max_boxes), np.int32)
    valid = np.zeros((n, max_boxes), bool)
    image_ids = np.zeros((n,), np.int64)
    orig_sizes = np.zeros((n, 2), np.int32)

    with ThreadPoolExecutor(max(1, num_workers)) as pool:
        for start in range(0, n, flush_every):
            idxs = range(start, min(n, start + flush_every))
            for i, ex in zip(idxs, pool.map(dataset.get_example, idxs)):
                images[i] = ex["images"]
                boxes[i] = ex["boxes"]
                labels[i] = ex["labels"]
                valid[i] = ex["valid"]
                image_ids[i] = ex["image_id"]
                orig_sizes[i] = ex["orig_size"]
    images.flush()

    np.save(os.path.join(out_dir, "boxes.npy"), boxes)
    np.save(os.path.join(out_dir, "labels.npy"), labels)
    np.save(os.path.join(out_dir, "valid.npy"), valid)
    np.save(os.path.join(out_dir, "image_ids.npy"), image_ids)
    np.save(os.path.join(out_dir, "orig_sizes.npy"), orig_sizes)

    label_to_cat = getattr(dataset, "label_to_cat_id", {}) or {}
    meta = {
        "format_version": _FORMAT_VERSION,
        "num_images": n,
        "image_size": size,
        "max_boxes": max_boxes,
        "num_classes": getattr(dataset, "num_classes", len(label_to_cat)),
        # JSON keys must be strings; order is the contiguous label index.
        "label_to_cat_id": {str(k): int(v) for k, v in label_to_cat.items()},
        "annotation_file": getattr(dataset, "coco_path", None),
        "images_dir": getattr(dataset, "images_dir", None),
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return out_dir


class PackedDataset:
    """Memmap-backed dataset over a `pack_dataset` directory.

    Drop-in for CocoDetectionDataset on the training/eval paths: same
    `get_example` keys and the same side-table attributes
    (label_to_cat_id / num_classes / coco_path). Additionally exposes
    `get_batch(idxs)` — one fancy-index copy per batch — which
    DataLoader uses instead of its per-example thread pool.
    """

    def __init__(
        self,
        path: str,
        indices: Optional[List[int]] = None,
        output_dtype: str = "uint8",
        normalize: bool = True,
        image_size: Optional[int] = None,
        max_boxes: Optional[int] = None,
    ):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"packed dataset {path} has format_version "
                f"{self.meta.get('format_version')}, expected {_FORMAT_VERSION}"
            )
        if image_size is not None and image_size != self.meta["image_size"]:
            raise ValueError(
                f"packed dataset was built at image_size="
                f"{self.meta['image_size']}, requested {image_size}; repack "
                f"at image_size {image_size}"
            )
        self.image_size = self.meta["image_size"]
        # Narrowing slices the pad; widening pads with zeros/False — both
        # exact, because pack stores fully padded targets and padding IS
        # zeros with valid=False. A request wider than what was packed
        # only loses boxes if an image actually had more than the packed
        # max (the packer already truncated those).
        self.max_boxes = (
            self.meta["max_boxes"] if max_boxes is None else max_boxes
        )
        self.output_dtype = output_dtype
        self.normalize = normalize

        self._images = np.load(
            os.path.join(path, "images.u8.npy"), mmap_mode="r"
        )
        self._boxes = np.load(os.path.join(path, "boxes.npy"))
        self._labels = np.load(os.path.join(path, "labels.npy"))
        self._valid = np.load(os.path.join(path, "valid.npy"))
        self._image_ids = np.load(os.path.join(path, "image_ids.npy"))
        self._orig_sizes = np.load(os.path.join(path, "orig_sizes.npy"))

        self._index = (
            np.arange(self.meta["num_images"])
            if indices is None
            else np.asarray(indices, np.int64)
        )

        self.label_to_cat_id = {
            int(k): v for k, v in self.meta["label_to_cat_id"].items()
        }
        self.cat_id_to_label = {v: k for k, v in self.label_to_cat_id.items()}
        self.num_classes = self.meta["num_classes"]
        self.coco_path = self.meta.get("annotation_file")
        self.images_dir = self.meta.get("images_dir")
        self.image_ids = [int(i) for i in self._image_ids[self._index]]

    def __len__(self) -> int:
        return len(self._index)

    def _convert(self, images: np.ndarray) -> np.ndarray:
        if self.output_dtype == "uint8":
            return images
        out = images.astype(np.float32) / 255.0
        if self.normalize:
            out = (out - IMAGENET_MEAN) / IMAGENET_STD
        return out

    def _targets(self, rows) -> Dict[str, np.ndarray]:
        packed_mb = self.meta["max_boxes"]
        b = self._boxes[rows, : self.max_boxes]
        l = self._labels[rows, : self.max_boxes]
        v = self._valid[rows, : self.max_boxes]
        if self.max_boxes > packed_mb:
            extra = self.max_boxes - packed_mb
            pad = [(0, 0)] * (b.ndim - 2) + [(0, extra)]
            b = np.pad(b, pad + [(0, 0)])
            l = np.pad(l, pad)
            v = np.pad(v, pad)
        return {"boxes": b, "labels": l, "valid": v}

    def get_batch(self, idxs) -> Dict[str, np.ndarray]:
        """Assemble a whole batch with one gather per field (the loader
        fast path; ~150 KB/image memcpy instead of a JPEG decode)."""
        rows = self._index[np.asarray(idxs, np.int64)]
        out = {"images": self._convert(self._images[rows])}
        out.update(self._targets(rows))
        out["image_id"] = self._image_ids[rows]
        out["orig_size"] = self._orig_sizes[rows]
        return out

    def get_example(self, idx: int) -> Dict[str, np.ndarray]:
        row = self._index[idx]
        out = {"images": self._convert(np.asarray(self._images[row]))}
        out.update(self._targets(row))
        out["image_id"] = np.int64(self._image_ids[row])
        out["orig_size"] = self._orig_sizes[row]
        return out
