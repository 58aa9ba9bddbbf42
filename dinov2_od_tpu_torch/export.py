"""Serving bundles: the folded serving weights and the detector config on
disk (counterpart of dinov2_od_tpu/export.py).

The JAX package's bundle carries the serving computation itself, as
StableHLO modules one per batch size. The port's bundle carries weights
and a config, not a program: its kernels are ctypes launches of
hand-written CUDA (ops/_build.py), which `torch.export` cannot trace, so
the loader rebuilds the forward from the port's own model code
(`detector_apply` through a `Predictor`). What stays the JAX bundle's:
the weights are folded (and optionally int8-quantized) once at export,
and inputs are chunked and padded onto the exported batch sizes, so the
kernels see only those shapes.

Bundle directory layout::

    manifest.json    format version, torch version, batch sizes, image
                     size, max_detections, normalize, quantize mode,
                     label->category-id map, class names, param metadata
                     (dtype, shape) and the detector config (its
                     dataclasses as JSON)
    params.npz       flat {path: raw bytes} of the folded serving params
                     in logical row-major order (dtype and shape in the
                     manifest: bf16 and int8 round-trip bit for bit)

The loader lays every int8 `kernel_q` out K-major again, as
`quantize_linear` stores it: the layout the int8 GEMMs read in place.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import BackboneConfig, DecoderConfig, DetectorConfig
from .evaluation.postprocess import format_detections
from .models.layers import resolve_device
from .models.quantize import k_major
from .train.checkpoint import flatten_tree

MANIFEST = "manifest.json"
PARAMS = "params.npz"
_FORMAT_VERSION = 1


def _unflatten_params(flat: Dict[str, torch.Tensor]) -> dict:
    """flat {'a/b/c': leaf} (train/checkpoint.py `flatten_tree`) -> the
    nested-dict tree."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's values in logical row-major order as uint8 bytes."""
    flat = t.detach().cpu().contiguous().reshape(-1)
    return flat.view(torch.uint8).numpy()


def _from_bytes(raw: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(raw, copy=True)).view(getattr(torch, dtype))
    return t.reshape(shape).to(device)


def _config_from_json(d: dict) -> DetectorConfig:
    return DetectorConfig(backbone=BackboneConfig(**d["backbone"]),
                          decoder=DecoderConfig(**d["decoder"]))


def export_serving_bundle(
    params,
    cfg: DetectorConfig,
    out_dir: str,
    *,
    batch_sizes: Sequence[int] = (1, 8, 32),
    max_detections: int = 100,
    fold_lora: bool = True,
    quantize: Optional[str] = None,
    normalize: bool = True,
    label_to_cat_id: Optional[Dict[int, int]] = None,
    class_names: Optional[Dict[int, str]] = None,
) -> str:
    """Export a serving bundle to ``out_dir``.

    Args:
      params: trained detector params (LoRA factors still separate:
        folded here unless ``fold_lora=False`` because they already are),
        on the device the transforms should run on.
      cfg: the detector config the params serve with (its backbone dtype
        included); recorded in the manifest.
      quantize: None or "int8" (W8A8 backbone, models/quantize.py).
      batch_sizes: the batch sizes the loader runs; at serve time inputs
        are chunked and padded onto these.

    Returns:
      out_dir.
    """
    from .models.detector import fold_detector_lora

    if fold_lora:
        params = fold_detector_lora(params, cfg)
    if quantize == "int8":
        from .models.quantize import quantize_detector_int8

        params = quantize_detector_int8(params, cfg)
    elif quantize is not None:
        raise ValueError(f"unknown quantize mode: {quantize!r}")

    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"bad batch_sizes: {batch_sizes}")

    os.makedirs(out_dir, exist_ok=True)
    flat = flatten_tree(params)
    np.savez(os.path.join(out_dir, PARAMS),
             **{p: _raw_bytes(t) for p, t in flat.items()})
    manifest = {
        "format_version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        "batch_sizes": batch_sizes,
        "image_size": cfg.backbone.image_size,
        "max_detections": max_detections,
        "normalize": normalize,
        "quantize": quantize,
        "label_to_cat_id": {
            str(k): int(v) for k, v in (label_to_cat_id or {}).items()
        },
        "class_names": {
            str(k): str(v) for k, v in (class_names or {}).items()
        },
        "params": {
            p: {"dtype": _dtype_name(t), "shape": list(t.shape)}
            for p, t in flat.items()
        },
        "detector_config": dataclasses.asdict(cfg),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


class ServingModel:
    """A loaded serving bundle on `device` (CUDA unless the caller asks
    for the CPU; raises when CUDA is absent).

    ``detect()`` matches Predictor.detect's output format, so a bundle is
    a drop-in replacement for checkpoint-based serving.
    """

    def __init__(self, path: str, device="cuda"):
        from .inference import Predictor

        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest["format_version"] > _FORMAT_VERSION:
            raise ValueError(
                f"bundle format {self.manifest['format_version']} is newer "
                f"than this loader ({_FORMAT_VERSION})"
            )
        self.cfg = _config_from_json(self.manifest["detector_config"])
        self.batch_sizes: List[int] = list(self.manifest["batch_sizes"])
        self.image_size: int = self.manifest["image_size"]
        self.max_detections: int = self.manifest["max_detections"]
        self.normalize: bool = self.manifest["normalize"]
        self.label_to_cat_id = {
            int(k): v for k, v in self.manifest["label_to_cat_id"].items()
        }
        self.class_names = {
            int(k): v for k, v in self.manifest["class_names"].items()
        }

        # The leaves are placed on the device, then handed to a Predictor
        # unchanged (already folded and quantized).
        self.device = resolve_device(device)
        meta = self.manifest["params"]
        with np.load(os.path.join(path, PARAMS)) as z:
            flat = {}
            for p in z.files:
                t = _from_bytes(z[p], meta[p]["dtype"], meta[p]["shape"],
                                self.device)
                flat[p] = k_major(t) if p.endswith("/kernel_q") else t
        self.params = _unflatten_params(flat)
        self._predictor = Predictor(self.params, self.cfg, fold_lora=False,
                                    device=self.device)
        self.device_batches = 0  # forward calls issued, for callers' checks

    def _chunks(self, n: int) -> List[Tuple[int, int]]:
        """(start, exported_batch) chunking: greedy largest exported
        size, padding the final partial chunk onto the smallest size
        that fits it."""
        out, start, largest = [], 0, self.batch_sizes[-1]
        while n - start >= largest:
            out.append((start, largest))
            start += largest
        if n - start:
            fit = next(b for b in self.batch_sizes if b >= n - start)
            out.append((start, fit))
        return out

    def call_packed(self, pixel: np.ndarray, sizes: np.ndarray) -> np.ndarray:
        """[N,H,W,3] float32 (already normalized) + [N,2] sizes ->
        packed [N, K, 6] detections (score, label, x, y, w, h)."""
        outs = []
        for start, b in self._chunks(len(pixel)):
            chunk = pixel[start : start + b]
            sz = sizes[start : start + b]
            pad = b - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)]
                )
                sz = np.concatenate([sz, np.ones((pad, 2), sz.dtype)])
            pred = self._predictor
            out = pred._forward_topk(pred._upload(chunk), pred._upload(sz),
                                     self.max_detections)
            self.device_batches += 1
            outs.append(out[: b - pad].cpu().numpy())
        return np.concatenate(outs) if outs else np.zeros(
            (0, self.max_detections, 6), np.float32
        )

    def detect(
        self,
        images: Sequence[Union[str, np.ndarray]],
        score_threshold: float = 0.5,
    ) -> List[List[dict]]:
        """File paths or [H,W,3] float arrays in [0,1] -> per-image
        detection dicts ({"bbox" xywh pixels, "score", "category_id",
        "name" when known}): Predictor.detect's format."""
        from .inference import prepare_images

        pixel, orig_sizes = prepare_images(
            images, self.image_size, self.normalize
        )
        packed = self.call_packed(pixel, orig_sizes)
        per_image: List[List[dict]] = [[] for _ in range(len(pixel))]
        results = format_detections(
            packed[..., 0],
            packed[..., 1].astype(np.int32),
            packed[..., 2:],
            np.arange(len(pixel)),
            self.label_to_cat_id,
            score_threshold=score_threshold,
        )
        for r in results:
            det = {
                "bbox": r["bbox"],
                "score": r["score"],
                "category_id": r["category_id"],
            }
            if self.class_names:
                det["name"] = self.class_names.get(r["category_id"], "")
            per_image[r["image_id"]].append(det)
        return per_image


def load_serving_bundle(path: str, device="cuda") -> ServingModel:
    return ServingModel(path, device=device)
