"""High-level inference API (counterpart of dinov2_od_tpu/inference.py).

    from dinov2_od_tpu_torch.inference import Predictor
    p = Predictor(params, cfg)                 # on the CUDA card
    detections = p.detect(["img1.jpg", img_array], score_threshold=0.5)

- LoRA factors are folded into the base kernels at construction (one GEMM
  per adapted linear).
- Inputs are padded to the configured batch size, so every device batch
  has one shape.
- Post-processing (sigmoid, top-k, rescale) runs on the device; one
  compact [B, K, 6] tensor comes back per batch.
- Double-buffered, as in the JAX package: chunk i+1 is dispatched before
  chunk i's top-k is read back. On the card each chunk is staged in
  pinned memory and copied in on a side stream (a pageable copy would
  wait for the card), and its top-k is copied out into pinned memory
  behind an event the host waits on only after the next chunk is queued.
- `quantize="int8"` serves W8A8 (models/quantize.py): LoRA is folded,
  then the backbone's block linears are quantized, in the JAX order.
- `Predictor.from_checkpoint` loads the params of a checkpoint that the
  training loop wrote (train/checkpoint.py).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .config import DetectorConfig, detector_config_for_model_name
from .data.coco import IMAGENET_MEAN, IMAGENET_STD
from .evaluation.postprocess import format_detections, select_topk_detections
from .models.detector import (cast_frozen_weights, detector_apply,
                              fold_detector_lora, init_detector_params)
from .models.layers import resolve_device
from .models.quantize import quantize_detector_int8



def _load_image(path: str, image_size: int) -> np.ndarray:
    """Full PIL decode + bilinear resize, [S, S, 3] float32 in [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize(
            (image_size, image_size), Image.Resampling.BILINEAR
        )
        return np.asarray(im, np.float32) / 255.0


def prepare_images(
    images: Sequence[Union[str, np.ndarray]],
    image_size: int,
    normalize: bool,
):
    """File paths or [H, W, 3] float arrays in [0, 1] -> (pixels
    [N, S, S, 3] float32, orig_sizes [N, 2] int32). Pillow is needed only
    for files and for arrays not already at S x S."""
    arrs, orig_sizes = [], []
    for im in images:
        if isinstance(im, str):
            from PIL import Image

            with Image.open(im) as pil:
                orig_sizes.append([pil.size[1], pil.size[0]])
            arr = _load_image(im, image_size)
        else:
            arr = np.asarray(im, np.float32)
            orig_sizes.append(list(arr.shape[:2]))
            if arr.shape[:2] != (image_size, image_size):
                from PIL import Image

                pil = Image.fromarray((arr * 255).astype(np.uint8))
                arr = np.asarray(
                    pil.resize((image_size, image_size),
                               Image.Resampling.BILINEAR),
                    np.float32,
                ) / 255.0
        if normalize:
            arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
        arrs.append(arr)
    return np.stack(arrs), np.asarray(orig_sizes, np.int32)


def _to_device(tree, device):
    """The tree on `device`, detached: serving takes no gradient, and a
    weight that requires grad (a train state's trainable leaf) sends
    `torch.matmul` down another path (it folds batch dims only for
    inputs that do not), whose GEMMs round apart in the last bit."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.detach().to(device)


def checkpoint_params(checkpoint_path: str, cfg: DetectorConfig,
                      device="cuda"):
    """The params of a checkpoint directory of the training loop
    (`checkpoint_epoch_N` or `final_model`), restored onto a template
    drawn from seed 0 on `device` (leaves absent from the checkpoint keep
    the template's values, with a warning). Under a bf16 backbone the
    template stores the frozen weights in bf16, as the training loop
    saved them, so LoRA folds in the dtype it folds in for the loop's
    params."""
    from .train.checkpoint import restore_checkpoint

    template = init_detector_params(torch.Generator().manual_seed(0), cfg,
                                    device=device)
    if cfg.backbone.dtype == "bfloat16":
        template = cast_frozen_weights(template, cfg)
    return restore_checkpoint(checkpoint_path, template).params


class Predictor:
    def __init__(
        self,
        params,
        cfg: DetectorConfig,
        label_to_cat_id: Optional[Dict[int, int]] = None,
        class_names: Optional[Dict[int, str]] = None,
        batch_size: int = 8,
        normalize: bool = True,
        fold_lora: bool = True,
        quantize: Optional[str] = None,
        device="cuda",
    ):
        """params: the port's param tree (params.params_from_numpy turns a
        JAX tree into one). device: CUDA unless the caller asks for the
        CPU; raises when CUDA is asked for and absent."""
        self.device = resolve_device(device)
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode: {quantize!r}")
        params = _to_device(params, self.device)
        if fold_lora:
            params = fold_detector_lora(params, cfg)
        if quantize == "int8":  # raises on unfolded LoRA
            params = quantize_detector_int8(params, cfg)
        self.params = params
        self.cfg = cfg
        self.batch_size = batch_size
        self.normalize = normalize
        self.label_to_cat_id = label_to_cat_id or {}
        self.class_names = class_names or {}
        self.device_batches = 0  # forward calls issued, for callers' checks
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)

    # False reads each chunk back before the next is dispatched (the
    # schedule to compare the double buffer against; the results match).
    overlap_chunks = True

    @classmethod
    def from_checkpoint(
        cls,
        checkpoint_path: str,
        model_name: str = "facebook/dinov2-base",
        num_classes: int = 91,
        detector_cfg: Optional[DetectorConfig] = None,
        device="cuda",
        **kwargs,
    ) -> "Predictor":
        """A Predictor over the params of a checkpoint directory of the
        training loop (`checkpoint_params`)."""
        cfg = detector_cfg or detector_config_for_model_name(
            model_name, num_classes=num_classes)
        return cls(checkpoint_params(checkpoint_path, cfg, device), cfg,
                   device=device, **kwargs)

    @torch.inference_mode()
    def _forward_topk(self, x: torch.Tensor, sizes: torch.Tensor,
                      max_detections: int) -> torch.Tensor:
        """Forward + device-side top-k as one [B, K, 6] fp32 tensor:
        (score, label, x, y, w, h)."""
        out = detector_apply(self.params, self.cfg, x, deterministic=True)
        scores, labels, boxes = select_topk_detections(
            out["pred_logits"], out["pred_boxes"], sizes,
            max_detections=max_detections,
        )
        return torch.cat(
            [scores[..., None], labels[..., None].float(), boxes], dim=-1
        )

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """`arr` on the device. On CUDA: staged in pinned memory, copied
        with non_blocking=True on the side stream, and the current stream
        waits on the copy (record_stream keeps the allocator off the
        tensor until that stream is done with it)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self._copy_stream is None:
            return t.to(self.device)
        stream = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = t.pin_memory().to(self.device, non_blocking=True)
        stream.wait_stream(self._copy_stream)
        out.record_stream(stream)
        return out

    def _download(self, topk: torch.Tensor):
        """(host tensor, event): on CUDA a copy into pinned memory queued
        behind the forward, and the event to wait on before reading it."""
        if self._copy_stream is None:
            return topk.cpu(), None
        host = torch.empty(topk.shape, dtype=topk.dtype, pin_memory=True)
        host.copy_(topk, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def detect(
        self,
        images: Sequence[Union[str, np.ndarray]],
        score_threshold: float = 0.5,
        max_detections: int = 100,
    ) -> List[List[dict]]:
        """Run detection.

        Args:
          images: file paths, or [H, W, 3] float arrays in [0, 1].

        Returns:
          Per image: list of {"bbox": xywh pixels, "score", "category_id",
          "name" (if class names known)}.
        """
        pixel, orig_sizes = prepare_images(
            images, self.cfg.backbone.image_size, self.normalize
        )
        n = len(pixel)
        bs = self.batch_size
        per_image: List[List[dict]] = [[] for _ in range(n)]

        def drain(entry):
            host, done, start, count = entry
            if done is not None:
                done.synchronize()
            topk = host.numpy()
            results = format_detections(
                topk[..., 0],
                topk[..., 1].astype(np.int32),
                topk[..., 2:],
                np.arange(start, start + count),
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

        in_flight = 1 if self.overlap_chunks else 0
        pending: deque = deque()
        for start in range(0, n, bs):
            chunk = pixel[start:start + bs]
            sizes = orig_sizes[start:start + bs]
            count = len(chunk)
            pad = bs - count
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
                sizes = np.concatenate([sizes, np.ones((pad, 2), sizes.dtype)])
            out = self._forward_topk(self._upload(chunk), self._upload(sizes),
                                     max_detections)
            self.device_batches += 1
            pending.append((*self._download(out[:count]), start, count))
            if len(pending) > in_flight:
                drain(pending.popleft())
        while pending:
            drain(pending.popleft())
        return per_image
