"""The train step at COCO's densest GT, with and without deep supervision
(counterpart of tools/bench_dense.py).

The full-width ViT-B/14 train step at 224 px (bf16 backbone) with 93
valid GT of 100 slots an image, where the matcher solves on the card
(the auction at 40 or more slots), with and without `--aux_loss` (every
intermediate decoder layer matched and scored too) and
`--share_aux_match` (the aux layers reuse the final layer's assignment).

Usage:
  python -m dinov2_od_tpu_torch.tools.bench_dense [--aux_loss]
      [--share_aux_match] [--both] [--batch_size 32] [--valid_gt 93]
      [--device cuda]

Prints one JSON line a configuration: sec_per_step, images/s, and the
matcher's solver calls and rounds a step.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

MAX_BOXES = 100


def dense_batch(batch_size: int, valid_gt: int, image_size: int = 224,
                seed: int = 0, device="cuda"):
    """A random batch with `valid_gt` valid boxes of MAX_BOXES an image,
    drawn as the JAX tool draws it."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (batch_size, image_size, image_size, 3)
                         ).astype(np.float32)
    wh = rng.uniform(0.05, 0.3, (batch_size, MAX_BOXES, 2)).astype(np.float32)
    cxy = rng.uniform(0.2, 0.8, (batch_size, MAX_BOXES, 2)).astype(np.float32)
    labels = rng.integers(0, 91, (batch_size, MAX_BOXES)).astype(np.int64)
    valid = np.zeros((batch_size, MAX_BOXES), bool)
    valid[:, :valid_gt] = True
    raw = {"images": images, "boxes": np.concatenate([cxy, wh], axis=-1),
           "labels": labels, "valid": valid}
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


def run(batch_size: int, valid_gt: int, aux_loss: bool,
        share_aux_match: bool = False, device: str = "cuda",
        iters: int = 8, model: str = "facebook/dinov2-base") -> dict:
    from ..config import (DataConfig, OptimConfig, TrainConfig,
                          detector_config_for_model_name)
    from ..models.detector import cast_frozen_weights, init_detector_params
    from ..ops import matching
    from ..train.state import create_train_state
    from ..train.step import make_train_step
    from ..utils.benchmark import measure_steps_per_sec

    det = detector_config_for_model_name(model, hidden_dim=768,
                                         image_size=224)
    det = dataclasses.replace(
        det, backbone=dataclasses.replace(det.backbone, dtype="bfloat16"),
        decoder=dataclasses.replace(det.decoder, aux_loss=aux_loss))
    cfg = TrainConfig(detector=det,
                      data=DataConfig(batch_size=batch_size,
                                      max_boxes=MAX_BOXES),
                      optim=OptimConfig(), share_aux_match=share_aux_match)
    params = cast_frozen_weights(
        init_detector_params(torch.Generator().manual_seed(0), det,
                             device=device), det)
    state = create_train_state(params, cfg.optim, det)
    step = make_train_step(cfg)
    batch = dense_batch(batch_size, valid_gt, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    matching.reset_solver_stats()
    sec, _ = measure_steps_per_sec(step, state, batch, gen, iters=iters,
                                   device=device)
    steps = 1 + 1 + 1 + (1 + iters)  # warm-up, throwaway, base, total
    solver = {k: v / steps for k, v in matching.solver_stats.items()}
    out = {
        "metric": (f"ViT-{det.backbone.variant[0].upper()}/14 train step, "
                   f"dense GT (G={valid_gt}/"
                   f"max_boxes={MAX_BOXES}), batch {batch_size}, "
                   f"aux_loss={aux_loss}"
                   + (", shared aux match" if share_aux_match else "")
                   + (f", {torch.cuda.get_device_name()}"
                      if device == "cuda" else f", {device}")),
        "sec_per_step": sec,
        "value": batch_size / sec,
        "unit": "images/sec/chip",
        "matcher_per_step": solver,
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--valid_gt", type=int, default=93)
    p.add_argument("--aux_loss", action="store_true")
    p.add_argument("--share_aux_match", action="store_true")
    p.add_argument("--both", action="store_true",
                   help="aux_loss off, on, and on with the shared match")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_dense: no CUDA device", file=sys.stderr)
        return 1
    if args.both:
        for aux, share in ((False, False), (True, False), (True, True)):
            run(args.batch_size, args.valid_gt, aux, share, args.device)
    else:
        run(args.batch_size, args.valid_gt, args.aux_loss,
            args.share_aux_match, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
