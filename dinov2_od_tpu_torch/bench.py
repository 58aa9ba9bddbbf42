"""Headline benchmark of the port: DINOv2 + DETR throughput on one card
(counterpart of the repo's bench.py).

    python -m dinov2_od_tpu_torch.bench

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "images/sec/chip", "vs_baseline": N}

- Builds the configuration of bench.py from the same environment knobs
  (`bench_config`): BENCH_BATCH (32), BENCH_MODEL (small|base|large|giant,
  base), BENCH_IMAGE_SIZE (224), BENCH_PREFIX_INT8=1, BENCH_REMAT=1,
  BENCH_AUG=1, BENCH_FFN=moe with BENCH_MOE_EXPERTS (8: the MoE FFN of
  ops/moe.py in the 2 adapted blocks, top-2, capacity factor 1.25);
  BENCH_SCAN_UNROLL is accepted and has no effect (the port's backbone is
  unrolled). BENCH_REMAT=1 recomputes the adapted blocks in the
  backward, BENCH_AUG=1 augments each batch on the card (hflip 0.5,
  colour 0.3, scale 0.25).
- Random weights from seed 0, frozen backbone weights stored in bf16
  (`cast_frozen_weights`), the batch `make_batch(default_rng(0), ...,
  max_boxes=25)`.
- BENCH_MODE=train (the default) times the train step with
  `measure_steps_per_sec`; BENCH_MODE=eval times `detector_apply` on the
  LoRA-folded params (int8-quantized with BENCH_QUANT=int8) with
  `time_fn`.
- The step runs on one card, so images/s is divided by that one card (the
  JAX bench divides by every visible device).
- vs_baseline divides by the reference's images/s in the repo's
  BASELINE_MEASURED.json (standard_attention), 0 when it is absent.

Runs on the CUDA card and exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from .config import (AugmentConfig, DataConfig, OptimConfig, TrainConfig,
                     detector_config_for_model_name)

REPO = Path(__file__).resolve().parent.parent
MAX_BOXES = 25


def bench_config(env: Mapping[str, str]) -> TrainConfig:
    """The TrainConfig bench.py:48-101 builds from the same knobs."""
    batch_size = int(env.get("BENCH_BATCH", "32"))
    model = env.get("BENCH_MODEL", "base")
    image_size = int(env.get("BENCH_IMAGE_SIZE", "224"))
    ffn = env.get("BENCH_FFN", "")
    det = detector_config_for_model_name(
        f"facebook/dinov2-{model}", hidden_dim=768, image_size=image_size)
    det = dataclasses.replace(det, backbone=dataclasses.replace(
        det.backbone, dtype="bfloat16",
        prefix_int8=env.get("BENCH_PREFIX_INT8", "0") == "1",
        ffn_type_override=ffn or None,
        moe_num_experts=int(env.get("BENCH_MOE_EXPERTS", "8"))))
    augment = (AugmentConfig(hflip_prob=0.5, color_jitter=0.3,
                             scale_jitter=0.25)
               if env.get("BENCH_AUG", "0") == "1" else AugmentConfig())
    return TrainConfig(
        detector=det,
        data=DataConfig(batch_size=batch_size, max_boxes=MAX_BOXES),
        optim=OptimConfig(),
        augment=augment,
        use_remat=env.get("BENCH_REMAT", "0") == "1",
    )


def bench_inputs(cfg: TrainConfig, device: str = "cuda"):
    """(params, batch) of the bench: random weights from seed 0 with the
    frozen backbone weights in bf16, and the synthetic batch of seed 0, on
    `device`."""
    from .data.synthetic import make_batch
    from .models.detector import cast_frozen_weights, init_detector_params

    det = cfg.detector
    params = init_detector_params(torch.Generator().manual_seed(0), det,
                                  device=device)
    params = cast_frozen_weights(params, det)
    raw = make_batch(np.random.default_rng(0), cfg.data.batch_size,
                     image_size=det.backbone.image_size,
                     max_boxes=cfg.data.max_boxes)
    return params, {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


def eval_params(params, cfg: TrainConfig, quant: str):
    """The serving tree: LoRA folded, then int8-quantized for "int8"."""
    from .models.detector import fold_detector_lora
    from .models.quantize import quantize_detector_int8

    out = fold_detector_lora(params, cfg.detector)
    if quant == "int8":
        out = quantize_detector_int8(out, cfg.detector)
    return out


def _vs_baseline(images_per_sec: float) -> float:
    path = REPO / "BASELINE_MEASURED.json"
    if not path.exists():
        return 0.0
    base = json.loads(path.read_text())
    ref = base.get("standard_attention", {}).get("images_per_sec", 0.0)
    return images_per_sec / ref if ref > 0 else 0.0


def run(env: Mapping[str, str]) -> dict:
    """Build, time and return the bench's one record."""
    from .models.detector import detector_apply
    from .train.state import create_train_state
    from .train.step import make_train_step
    from .utils.benchmark import measure_steps_per_sec, time_fn

    cfg = bench_config(env)
    det = cfg.detector
    mode = env.get("BENCH_MODE", "train")
    quant = env.get("BENCH_QUANT", "")
    params, batch = bench_inputs(cfg)
    if mode == "eval":
        p = eval_params(params, cfg, quant)
        with torch.no_grad():
            sec_per_step = time_fn(
                lambda im: detector_apply(p, det, im, deterministic=True),
                batch["images"])
    else:
        state = create_train_state(params, cfg.optim, det)
        step = make_train_step(cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        sec_per_step, _ = measure_steps_per_sec(step, state, batch, gen,
                                                iters=8)
    images_per_sec = cfg.data.batch_size / sec_per_step
    model = env.get("BENCH_MODEL", "base")
    return {
        "metric": (
            f"ViT-{model[0].upper()}/14+DETR(deformable) {mode} "
            f"step throughput (batch {cfg.data.batch_size}, "
            f"{det.backbone.image_size}px, "
            + ("int8 W8A8 backbone, " if mode == "eval" and quant == "int8"
               else "bf16 backbone, ")
            + (f"moe-E{det.backbone.moe_num_experts} FFN, "
               if det.backbone.ffn_type_override == "moe" else "")
            + f"{torch.cuda.get_device_name()})"
        ),
        "value": round(images_per_sec, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(_vs_baseline(images_per_sec), 2),
    }


def main(env: Mapping[str, str] = os.environ) -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(run(env)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
