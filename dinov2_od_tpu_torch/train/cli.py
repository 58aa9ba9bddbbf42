"""Training CLI, the `python -m dinov2_od_tpu_torch.train` entry point
(counterpart of dinov2_od_tpu/train/cli.py).

The reference's `python -m dino_detector.train` flag surface
(dino_detector/train.py:1354-1462): dataset paths, debug/overfit mode,
coco-mini subsets, test-mini, the lightweight config, checkpoints, loss
and matcher costs, logging. Every flag name of the JAX package's CLI is
kept, so a JAX command line carries across. The port trains in one
process on one device (`--device cuda`, the default, or `cpu`). The flags
of paths not ported yet raise `NotImplementedError` naming their
ROADMAP.md item when they are asked for (`UNPORTED`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

from .. import config as C


def str2bool(v) -> bool:
    """Proper boolean flag parsing. The reference used `type=bool`, which
    treats any non-empty string (including "False") as True
    (train.py:1421; SURVEY.md §5 quirk)."""
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "t", "yes", "y")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train DINOv2 Object Detector (PyTorch, CUDA)")

    # Dataset paths (reference train.py:1357-1366)
    p.add_argument("--train_images", type=str, default="")
    p.add_argument("--train_annotations", type=str, default="")
    p.add_argument("--val_images", type=str, default="")
    p.add_argument("--val_annotations", type=str, default="")
    p.add_argument("--testdev_images", type=str, default="")

    # Dataset download (reference train.py:1369-1376)
    p.add_argument("--data_dir", type=str, default="coco_data")
    p.add_argument("--download_train_data", action="store_true")
    p.add_argument("--download_val_data", action="store_true")
    p.add_argument("--download_test_data", action="store_true")

    # Training options (reference train.py:1379-1386)
    p.add_argument("--output_dir", type=str, default="outputs")
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--val_frequency", type=int, default=5)
    p.add_argument("--only_evaluate", action="store_true")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="serving-path quantization for --only_evaluate: "
                        "'int8' folds LoRA and runs the backbone's block "
                        "linears as W8A8 (the int8 GEMM kernel)")
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=None)

    # Parallelism (reference --distributed/--world_size/--dist_url). The
    # port trains in one process on one card: the multi-process and mesh
    # flags below raise when asked for (ROADMAP.md Queue A item 7).
    p.add_argument("--distributed", action="store_true",
                   help="multi-process data parallelism (not ported yet)")
    p.add_argument("--world_size", type=int, default=0,
                   help="accepted for compatibility; ignored")
    p.add_argument("--dist_url", type=str, default="env://",
                   help="accepted for compatibility; ignored")
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-host job (not ported yet)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (multihost)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total process count (multihost)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's id (multihost)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="model-axis size of the mesh: tensor parallelism "
                        "by default; repurposed as the sequence axis "
                        "under --context_parallel or the stage axis under "
                        "--pipeline_parallel")
    p.add_argument("--context_parallel", action="store_true",
                   help="context (sequence) parallelism: backbone "
                        "attention runs as ring attention with tokens "
                        "sharded over the model axis (requires "
                        "--model_parallel > 1; exclusive with TP/PP)")
    p.add_argument("--context_parallel_size", type=int, default=0,
                   help="dedicated context-axis size (three-axis mesh "
                        "data x context x model): ring attention over "
                        "the context axis COMPOSED with tensor "
                        "parallelism of --model_parallel over the model "
                        "axis (exclusive with --context_parallel/"
                        "--pipeline_parallel)")
    p.add_argument("--pipeline_parallel_size", type=int, default=0,
                   help="dedicated stage-axis size (three-axis mesh "
                        "data x stage x model): backbone pipeline over "
                        "the stage axis COMPOSED with tensor parallelism "
                        "of --model_parallel over the model axis "
                        "(exclusive with --pipeline_parallel/"
                        "--context_parallel*)")
    p.add_argument("--pipeline_parallel", action="store_true",
                   help="pipeline parallelism: backbone depth splits into "
                        "--model_parallel GPipe stages (exclusive with "
                        "TP/CP)")
    p.add_argument("--pipeline_microbatches", type=int, default=0,
                   help="microbatches for the pipeline schedule "
                        "(0 -> stage count)")
    p.add_argument("--pipeline_chunks", type=int, default=1,
                   help="chunks per pipeline stage: 1 = GPipe; >1 = "
                        "interleaved schedule (each device holds that "
                        "many non-consecutive depth chunks; bubble "
                        "shrinks by the same factor; microbatches must "
                        "divide by the stage count)")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: shard parameters + optimizer state over "
                        "the data axis (weights all-gathered on use, "
                        "gradients reduce-scattered — ~1/N param memory "
                        "per device at unchanged math). Composes with "
                        "--model_parallel; exclusive with pipeline/"
                        "context parallelism")

    # Debug / overfit (reference train.py:1397-1406)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--debug_samples", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=8,
                   help="images per step on the card")
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "cosine", "linear"],
                   help="LR schedule (beyond reference, which has none): "
                        "cosine/linear decay to --min_lr_ratio x lr over "
                        "the run, with optional --warmup_steps")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup from 0 over this many optimizer "
                        "steps (works with every --lr_schedule)")
    p.add_argument("--min_lr_ratio", type=float, default=0.0,
                   help="decay floor as a fraction of the peak lr")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA of trainable weights (0 = off; e.g. 0.999): "
                        "validation and the final model use the EMA-"
                        "merged weights")
    p.add_argument("--skip_nonfinite", action="store_true",
                   help="skip optimizer steps whose gradients contain "
                        "NaN/Inf (params and Adam moments untouched; "
                        "skips counted in the logged metrics)")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1,
                   help="accumulate gradients over N steps before each "
                        "optimizer update (the mean of the N gradients, "
                        "optax.MultiSteps' semantics)")
    p.add_argument("--debug_lr", type=float, default=5e-4)

    # Train-time augmentation (beyond the reference, whose pipeline is
    # Resize+ToTensor only, train.py:584-587), on the card inside the
    # train step (data/augment.py); off by default.
    p.add_argument("--hflip_prob", type=float, default=0.0,
                   help="per-image horizontal-flip probability (boxes "
                        "mirrored with the image); 0 = off")
    p.add_argument("--color_jitter", type=float, default=0.0,
                   help="brightness/contrast/saturation jitter strength "
                        "s: per-image factors ~ U[1-s, 1+s]; 0 = off")
    p.add_argument("--scale_jitter", type=float, default=0.0,
                   help="random zoom strength s: aspect-preserving scale "
                        "~ U[1-s, 1+s] with random placement (zoom-out "
                        "pads, zoom-in crops); boxes follow, clipped "
                        "boxes below --min_box_size are dropped; 0 = off")
    p.add_argument("--min_box_size", type=float, default=1e-3,
                   help="normalized min box side kept after scale jitter")
    p.add_argument("--save_on_preemption", type=str2bool, default=True,
                   help="on SIGTERM (pod preemption / cluster eviction): "
                        "checkpoint at the next step boundary and exit "
                        "cleanly; resume with --checkpoint restarts the "
                        "interrupted epoch")
    p.add_argument("--compilation_cache", type=str, default="",
                   help="the JAX package's XLA compilation cache; the "
                        "port compiles nothing ahead, so it raises")

    # coco-mini (reference train.py:1408-1419)
    p.add_argument("--use_coco_mini", action="store_true")
    p.add_argument("--coco_mini_size", type=str, default="1k")
    p.add_argument("--coco_mini_seed", type=int, default=42)
    p.add_argument("--coco_mini_indices_file", type=str, default="")
    p.add_argument("--test_mini", action="store_true")
    p.add_argument("--test_mini_size", type=int, default=30)

    # Model architecture (reference train.py:1421-1431)
    p.add_argument("--use_deformable", type=str2bool, default=True)
    p.add_argument("--backbone_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="backbone activation compute dtype; with "
                        "bfloat16 the frozen weights are also stored "
                        "bf16 (the forward casts them anyway). float32 "
                        "default matches the reference")
    p.add_argument("--backbone_prefix_int8", type=str2bool, default=False,
                   help="int8 (W8A8) forward for the frozen prefix "
                        "blocks during training: they are stop-"
                        "gradiented, so their forward is pure inference "
                        "and the serving quantization applies (adapted "
                        "suffix stays full precision)")
    p.add_argument("--aux_loss", type=str2bool, default=False,
                   help="deep supervision: match+score every intermediate "
                        "decoder layer (Deformable-DETR sec. 4); not in "
                        "the reference")
    p.add_argument("--share_aux_match", type=str2bool, default=False,
                   help="aux losses reuse the final decoder layer's "
                        "assignment instead of re-matching per layer "
                        "(cheaper at dense GT; DETR semantics is "
                        "per-layer matching)")
    p.add_argument("--n_points", type=int, default=2)
    p.add_argument("--dino_model", type=str, default="facebook/dinov2-base")
    # MoE backbone FFN (beyond reference; ops/moe.py), in the adapted
    # blocks. Expert parallelism is ROADMAP.md Queue A item 7.
    p.add_argument("--ffn_type", type=str, default=None,
                   choices=["mlp", "swiglu", "moe"],
                   help="override the backbone FFN type (default: the "
                        "ViT variant's — mlp, swiglu for giant); 'moe' "
                        "swaps in a mixture-of-experts FFN in the adapted "
                        "blocks")
    p.add_argument("--moe_experts", type=int,
                   default=8,
                   help="experts per MoE layer (with --ffn_type moe)")
    p.add_argument("--moe_top_k", type=int,
                   default=2,
                   help="experts routed per token")
    p.add_argument("--moe_capacity_factor", type=float,
                   default=1.25,
                   help="per-expert slot budget multiplier")
    p.add_argument("--moe_aux_weight", type=float,
                   default=0.01,
                   help="router load-balance loss weight")
    p.add_argument("--lightweight", action="store_true")
    p.add_argument("--skip_checkpoint_load", action="store_true")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--pretrained_backbone", type=str, default="",
                   help="path to an HF PyTorch DINOv2 checkpoint dir/file to import")
    p.add_argument("--import_reference_checkpoint", type=str, default="",
                   help="path to a full PyTorch reference (dino_detector) "
                        "detector checkpoint to migrate (backbone + LoRA + "
                        "decoder)")

    # Loss / matcher (reference train.py:1434-1445)
    p.add_argument("--set_cost_class", type=float, default=1.0)
    p.add_argument("--set_cost_bbox", type=float, default=5.0)
    p.add_argument("--set_cost_giou", type=float, default=2.0)
    p.add_argument("--focal_alpha", type=float, default=0.25)
    p.add_argument("--focal_gamma", type=float, default=2.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the default; raises without a card) or "
                        "'cpu'")
    p.add_argument("--num_classes", type=int, default=91)
    p.add_argument("--memory_monitor", action="store_true")
    p.add_argument("--num_workers", type=int, default=C.DataConfig.num_workers,
                   help="data-loading worker count (reference "
                        "config.py:8): decode/resize threads for the "
                        "threaded loader")
    p.add_argument("--checkpoint_frequency", type=int,
                   default=C.TrainConfig.checkpoint_every_epochs,
                   help="save a checkpoint every N epochs (reference "
                        "hardcodes 10, train.py:1279)")
    p.add_argument("--loader", type=str, default="threaded",
                   choices=["threaded"],
                   help="input pipeline backend (the threaded "
                        "prefetch loader, data/loader.py)")

    p.add_argument("--feed_dtype", type=str, default="uint8",
                   choices=["uint8", "float32"],
                   help="image feed dtype: uint8 ships raw bytes and "
                        "normalizes on the card (4x less host-to-device "
                        "traffic); float32 preprocesses on the host "
                        "(reference behavior)")
    p.add_argument("--decode_backend", type=str,
                   default="auto",
                   choices=["auto", "cv2", "pil"],
                   help="JPEG decode: auto = the native libjpeg decoder "
                        "(M/8 scaled decode; cv2, then PIL, where it does "
                        "not build); cv2 = reduced-scale cv2 path; pil = "
                        "exact reference pixels (forced by --parity_mode)")
    p.add_argument("--device_cache", action="store_true",
                   help="upload the whole train/val dataset to the card "
                        "once and gather batches there: one [K, B] index "
                        "copy a dispatch (the dataset must fit in the "
                        "card's free memory, else it raises)")
    p.add_argument("--device_cache_layout", type=str, default="auto",
                   choices=["auto", "replicated", "sharded"],
                   help="with --device_cache: the cache's placement; in "
                        "one process 'auto' is 'replicated' ('sharded' "
                        "needs data-parallel ranks and raises)")
    p.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="with --device_cache: train steps queued behind "
                        "one index copy")
    p.add_argument("--packed_train_data", type=str, default=None,
                   help="directory written by data/packed.py pack_dataset "
                        "(either package's): train from pre-decoded uint8 "
                        "memmaps; overrides --train_images/"
                        "--train_annotations")
    p.add_argument("--packed_val_data", type=str, default=None,
                   help="packed directory for the validation split")

    # Parity / quirk toggles
    p.add_argument("--parity_mode", action="store_true",
                   help="reproduce reference eval quirks (no box rescale, "
                        "contiguous category ids, class 0 skipped)")
    p.add_argument("--no_normalize", action="store_true",
                   help="skip ImageNet normalization (reference behavior)")
    p.add_argument("--ref_match_bug", action="store_true",
                   help="replicate the reference's batch-0 matching bug "
                        "(every image matched with image 0's predictions; "
                        "matching.py:102) for A/B accuracy studies")
    p.add_argument("--keep_cls_token", action="store_true",
                   help="keep the CLS token in the decoder memory, making "
                        "the deformable grid 65/257 tokens with non-square "
                        "factoring (reference behavior; the default drops "
                        "it — SURVEY.md §7.5 fix)")
    p.add_argument("--tie_decoder_layers", action="store_true",
                   help="tie all decoder layers to one weight instance "
                        "(reproduces the reference's accidental tying, "
                        "deformable_attention.py:284)")

    # Logging (reference train.py:1448-1461)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--log_frequency", type=int, default=10)
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--log_images", action="store_true")
    p.add_argument("--log_images_frequency", type=int, default=100)
    return p


def build_detector_config(args) -> C.DetectorConfig:
    if args.lightweight:
        cfg = C.lightweight_detector_config(
            num_classes=args.num_classes,
            use_deformable=args.use_deformable,
            n_points=args.n_points,
            image_size=args.image_size,
        )
    else:
        cfg = C.detector_config_for_model_name(
            args.dino_model,
            num_classes=args.num_classes,
            use_deformable=args.use_deformable,
            n_points=args.n_points,
            image_size=args.image_size,
        )
    if args.parity_mode:
        # Exact erf GELU (torch nn.GELU) for AP-parity runs; the default
        # tanh approximation deviates by <=5e-4 per activation.
        cfg = dataclasses.replace(
            cfg,
            backbone=dataclasses.replace(cfg.backbone, gelu_approximate=False),
        )
    if args.keep_cls_token:
        cfg = dataclasses.replace(
            cfg,
            backbone=dataclasses.replace(cfg.backbone, drop_cls_token=False),
        )
    if args.tie_decoder_layers:
        cfg = dataclasses.replace(
            cfg,
            decoder=dataclasses.replace(cfg.decoder, tie_layer_weights=True),
        )
    if args.aux_loss:
        cfg = dataclasses.replace(
            cfg, decoder=dataclasses.replace(cfg.decoder, aux_loss=True)
        )
    if args.backbone_dtype != cfg.backbone.dtype:
        cfg = dataclasses.replace(
            cfg,
            backbone=dataclasses.replace(cfg.backbone, dtype=args.backbone_dtype),
        )
    if args.backbone_prefix_int8:
        cfg = dataclasses.replace(
            cfg,
            backbone=dataclasses.replace(cfg.backbone, prefix_int8=True),
        )
    if args.ffn_type:
        cfg = dataclasses.replace(
            cfg,
            backbone=dataclasses.replace(
                cfg.backbone,
                ffn_type_override=args.ffn_type,
                moe_num_experts=args.moe_experts,
                moe_top_k=args.moe_top_k,
                moe_capacity_factor=args.moe_capacity_factor,
                moe_aux_weight=args.moe_aux_weight,
            ),
        )
    return cfg


# (the flag asked for, the ROADMAP.md item that ports it)
UNPORTED = (
    (lambda a: a.distributed or a.multihost or a.coordinator_address
     or a.num_processes, "--distributed/--multihost",
     "Queue A item 7 (multi-process layouts)"),
    (lambda a: a.model_parallel > 1, "--model_parallel > 1",
     "Queue A item 7 (tensor parallelism in the loop)"),
    (lambda a: a.context_parallel or a.context_parallel_size > 0,
     "--context_parallel*", "Queue A item 7"),
    (lambda a: (a.pipeline_parallel or a.pipeline_parallel_size > 0
                or a.pipeline_microbatches > 0 or a.pipeline_chunks != 1),
     "--pipeline_*", "Queue A item 7"),
    (lambda a: a.fsdp, "--fsdp", "Queue A item 7"),
    (lambda a: (a.download_train_data or a.download_val_data
                or a.download_test_data), "--download_*",
     "Queue A (tools/download.py needs the network; no port item)"),
    (lambda a: a.compilation_cache, "--compilation_cache",
     "Queue A (XLA's cache; torch has no counterpart)"),
)


def check_ported(args) -> None:
    for asked, flag, item in UNPORTED:
        if asked(args):
            raise NotImplementedError(
                f"{flag} is not ported to PyTorch yet (ROADMAP.md {item})")


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    check_ported(args)

    import torch

    from ..data.coco import CocoDetectionDataset, CocoTestDataset
    from ..models.detector import (cast_frozen_weights, fold_detector_lora,
                                   init_detector_params)
    from ..models.layers import resolve_device
    from ..models.quantize import quantize_detector_int8
    from ..utils.logging import setup_logger, setup_tensorboard
    from . import checkpoint as ckpt
    from .loop import (create_coco_mini, create_debug_subset,
                       evaluate_dataset, run_training, validate)
    from .state import create_train_state
    from .step import make_eval_topk_step

    if args.device not in ("cuda", "cpu"):
        raise ValueError(f"--device must be 'cuda' or 'cpu', not "
                         f"{args.device!r}")
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    logger = setup_logger(args.log_dir or args.output_dir)
    writer = setup_tensorboard(args.log_dir or args.output_dir,
                               args.experiment_name)

    det_cfg = build_detector_config(args)
    normalize = not (args.no_normalize or args.parity_mode)
    # Debug mode: higher lr, more epochs (reference config.py:11-14,
    # train.py:1028-1034).
    num_epochs = args.num_epochs
    learning_rate = args.learning_rate
    if args.debug:
        num_epochs = num_epochs or 100
        learning_rate = learning_rate or args.debug_lr
    cfg = C.TrainConfig(
        detector=det_cfg,
        data=C.DataConfig(batch_size=args.batch_size, normalize=normalize,
                          num_workers=args.num_workers),
        optim=C.OptimConfig(
            gradient_accumulation_steps=args.gradient_accumulation_steps,
            lr_schedule=args.lr_schedule,
            warmup_steps=args.warmup_steps,
            min_lr_ratio=args.min_lr_ratio,
            ema_decay=args.ema_decay,
            skip_nonfinite=args.skip_nonfinite,
        ),
        matcher=C.MatcherConfig(
            cost_class=args.set_cost_class, cost_bbox=args.set_cost_bbox,
            cost_giou=args.set_cost_giou, focal_alpha=args.focal_alpha,
            focal_gamma=args.focal_gamma,
            replicate_batch0_bug=args.ref_match_bug,
        ),
        loss=C.LossConfig(focal_alpha=args.focal_alpha,
                          focal_gamma=args.focal_gamma),
        augment=C.AugmentConfig(
            hflip_prob=args.hflip_prob, color_jitter=args.color_jitter,
            scale_jitter=args.scale_jitter, min_box_size=args.min_box_size),
        share_aux_match=args.share_aux_match,
        num_epochs=num_epochs or 50,
        checkpoint_every_epochs=args.checkpoint_frequency,
        save_on_preemption=args.save_on_preemption,
    )
    logger.info("device: %s", device)
    logger.info("detector config: %s", det_cfg)
    # Model init (+ optional pretrained backbone or full reference import).
    params = init_detector_params(torch.Generator().manual_seed(cfg.seed),
                                  det_cfg, device=device)
    if args.import_reference_checkpoint:
        from ..models.import_reference import load_reference_detector_params

        params = load_reference_detector_params(
            args.import_reference_checkpoint, det_cfg, params)
        logger.info("migrated full reference checkpoint from %s",
                    args.import_reference_checkpoint)
    elif args.pretrained_backbone:
        from ..models.import_torch import load_dinov2_backbone_params

        params["backbone"] = load_dinov2_backbone_params(
            args.pretrained_backbone, det_cfg.backbone, params["backbone"])
        logger.info("imported pretrained backbone from %s",
                    args.pretrained_backbone)
    else:
        logger.warning("no --pretrained_backbone given: the backbone is "
                       "randomly initialized (nothing is downloaded)")
    if det_cfg.backbone.dtype == "bfloat16":
        # As the loop stores them (and saves them): the restore template's
        # dtypes are the checkpoint's.
        params = cast_frozen_weights(params, det_cfg)

    # Checkpoint resume (reference train.py:686-747).
    start_epoch, start_batch, restored_opt, restored_ema, history = (
        0, 0, None, None, None)
    if args.checkpoint and not args.skip_checkpoint_load:
        template = create_train_state(params, cfg.optim, det_cfg)
        restored = ckpt.restore_checkpoint(
            args.checkpoint, params, template.opt_state, template.ema)
        params, restored_opt, restored_ema = (
            restored.params, restored.opt_state, restored.ema)
        start_epoch, history = restored.start_epoch, restored.metrics_history
        # A preemption checkpoint records how many steps of the
        # interrupted epoch ran; the loop skips them (exact resume).
        start_batch = int(history.pop("_preempt_batch_index", 0))
        logger.info("resumed from %s at epoch %d%s (step %d)",
                    args.checkpoint, start_epoch,
                    f" batch {start_batch}" if start_batch else "",
                    restored.step)

    ds_kwargs = dict(normalize=normalize, output_dtype=args.feed_dtype,
                     decode_backend=("pil" if args.parity_mode
                                     else args.decode_backend))

    def packed(path, indices=None):
        from ..data.packed import PackedDataset

        return PackedDataset(path, indices=indices,
                             output_dtype=args.feed_dtype,
                             normalize=normalize, image_size=args.image_size,
                             max_boxes=cfg.data.max_boxes)

    # ------------------------------------------------------------------
    # only_evaluate (reference train.py:750-890)
    # ------------------------------------------------------------------
    if args.only_evaluate:
        if args.quantize == "int8":
            params = quantize_detector_int8(
                fold_detector_lora(params, det_cfg), det_cfg)
            logger.info("evaluating with the int8-quantized backbone (W8A8)")
        eval_step = make_eval_topk_step(cfg, parity_mode=args.parity_mode)
        if args.testdev_images:
            ds = CocoTestDataset(args.testdev_images, None, args.image_size,
                                 **ds_kwargs)
            if args.test_mini:
                idx = create_debug_subset(len(ds), args.test_mini_size)
                with open(os.path.join(args.output_dir,
                                       "test_mini_indices.json"), "w") as f:
                    json.dump({"indices": idx}, f)
                ds = CocoTestDataset(args.testdev_images, None,
                                     args.image_size, indices=idx,
                                     **ds_kwargs)
            out_file = os.path.join(args.output_dir,
                                    "testdev_predictions.json")
            results = evaluate_dataset(
                eval_step, params, ds, args.batch_size, ds.label_to_cat_id,
                output_file=out_file, parity_mode=args.parity_mode)
            logger.info("wrote %d detections to %s", len(results), out_file)
            return 0
        if args.packed_val_data:
            make_val = lambda idx=None: packed(args.packed_val_data, idx)
        elif args.val_images:
            make_val = lambda idx=None: CocoDetectionDataset(
                args.val_images, args.val_annotations, args.image_size,
                indices=idx, **ds_kwargs)
        else:
            logger.error("--only_evaluate needs --val_images, "
                         "--packed_val_data or --testdev_images")
            return 1
        ds = make_val()
        indices = None
        if args.use_coco_mini:
            indices = create_coco_mini(
                len(ds), args.coco_mini_size, args.coco_mini_seed,
                args.coco_mini_indices_file, args.output_dir)
        elif args.debug:
            indices = create_debug_subset(len(ds), args.debug_samples)
        if indices is not None:
            ds = make_val(indices)
        metrics = validate(eval_step, params, ds, args.batch_size,
                           start_epoch, args.output_dir,
                           parity_mode=args.parity_mode)
        logger.info("evaluation metrics: %s", metrics)
        return 0

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    if not args.packed_train_data and (
            not args.train_images or not args.train_annotations):
        logger.error("--train_images and --train_annotations are required "
                     "(or --packed_train_data)")
        return 1

    def make_train_ds(indices=None):
        if args.packed_train_data:
            return packed(args.packed_train_data, indices)
        return CocoDetectionDataset(
            args.train_images, args.train_annotations, args.image_size,
            max_boxes=cfg.data.max_boxes, indices=indices, **ds_kwargs)

    train_ds = make_train_ds()
    indices = None
    if args.debug:
        indices = create_debug_subset(len(train_ds), args.debug_samples)
        logger.info("debug mode: %d-sample overfit subset", len(indices))
    elif args.use_coco_mini:
        indices = create_coco_mini(
            len(train_ds), args.coco_mini_size, args.coco_mini_seed,
            args.coco_mini_indices_file, args.output_dir)
    if indices is not None:
        train_ds = make_train_ds(indices)

    val_ds = None
    if args.packed_val_data:
        val_ds = packed(args.packed_val_data)
    elif args.val_images and args.val_annotations:
        val_ds = CocoDetectionDataset(
            args.val_images, args.val_annotations, args.image_size,
            max_boxes=cfg.data.max_boxes, **ds_kwargs)
        if args.debug:
            # Debug mode validates on the train subset (an overfit check,
            # reference train.py:897-900).
            val_ds = train_ds

    val_freq = args.val_frequency
    if args.debug:
        val_freq = max(1, args.val_frequency // 5)  # reference train.py:1030

    run_training(
        cfg, params, train_ds, val_ds, args.output_dir, writer=writer,
        num_epochs=num_epochs, learning_rate=learning_rate,
        start_epoch=start_epoch, start_batch=start_batch,
        restored_opt_state=restored_opt, restored_ema=restored_ema,
        metrics_history=history, val_frequency=val_freq,
        log_frequency=args.log_frequency,
        memory_monitor=args.memory_monitor, parity_mode=args.parity_mode,
        log_images_enabled=args.log_images,
        log_images_frequency=args.log_images_frequency,
        device_cache=args.device_cache,
        steps_per_dispatch=args.steps_per_dispatch,
        device_cache_layout=args.device_cache_layout,
    )
    if writer is not None:
        writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
