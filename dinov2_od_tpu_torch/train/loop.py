"""Training orchestration: dataset subsets, the epoch loop, validation with
COCO AP, checkpoints, plots (counterpart of dinov2_od_tpu/train/loop.py;
the reference's dino_detector/train.py main_worker, :514-1351). The engine
behind the CLI (train/cli.py), in one process on one device: the device
of the params.

Files written under `output_dir`, per epoch N:
- `train_epoch_N.json`: the epoch's global steps, each step's loss, its
  mean, the images/s of the loop (loader, copies, steps) and the steps
  the non-finite guard skipped; under the MoE FFN also each step's
  router load-balance loss (`loss_moe_aux`) and its mean;
- `predictions_epoch_N.json`, `metrics_epoch_N.json`: the validation's
  detections and its twelve COCO stats (AP, AP50, AP75, ...);
- `checkpoint_epoch_N/` (train/checkpoint.py), and `final_model/` at the
  end of an uninterrupted run.

Dropout and the augmentation's draws are a function of (seed, step):
before each step the loop seeds its generator with
`step_seed(cfg.seed, state.step)`, so a run resumed at a step draws what
the uninterrupted run drew there (the JAX loop folds `state.step` into
its key for the same reason). With the preemption checkpoint's batch
index, a resumed run repeats the uninterrupted one; on the CPU bit for
bit, on CUDA up to the atomics of the deformable gathers' backward.

With `device_cache` the training set lives on the card
(train/device_cache.py): each dispatch copies one [K, B] index tensor and
queues K steps on it, and the previous dispatch's stacked metrics are
read while the card runs the next; validation runs from a cache of the
validation set, its top-k copied back once.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..data.loader import DataLoader, device_prefetch, pad_batch
from ..evaluation.coco_metrics import CocoEvaluator
from ..evaluation.postprocess import format_detections
from ..models.detector import cast_frozen_weights
from ..utils.logging import log_images, log_metrics
from ..utils.memory import format_memory_stats
from . import checkpoint as ckpt
from .preemption import PreemptionGuard
from .state import (TrainState, create_train_state, lr_schedule_fn,
                    merge_ema, tree_leaves, tree_map)
from .step import make_eval_topk_step, make_train_step, step_seed

logger = logging.getLogger("dinov2_od_tpu_torch")

TRAIN_KEYS = ("images", "boxes", "labels", "valid")


def params_device(params) -> torch.device:
    return tree_leaves(params)[0].device


# ---------------------------------------------------------------------------
# Dataset subsets (reference train.py:50-216)
# ---------------------------------------------------------------------------

def create_debug_subset(n_total: int, n_samples: int,
                        seed: int = 42) -> List[int]:
    """Seeded debug/overfit subset (reference train.py:50-84; seed 42)."""
    rng = np.random.default_rng(seed)
    n = min(n_samples, n_total)
    return sorted(rng.choice(n_total, size=n, replace=False).tolist())


def create_coco_mini(n_total: int, size: str = "1k", seed: int = 42,
                     indices_file: str = "", save_dir: str = "") -> List[int]:
    """coco-mini subset with persisted, reloadable indices (reference
    train.py:86-216)."""
    if indices_file:
        with open(indices_file) as f:
            data = json.load(f)
        indices = data["indices"] if isinstance(data, dict) else data
        logger.info("coco_mini: loaded %d indices from %s", len(indices),
                    indices_file)
        return indices
    sizes = {"1k": 1000, "5k": 5000, "10k": 10000}
    n = sizes.get(size, int(size) if str(size).isdigit() else 1000)
    n = min(n, n_total)
    rng = np.random.default_rng(seed)
    indices = sorted(rng.choice(n_total, size=n, replace=False).tolist())
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        out = os.path.join(save_dir, f"coco_mini_indices_{size}_{seed}.json")
        with open(out, "w") as f:
            json.dump({"indices": indices, "size": size, "seed": seed}, f)
        logger.info("coco_mini: saved %d indices to %s", len(indices), out)
    return indices


# ---------------------------------------------------------------------------
# Evaluation (reference utils.py:167-240, train.py:248-286)
# ---------------------------------------------------------------------------

def evaluate_dataset(
    eval_topk_step,
    params,
    dataset,
    batch_size: int,
    label_to_cat_id: Dict[int, int],
    output_file: Optional[str] = None,
    score_threshold: float = 0.05,
    parity_mode: bool = False,
) -> List[dict]:
    """Inference over a dataset -> COCO result dicts (and a JSON file).

    `eval_topk_step` (train/step.py `make_eval_topk_step`) runs the
    forward and the top-k on the device and gives one [B, K, 6] tensor a
    batch. A loader thread decodes batch i+1 and a prefetch thread copies
    it to the device while batch i runs; batch i-1's top-k is copied back
    after batch i is issued, so decode, copy in, compute and copy out
    overlap. A trailing partial batch is padded to `batch_size`."""
    device = params_device(params)
    loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False)
    results: List[dict] = []

    def pad(batch):
        n = len(batch["images"])
        batch = pad_batch(batch, batch_size)
        batch["_n"] = n
        return batch

    def readback(out, batch):
        n = batch["_n"]
        topk = out["topk"][:n].cpu().numpy()  # the one copy to the host
        return format_detections(
            topk[..., 0], topk[..., 1].astype(np.int32), topk[..., 2:],
            batch["image_id"][:n], label_to_cat_id,
            score_threshold=score_threshold, parity_mode=parity_mode)

    pending: deque = deque()
    for batch in device_prefetch(iter(loader), device, size=2,
                                 device_keys=("images", "orig_size"),
                                 transform=pad):
        out = eval_topk_step(params, batch["images"], batch["orig_size"])
        pending.append((out, batch))
        if len(pending) > 1:
            results.extend(readback(*pending.popleft()))
    while pending:
        results.extend(readback(*pending.popleft()))
    if output_file:
        with open(output_file, "w") as f:
            json.dump(results, f)
    return results


def validate(
    eval_topk_step,
    params,
    dataset,
    batch_size: int,
    epoch: int,
    output_dir: str,
    parity_mode: bool = False,
    evaluator: Optional[CocoEvaluator] = None,
) -> Dict[str, float]:
    """A validation pass: predictions_epoch_N.json and
    metrics_epoch_N.json under `output_dir` (reference train.py:248-286).
    `eval_topk_step` must be built with the same parity_mode. Pass the
    run's `evaluator` to parse the GT file once a run."""
    os.makedirs(output_dir, exist_ok=True)
    results = evaluate_dataset(
        eval_topk_step, params, dataset, batch_size, dataset.label_to_cat_id,
        output_file=os.path.join(output_dir,
                                 f"predictions_epoch_{epoch}.json"),
        parity_mode=parity_mode)
    evaluator = evaluator or CocoEvaluator(dataset.coco_path)
    return _write_metrics(evaluator.evaluate(results), epoch, output_dir)


def _write_metrics(metrics: Dict[str, float], epoch: int,
                   output_dir: str) -> Dict[str, float]:
    with open(os.path.join(output_dir, f"metrics_epoch_{epoch}.json"),
              "w") as f:
        json.dump(metrics, f)
    logger.info("epoch %d validation: %s", epoch, metrics)
    return metrics


def validate_cached(eval_all, params, val_cache, dataset, epoch: int,
                    output_dir: str, evaluator: CocoEvaluator,
                    parity_mode: bool = False) -> Dict[str, float]:
    """`validate` over the validation set's cache on the card
    (train/device_cache.py): one copy of the top-k to the host, the
    predictions file and the COCO stats from flat arrays."""
    from .device_cache import evaluate_cached

    os.makedirs(output_dir, exist_ok=True)
    cache, ids, n = val_cache
    arrays = evaluate_cached(
        eval_all, params, cache, ids, n, dataset.label_to_cat_id,
        output_file=os.path.join(output_dir,
                                 f"predictions_epoch_{epoch}.json"),
        parity_mode=parity_mode, return_arrays=True)
    return _write_metrics(evaluator.evaluate_arrays(*arrays), epoch,
                          output_dir)


def plot_history(history: Dict[str, Any], output_dir: str) -> None:
    """Loss and AP curves (reference train.py:288-321), when matplotlib is
    installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    os.makedirs(output_dir, exist_ok=True)
    if history.get("train_loss"):
        plt.figure()
        plt.plot(history["epochs"], history["train_loss"], label="train loss")
        plt.xlabel("epoch"); plt.ylabel("loss"); plt.legend(); plt.grid(True)
        plt.savefig(os.path.join(output_dir, "loss_plot.png"))
        plt.close()
    if history.get("val_AP"):
        plt.figure()
        for key in ("val_AP", "val_AP50", "val_AP75"):
            if history.get(key):
                plt.plot(history["val_epochs"], history[key], label=key)
        plt.xlabel("epoch"); plt.ylabel("AP"); plt.legend(); plt.grid(True)
        plt.savefig(os.path.join(output_dir, "ap_plot.png"))
        plt.close()


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------

def _fill_lr_horizon(cfg: TrainConfig, n_train: int, num_epochs: int,
                     learning_rate: Optional[float]) -> TrainConfig:
    """The learning rate override, and the decay horizon (optimizer
    updates over the run) when a schedule needs one and none is set."""
    optim = cfg.optim
    if learning_rate is not None:
        optim = dataclasses.replace(optim, learning_rate=learning_rate)
    if ((optim.lr_schedule != "constant" or optim.warmup_steps > 0)
            and optim.total_steps == 0):
        spe = max(1, n_train // cfg.data.batch_size)
        total = max(1, spe * num_epochs
                    // max(1, optim.gradient_accumulation_steps))
        optim = dataclasses.replace(optim, total_steps=total)
        logger.info("lr schedule %s: warmup %d, total %d optimizer steps",
                    optim.lr_schedule, optim.warmup_steps, total)
    return dataclasses.replace(cfg, optim=optim)


def run_training(
    cfg: TrainConfig,
    params,
    train_dataset,
    val_dataset,
    output_dir: str,
    writer=None,
    num_epochs: Optional[int] = None,
    learning_rate: Optional[float] = None,
    start_epoch: int = 0,
    start_batch: int = 0,
    restored_opt_state=None,
    restored_ema=None,
    metrics_history: Optional[Dict[str, Any]] = None,
    val_frequency: int = 5,
    log_frequency: int = 10,
    checkpoint_every: Optional[int] = None,
    memory_monitor: bool = False,
    parity_mode: bool = False,
    log_images_enabled: bool = False,
    log_images_frequency: int = 100,
    device_cache: bool = False,
    steps_per_dispatch: int = 8,
    device_cache_layout: str = "auto",
) -> TrainState:
    """Train `params` (on their device) for epochs start_epoch ..
    num_epochs - 1, from batch `start_batch` of the first; validate every
    `val_frequency` epochs and checkpoint every `checkpoint_every`. With
    `device_cache`, from the training set on the card, K =
    `steps_per_dispatch` steps a dispatch. Returns the final state
    (params updated in place)."""
    os.makedirs(output_dir, exist_ok=True)
    num_epochs = num_epochs or cfg.num_epochs
    if checkpoint_every is None:
        checkpoint_every = cfg.checkpoint_every_epochs
    history = metrics_history or {
        "epochs": [], "train_loss": [],
        "val_epochs": [], "val_AP": [], "val_AP50": [], "val_AP75": [],
    }
    device = params_device(params)
    if cfg.detector.backbone.dtype == "bfloat16":
        # The forward casts the frozen weights to bf16 anyway; stored so,
        # the per-step casts go and their reads halve. LoRA, the decoder
        # and the norms stay fp32.
        params = cast_frozen_weights(params, cfg.detector)

    cfg = _fill_lr_horizon(cfg, len(train_dataset), num_epochs,
                           learning_rate)
    lr_sched = lr_schedule_fn(cfg.optim, cfg.optim.learning_rate)
    state = create_train_state(params, cfg.optim, cfg.detector)
    if restored_opt_state is not None:
        state.opt_state = restored_opt_state
    if restored_ema is not None and state.ema is not None:
        state.ema = restored_ema
    train_step = make_train_step(cfg)
    eval_step = make_eval_topk_step(cfg, parity_mode=parity_mode)
    evaluator = None
    val_cache = None
    if device_cache:
        from . import device_cache as dc

        cache = dc.upload_train_cache(train_dataset, device,
                                      device_cache_layout)
        multi_step = dc.make_multi_train_step(cfg, train_step)
        eval_all = dc.make_cached_eval(cfg, parity_mode=parity_mode)

    loader = DataLoader(train_dataset, cfg.data.batch_size, shuffle=True,
                        seed=cfg.seed, drop_last=True,
                        num_workers=cfg.data.num_workers)
    steps_per_epoch = len(loader)
    global_step = start_epoch * max(steps_per_epoch, 1) + start_batch
    state.step = global_step
    generator = torch.Generator(device=device)

    guard = PreemptionGuard() if cfg.save_on_preemption else None
    preempted = False
    steps_done = start_batch  # completed steps of the current epoch

    def check_preempt(epoch: int) -> bool:
        nonlocal preempted
        if guard is None or not guard.triggered or preempted:
            return preempted
        preempted = True
        # Epoch - 1 in the metadata makes the restore resume at `epoch`;
        # the sidecar's batch index lets the CLI skip the steps that ran.
        path = ckpt.save_checkpoint(
            output_dir, epoch - 1, state.params, state.opt_state,
            float("nan"), {**history, "_preempt_batch_index": steps_done},
            name=f"checkpoint_epoch_{max(epoch - 1, 0)}",
            step=state.step, ema=state.ema)
        logger.warning("preemption checkpoint saved: %s (resume with "
                       "--checkpoint to continue epoch %d at batch %d)",
                       path, epoch, steps_done)
        return True

    if guard is not None:
        guard.install()
    for epoch in range(start_epoch, num_epochs):
        steps_done = start_batch if epoch == start_epoch else 0
        if check_preempt(epoch):
            break
        epoch_skip = steps_done
        losses, skips, steps, moe_aux = [], [], [], []
        t_epoch = time.perf_counter()

        def log_step(scalars, i):
            logger.info(
                "epoch %d batch %d/%d loss %.4f (ce %.4f bbox %.4f "
                "giou %.4f)%s%s", epoch, i, steps_per_epoch,
                scalars["loss"], scalars["loss_ce"],
                scalars["loss_bbox"], scalars["loss_giou"],
                (f" moe_aux {scalars['loss_moe_aux']:.4f}"
                 if "loss_moe_aux" in scalars else ""),
                " nonfinite_skip" if scalars.get("nonfinite_skip")
                else "")
            if lr_sched is not None:
                scalars["lr"] = float(lr_sched(int(state.opt_state.count)))
            log_metrics(writer, scalars, global_step, prefix="train/")
            if memory_monitor:
                logger.info("memory:\n%s", format_memory_stats())

        def logged(metrics) -> dict:
            return {k: v for k, v in metrics.items()
                    if k.startswith("loss") or k in ("grad_norm",
                                                     "nonfinite_skip")}

        if device_cache:
            groups = dc.epoch_index_groups(
                len(train_dataset), cfg.data.batch_size, steps_per_dispatch,
                cfg.seed, epoch, skip=epoch_skip)
            pending = None  # the last dispatch's (first batch, metrics)

            def read(first, metrics):
                # One copy of the stacked [K] metrics to the host.
                host = {k: v.cpu() for k, v in logged(metrics).items()}
                losses.append(host["loss"])
                if "nonfinite_skip" in host:
                    skips.append(host["nonfinite_skip"])
                if "loss_moe_aux" in host:
                    moe_aux.append(host["loss_moe_aux"])
                k = len(host["loss"])
                if (first // log_frequency != (first + k) // log_frequency
                        or first == epoch_skip):
                    log_step({n: float(v[-1]) for n, v in host.items()},
                             first + k - 1)

            for group in groups:
                idxs = dc.index_tensor(group, device)
                steps.extend(range(state.step, state.step + len(group)))
                state, metrics = multi_step(state, cache, idxs, generator)
                global_step += len(group)
                first, steps_done = steps_done, steps_done + len(group)
                if pending is not None:
                    read(*pending)
                pending = (first, metrics)
                if guard is not None and guard.triggered:
                    break
                if (log_images_enabled and writer is not None
                        and first // log_images_frequency
                        != steps_done // log_images_frequency):
                    idx = idxs[-1]
                    log_images(writer, cache["images"][idx].float().cpu()
                               .numpy(), global_step, tag="train/images",
                               gt_boxes=cache["boxes"][idx].cpu().numpy(),
                               gt_valid=cache["valid"][idx].cpu().numpy())
            if pending is not None:
                read(*pending)
        else:
            loader.set_epoch(epoch)
            batches = device_prefetch(iter(loader), device, size=2,
                                      device_keys=TRAIN_KEYS)
            for i, batch in enumerate(batches):
                if i < epoch_skip:
                    # Exact mid-epoch resume: skip the steps the
                    # interrupted run completed (the loader's order is
                    # deterministic).
                    continue
                generator.manual_seed(step_seed(cfg.seed, state.step))
                steps.append(state.step)
                state, metrics = train_step(
                    state, {k: batch[k] for k in TRAIN_KEYS}, generator)
                global_step += 1
                steps_done = i + 1
                if guard is not None and guard.triggered:
                    break  # checkpoint and a clean exit below
                # Device scalars; read once an epoch.
                losses.append(metrics["loss"])
                if "nonfinite_skip" in metrics:
                    skips.append(metrics["nonfinite_skip"])
                if "loss_moe_aux" in metrics:
                    moe_aux.append(metrics["loss_moe_aux"])
                if i % log_frequency == 0:
                    log_step({k: float(v)
                              for k, v in logged(metrics).items()}, i)
                if (log_images_enabled and writer is not None
                        and global_step % log_images_frequency == 0):
                    log_images(writer, batch["images"].float().cpu().numpy(),
                               global_step, tag="train/images",
                               gt_boxes=batch["boxes"].cpu().numpy(),
                               gt_valid=batch["valid"].cpu().numpy())
            batches.close()

        if check_preempt(epoch):
            break

        # One copy to the host for the whole epoch (the cache's dispatches
        # were read already).
        def host_list(xs):
            return (torch.cat([x.reshape(-1) for x in xs]).float().cpu()
                    .tolist() if xs else [])

        loss_list = host_list(losses)
        n_skipped = (int(torch.cat([x.reshape(-1) for x in skips]).sum())
                     if skips else 0)
        epoch_loss = float(np.mean(loss_list)) if loss_list else float("nan")
        images_per_sec = (len(loss_list) * cfg.data.batch_size
                          / max(time.perf_counter() - t_epoch, 1e-9))
        record = {"epoch": epoch, "steps": steps[:len(loss_list)],
                  "losses": loss_list, "mean_loss": epoch_loss,
                  "images_per_sec": images_per_sec,
                  "nonfinite_skips": n_skipped}
        if moe_aux:
            # The MoE router's load-balance loss of each step, unweighted.
            record["loss_moe_aux"] = host_list(moe_aux)
            record["mean_loss_moe_aux"] = float(
                np.mean(record["loss_moe_aux"]))
        logger.info("epoch %d done: mean loss %.4f%s, %.1f images/sec, %d "
                    "non-finite steps skipped", epoch, epoch_loss,
                    (f", mean moe_aux {record['mean_loss_moe_aux']:.4f}"
                     if moe_aux else ""), images_per_sec, n_skipped)
        with open(os.path.join(output_dir, f"train_epoch_{epoch}.json"),
                  "w") as f:
            json.dump(record, f)
        history["epochs"].append(epoch)
        history["train_loss"].append(epoch_loss)
        log_metrics(writer, {"epoch_loss": epoch_loss,
                             "images_per_sec": images_per_sec,
                             "nonfinite_skips": n_skipped},
                    epoch, prefix="epoch/")

        if val_dataset is not None and (epoch + 1) % val_frequency == 0:
            eval_params = state.params
            if state.ema is not None:
                # Validate the EMA weights (what serving would use).
                eval_params = merge_ema(state.params, state.ema,
                                        cfg.detector)
            # Detached, as a restored checkpoint's are: `torch.matmul`
            # folds a 3-D input into one GEMM only for a weight that does
            # not require grad, and the validation should give the saved
            # model's detections to the bit.
            eval_params = tree_map(torch.Tensor.detach, eval_params)
            if evaluator is None:
                evaluator = CocoEvaluator(val_dataset.coco_path)
            if device_cache:
                if val_cache is None:  # uploaded at the first validation
                    val_cache = dc.upload_eval_cache(
                        val_dataset, cfg.data.batch_size, device,
                        device_cache_layout)
                metrics = validate_cached(
                    eval_all, eval_params, val_cache, val_dataset, epoch,
                    output_dir, evaluator, parity_mode=parity_mode)
            else:
                metrics = validate(eval_step, eval_params, val_dataset,
                                   cfg.data.batch_size, epoch, output_dir,
                                   parity_mode=parity_mode,
                                   evaluator=evaluator)
            history["val_epochs"].append(epoch)
            for k in ("AP", "AP50", "AP75"):
                history[f"val_{k}"].append(metrics[k])
            log_metrics(writer, metrics, epoch, prefix="val/")
            plot_history(history, output_dir)

        if (epoch + 1) % checkpoint_every == 0 or epoch == num_epochs - 1:
            path = ckpt.save_checkpoint(
                output_dir, epoch, state.params, state.opt_state,
                epoch_loss, history, async_save=True, step=state.step,
                ema=state.ema)
            logger.info("checkpoint save started: %s", path)

    if guard is not None:
        guard.uninstall()
    ckpt.wait_for_saves()
    if preempted:
        # The preemption checkpoint is the resume point, not a final
        # model.
        return state
    final_params = state.params
    if state.ema is not None:
        final_params = merge_ema(state.params, state.ema, cfg.detector)
    ckpt.save_final_params(output_dir, final_params)
    plot_history(history, output_dir)
    return state
