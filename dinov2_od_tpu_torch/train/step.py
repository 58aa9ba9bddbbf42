"""The train step (counterpart of dinov2_od_tpu/train/step.py): forward in
train mode, matching and the set loss (with the auxiliary layers' terms),
backward through the decoder and the adapted backbone blocks, global-norm
clipping, L2 weight decay and masked Adam.

Where the JAX package compiles the whole step into one XLA program, the
port runs it eagerly: the matcher copies each criterion call's cost
matrix to the host once (ops/hungarian.py), and the parameters are
updated in place under `torch.no_grad()`.

Under a ('data', 'model') mesh (parallel/) each rank runs the step on its
batch slice and its param shard, as GSPMD runs the JAX step: the forward
places its tensor-parallel collectives itself, each rank matches its own
(model-replicated) predictions, the partial gradients of replicated
leaves are summed over the model group and every gradient over the data
group, and the optimizer updates the shards.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import TrainConfig
from ..inference import IMAGENET_MEAN, IMAGENET_STD
from ..models.detector import detector_apply
from ..ops.losses import set_criterion
from ..parallel.collectives import all_reduce_coalesced_, reduce_gradients
from ..parallel.sharding import check_tp_compatible, leaf_paths
from .state import (
    TrainState,
    global_norm,
    mask_gradients,
    optimizer_update,
    trainable_leaves,
    tree_leaves,
    tree_unflatten,
    update_ema,
)

Batch = Dict[str, torch.Tensor]
# Batch keys, all on the params' device:
#   images: [B, H, W, 3] float32 (preprocessed) or uint8 (raw bytes)
#   labels: [B, G] int; boxes: [B, G, 4] float32 cxcywh in [0, 1];
#   valid: [B, G] bool


def prep_images(images: torch.Tensor, normalize: bool) -> torch.Tensor:
    """uint8 feeds become fp32 / 255, ImageNet-normalised when `normalize`;
    float feeds are taken as already preprocessed and pass through."""
    if images.dtype.is_floating_point:
        return images
    x = images.float() / 255.0
    if normalize:
        mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
        std = torch.as_tensor(IMAGENET_STD, device=x.device)
        x = (x - mean) / std
    return x


def train_loss(cfg: TrainConfig, params, batch: Batch,
               generator: Optional[torch.Generator] = None, *,
               attn_impl: str = "auto", mesh=None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, loss terms) of one batch in train mode. Each auxiliary
    decoder layer is matched on its own, or reuses the final layer's
    assignment when cfg.share_aux_match, and adds its loss to the total
    (also reported as loss_aux_i). Under `mesh`, params are this rank's
    shard and the batch its slice: the loss is its share of the global
    one."""
    det_cfg = cfg.detector
    images = prep_images(batch["images"], cfg.data.normalize)
    out = detector_apply(params, det_cfg, images, generator=generator,
                         deterministic=False, attn_impl=attn_impl, mesh=mesh)
    kw = dict(matcher_cfg=cfg.matcher, loss_cfg=cfg.loss,
              num_classes=det_cfg.decoder.num_classes, mesh=mesh)
    gt = (batch["labels"], batch["boxes"], batch["valid"])
    losses, final_match = set_criterion(out["pred_logits"], out["pred_boxes"],
                                        *gt, return_match=True, **kw)
    total = losses["loss"]
    for i, aux in enumerate(out.get("aux_outputs", [])):
        aux_losses = set_criterion(
            aux["pred_logits"], aux["pred_boxes"], *gt,
            match=final_match if cfg.share_aux_match else None, **kw)
        total = total + aux_losses["loss"]
        losses[f"loss_aux_{i}"] = aux_losses["loss"]
    losses["loss"] = total
    return total, losses


def train_grads(cfg: TrainConfig, state: TrainState, batch: Batch,
                generator: Optional[torch.Generator] = None, *,
                attn_impl: str = "auto", mesh=None):
    """(loss terms, masked gradients) of one batch, the gradients a tree
    shaped as the params with None at frozen leaves. Under `mesh`: this
    rank's shard of the logical gradients (partial replicated ones summed
    over the model group, all of them over the data group) and the loss
    terms of the global batch."""
    params = state.params
    total, losses = train_loss(cfg, params, batch, generator,
                               attn_impl=attn_impl, mesh=mesh)
    grads = list(torch.autograd.grad(
        total, trainable_leaves(params, state.opt_state),
        materialize_grads=True))
    losses = {k: v.detach() for k, v in losses.items()}
    if mesh is not None:
        reduce_gradients(grads, leaf_paths(state.opt_state.mu), mesh)
        if mesh.data_size > 1:
            # Each rank's terms are its share of the global sums; the box
            # count is global already.
            terms = [v for k, v in losses.items() if k != "num_boxes"]
            all_reduce_coalesced_(terms, mesh.data_group, mesh.backend)
    grads = tree_unflatten(state.opt_state.mu, grads)
    return losses, mask_gradients(grads, params, cfg.detector)


def _check_supported(cfg: TrainConfig) -> None:
    unported = {
        "gradient_accumulation_steps > 1":
            cfg.optim.gradient_accumulation_steps > 1,
        "use_remat": cfg.use_remat,
        "train-time augmentation": cfg.augment.enabled,
        "lora_mode='fold' (serving only)":
            cfg.detector.backbone.lora_mode != "factored",
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(
                f"{what} is not ported to the PyTorch train step yet "
                f"(ROADMAP.md)")


def make_train_step(cfg: TrainConfig, mesh=None):
    """The train step: step(state, batch, generator) -> (state, metrics).

    `generator` (on the params' device) drives dropout. The step updates
    `state.params` in place under torch.no_grad() and returns the state
    with the new step count, Adam state and EMA. Metrics are 0-dim tensors:
    the loss terms, 'grad_norm' (of the masked gradients) and, with
    cfg.optim.skip_nonfinite, 'nonfinite_skip' (1 when a gradient held NaN
    or Inf: params, moments and EMA then keep their values; the check
    waits for the device).

    Under `mesh` (parallel/sharding.py `create_mesh`, its model axis of
    cfg.mesh.model_parallel_size) every rank calls the step with its state
    of param shards (`shard_params`), its batch slice (`batch_sharding`)
    and a generator seeded as every other rank's; the metrics are the
    global batch's."""
    _check_supported(cfg)
    tp = cfg.mesh.model_parallel_size
    if (mesh.model_size if mesh is not None else 1) != tp:
        raise ValueError(f"cfg.mesh.model_parallel_size={tp} needs a mesh "
                         f"with a model axis of that size")
    check_tp_compatible(cfg.detector, tp)
    det_cfg = cfg.detector

    def step(state: TrainState, batch: Batch,
             generator: Optional[torch.Generator] = None):
        params = state.params
        metrics, grads = train_grads(cfg, state, batch, generator, mesh=mesh)
        leaves = trainable_leaves(params, state.opt_state)
        metrics["grad_norm"] = global_norm(grads, mesh)
        if cfg.optim.skip_nonfinite:
            finite = bool(torch.stack([torch.isfinite(g).all()
                                       for g in tree_leaves(grads)]).all())
            metrics["nonfinite_skip"] = torch.tensor(
                0.0 if finite else 1.0, device=metrics["loss"].device)
            if not finite:
                state.step += 1
                return state, metrics
        updates, opt_state = optimizer_update(grads, state.opt_state, params,
                                              cfg.optim, mesh)
        # Masked again: weight decay re-adds wd * param where the gradient
        # was zeroed, which would move the non-adapted blocks' LoRA rows.
        updates = mask_gradients(updates, params, det_cfg)
        with torch.no_grad():
            torch._foreach_add_(leaves, tree_leaves(updates))
            if state.ema is not None and cfg.optim.ema_decay > 0:
                update_ema(state.ema, params, det_cfg, cfg.optim.ema_decay)
        state.step += 1
        state.opt_state = opt_state
        return state, metrics

    return step
