"""The train and eval steps (counterpart of dinov2_od_tpu/train/step.py).
The train step: forward in train mode, matching and the set loss (with
the auxiliary layers' terms), backward through the decoder and the
adapted backbone blocks, global-norm clipping, L2 weight decay and masked
Adam. The eval steps: the forward alone, the forward with the detection
top-k (one [B, K, 6] tensor a batch for the host), and the loss of a
batch without an update.

Where the JAX package compiles the whole step into one XLA program, the
port runs it eagerly: the matcher copies each criterion call's cost
matrix to the host once (ops/hungarian.py), and the parameters are
updated in place under `torch.no_grad()`.

Under a ('data', 'model') mesh (parallel/) each rank runs the step on its
batch slice and its param shard, as GSPMD runs the JAX step: the forward
places its tensor-parallel collectives itself, each rank matches its own
(model-replicated) predictions, the partial gradients of replicated
leaves are summed over the model group and every gradient over the data
group, and the optimizer updates the shards. Under context parallelism
(either of `MeshConfig`'s modes) the backbone's attention is the ring
(`_cp_kwargs`): each rank of the ring runs the backbone on its tokens and
the decoder, the matcher and the loss whole on the gathered features, so
the backbone leaves' gradients are summed over the ring and the decoder's
are not (parallel/collectives.py `reduce_gradients`). The decoder's
dropout masks are drawn alike on every rank of the ring, from generators
seeded alike.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..config import TrainConfig
from ..data.augment import augment_batch
from ..data.coco import IMAGENET_MEAN, IMAGENET_STD
from ..evaluation.postprocess import select_topk_detections
from ..models.detector import detector_apply
from ..models.vit import check_backbone_supported
from ..ops.losses import set_criterion
from ..parallel.collectives import all_reduce_coalesced_, reduce_gradients
from ..parallel.sharding import check_tp_compatible, leaf_paths
from .state import (
    AdamTable,
    TrainState,
    accumulate,
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


def step_seed(seed: int, step: int) -> int:
    """The seed of a train step's generator (its augmentation draws, then
    its dropout masks)."""
    return (seed * 1_000_003 + step) % (2 ** 63)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device):
    """The ImageNet mean and std on `device`, copied there once: a copy
    from pageable host memory would wait for the card every step."""
    return (torch.as_tensor(IMAGENET_MEAN, device=device),
            torch.as_tensor(IMAGENET_STD, device=device))


def prep_images(images: torch.Tensor, normalize: bool) -> torch.Tensor:
    """uint8 feeds become fp32 / 255, ImageNet-normalised when `normalize`;
    float feeds are taken as already preprocessed and pass through."""
    if images.dtype.is_floating_point:
        return images
    x = images.float() / 255.0
    if normalize:
        mean, std = _imagenet_stats(x.device)
        x = (x - mean) / std
    return x


def _cp_kwargs(cfg: TrainConfig, mesh) -> dict:
    """detector_apply's kwargs for context parallelism (the JAX step's
    `_cp_kwargs`): ring attention over the mesh's ring in either mode,
    composed with Megatron TP over the model axis on the three-axis mesh;
    {} without a ring."""
    if mesh is None or cfg.mesh.context_size == 1:
        return {}
    if mesh.context_size != cfg.mesh.context_size:
        raise ValueError(f"cfg.mesh asks for a ring of "
                         f"{cfg.mesh.context_size}; the mesh has "
                         f"{mesh.context_size}")
    return {"attn_impl": "ring", "seq_axis": mesh.seq_axis}


def train_loss(cfg: TrainConfig, params, batch: Batch,
               generator: Optional[torch.Generator] = None, *,
               attn_impl: str = "auto", mesh=None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, loss terms) of one batch in train mode. Each auxiliary
    decoder layer is matched on its own, or reuses the final layer's
    assignment when cfg.share_aux_match, and adds its loss to the total
    (also reported as loss_aux_i); under the MoE FFN the router's
    load-balance loss adds moe_aux_weight times itself (reported as
    loss_moe_aux). Under `mesh`, params are this rank's
    shard and the batch its slice: the loss is its share of the global
    one."""
    det_cfg = cfg.detector
    images = prep_images(batch["images"], cfg.data.normalize)
    kw = {"attn_impl": attn_impl, **_cp_kwargs(cfg, mesh)}
    out = detector_apply(params, det_cfg, images, generator=generator,
                         deterministic=False, mesh=mesh,
                         use_remat=cfg.use_remat, **kw)
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
    if "moe_aux" in out:
        # The MoE router's load-balance loss (ops/moe.py).
        total = total + det_cfg.backbone.moe_aux_weight * out["moe_aux"]
        losses["loss_moe_aux"] = out["moe_aux"]
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


def _unit_interval_images(images: torch.Tensor,
                          normalize: bool) -> torch.Tensor:
    """A batch as un-normalised [0, 1] RGB for augmentation: uint8 / 255;
    a float feed (already preprocessed) through the exact inverse of
    its normalisation."""
    if not images.dtype.is_floating_point:
        return images.float() / 255.0
    if normalize:
        mean, std = _imagenet_stats(images.device)
        return images * std + mean
    return images


def _normalize_unit_images(images: torch.Tensor,
                           normalize: bool) -> torch.Tensor:
    if normalize:
        mean, std = _imagenet_stats(images.device)
        return (images - mean) / std
    return images


def augment_step_batch(cfg: TrainConfig, batch: Batch,
                       generator: Optional[torch.Generator]) -> Batch:
    """The batch with cfg.augment's augmentations drawn from `generator`
    (data/augment.py): images un-normalised to [0, 1], augmented with
    their boxes and valid bits, and normalised again as fp32."""
    x01 = _unit_interval_images(batch["images"], cfg.data.normalize)
    x01, boxes, valid = augment_batch(generator, x01, batch["boxes"],
                                      batch["valid"], cfg.augment)
    return {**batch, "boxes": boxes, "valid": valid,
            "images": _normalize_unit_images(x01, cfg.data.normalize)}


def _select_(dst: list, src: list, keep_new: torch.Tensor) -> None:
    """dst[i] = src[i] where `keep_new` (a 0-dim bool), in place."""
    for d, n in zip(dst, src):
        d.copy_(torch.where(keep_new, n, d))


def make_train_step(cfg: TrainConfig, mesh=None):
    """The train step: step(state, batch, generator) -> (state, metrics).

    `generator` (on the params' device) drives the augmentation's draws,
    then dropout. The step updates `state.params` in place under
    torch.no_grad() and returns the state with the new step count, Adam
    state and EMA. Metrics are 0-dim tensors: the loss terms, 'grad_norm'
    (of the masked gradients) and, with cfg.optim.skip_nonfinite,
    'nonfinite_skip' (1 when a gradient held NaN or Inf: params, moments,
    the accumulator and the EMA then keep their values).

    Options, as the JAX step has them:
    - cfg.augment: device-side augmentation of each batch;
    - cfg.use_remat: each adapted backbone block recomputed in the
      backward (12 + 2 attention forwards a ViT-B step instead of 12);
    - lora_mode="fold": the adapted linears through W + alpha * A @ B;
    - gradient_accumulation_steps k > 1: the update every k-th call, on
      the mean of the k gradients (optax.MultiSteps); the EMA moves every
      call, toward the params as they are.
    - skip_nonfinite: branchless, so the step never waits for the card:
      the update is computed and selected by torch.where, and Adam's
      count (with the mini-step) becomes a 0-dim tensor that indexes the
      host's bias corrections and learning rates (`AdamTable`).

    Under `mesh` (parallel/sharding.py `create_mesh` from cfg.mesh) every
    rank calls the step with its state of param shards (`shard_params`),
    its batch slice (`batch_sharding`) and a generator seeded as every
    other rank's; the metrics are the global batch's."""
    tp = cfg.mesh.tensor_parallel_size
    if (mesh.model_size if mesh is not None else 1) != tp:
        raise ValueError(f"cfg.mesh's tensor-parallel size {tp} needs a "
                         f"mesh with a model axis of that size")
    _cp_kwargs(cfg, mesh)
    check_tp_compatible(cfg.detector, tp)
    check_backbone_supported(cfg.detector.backbone, mesh)
    det_cfg = cfg.detector
    k_acc = cfg.optim.gradient_accumulation_steps
    if k_acc < 1:
        raise ValueError("gradient_accumulation_steps must be >= 1")
    table: Dict[str, object] = {}

    def ema_step(state: TrainState) -> None:
        if state.ema is not None and cfg.optim.ema_decay > 0:
            update_ema(state.ema, state.params, det_cfg, cfg.optim.ema_decay)

    def guarded(state: TrainState, grads, metrics):
        """The update under the non-finite guard, without a host sync."""
        params, opt = state.params, state.opt_state
        leaves = trainable_leaves(params, opt)
        device = leaves[0].device
        finite = torch.stack([torch.isfinite(g).all()
                              for g in tree_leaves(grads)]).all()
        metrics["nonfinite_skip"] = (~finite).float()
        if not torch.is_tensor(opt.count):
            table["bound"] = opt.count
            opt = opt._replace(
                count=torch.tensor(opt.count, device=device),
                mini_step=torch.tensor(opt.mini_step, device=device))
        elif "bound" not in table:
            table["bound"] = int(opt.count)  # once: the count's limit
        if "adam" not in table:
            table["adam"] = AdamTable(cfg.optim, device)
        emit, ms = finite, opt.mini_step
        if k_acc > 1:
            acc = accumulate(grads, opt, (ms + 1).float())
            grads = tree_unflatten(opt.mu, acc)
            emit = finite & (ms == k_acc - 1)
        scalars = table["adam"](opt.count, table["bound"])
        updates, new = optimizer_update(grads, opt, params, cfg.optim, mesh,
                                        scalars=scalars)
        updates = mask_gradients(updates, params, det_cfg)
        with torch.no_grad():
            _select_(leaves, torch._foreach_add(leaves,
                                                tree_leaves(updates)), emit)
            for old, fresh in (("mu", new.mu), ("nu", new.nu)):
                _select_(tree_leaves(getattr(opt, old)), tree_leaves(fresh),
                         emit)
            if k_acc > 1:
                kept = [torch.where(emit, torch.zeros_like(a), a)
                        for a in acc]
                _select_(tree_leaves(opt.acc), kept, finite)
                ms = torch.where(finite, (ms + 1) % k_acc, ms)
            if state.ema is not None and cfg.optim.ema_decay > 0:
                before = [e.clone() for e in tree_leaves(state.ema)]
                ema_step(state)
                _select_(tree_leaves(state.ema), before, ~finite)
        table["bound"] += 1
        state.opt_state = opt._replace(count=opt.count + emit.long(),
                                       mini_step=ms)

    def step(state: TrainState, batch: Batch,
             generator: Optional[torch.Generator] = None):
        if cfg.augment.enabled:
            batch = augment_step_batch(cfg, batch, generator)
        params = state.params
        metrics, grads = train_grads(cfg, state, batch, generator, mesh=mesh)
        leaves = trainable_leaves(params, state.opt_state)
        metrics["grad_norm"] = global_norm(grads, mesh)
        if cfg.optim.skip_nonfinite:
            guarded(state, grads, metrics)
            state.step += 1
            return state, metrics
        opt_state = state.opt_state
        if k_acc > 1:
            ms = opt_state.mini_step
            acc = accumulate(grads, opt_state, ms + 1)
            if ms < k_acc - 1:
                torch._foreach_copy_(tree_leaves(opt_state.acc), acc)
                state.opt_state = opt_state._replace(mini_step=ms + 1)
                with torch.no_grad():
                    ema_step(state)
                state.step += 1
                return state, metrics
            grads = tree_unflatten(opt_state.mu, acc)
            torch._foreach_zero_(tree_leaves(opt_state.acc))
            opt_state = opt_state._replace(mini_step=0)
        updates, opt_state = optimizer_update(grads, opt_state, params,
                                              cfg.optim, mesh)
        # Masked again: weight decay re-adds wd * param where the gradient
        # was zeroed, which would move the non-adapted blocks' LoRA rows.
        updates = mask_gradients(updates, params, det_cfg)
        with torch.no_grad():
            torch._foreach_add_(leaves, tree_leaves(updates))
            ema_step(state)
        state.step += 1
        state.opt_state = opt_state
        return state, metrics

    return step


def make_eval_step(cfg: TrainConfig, mesh=None):
    """eval_step(params, images) -> the detector's raw outputs, in eval
    mode (no dropout, no gradient). Under `mesh`, as the train step: this
    rank's param shards and batch slice, the ring under context
    parallelism."""
    det_cfg = cfg.detector
    cp = _cp_kwargs(cfg, mesh)

    @torch.inference_mode()
    def eval_step(params, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return detector_apply(params, det_cfg,
                              prep_images(images, cfg.data.normalize),
                              deterministic=True, mesh=mesh, **cp)

    return eval_step


def make_eval_topk_step(cfg: TrainConfig, mesh=None,
                        max_detections: int = 100,
                        parity_mode: bool = False):
    """eval_topk_step(params, images, orig_sizes) -> {"topk": [B, K, 6]}
    fp32, (score, label, x, y, w, h) along the last dim (labels exact in
    fp32): the forward and the top-k over (query, class) on the device,
    one compact tensor for the host to copy (evaluate_dataset's path).
    Under `mesh` as `make_eval_step`."""
    det_cfg = cfg.detector
    cp = _cp_kwargs(cfg, mesh)

    @torch.inference_mode()
    def eval_topk_step(params, images: torch.Tensor,
                       orig_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = detector_apply(params, det_cfg,
                             prep_images(images, cfg.data.normalize),
                             deterministic=True, mesh=mesh, **cp)
        scores, labels, boxes = select_topk_detections(
            out["pred_logits"], out["pred_boxes"], orig_sizes,
            max_detections=max_detections, parity_mode=parity_mode)
        return {"topk": torch.cat([scores[..., None].float(),
                                   labels[..., None].float(),
                                   boxes.float()], dim=-1)}

    return eval_topk_step


def make_loss_eval_step(cfg: TrainConfig):
    """loss_eval_step(params, batch) -> the set criterion's terms in eval
    mode, without an update (validation loss curves)."""
    det_cfg = cfg.detector

    @torch.inference_mode()
    def loss_eval_step(params, batch: Batch) -> Dict[str, torch.Tensor]:
        out = detector_apply(params, det_cfg,
                             prep_images(batch["images"], cfg.data.normalize),
                             deterministic=True)
        return set_criterion(
            out["pred_logits"], out["pred_boxes"], batch["labels"],
            batch["boxes"], batch["valid"], matcher_cfg=cfg.matcher,
            loss_cfg=cfg.loss, num_classes=det_cfg.decoder.num_classes)

    return loss_eval_step
