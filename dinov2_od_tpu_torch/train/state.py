"""Train state and optimizer (counterpart of dinov2_od_tpu/train/state.py).

The optimizer is the JAX package's optax chain written out in tensor ops,
in optax's order, over the trainable leaves only:

  clip_by_global_norm(gradient_clip_val)   scale by max/||g|| when over it
  add_decayed_weights(weight_decay)        g + wd * p (L2, before Adam)
  scale_by_adam(0.9, 0.999, eps=1e-8)      eps added to sqrt(nu_hat)
  scale(-lr) | scale_by_learning_rate(schedule)

With `gradient_accumulation_steps` k > 1 the chain is wrapped as optax's
`MultiSteps` wraps it: each call folds its gradient into a running mean
(acc += (g - acc) / (n + 1), n the mini-step), and only every k-th call
runs the chain on that mean and zeroes it; the other calls leave params
and moments as they are. Adam's count and the schedule count the
chain's updates, not the calls.

`torch.optim.Adam` would not do: it cannot mask the per-block rows of a
stacked `[depth, ...]` LoRA leaf, and without that mask weight decay
would move the non-adapted blocks' factors. The train step masks the
gradients before the optimizer and its updates after it
(`mask_gradients`).

Trees are the param dict; gradients, Adam moments and the EMA hold None
(moments, gradients) or a scalar placeholder (EMA) at frozen leaves, which
carry no `requires_grad` and no optimizer state.

Under tensor parallelism and FSDP every rank holds its shard of each tree
(parallel/sharding.py): Adam, weight decay, the EMA, the accumulation and
the LoRA row masks are elementwise and run on the shards as they are
(FSDP never cuts a 3-D leaf's depth axis, and the masks' `[depth, 1, 1]`
multipliers touch only the 3-D LoRA leaves); only the clip's global norm
reads the logical tree (`global_norm` with the mesh).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..config import DetectorConfig, OptimConfig
from ..models.detector import lora_block_multiplier, trainable_mask
from ..parallel.collectives import all_reduce
from ..parallel.sharding import (fsdp, fsdp_layout_of, leaf_paths,
                                 model_size, shard_dim)

Params = Dict[str, Any]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts; a None leaf of `tree` stays
    None without calling fn."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return None if tree is None else fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The non-None leaves of nested dicts, in key order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves) -> Params:
    """A tree shaped as `like` holding `leaves`, in `tree_leaves` order, at
    its non-None leaves (None elsewhere)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


class AdamState(NamedTuple):
    """Update count and first/second moments (None at frozen leaves); with
    gradient accumulation, the running mean of the mini-steps' gradients
    and the mini-step (the calls since the last update). The counts are
    host ints, or 0-dim device tensors in the train step's branchless
    non-finite guard."""

    count: Any
    mu: Params
    nu: Params
    acc: Optional[Params] = None
    mini_step: Any = 0


@dataclasses.dataclass
class TrainState:
    """The train step's state. `params` are updated in place."""

    step: int
    params: Params
    opt_state: AdamState
    # EMA of the trainable leaves (OptimConfig.ema_decay > 0), with scalar
    # placeholders at frozen leaves; None when EMA is off.
    ema: Optional[Params] = None


def lr_schedule_fn(optim_cfg: OptimConfig,
                   lr: float) -> Optional[Callable[[int], float]]:
    """The learning rate at an update count, or None for a constant rate
    without warmup. optax's schedules: 'cosine' (warmup_cosine_decay to
    min_lr_ratio * lr over total_steps), 'linear' (warmup, then linear
    decay) and 'constant' (with warmup), each warming up linearly from 0
    over warmup_steps."""
    w = optim_cfg.warmup_steps
    kind = optim_cfg.lr_schedule
    if kind not in ("constant", "cosine", "linear"):
        raise ValueError(f"unknown lr_schedule {kind!r}")
    if kind == "constant" and w == 0:
        return None
    total = max(optim_cfg.total_steps, w + 1)
    end = lr * optim_cfg.min_lr_ratio

    def linear(init, stop, steps):
        def f(count):
            if steps <= 0:
                return init
            frac = 1.0 - min(max(count, 0), steps) / steps
            return (init - stop) * frac + stop
        return f

    if kind == "cosine":
        alpha = 0.0 if lr == 0.0 else end / lr
        decay_steps = total - w

        def main(count):
            c = min(count, decay_steps)
            cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
            return lr * ((1.0 - alpha) * cosine + alpha)
        warm = linear(0.0, lr, w)
    else:
        main = (linear(lr, end, max(total - w, 1)) if kind == "linear"
                else (lambda count: lr))
        if w == 0:
            return main
        warm = linear(0.0, lr, w)
    return lambda count: warm(count) if count < w else main(count - w)


def mask_gradients(grads: Params, params: Params,
                   detector_cfg: DetectorConfig) -> Params:
    """Zero the non-adapted blocks' rows of the stacked LoRA gradients (or
    updates), so they neither update nor count in the clip's norm: the
    leaves times `lora_block_multiplier`, skipping its factors of 1."""
    mult = lora_block_multiplier(params, detector_cfg)
    return tree_map(lambda g, m: g * m if torch.is_tensor(m) else g,
                    grads, mult)


def global_norm(tree: Params, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every non-None leaf, fp32. Under a
    mesh, of the logical tree: each leaf's squares summed over every group
    that shards it (the model group, the data group under FSDP, or both),
    each replicated leaf counted once."""
    leaves = [g.float() for g in tree_leaves(tree)]
    norms = torch.stack(torch._foreach_norm(leaves))
    tp = model_size(mesh) > 1
    if not (tp or fsdp(mesh)):
        return torch.linalg.vector_norm(norms)
    paths = leaf_paths(tree)
    cut = [fsdp_layout_of(p, mesh) is not None for p in paths]
    m = torch.tensor([tp and shard_dim(p) is not None for p in paths],
                     device=norms.device)
    d = torch.tensor(cut, device=norms.device)
    sq = norms.square()
    rep, model_only = sq[~m & ~d].sum(), sq[m & ~d].sum()
    data_only, both = sq[~m & d].sum(), sq[m & d].sum()
    if tp:
        model_only, both = all_reduce(torch.stack([model_only, both]),
                                      mesh.model_group, mesh.backend)
    if any(cut):
        data_only, both = all_reduce(torch.stack([data_only, both]),
                                     mesh.data_group, mesh.backend)
    return (model_only + rep + data_only + both).sqrt()


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in fp32, as optax computes it: with b2 = 0.999
    rounded to fp32 the first step's 1 - b2 is 0.00099998713, 1.3e-5 off
    the exact 0.001."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return (one - torch.tensor(decay, dtype=torch.float32) ** count).item()


def adam_scalars(optim_cfg: OptimConfig, count: int):
    """(1 - b1**(count+1), 1 - b2**(count+1), the learning rate) of the
    update after `count` updates, as floats."""
    schedule = lr_schedule_fn(optim_cfg, optim_cfg.learning_rate)
    lr = (optim_cfg.learning_rate if schedule is None
          else schedule(count))
    return (_bias_correction(_B1, count + 1),
            _bias_correction(_B2, count + 1), lr)


class AdamTable:
    """`adam_scalars` of every count up to a bound, as fp32 tensors on a
    device: indexed by a 0-dim count tensor, they give the same values as
    the host path without a copy to the host."""

    def __init__(self, optim_cfg: OptimConfig, device):
        self.optim_cfg, self.device = optim_cfg, device
        self.rows = torch.zeros((0, 3), dtype=torch.float32, device=device)

    def __call__(self, count: torch.Tensor, bound: int):
        """The scalars at `count`, which must not exceed `bound`."""
        n = self.rows.shape[0]
        if bound >= n:
            new = [adam_scalars(self.optim_cfg, c)
                   for c in range(n, max(2 * n, bound + 1, 64))]
            self.rows = torch.cat([self.rows, torch.tensor(
                new, dtype=torch.float32, device=self.device)])
        return self.rows[count].unbind()


@torch.no_grad()
def optimizer_update(grads: Params, opt_state: AdamState, params: Params,
                     optim_cfg: OptimConfig, mesh=None,
                     scalars=None) -> Tuple[Params, AdamState]:
    """One step of the masked chain on the leaves that have moments (this
    rank's shards under `mesh`, whose logical norm the clip reads).
    Returns the updates (None at frozen leaves) and the new state.
    `scalars` are `adam_scalars` at opt_state.count as 0-dim tensors
    (`AdamTable`) when the count is one; by default they are computed on
    the host.

    Each stage runs as one multi-tensor (`torch._foreach_*`) op over all
    the trainable leaves: the same elementwise math in the same order,
    in a few launches instead of a few per leaf."""
    gs = tree_leaves(grads)  # None exactly where opt_state.mu is None
    g_norm = global_norm(grads, mesh)
    clip = optim_cfg.gradient_clip_val
    # clip_by_global_norm: g unchanged below the maximum, else g/|g|*max.
    factor = torch.where(g_norm < clip, torch.ones_like(g_norm),
                         clip / g_norm)
    gs = torch._foreach_mul(gs, factor)
    if optim_cfg.weight_decay:
        torch._foreach_add_(gs, trainable_leaves(params, opt_state),
                            alpha=optim_cfg.weight_decay)
    mu = torch._foreach_mul(tree_leaves(opt_state.mu), _B1)
    torch._foreach_add_(mu, gs, alpha=1.0 - _B1)
    nu = torch._foreach_mul(tree_leaves(opt_state.nu), _B2)
    torch._foreach_addcmul_(nu, gs, gs, value=1.0 - _B2)
    bc1, bc2, lr = (adam_scalars(optim_cfg, opt_state.count)
                    if scalars is None else scalars)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, _EPS)
    updates = torch._foreach_div(mu, bc1)
    torch._foreach_div_(updates, denom)
    torch._foreach_mul_(updates, -lr)
    like = opt_state.mu
    return (tree_unflatten(like, updates),
            opt_state._replace(count=opt_state.count + 1,
                               mu=tree_unflatten(like, mu),
                               nu=tree_unflatten(like, nu)))


@torch.no_grad()
def accumulate(grads: Params, opt_state: AdamState, n) -> list:
    """The running mean of the mini-steps' gradients with this one, the
    n-th, folded in: acc + (g - acc) / n (optax.MultiSteps' Welford
    update), as a list in `tree_leaves` order. `n` is an int or a 0-dim
    float tensor."""
    acc = tree_leaves(opt_state.acc)
    delta = torch._foreach_sub(tree_leaves(grads), acc)
    torch._foreach_div_(delta, n)
    return torch._foreach_add(acc, delta)


def trainable_leaves(params: Params, opt_state: AdamState) -> list:
    """The params that have Adam moments, in `tree_leaves` order."""
    return tree_leaves(tree_map(lambda m, p: p, opt_state.mu, params))


def init_ema(params: Params, detector_cfg: DetectorConfig) -> Params:
    """Copies of the trainable leaves; a scalar placeholder at frozen ones
    (they never change, so the EMA would equal them)."""
    return tree_map(
        lambda p, m: (p.detach().clone() if m
                      else torch.zeros((), dtype=p.dtype, device=p.device)),
        params, trainable_mask(params, detector_cfg))


@torch.no_grad()
def update_ema(ema: Params, params: Params, detector_cfg: DetectorConfig,
               decay: float) -> None:
    """ema = decay * ema + (1 - decay) * params on the trainable leaves,
    in place."""
    pairs = tree_leaves(tree_map(lambda e, p, m: (e, p) if m else None,
                                 ema, params,
                                 trainable_mask(params, detector_cfg)))
    es = [e for e, _ in pairs]
    torch._foreach_mul_(es, decay)
    torch._foreach_add_(es, [p for _, p in pairs], alpha=1.0 - decay)


def merge_ema(params: Params, ema: Params,
              detector_cfg: DetectorConfig) -> Params:
    """The param tree with its trainable leaves taken from the EMA."""
    return tree_map(lambda p, e, m: e if m else p, params, ema,
                    trainable_mask(params, detector_cfg))


def create_train_state(params: Params, optim_cfg: OptimConfig,
                       detector_cfg: DetectorConfig) -> TrainState:
    """Mark the trainable leaves `requires_grad` (the others not), give
    them zero Adam moments (and a zero gradient accumulator when
    optim_cfg.gradient_accumulation_steps > 1), and an EMA when
    optim_cfg.ema_decay > 0."""
    mask = trainable_mask(params, detector_cfg)
    tree_map(lambda p, m: p.requires_grad_(bool(m)), params, mask)

    def zeros(p, m):
        return torch.zeros_like(p) if m else None

    acc = (tree_map(zeros, params, mask)
           if optim_cfg.gradient_accumulation_steps > 1 else None)
    opt_state = AdamState(count=0, mu=tree_map(zeros, params, mask),
                          nu=tree_map(zeros, params, mask), acc=acc)
    ema = (init_ema(params, detector_cfg) if optim_cfg.ema_decay > 0
           else None)
    return TrainState(step=0, params=params, opt_state=opt_state, ema=ema)
