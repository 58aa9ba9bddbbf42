"""Checkpoints as torch state dicts (counterpart of
dinov2_od_tpu/train/checkpoint.py, which writes Orbax trees).

A checkpoint is a directory `checkpoint_epoch_{N}` holding:
- `state.pt`: `torch.save` of a dict of CPU tensors and numbers: the
  params, Adam's count, mu and nu (None at frozen leaves), with gradient
  accumulation its running mean and mini-step, the train step, the EMA
  (or None), the epoch and the epoch's mean loss. Dropout and the
  augmentation's draws are a function of (seed, step) (train/step.py
  `step_seed`), so the step is all a resumed run needs to continue the
  same draws, and a run resumed between two mini-steps continues the
  accumulation it was in;
- `metrics_history.json`: the loop's history, and on preemption the
  mid-epoch resume index `_preempt_batch_index`.

Each save is written into a temporary directory beside its target and
renamed into place, as Orbax does, so a reader never sees half a
checkpoint. `async_save` copies the tensors to the host synchronously and
writes them in a background thread, one save in flight; `wait_for_saves`
blocks until every save has landed (and raises a failed write's error).

The restore semantics are the reference's (dino_detector/train.py): a
shape-tolerant partial restore of the params (`merge_compatible`: leaves
whose path or shape differ keep the template's value, with a warning),
and a fresh optimizer when the saved one does not fit.

Under a mesh of processes (parallel/sharding.py) the file holds the
logical tree, the same file one process writes, so a tensor-parallel
run's checkpoint loads in one process (`Predictor.from_checkpoint`,
`serve.main`). Every rank calls `save_checkpoint` and
`save_final_params` with `mesh`: the params, Adam's moments, the
accumulator and the EMA are gathered over the model group (a
collective), world rank 0 writes the file synchronously, and a barrier
follows, so no rank reads a checkpoint before it is whole. A restore reads
the logical tree on every rank; `shard_train_trees` then cuts each
rank's shard of it, the optimizer state and the EMA included.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from ..parallel.multihost import barrier, process_index
from .state import AdamState, tree_map

logger = logging.getLogger("dinov2_od_tpu_torch")

STATE_FILE = "state.pt"
HISTORY_FILE = "metrics_history.json"

# The background writer and its saves not yet waited for.
_writer: Optional[ThreadPoolExecutor] = None
_pending: List[Future] = []


def wait_for_saves() -> None:
    """Block until every async save has been renamed into place; raise the
    first failed write's error. Saves and restores here call it
    themselves; callers call it before reading a just-written checkpoint
    and at the end of training."""
    while _pending:
        _pending.pop(0).result()


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """{'a/b/c': leaf} for the non-None leaves of nested dicts."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        elif v is not None:
            out[key] = v
    return out


def merge_compatible(template, restored, *, label: str = "params"):
    """Copy leaves of `restored` into a copy of `template` wherever path and
    shape match, cast to the template leaf's dtype and device; every other
    leaf keeps the template's value (with a warning). Returns (merged,
    num_loaded, num_skipped)."""
    restored_flat = flatten_tree(restored)
    loaded = skipped = 0

    def pick(leaf, path):
        nonlocal loaded, skipped
        cand = restored_flat.get(path)
        if cand is None:
            logger.warning("checkpoint %s: missing %s, keeping init",
                           label, path)
        elif tuple(cand.shape) == tuple(leaf.shape):
            loaded += 1
            return cand.to(device=leaf.device, dtype=leaf.dtype)
        else:
            logger.warning("checkpoint %s: shape mismatch at %s (ckpt %s vs "
                           "model %s), skipped", label, path,
                           tuple(cand.shape), tuple(leaf.shape))
        skipped += 1
        return leaf

    merged = tree_map(pick, template, _paths(template))
    return merged, loaded, skipped


def _paths(tree, prefix: str = ""):
    """A tree shaped as `tree` holding each leaf's flattened path."""
    return {k: (_paths(v, f"{prefix}/{k}" if prefix else str(k))
                if isinstance(v, dict)
                else (f"{prefix}/{k}" if prefix else str(k)))
            for k, v in tree.items()}


def _to_host(tree):
    if tree is None:
        return None
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _write(path: str, payload: dict, history: Optional[dict]) -> str:
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    if history is not None:
        with open(os.path.join(tmp, HISTORY_FILE), "w") as f:
            json.dump(history, f)
    old = path + ".old"
    if os.path.exists(path):
        shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)
    return path


def save_checkpoint(
    directory: str,
    epoch: int,
    params,
    opt_state: Optional[AdamState],
    loss: float,
    metrics_history: Optional[Dict[str, Any]] = None,
    name: Optional[str] = None,
    async_save: bool = False,
    *,
    step: int = 0,
    ema=None,
    mesh=None,
) -> str:
    """Write one checkpoint under `directory` (reference naming
    checkpoint_epoch_{N}) and return its path. With async_save the
    tensors are copied to the host before the call returns and written by
    the background writer (at most one save in flight). Under `mesh`
    every rank calls it: the trees are gathered, rank 0 writes
    synchronously and the ranks meet at a barrier."""
    global _writer
    name = name or f"checkpoint_epoch_{epoch}"
    path = os.path.abspath(os.path.join(directory, name))
    if mesh is not None:
        params, opt_state, ema = gather_train_trees(params, opt_state, ema,
                                                    mesh)
        async_save = False
    payload = {
        "epoch": int(epoch),
        "loss": float(loss),
        "step": int(step),
        "params": _to_host(params),
        "opt_state": None if opt_state is None else {
            "count": int(opt_state.count),
            "mu": _to_host(opt_state.mu),
            "nu": _to_host(opt_state.nu),
            "acc": _to_host(opt_state.acc),
            "mini_step": int(opt_state.mini_step),
        },
        "ema": _to_host(ema),
    }
    history = (None if metrics_history is None
               else json.loads(json.dumps(metrics_history)))
    wait_for_saves()
    if mesh is not None:
        return _written_by_rank0(path, payload, history)
    if not async_save:
        return _write(path, payload, history)
    if _writer is None:
        _writer = ThreadPoolExecutor(1, thread_name_prefix="ckpt-writer")
    _pending.append(_writer.submit(_write, path, payload, history))
    return path


def _written_by_rank0(path: str, payload: dict,
                      history: Optional[dict]) -> str:
    if process_index() == 0:
        _write(path, payload, history)
    barrier()
    return path


def save_final_params(directory: str, params, name: str = "final_model",
                      mesh=None) -> str:
    """Bare-params save, the reference's final state_dict-only format.
    Under `mesh`, as `save_checkpoint`: gathered, rank 0 writes, a
    barrier."""
    wait_for_saves()
    path = os.path.abspath(os.path.join(directory, name))
    if mesh is not None:
        params = gather_train_trees(params, None, None, mesh)[0]
        return _written_by_rank0(path, {"params": _to_host(params)}, None)
    return _write(path, {"params": _to_host(params)}, None)


def gather_train_trees(params, opt_state: Optional[AdamState], ema, mesh):
    """The logical params, Adam state and EMA from each rank's shards
    (`parallel.sharding.gather_params` over the model group); every rank
    of the mesh must call it."""
    from ..parallel.sharding import gather_params

    def full(tree):
        return None if tree is None else gather_params(tree, mesh)

    if opt_state is not None:
        opt_state = opt_state._replace(mu=full(opt_state.mu),
                                       nu=full(opt_state.nu),
                                       acc=full(opt_state.acc))
    return full(params), opt_state, full(ema)


def shard_train_trees(opt_state: Optional[AdamState], ema, mesh):
    """This rank's shards of a restored logical Adam state and EMA
    (`parallel.sharding.shard_params`)."""
    from ..parallel.sharding import shard_params

    def cut(tree):
        return None if tree is None else shard_params(tree, mesh)

    if opt_state is not None:
        opt_state = opt_state._replace(mu=cut(opt_state.mu),
                                       nu=cut(opt_state.nu),
                                       acc=cut(opt_state.acc))
    return opt_state, cut(ema)


class Restored(NamedTuple):
    """What `restore_checkpoint` gives back."""

    params: Any
    opt_state: Optional[AdamState]  # the template when incompatible
    start_epoch: int
    metrics_history: Dict[str, Any]
    step: int
    ema: Any  # None unless a compatible EMA was saved and asked for


def _tree_fits(template, saved) -> bool:
    """The same leaf paths (None where the template has None) and shapes."""
    t, f = flatten_tree(template), flatten_tree(saved)
    return t.keys() == f.keys() and all(t[k].shape == f[k].shape for k in t)


def _place(template, saved):
    """`saved`'s leaves on the template leaves' devices and dtypes."""
    flat = flatten_tree(saved)
    return tree_map(lambda t, path: flat[path].to(device=t.device,
                                                  dtype=t.dtype),
                    template, _paths(template))


def restore_checkpoint(
    path: str,
    params_template,
    opt_state_template: Optional[AdamState] = None,
    ema_template=None,
) -> Restored:
    """Shape-tolerant restore onto the templates' dtypes and devices. The
    optimizer state comes back only when its trees fit the template's
    (else the template, a fresh optimizer); the EMA likewise."""
    wait_for_saves()  # the path may be an async save still in flight
    path = os.path.abspath(path)
    raw = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                     weights_only=True)
    params, loaded, skipped = merge_compatible(params_template,
                                               raw["params"])
    logger.info("checkpoint restore: %d tensors loaded, %d kept from init",
                loaded, skipped)

    opt_state = opt_state_template
    saved_opt = raw.get("opt_state")
    if opt_state_template is not None and saved_opt is not None:
        acc = opt_state_template.acc
        saved_acc = saved_opt.get("acc")
        if (_tree_fits(opt_state_template.mu, saved_opt["mu"])
                and _tree_fits(opt_state_template.nu, saved_opt["nu"])):
            mini_step = 0
            if acc is not None and saved_acc is not None:
                if _tree_fits(acc, saved_acc):
                    acc = _place(acc, saved_acc)
                    mini_step = int(saved_opt.get("mini_step", 0))
            elif saved_opt.get("mini_step", 0):
                logger.warning("checkpoint saved mid-accumulation; the "
                               "accumulated gradients are dropped")
            opt_state = AdamState(
                count=int(saved_opt["count"]),
                mu=_place(opt_state_template.mu, saved_opt["mu"]),
                nu=_place(opt_state_template.nu, saved_opt["nu"]),
                acc=acc, mini_step=mini_step)
            logger.info("optimizer state restored")
        else:
            logger.warning("optimizer state incompatible, starting the "
                           "optimizer fresh (reference fallback, "
                           "train.py:1013-1025)")

    ema = None
    if ema_template is not None and raw.get("ema") is not None:
        if _tree_fits(ema_template, raw["ema"]):
            ema = _place(ema_template, raw["ema"])
        else:
            logger.warning("EMA incompatible, starting it from the params")

    epoch = int(raw.get("epoch", -1))
    metrics_history: Dict[str, Any] = {}
    hist_file = os.path.join(path, HISTORY_FILE)
    if os.path.exists(hist_file):
        with open(hist_file) as f:
            metrics_history = json.load(f)
    return Restored(params=params, opt_state=opt_state,
                    start_epoch=epoch + 1 if epoch >= 0 else 0,
                    metrics_history=metrics_history,
                    step=int(raw.get("step", 0)), ema=ema)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The checkpoint_epoch_N under `directory` with the largest N."""
    if not os.path.isdir(directory):
        return None
    best, best_epoch = None, -1
    for entry in os.listdir(directory):
        if entry.startswith("checkpoint_epoch_"):
            try:
                e = int(entry.rsplit("_", 1)[1])
            except ValueError:
                continue
            if e > best_epoch:
                best, best_epoch = os.path.join(directory, entry), e
    return best

