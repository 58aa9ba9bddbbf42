"""The dataset resident on the card, and K train steps a dispatch
(counterpart of dinov2_od_tpu/train/device_cache.py).

- `upload_train_cache` puts the whole training set on the card once: the
  uint8 images and the padded boxes, labels and valid bits (synthetic-5k
  at 224 px is 0.76 GB, COCO train2017 17.8 GB). A step's batch is then a
  gather on the card; what crosses from the host is one [K, B] int64
  index tensor a dispatch.
- `make_multi_train_step` runs K train steps behind that one index copy,
  each the train step of train/step.py with its generator seeded by
  (seed, step), so K steps a dispatch repeat K single steps exactly. The
  metrics come back stacked to [K].
- `epoch_index_groups` is the epoch's schedule: the loader's shuffled
  order (data/loader.py `shuffled_order`, last partial batch dropped) in
  [K, B] groups, minus the batches a resumed run already took.
- `upload_eval_cache`, `make_cached_eval` and `evaluate_cached`: the
  validation set on the card in [nb, B] batches, the forward and top-k
  of every batch queued at once, one [nb, B, K, 6] copy to the host.

Before an upload the cache's bytes are held against the card's free
memory (`torch.cuda.mem_get_info`); a cache that does not fit raises
rather than falling back to the host loader. In one process there is one
layout: 'auto' is 'replicated' (the JAX package's single-device layout);
'sharded' needs more than one data-parallel rank (ROADMAP.md Queue A
item 7) and raises.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TrainConfig
from ..data.loader import shuffled_order
from ..evaluation.postprocess import format_detections, select_above_threshold
from .step import make_eval_topk_step, make_train_step, step_seed

logger = logging.getLogger("dinov2_od_tpu_torch")

TRAIN_KEYS = ("images", "boxes", "labels", "valid")
LAYOUTS = ("auto", "replicated", "sharded")


def resolve_layout(layout: str) -> str:
    """The cache layout a one-process run takes for `layout`."""
    if layout not in LAYOUTS:
        raise ValueError(f"device cache layout must be one of {LAYOUTS}, "
                         f"not {layout!r}")
    if layout == "sharded":
        raise NotImplementedError(
            "--device_cache_layout sharded splits the cache over the "
            "data-parallel ranks, which the port does not run yet "
            "(ROADMAP.md Queue A item 7)")
    return "replicated"


def _dataset_arrays(dataset, keys) -> Dict[str, np.ndarray]:
    n = len(dataset)
    if hasattr(dataset, "get_batch"):
        return {k: v for k, v in dataset.get_batch(np.arange(n)).items()
                if k in keys}
    ex = [dataset.get_example(i) for i in range(n)]
    return {k: np.stack([e[k] for e in ex]) for k in keys}


def cache_nbytes(dataset, keys=TRAIN_KEYS) -> int:
    """The cache's bytes on the card, from one example (nothing loaded)."""
    ex = dataset.get_example(0)
    return len(dataset) * sum(np.asarray(ex[k]).nbytes
                              for k in keys if k in ex)


def check_fits(nbytes: int, device, what: str) -> None:
    """Raise MemoryError when `nbytes` exceed the card's free memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    free, total = torch.cuda.mem_get_info(device)
    if nbytes > free:
        raise MemoryError(
            f"--device_cache: the {what} takes {nbytes / 1e9:.2f} GB, but "
            f"{device} has {free / 1e9:.2f} GB free of {total / 1e9:.2f} "
            f"GB; train without --device_cache (the host loader) or on a "
            f"subset")


def _to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str,
                                                              torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def upload_train_cache(dataset, device="cuda",
                       layout: str = "auto") -> Dict[str, torch.Tensor]:
    """images, boxes, labels and valid of the whole dataset, on `device`,
    once. Raises when the card lacks the memory."""
    resolve_layout(layout)
    nbytes = cache_nbytes(dataset)
    check_fits(nbytes, device, "training-set cache")
    arrays = _dataset_arrays(dataset, TRAIN_KEYS)
    if arrays["images"].dtype != np.uint8:
        logger.warning("device cache with float images: 4x the memory of "
                       "a uint8 feed (use --feed_dtype uint8)")
    logger.info("uploading %.2f GB dataset cache to %s",
                sum(a.nbytes for a in arrays.values()) / 1e9, device)
    return _to_device(arrays, device)


def index_tensor(group: np.ndarray, device) -> torch.Tensor:
    """A [K, B] index group on `device`: from pinned memory, without a
    wait, on CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(group, dtype=np.int64))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def make_multi_train_step(cfg: TrainConfig, train_step=None):
    """multi_step(state, cache, idxs [K, B] on the cache's device,
    generator) -> (state, metrics stacked [K]): K train steps on the
    cache's rows, each with `generator` seeded by (cfg.seed, its step),
    none waiting for the card beyond what the step itself waits for."""
    step = train_step or make_train_step(cfg)

    def multi_step(state, cache: Dict[str, torch.Tensor], idxs: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        per_step = []
        for idx in idxs.unbind(0):
            batch = {k: cache[k].index_select(0, idx) for k in TRAIN_KEYS}
            if generator is not None:
                generator.manual_seed(step_seed(cfg.seed, state.step))
            state, metrics = step(state, batch, generator)
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    return multi_step


def epoch_index_groups(n: int, batch_size: int, steps_per_dispatch: int,
                       seed: int, epoch: int,
                       skip: int = 0) -> List[np.ndarray]:
    """The epoch's dispatch schedule: the loader's shuffled order with the
    last partial batch dropped, as [K, B] groups and at most one shorter
    remainder, without the first `skip` batches (mid-epoch resume)."""
    order = shuffled_order(n, seed, epoch)
    nb = n // batch_size
    batches = order[: nb * batch_size].reshape(nb, batch_size)[skip:]
    k = max(1, steps_per_dispatch)
    return [batches[i: i + k] for i in range(0, len(batches), k)]


# ---------------------------------------------------------------------------
# Cached evaluation
# ---------------------------------------------------------------------------

def upload_eval_cache(dataset, batch_size: int, device="cuda",
                      layout: str = "auto"
                      ) -> Tuple[Dict[str, torch.Tensor], np.ndarray, int]:
    """images and orig_size of the dataset as [nb, B, ...] on `device`,
    the last batch padded with zero rows. Returns (cache, image_ids,
    n_real)."""
    resolve_layout(layout)
    keys = ("images", "orig_size")
    n = len(dataset)
    nb = -(-n // batch_size)
    check_fits(nb * batch_size * cache_nbytes(dataset, keys) // max(n, 1),
               device, "validation-set cache")
    arrays = _dataset_arrays(dataset, keys)
    if hasattr(dataset, "get_batch"):
        ids = dataset.get_batch(np.arange(n))["image_id"]
    else:
        ids = np.asarray([dataset.get_example(i)["image_id"]
                          for i in range(n)])
    pad = nb * batch_size - n
    for k, v in arrays.items():
        if pad:
            v = np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
        arrays[k] = v.reshape((nb, batch_size) + v.shape[1:])
    return _to_device(arrays, device), np.asarray(ids), n


def make_cached_eval(cfg: TrainConfig, max_detections: int = 100,
                     parity_mode: bool = False):
    """eval_all(params, cache) -> the packed top-k [nb, B, K, 6] of every
    cached batch, all queued on the card before any copy back."""
    step = make_eval_topk_step(cfg, max_detections=max_detections,
                               parity_mode=parity_mode)

    def eval_all(params, cache):
        return torch.stack([step(params, images, orig)["topk"]
                            for images, orig in zip(cache["images"],
                                                    cache["orig_size"])])

    return eval_all


def write_predictions(path: str, ids, cats, boxes, scores) -> None:
    """COCO result JSON from flat arrays, written as a stream: no list of
    per-detection dicts is built."""
    with open(path, "w") as f:
        f.write("[")
        for i, (ii, cc, bb, ss) in enumerate(zip(
                ids.tolist(), cats.tolist(), boxes.tolist(),
                scores.tolist())):
            f.write(", " if i else "")
            f.write(json.dumps({"image_id": ii, "category_id": cc,
                                "bbox": bb, "score": ss}))
        f.write("]")


def evaluate_cached(eval_all, params, cache: Dict[str, torch.Tensor],
                    image_ids: np.ndarray, n_real: int,
                    label_to_cat_id: Dict[int, int],
                    output_file: Optional[str] = None,
                    score_threshold: float = 0.05,
                    parity_mode: bool = False,
                    return_arrays: bool = False):
    """evaluate_dataset's result over an uploaded cache, with one copy to
    the host: the COCO result dicts, or with `return_arrays` the flat
    (image_ids, category_ids, boxes, scores) arrays for
    `CocoEvaluator.evaluate_arrays` (the predictions file is then written
    from the arrays)."""
    topk = eval_all(params, cache).cpu().numpy()
    topk = topk.reshape(-1, *topk.shape[2:])[:n_real]
    det_args = (topk[..., 0], topk[..., 1].astype(np.int32), topk[..., 2:],
                image_ids[:n_real], label_to_cat_id)
    kw = dict(score_threshold=score_threshold, parity_mode=parity_mode)
    if not return_arrays:
        results = format_detections(*det_args, **kw)
        if output_file:
            with open(output_file, "w") as f:
                json.dump(results, f)
        return results
    arrays = select_above_threshold(*det_args, **kw)
    if output_file:
        write_predictions(output_file, *arrays)
    return arrays
