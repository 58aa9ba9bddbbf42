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
rather than falling back to the host loader.

Two layouts, as in the JAX package, over a mesh of processes
(parallel/sharding.py; without one, a single data rank):
- 'replicated': every rank holds the whole cache, and a data rank's share
  of a global batch [B] is a gather of its contiguous B / D indices;
- 'sharded': data rank d holds rows [d n_pad / D, (d + 1) n_pad / D) (the
  rows zero-padded to a multiple of D; its tensor- and context-parallel
  peers hold the same rows), so the cache per rank shrinks D-fold. A
  batch is `sharded_batch_gather`: each rank gathers the rows of the
  global index it holds into a zero [B, ...], the data group sums them
  (JAX's psum_scatter; gloo has no reduce-scatter, so an all-reduce and a
  slice), and each rank keeps its B / D slice. One rank contributes each
  element, so the sum is exact in every dtype, the uint8 images included.
'auto' takes 'sharded' when the data axis is larger than 1; 'sharded' in
one process is the one-shard case. The validation cache lays each batch's
columns out by data rank (all of them in 'replicated', this rank's in
'sharded'), so the validation runs without a collective until its one
gather of the top-k.
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
from ..parallel.collectives import all_gather, all_reduce
from ..parallel.multihost import process_index
from ..parallel.sharding import data_place
from .step import make_eval_topk_step, make_train_step, step_seed

logger = logging.getLogger("dinov2_od_tpu_torch")

TRAIN_KEYS = ("images", "boxes", "labels", "valid")
LAYOUTS = ("auto", "replicated", "sharded")


def resolve_layout(layout: str, mesh=None,
                   batch_size: Optional[int] = None) -> str:
    """The cache layout a run over `mesh` takes for `layout`: 'auto' is
    'sharded' when the data axis is larger than 1 (the JAX package's
    rule), else 'replicated'. Raises when `batch_size` does not divide by
    the data axis."""
    if layout not in LAYOUTS:
        raise ValueError(f"device cache layout must be one of {LAYOUTS}, "
                         f"not {layout!r}")
    d, _ = data_place(mesh)
    if batch_size is not None and batch_size % d:
        raise ValueError(
            f"--device_cache: --batch_size {batch_size} is not divisible "
            f"by the mesh's data axis of {d} (mesh data {d} x context "
            f"{mesh.context_size} x model {mesh.model_size})")
    if layout == "auto":
        return "sharded" if d > 1 else "replicated"
    return layout


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


def upload_train_cache(dataset, device="cuda", layout: str = "auto",
                       mesh=None) -> Dict[str, torch.Tensor]:
    """images, boxes, labels and valid of the whole dataset on `device`,
    once: every row ('replicated') or this data rank's block of rows
    ('sharded'). Raises when the card lacks the memory."""
    layout = resolve_layout(layout, mesh)
    d, di = data_place(mesh)
    n = len(dataset)
    n_loc = -(-n // d) if layout == "sharded" else n
    check_fits(cache_nbytes(dataset) * n_loc // max(n, 1), device,
               "training-set cache")
    arrays = _dataset_arrays(dataset, TRAIN_KEYS)
    if arrays["images"].dtype != np.uint8:
        logger.warning("device cache with float images: 4x the memory of "
                       "a uint8 feed (use --feed_dtype uint8)")
    if layout == "sharded":
        pad = n_loc * d - n
        arrays = {k: np.concatenate([v, np.zeros((pad,) + v.shape[1:],
                                                 v.dtype)])[
                                                     di * n_loc:
                                                     (di + 1) * n_loc]
                  for k, v in arrays.items()}
    logger.info("uploading %.2f GB dataset cache to %s (%s, %d of %d rows)",
                sum(a.nbytes for a in arrays.values()) / 1e9, device, layout,
                n_loc, n)
    return _to_device(arrays, device)


def sharded_batch_gather(cache: Dict[str, torch.Tensor], idx: torch.Tensor,
                         mesh=None) -> Dict[str, torch.Tensor]:
    """This data rank's B / D rows of the global batch `idx` [B] from a
    'sharded' cache: the rows this rank holds gathered into zeros, summed
    over the data group, and this rank's contiguous slice kept. Exact in
    every dtype (one contributor an element); bit-equal to the
    replicated layout's gather."""
    d, di = data_place(mesh)
    n_loc = next(iter(cache.values())).shape[0]
    local = idx - di * n_loc
    ok = (local >= 0) & (local < n_loc)
    safe = torch.where(ok, local, torch.zeros_like(local))
    w = idx.shape[0] // d
    out = {}
    for k, x in cache.items():
        v = x.index_select(0, safe)
        was_bool = v.dtype == torch.bool
        if was_bool:
            v = v.to(torch.uint8)
        v = torch.where(ok.view((-1,) + (1,) * (v.dim() - 1)), v,
                        torch.zeros((), dtype=v.dtype, device=v.device))
        if d > 1:
            v = all_reduce(v, mesh.data_group, mesh.backend)
        v = v[di * w:(di + 1) * w]
        out[k] = v.bool() if was_bool else v
    return out


def replicated_batch_gather(cache: Dict[str, torch.Tensor],
                            idx: torch.Tensor,
                            mesh=None) -> Dict[str, torch.Tensor]:
    """This data rank's B / D rows of the global batch `idx` [B] from a
    'replicated' cache: its contiguous slice of the indices, gathered."""
    d, di = data_place(mesh)
    w = idx.shape[0] // d
    rows = idx[di * w:(di + 1) * w]
    return {k: cache[k].index_select(0, rows) for k in TRAIN_KEYS}


def index_tensor(group: np.ndarray, device) -> torch.Tensor:
    """A [K, B] index group on `device`: from pinned memory, without a
    wait, on CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(group, dtype=np.int64))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def make_multi_train_step(cfg: TrainConfig, train_step=None, mesh=None,
                          layout: str = "replicated"):
    """multi_step(state, cache, idxs [K, B] on the cache's device,
    generator) -> (state, metrics stacked [K]): K train steps on the
    cache's rows (each rank's share of each global batch, gathered as
    `layout` lays the cache out), each with `generator` seeded by
    (cfg.seed, its step), none waiting for the card beyond what the step
    itself waits for."""
    step = train_step or make_train_step(cfg, mesh)
    gather = (sharded_batch_gather if layout == "sharded"
              else replicated_batch_gather)

    def multi_step(state, cache: Dict[str, torch.Tensor], idxs: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        per_step = []
        for idx in idxs.unbind(0):
            batch = gather(cache, idx, mesh)
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
                      layout: str = "auto", mesh=None
                      ) -> Tuple[Dict[str, torch.Tensor], np.ndarray, int]:
    """images and orig_size of the dataset as [nb, B, ...] on `device`,
    the last batch padded with zero rows; in the 'sharded' layout this
    data rank's columns [nb, B / D, ...] only. Returns (cache, image_ids,
    n_real)."""
    layout = resolve_layout(layout, mesh, batch_size)
    d, di = data_place(mesh)
    cols = (slice(di * batch_size // d, (di + 1) * batch_size // d)
            if layout == "sharded" else slice(None))
    keys = ("images", "orig_size")
    n = len(dataset)
    nb = -(-n // batch_size)
    width = batch_size // d if layout == "sharded" else batch_size
    check_fits(nb * width * cache_nbytes(dataset, keys) // max(n, 1),
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
        arrays[k] = v.reshape((nb, batch_size) + v.shape[1:])[:, cols]
    return _to_device(arrays, device), np.asarray(ids), n


def make_cached_eval(cfg: TrainConfig, max_detections: int = 100,
                     parity_mode: bool = False, mesh=None,
                     layout: str = "replicated"):
    """eval_all(params, cache) -> the packed top-k [nb, B, K, 6] of every
    cached batch, all queued on the card before any copy back. Under a
    data axis of D, each rank runs its B / D columns of every batch (cut
    from a 'replicated' cache, held by a 'sharded' one), and the data
    group all-gathers the top-k once."""
    step = make_eval_topk_step(cfg, mesh, max_detections=max_detections,
                               parity_mode=parity_mode)
    d, di = data_place(mesh)

    def eval_all(params, cache):
        images, orig = cache["images"], cache["orig_size"]
        if layout != "sharded" and d > 1:
            w = images.shape[1] // d
            images = images[:, di * w:(di + 1) * w]
            orig = orig[:, di * w:(di + 1) * w]
        topk = torch.stack([step(params, x, o)["topk"]
                            for x, o in zip(images, orig)])
        if d > 1:
            topk = torch.cat(all_gather(topk, mesh.data_group, mesh.backend),
                             dim=1)
        return topk

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
    from the arrays). Every rank of a mesh gets the same result; world
    rank 0 alone writes the file."""
    topk = eval_all(params, cache).cpu().numpy()
    topk = topk.reshape(-1, *topk.shape[2:])[:n_real]
    det_args = (topk[..., 0], topk[..., 1].astype(np.int32), topk[..., 2:],
                image_ids[:n_real], label_to_cat_id)
    kw = dict(score_threshold=score_threshold, parity_mode=parity_mode)
    write = output_file and process_index() == 0
    if not return_arrays:
        results = format_detections(*det_args, **kw)
        if write:
            with open(output_file, "w") as f:
                json.dump(results, f)
        return results
    arrays = select_above_threshold(*det_args, **kw)
    if write:
        write_predictions(output_file, *arrays)
    return arrays
