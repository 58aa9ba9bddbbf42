"""Host input-pipeline benchmark: from-disk decode, loader, and
end-to-end train and eval throughput on image files (counterpart of
tools/bench_input.py).

Every other bench feeds batches already on the card; this one measures
the decode backends (data/coco.py), the threaded loader, the packed
memmaps, the uint8 feed with `device_prefetch`, and the from-disk train
and eval rates against the rates of the same step on a batch already on
the card. With `--device_cache` it also runs the train and eval paths of
train/device_cache.py (the set on the card, K steps a dispatch).

The dataset is synthetic COCO written by `write_coco_dataset` as 640 px
JPEGs under `--dir` (default `build/coco_syn640` in the repository,
which .gitignore lists), written once and reused.

    python -m dinov2_od_tpu_torch.tools.bench_input [--gen 2000]
        [--train] [--eval] [--packed] [--device_cache]
        [--steps_per_dispatch 8] [--skip_host] [--device cuda]

`BENCH_QUANT=int8` evaluates with the int8 W8A8 backbone. The flagship
step is the port's bench configuration (`bench.bench_config`: ViT-B/14
at 224 px, bf16 backbone, batch 32, 25 GT slots). The JAX tool's Grain
loader has no port; the output says so. Prints the JAX tool's progress
lines and, last, its JSON dict of rates (images/s) with
`decode_backend_auto`, what 'auto' resolved to in this process. Host
phases run anywhere; the train and eval phases run on the CUDA card, or
on the CPU with `--device cpu` (no CPU rate is a device rate).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Optional

REPO = Path(__file__).resolve().parent.parent.parent
TRAIN_KEYS = ("images", "boxes", "labels", "valid")


def ensure_dataset(path: str, n: int, size: int, out=None) -> tuple:
    """(images_dir, annotation file) of at least `n` synthetic JPEGs at
    `size` px under `path`, written if missing."""
    from ..data.synthetic import write_coco_dataset

    images_dir = os.path.join(path, "images")
    ann = os.path.join(path, "annotations.json")
    if os.path.isdir(images_dir) and os.path.exists(ann):
        have = len([f for f in os.listdir(images_dir) if f.endswith(".jpg")])
        if have >= n:
            return images_dir, ann
    print(f"writing {n} synthetic {size}px JPEGs to {path} ...", file=out)
    t0 = time.time()
    res = write_coco_dataset(path, num_images=n, image_size=size, fmt="jpg")
    print(f"  wrote in {time.time() - t0:.1f}s", file=out, flush=True)
    return res


def bench_decode(images_dir: str, ann: str, image_size: int, n: int = 300,
                 out=None) -> dict:
    """Single-thread per-example rates of each backend and dtype. A
    backend that is not available here is left out and said so; the
    'auto' row is named by what it resolved to."""
    from ..data import coco, native_decode

    auto = coco.resolved_decode_backend()
    variants = [("pil_float32", dict(decode_backend="pil",
                                     output_dtype="float32")),
                ("pil_uint8", dict(decode_backend="pil",
                                   output_dtype="uint8"))]
    if coco._cv2():
        variants.append(("cv2_uint8", dict(decode_backend="cv2",
                                           output_dtype="uint8")))
    else:
        print("  decode cv2_uint8: cv2 does not import here", file=out)
    if auto == "native":
        variants.append(("native_uint8", dict(decode_backend="auto",
                                              output_dtype="uint8")))
    else:
        print(f"  decode native_uint8: the native decoder is unavailable "
              f"('auto' resolved to {auto!r})", file=out)
    results = {}
    for name, kw in variants:
        ds = coco.CocoDetectionDataset(images_dir, ann, image_size, **kw)
        m = min(n, len(ds))
        ds.get_example(0)  # warm caches and lazy imports
        t0 = time.perf_counter()
        for i in range(m):
            ds.get_example(i)
        dt = time.perf_counter() - t0
        results[name] = m / dt
        print(f"  decode {name}: {m / dt:.1f} img/s ({dt / m * 1e3:.2f} ms)",
              file=out, flush=True)

    if auto == "native":  # one call, the C thread pool
        ds = coco.CocoDetectionDataset(images_dir, ann, image_size,
                                       output_dtype="uint8",
                                       decode_backend="auto")
        paths = [os.path.join(images_dir, ds.images[i]["file_name"])
                 for i in ds.image_ids[: min(n, len(ds))]]
        native_decode.decode_batch(paths[:8], image_size)  # warm
        t0 = time.perf_counter()
        _, failed = native_decode.decode_batch(paths, image_size)
        dt = time.perf_counter() - t0
        if failed:
            raise RuntimeError(f"native batch decode failed on {failed}")
        results["native_batch"] = len(paths) / dt
        print(f"  decode native_batch: {len(paths) / dt:.1f} img/s",
              file=out, flush=True)
    return results


def _timed_pass(loader, n_img: int) -> float:
    """images/s of one pass over up to n_img images, the iterator's
    construction included (prefetch fills during the first next())."""
    t0 = time.perf_counter()
    seen = 0
    for b in loader:
        seen += len(b["images"])
        if seen >= n_img:
            break
    return seen / (time.perf_counter() - t0)


def bench_loader(images_dir: str, ann: str, image_size: int, batch: int,
                 out=None) -> dict:
    """The threaded loader's rate at 1, 2, 4 and 8 workers ('auto'
    decode, uint8)."""
    from ..data.coco import CocoDetectionDataset
    from ..data.loader import DataLoader

    ds = CocoDetectionDataset(images_dir, ann, image_size,
                              output_dtype="uint8",
                              decode_backend="auto")
    n_img = min(len(ds), 1024)
    results = {}
    for workers in (1, 2, 4, 8):
        rate = _timed_pass(
            DataLoader(ds, batch, num_workers=workers, drop_last=True), n_img)
        results[f"threaded_w{workers}"] = rate
        print(f"  loader threaded_w{workers}: {rate:.1f} img/s", file=out,
              flush=True)
    print("  grain: not ported (the port has no Grain loader)", file=out)
    return results


def ensure_packed(images_dir: str, ann: str, image_size: int,
                  out=None) -> str:
    """Pack (decode once) the bench dataset; returns the packed dir."""
    from ..data.coco import CocoDetectionDataset
    from ..data.packed import pack_dataset

    packed = os.path.join(os.path.dirname(images_dir), f"packed_{image_size}")
    if os.path.exists(os.path.join(packed, "meta.json")):
        return packed
    ds = CocoDetectionDataset(images_dir, ann, image_size, max_boxes=25,
                              output_dtype="uint8",
                              decode_backend="auto")
    t0 = time.perf_counter()
    pack_dataset(ds, packed)
    dt = time.perf_counter() - t0
    print(f"  packed {len(ds)} images in {dt:.1f}s ({len(ds) / dt:.1f} "
          f"img/s)", file=out, flush=True)
    return packed


def bench_packed_loader(packed_dir: str, batch: int,
                        out=None) -> dict:
    """The loader over the packed memmaps, cold and then warm page
    cache; the warm rate is returned."""
    from ..data.loader import DataLoader
    from ..data.packed import PackedDataset

    ds = PackedDataset(packed_dir)
    loader = DataLoader(ds, batch, drop_last=True)
    n_img = min(len(ds), 2048)
    for phase in ("cold", "warm"):
        rate = _timed_pass(loader, n_img)
        print(f"  packed loader ({phase}): {rate:.1f} img/s", file=out,
              flush=True)
    return {"packed_loader": rate}


def flagship(batch: int, image_size: int, device: str,
             cfg_override: Optional[Callable] = None):
    """(cfg, params, device batch) of the bench's flagship step: ViT-B/14
    bf16, `batch` images at `image_size`, 25 GT slots, random weights from
    seed 0 (`cfg_override(cfg)` may replace the config)."""
    from ..bench import bench_config, bench_inputs

    cfg = bench_config({"BENCH_BATCH": str(batch),
                        "BENCH_IMAGE_SIZE": str(image_size)})
    if cfg_override is not None:
        cfg = cfg_override(cfg)
    params, dev_batch = bench_inputs(cfg, device=device)
    return cfg, params, dev_batch


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def bench_train_from_disk(images_dir: str, ann: str, image_size: int,
                          batch: int, packed_dir: Optional[str] = None,
                          device: str = "cuda", cfg_override=None,
                          out=None) -> dict:
    """From-disk train images/s (decode, copy in and step overlapped by
    the loader's threads and `device_prefetch`) on the flagship step,
    beside the same step's rate on a batch already on the card. With
    `packed_dir` the loader reads the packed memmaps instead of JPEGs."""
    import torch

    from ..data.coco import CocoDetectionDataset
    from ..data.loader import DataLoader, device_prefetch
    from ..data.packed import PackedDataset
    from ..train.state import create_train_state
    from ..train.step import make_train_step
    from ..utils.benchmark import measure_steps_per_sec

    cfg, params, dev_batch = flagship(batch, image_size, device,
                                      cfg_override)
    state = create_train_state(params, cfg.optim, cfg.detector)
    step = make_train_step(cfg)
    gen = torch.Generator(device=device).manual_seed(1)
    sec, _ = measure_steps_per_sec(step, state, dev_batch, gen, iters=8,
                                   device=device)
    device_rate = batch / sec
    print(f"  device-only train: {device_rate:.1f} img/s", file=out,
          flush=True)

    if packed_dir is not None:
        ds = PackedDataset(packed_dir, max_boxes=25)
    else:
        ds = CocoDetectionDataset(images_dir, ann, image_size, max_boxes=25,
                                  output_dtype="uint8",
                                  decode_backend="auto")
    loader = DataLoader(ds, batch, shuffle=True, drop_last=True)
    warmup, seen, t0, last = 3, 0, None, None
    if len(loader) <= warmup:
        raise ValueError(f"the train phase times the steps after {warmup}; "
                         f"{len(ds)} images give {len(loader)} batches of "
                         f"{batch}")
    for i, b in enumerate(device_prefetch(iter(loader), device, size=2,
                                          device_keys=TRAIN_KEYS)):
        state, metrics = step(state, {k: b[k] for k in TRAIN_KEYS}, gen)
        last = metrics["loss"]
        if i + 1 == warmup:
            float(last)
            t0 = time.perf_counter()
        elif i + 1 > warmup:
            seen += batch
    float(last)  # the whole tail done
    disk_rate = seen / (time.perf_counter() - t0)
    tag = "packed" if packed_dir is not None else "disk"
    print(f"  from-{tag} train: {disk_rate:.1f} img/s over {seen} images "
          f"({disk_rate / device_rate * 100:.0f}% of device-only)", file=out,
          flush=True)
    return {f"train_from_{tag}": disk_rate, "train_device_only": device_rate}


def bench_device_cache(packed_dir: str, image_size: int, batch: int,
                       steps_per_dispatch: int = 8, device: str = "cuda",
                       cfg_override=None, out=None) -> dict:
    """Train and eval images/s with the dataset on the card
    (train/device_cache.py): the host sends one [K, B] index group a
    dispatch of K steps."""
    import torch

    from ..bench import eval_params
    from ..data.packed import PackedDataset
    from ..train.device_cache import (epoch_index_groups, evaluate_cached,
                                      index_tensor, make_cached_eval,
                                      make_multi_train_step,
                                      upload_eval_cache, upload_train_cache)
    from ..train.state import create_train_state, tree_map

    cfg, params, _ = flagship(batch, image_size, device, cfg_override)
    ds = PackedDataset(packed_dir, max_boxes=25)
    res = {}
    t0 = time.perf_counter()
    cache = upload_train_cache(ds, device)
    _sync(device)
    print(f"  train cache upload: {time.perf_counter() - t0:.1f}s "
          f"({sum(v.nbytes for v in cache.values()) / 1e6:.0f} MB)",
          file=out, flush=True)

    # The serving tree before training: the step updates leaves in place.
    ev_params = tree_map(torch.clone, eval_params(
        params, cfg, os.environ.get("BENCH_QUANT", "")))
    state = create_train_state(params, cfg.optim, cfg.detector)
    multi = make_multi_train_step(cfg)
    gen = torch.Generator(device=device).manual_seed(1)
    groups = epoch_index_groups(len(ds), batch, steps_per_dispatch, 0, 0)
    state, m = multi(state, cache, index_tensor(groups[0], device), gen)
    float(m["loss"][-1])  # warm
    t0 = time.perf_counter()
    seen = 0
    for g in groups[1:]:
        if g.shape[0] != steps_per_dispatch:
            break
        state, m = multi(state, cache, index_tensor(g, device), gen)
        seen += g.size
    float(m["loss"][-1])
    rate = seen / (time.perf_counter() - t0)
    print(f"  device-cache train (K={steps_per_dispatch}): {rate:.1f} img/s "
          f"over {seen} images", file=out, flush=True)
    res["train_device_cache"] = rate
    del cache

    ecache, ids, n = upload_eval_cache(ds, batch, device)
    eval_all = make_cached_eval(cfg)
    evaluate_cached(eval_all, ev_params, ecache, ids, n,
                    ds.label_to_cat_id)  # warm
    t0 = time.perf_counter()
    results = evaluate_cached(eval_all, ev_params, ecache, ids, n,
                              ds.label_to_cat_id)
    rate = n / (time.perf_counter() - t0)
    print(f"  device-cache eval: {rate:.1f} img/s over {n} images, "
          f"{len(results)} detections", file=out, flush=True)
    res["eval_device_cache"] = rate
    t0 = time.perf_counter()
    arrays = evaluate_cached(eval_all, ev_params, ecache, ids, n,
                             ds.label_to_cat_id, return_arrays=True)
    rate = n / (time.perf_counter() - t0)
    print(f"  device-cache eval (array-native): {rate:.1f} img/s, "
          f"{len(arrays[0])} detections", file=out, flush=True)
    res["eval_device_cache_arrays"] = rate
    return res


def bench_eval_from_disk(images_dir: str, ann: str, image_size: int,
                         batch: int, packed_dir: Optional[str] = None,
                         device: str = "cuda", cfg_override=None,
                         out=None) -> dict:
    """`evaluate_dataset` images/s from disk (its double-buffered path)
    beside the forward's rate on a batch already on the card."""
    import torch

    from ..bench import eval_params
    from ..data.coco import CocoDetectionDataset
    from ..data.packed import PackedDataset
    from ..models.detector import detector_apply
    from ..train.loop import evaluate_dataset
    from ..train.step import make_eval_topk_step
    from ..utils.benchmark import time_fn

    cfg, params, dev_batch = flagship(batch, image_size, device,
                                      cfg_override)
    ev_params = eval_params(params, cfg, os.environ.get("BENCH_QUANT", ""))
    with torch.inference_mode():
        sec = time_fn(lambda im: detector_apply(ev_params, cfg.detector, im,
                                                deterministic=True),
                      dev_batch["images"], device=device)
    device_rate = batch / sec
    print(f"  device-only eval: {device_rate:.1f} img/s", file=out,
          flush=True)

    if packed_dir is not None:
        ds = PackedDataset(packed_dir)
    else:
        ds = CocoDetectionDataset(images_dir, ann, image_size,
                                  output_dtype="uint8",
                                  decode_backend="auto")
    eval_step = make_eval_topk_step(cfg)
    evaluate_dataset(eval_step, ev_params, ds, batch,
                     ds.label_to_cat_id)  # warm
    t0 = time.perf_counter()
    results = evaluate_dataset(eval_step, ev_params, ds, batch,
                               ds.label_to_cat_id)
    rate = len(ds) / (time.perf_counter() - t0)
    tag = "packed" if packed_dir is not None else "disk"
    print(f"  from-{tag} eval: {rate:.1f} img/s over {len(ds)} images, "
          f"{len(results)} detections ({rate / device_rate * 100:.0f}% of "
          f"device-only)", file=out, flush=True)
    return {f"eval_from_{tag}": rate, "eval_device_only": device_rate}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=str(REPO / "build" / "coco_syn640"))
    ap.add_argument("--gen", type=int, default=2000,
                    help="ensure this many synthetic 640px JPEGs exist")
    ap.add_argument("--source_size", type=int, default=640)
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--skip_host", action="store_true")
    ap.add_argument("--train", action="store_true", help="train phase")
    ap.add_argument("--eval", action="store_true", help="eval phase")
    ap.add_argument("--packed", action="store_true",
                    help="feed the train/eval phases from the pre-decoded "
                         "packed memmaps instead of decoding JPEGs a step")
    ap.add_argument("--device_cache", action="store_true",
                    help="end-to-end train/eval with the dataset on the "
                         "card and K steps a dispatch (implies --packed)")
    ap.add_argument("--steps_per_dispatch", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the train and eval phases run: 'cuda' "
                         "(the default; raises without a card) or 'cpu'")
    return ap.parse_args(argv)


def run(args, cfg_override: Optional[Callable] = None,
        out=None) -> dict:
    """Every phase the flags ask for; prints and returns the JSON dict."""
    from ..data.coco import resolved_decode_backend

    if (args.train or args.eval or args.device_cache) and \
            args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("bench_input: no CUDA device for the train "
                               "and eval phases (pass --device cpu)")
    images_dir, ann = ensure_dataset(args.dir, args.gen, args.source_size,
                                     out)
    res = {"decode_backend_auto": resolved_decode_backend()}
    print(f"decode_backend 'auto' resolves to {res['decode_backend_auto']!r}",
          file=out, flush=True)
    packed_dir = None
    dev = dict(device=args.device, cfg_override=cfg_override, out=out)
    if args.packed or args.device_cache:
        print("packing (decode-once):", file=out)
        packed_dir = ensure_packed(images_dir, ann, args.image_size, out)
        res.update(bench_packed_loader(packed_dir, args.batch, out))
    if args.device_cache:
        print(f"device-cache ({args.device}):", file=out)
        res.update(bench_device_cache(packed_dir, args.image_size,
                                      args.batch, args.steps_per_dispatch,
                                      **dev))
    if not args.skip_host:
        print("decode (single thread):", file=out)
        res["decode"] = bench_decode(images_dir, ann, args.image_size,
                                     out=out)
        print("loader throughput:", file=out)
        res["loader"] = bench_loader(images_dir, ann, args.image_size,
                                     args.batch, out)
    if args.train:
        print(f"train from disk ({args.device}):", file=out)
        res.update(bench_train_from_disk(images_dir, ann, args.image_size,
                                         args.batch, packed_dir, **dev))
    if args.eval:
        print(f"eval from disk ({args.device}):", file=out)
        res.update(bench_eval_from_disk(images_dir, ann, args.image_size,
                                        args.batch, packed_dir, **dev))
    print(json.dumps(res), file=out, flush=True)
    return res


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
