"""Fine-tuning traffic and its runner: a pool of distinct batches on the
card, cycled through the port's train step for the window.

The traffic's parameters (`traffic` in the workload file):
  batch_size, gt_slots   the step's batch and padded GT slots;
  gt_mean                mean GT boxes an image (1 + a geometric law,
                         clipped to gt_slots);
  box_shares             shares of small, medium and large boxes;
  labels                 "coco80" or "voc20": the GT classes drawn from;
  pool_batches           distinct batches made at set-up and cycled;
  warm_steps             steps after the checked ones, before the window
                         (past the first fast-moving steps of a fresh
                         head, whose matching takes more auction rounds);
  trace_steps            steps in the profiled sub-window.
The workload's `checks` give `first_steps`, the steps the reference
follows, and the limits.

Every seed gets the same multiset of GT counts (the law's quantiles at
evenly spaced points, shuffled by the seed), so seeds change which image
holds which count and where the boxes lie, not how much matching there
is. Images are uniform noise in uint8, made on the card.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List

import numpy as np

from ..harness import flops, port_config, weights
from ..harness.checks import (dtype_departures, lower_precision_launches,
                              train_gaps)
from ..harness.common import Check
from ..harness.context import Outcome, Readings, RunContext

# COCO's 80 category ids (of 1-90) and VOC's 20 classes as 1-20.
COCO80 = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19,
          20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38,
          39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
          56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75,
          76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90)
LABELS = {"coco80": COCO80, "voc20": tuple(range(1, 21))}
# COCO's area bands (small < 32^2, medium < 96^2 px) as shares of a 640 x
# 480 image; the smallest and largest boxes drawn.
AREA_BANDS = ((8.0 ** 2 / 307200, 32.0 ** 2 / 307200),
              (32.0 ** 2 / 307200, 96.0 ** 2 / 307200),
              (96.0 ** 2 / 307200, 0.9))
B1 = 0.9  # Adam's first-moment decay, to read the first gradient back


def gt_counts(n: int, mean: float, slots: int,
              rng: np.random.Generator) -> np.ndarray:
    """n GT counts: 1 + Geometric(p = 1 / mean) (mean `mean`) at the
    quantiles (i + 0.5) / n, clipped to `slots`, in an order drawn by
    `rng`."""
    u = (np.arange(n) + 0.5) / n
    k = 1 + np.floor(np.log1p(-u) / math.log1p(-1.0 / mean))
    k = np.minimum(k, slots).astype(np.int64)
    rng.shuffle(k)
    return k


def draw_boxes(n: int, shares, rng: np.random.Generator) -> np.ndarray:
    """n boxes (cx, cy, w, h) in [0, 1]: a size band by `shares`, the area
    log-uniform inside it, the aspect log-uniform in [1/2, 2], the box
    inside the image."""
    p = np.asarray(shares, np.float64)
    band = rng.choice(3, size=n, p=p / p.sum())
    lo = np.log([AREA_BANDS[b][0] for b in band])
    hi = np.log([AREA_BANDS[b][1] for b in band])
    area = np.exp(rng.uniform(lo, hi))
    aspect = np.exp(rng.uniform(math.log(0.5), math.log(2.0), n))
    w = np.minimum(np.sqrt(area * aspect), 1.0)
    h = np.minimum(np.sqrt(area / aspect), 1.0)
    cx = rng.uniform(w / 2, 1 - w / 2)
    cy = rng.uniform(h / 2, 1 - h / 2)
    return np.stack([cx, cy, w, h], axis=-1).astype(np.float32)


def make_targets(traffic: dict, batches: int, seed: int) -> List[dict]:
    """The pool's GT as numpy arrays: labels [B, G] int64, boxes
    [B, G, 4] float32, valid [B, G] bool, for `batches` batches."""
    rng = np.random.default_rng(seed)
    b, g = traffic["batch_size"], traffic["gt_slots"]
    counts = gt_counts(batches * b, traffic["gt_mean"], g, rng)
    labels_from = np.asarray(LABELS[traffic["labels"]], np.int64)
    out = []
    for i in range(batches):
        c = counts[i * b:(i + 1) * b]
        valid = np.arange(g)[None, :] < c[:, None]
        labels = np.zeros((b, g), np.int64)
        boxes = np.tile(np.array([0.5, 0.5, 0.1, 0.1], np.float32), (b, g, 1))
        n = int(valid.sum())
        labels[valid] = rng.choice(labels_from, size=n)
        boxes[valid] = draw_boxes(n, traffic["box_shares"], rng)
        out.append({"labels": labels, "boxes": boxes, "valid": valid})
    return out


def make_pool(traffic: dict, image_size: int, seed: int, device) -> List[dict]:
    """The pool of distinct batches on `device`: uint8 noise images from a
    generator on the device, GT from `make_targets`."""
    import torch

    n = traffic["pool_batches"]
    b = traffic["batch_size"]
    gen = torch.Generator(device=device).manual_seed((seed + 1) % 2**63)
    images = torch.randint(0, 256, (n, b, image_size, image_size, 3),
                           generator=gen, device=device, dtype=torch.uint8)
    pool = []
    for i, t in enumerate(make_targets(traffic, n, seed)):
        pool.append({"images": images[i],
                     "labels": torch.from_numpy(t["labels"]).to(device),
                     "boxes": torch.from_numpy(t["boxes"]).to(device),
                     "valid": torch.from_numpy(t["valid"]).to(device)})
    return pool


def quarters(stamps: List[float], rounds: List[int], rounds0: int,
             batch: int, window_s: float):
    """Images a second, and the auction's rounds a step, in each quarter
    of the window, by the host's time at each step's return and the
    matcher's running count of rounds then."""
    q = window_s / 4
    steps, spent = [0] * 4, [0] * 4
    prev = rounds0
    for t, r in zip(stamps, rounds):
        k = min(int(t / q), 3)
        steps[k] += 1
        spent[k] += r - prev
        prev = r
    return ([c * batch / q for c in steps],
            [r / max(c, 1) for r, c in zip(spent, steps)])


def dropout_seed(seed: int, step: int) -> int:
    return (seed * 1_000_003 + step) % 2**63


def _norms(tree: Dict[tuple, "object"]) -> Dict[tuple, float]:
    import torch
    return {p: float(torch.linalg.vector_norm(t.float()))
            for p, t in tree.items()}


def run(ctx: RunContext) -> Outcome:
    import torch
    from torch.profiler import record_function

    cfg = ctx.cell.config
    traffic = ctx.cell.workload["traffic"]
    checks_spec = ctx.cell.workload["checks"]
    dev = ctx.device
    tcfg = port_config.train_config(cfg, traffic)
    if ctx.control == "int8":
        # The port's own int8 path: the W8A8 backbone prefix (B6).
        det = tcfg.detector
        tcfg = dataclasses.replace(tcfg, detector=dataclasses.replace(
            det, backbone=dataclasses.replace(det.backbone,
                                              prefix_int8=True)))
    b = traffic["batch_size"]
    prog = ctx.program

    ctx.mark("imports")
    params = weights.make_params(tcfg.detector, cfg["backbone_dtype"],
                                 ctx.seed, dev)
    stated = {p: leaf.dtype for p, leaf in weights.leaf_items(params)}
    lower0 = lower_precision_launches(prog.launch_counts)
    state = prog.create_train_state(params, tcfg.optim, tcfg.detector)
    step_fn = prog.make_train_step(tcfg)
    pool = make_pool(traffic, cfg["image_size"], ctx.seed, dev)
    ctx.mark("weights and pool")
    gen = torch.Generator(device=dev)
    n_first = checks_spec["first_steps"]

    def step(i: int):
        gen.manual_seed(dropout_seed(ctx.seed, i))
        return step_fn(state, pool[i % len(pool)], gen)

    # The first steps, from the seed's weights: the readings the reference
    # follows. Adam's first moment after one step is (1 - b1) times the
    # gradient it received.
    trainable = {p: leaf for p, leaf in weights.leaf_items(state.params)
                 if _get(state.opt_state.mu, p) is not None}
    p0 = {p: t.detach().clone() for p, t in trainable.items()}
    losses, grad1 = [], {}
    for i in range(n_first):
        state, m = step(i)
        losses.append(float(m["loss"]))
        if i == 0:
            grad1 = {p: v / (1.0 - B1) for p, v in _norms(
                {p: _get(state.opt_state.mu, p) for p in trainable}).items()}
    change = _norms({p: trainable[p].detach() - p0[p] for p in trainable})
    del p0
    prog_readings = {"losses": losses, "grad1": grad1, "change": change}
    if ctx.control == "reference":
        from ..reference.model import LOWER
        prog_readings = reference_readings(cfg, tcfg.detector,
                                           pool[:n_first], ctx.seed,
                                           n_first, dev, LOWER)
    ctx.mark("first steps")
    # Warm-up beyond the checked steps: the window starts steady.
    for i in range(n_first, n_first + traffic.get("warm_steps", 2)):
        state, _ = step(i)
    i_next = n_first + traffic.get("warm_steps", 2)
    ctx.sync()

    stats0 = dict(prog.solver_stats)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    losses_w, stamps, rounds = [], [], []
    n = 0
    while time.perf_counter() - t0 < ctx.seconds:
        state, m = step(i_next + n)
        losses_w.append(m["loss"].detach())
        n += 1
        stamps.append(time.perf_counter() - t0)
        rounds.append(prog.solver_stats["auction_rounds"])
    ctx.sync()
    window_s = time.perf_counter() - t0
    rates, per_step = quarters(stamps, rounds, stats0["auction_rounds"], b,
                               window_s)
    ctx.log("window by quarter (host clock at each step's return): "
            "images/s " + " ".join(f"{v:.1f}" for v in rates)
            + "; auction rounds a step "
            + " ".join(f"{v:.1f}" for v in per_step))
    stats1 = dict(prog.solver_stats)
    i_next += n
    failed = (int((~torch.isfinite(torch.stack(losses_w))).sum())
              if losses_w else 0)

    summary, trace_steps = None, traffic["trace_steps"]
    if ctx.trace:
        from ..harness.trace import profile_window

        def body():
            nonlocal state
            for j in range(trace_steps):
                with record_function("bench.step"):
                    state, _ = step(i_next + j)
        summary = profile_window(body, ctx.sync)

    peak = (torch.cuda.max_memory_allocated(dev) if ctx.on_card else 0)
    lower = (lower_precision_launches(prog.launch_counts) - lower0
             + dtype_departures(dict(weights.leaf_items(state.params)),
                                stated))
    del state, step_fn, params, trainable, losses_w
    if ctx.on_card:
        torch.cuda.empty_cache()

    ref = reference_readings(cfg, tcfg.detector, pool[:n_first], ctx.seed,
                             n_first, dev)
    gaps = train_gaps(prog_readings, ref)
    limits = checks_spec["limits"]
    checks = [Check(k, gaps[k], limits[k]) for k in ("loss_gap", "grad1_gap",
                                                    "change_gap")]
    checks.append(Check("lower_precision", float(lower), 0.0))
    ctx.log(f"first losses: program {losses} reference {ref['losses']}")

    images = n * b
    counters = {"steps": n, "images": images,
                "auction_rounds": stats1["auction_rounds"]
                - stats0["auction_rounds"],
                "auction_calls": stats1["auction"] - stats0["auction"],
                "jv_calls": stats1["jv"] - stats0["jv"]}
    readings = Readings(
        kind="train", window_s=window_s,
        model_flops=flops.train_flops(cfg, images), counters=counters,
        trace=summary,
        trace_attention_bound_s=trace_steps * flops.attention_work(
            cfg, b, train=True)["bound_s"],
        trace_steps=trace_steps, window_units=n)
    return Outcome(
        end_to_end={"train_images_per_s": images / window_s,
                    "setup_s": setup_s},
        units={"train_images_per_s": "images/s", "setup_s": "s"},
        attempted=n, failed=failed, memory_peak_bytes=int(peak),
        checks=checks, readings=readings)


def reference_readings(cfg: dict, det_cfg, batches, seed: int, steps: int,
                       device, prec=None) -> dict:
    """The plain reference's first steps from the seed's weights, made
    again, on the pool's first batches with the same dropout seeds."""
    from ..reference import model as M
    from ..reference.train import train_steps

    with M.fp32_matmuls():
        params = weights.make_params(det_cfg, cfg["backbone_dtype"], seed,
                                     device)
        return train_steps(params, cfg, list(batches),
                           [dropout_seed(seed, i) for i in range(steps)],
                           prec or M.FP32, cfg["image_mean"],
                           cfg["image_std"])


def _get(tree, path):
    for k in path:
        if tree is None:
            return None
        tree = tree[k]
    return tree
