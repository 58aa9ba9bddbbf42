"""Time the auction's solve on the card: the kernel (csrc/auction.cu)
beside its plain version (the batched tensor-op rounds, `_solve_eager`),
on the matcher's problems at the benchmark's coco100 shapes.

    python -m dinov2_od_tpu_torch.tools.bench_auction [--batches 128 16]
        [--problems 4] [--reps 20] [--seed 0]

Problems come from `matcher_problem`: random predictions of 50 queries
against COCO-like GT (1 + geometric counts of mean 7.3 in 100 slots),
through the matcher's own cost and the auction's construction. Prints
one JSON line a batch size: the kernel's device ms a launch
(torch.profiler), the solve's ms a call on the host clock (the launch,
the kernel and the one sync that reads the rounds back), the plain
version's ms a call, the rounds a call, the benefit's bytes and their
time at 3.35 TB/s, the kernel's us a round of the longest image (the
chain that bounds it), and whether kernel and plain agree exactly; then
the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import MatcherConfig
from ..ops import auction, matching

# auction_assign's defaults, as the matcher calls it.
DELTA, EPS, EPS0, THETA, ROUNDS_PER_STEP, ROUND_CAP = (
    4e-3, 1e-3, 0.1, 4.0, 8, 4000)
HBM_BYTES_PER_S = 3.35e12


def matcher_problem(seed: int, batch: int, queries: int = 50,
                    slots: int = 100, gt_mean: float = 7.3,
                    ties: bool = False, near_duplicates: bool = False,
                    device="cpu"):
    """The auction's inputs as the matcher builds them (`auction_problem`)
    from random predictions and GT: `batch` images of `queries` queries
    against `slots` GT slots, 1 + Geometric(1 / gt_mean) of them valid
    (clipped to the slots). `ties` copies a quarter of each image's
    queries and valid GT slots from others, so costs tie exactly;
    `near_duplicates` puts 93% of the slots' boxes within 0.01 of one
    box. Returns `auction_assign`'s arguments: (cost [B, Q, N], row_valid
    [B, Q], col_pad [B, N], scale_phases)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(batch, queries, 91)).astype(np.float32)
    pb = np.clip(rng.uniform(0.1, 0.9, (batch, queries, 4))
                 * [1, 1, 0.3, 0.3], 0.02, 1).astype(np.float32)
    gl = rng.integers(0, 91, size=(batch, slots))
    gb = np.clip(rng.uniform(0.1, 0.9, (batch, slots, 4))
                 * [1, 1, 0.3, 0.3], 0.02, 1).astype(np.float32)
    counts = np.minimum(rng.geometric(1.0 / gt_mean, size=batch), slots)
    if near_duplicates:
        counts[:] = int(0.93 * slots)
        base = rng.uniform(0.2, 0.8, (batch, 1, 4))
        gb = np.clip(base + rng.normal(scale=0.01, size=(batch, slots, 4)),
                     0.02, 0.98).astype(np.float32)
        gl = rng.integers(0, 6, size=(batch, slots))
    if ties:
        for b in range(batch):
            q_src = rng.integers(0, queries, queries // 4)
            q_dst = rng.integers(0, queries, queries // 4)
            logits[b, q_dst], pb[b, q_dst] = logits[b, q_src], pb[b, q_src]
            c = int(counts[b])
            g_src = rng.integers(0, c, (c + 3) // 4)
            g_dst = rng.integers(0, c, (c + 3) // 4)
            gl[b, g_dst], gb[b, g_dst] = gl[b, g_src], gb[b, g_src]
    valid = np.arange(slots)[None, :] < counts[:, None]
    args = [torch.from_numpy(x).to(device) for x in (logits, pb, gl, gb,
                                                     valid)]
    cost_qg = matching.matching_cost_matrix(*args, MatcherConfig())
    return matching.auction_problem(cost_qg, args[4], queries, slots)


def solve_inputs(cost, row_valid, col_pad, scale_phases):
    """What `auction_assign` hands its solve, at its defaults: (benefit,
    row_valid, eps phases)."""
    return (auction._benefit(cost, col_pad, DELTA).contiguous(), row_valid,
            auction._eps_phases(EPS, scale_phases, EPS0, THETA))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _host_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _kernel_device_ms(fn, reps: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) or e.cuda_time_total
             for e in prof.key_averages() if "auction_kernel" in e.key)
    return us / 1e3 / reps


def bench(batch: int, problems: int, reps: int, seed: int) -> dict:
    rows = []
    for i in range(problems):
        benefit, row_valid, phases = solve_inputs(*matcher_problem(
            seed + i, batch, ties=bool(i % 2), device="cuda"))
        args = (benefit, row_valid, phases, ROUNDS_PER_STEP, ROUND_CAP)
        got = auction._solve_kernel(*args)
        want = auction._solve_eager(*args)
        equal = (all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
                 and got[3] == want[3])
        rows.append({
            "rounds": got[3], "equal": equal,
            "kernel_ms": _kernel_device_ms(
                lambda: auction._solve_kernel(*args), reps),
            "call_ms": _host_ms(lambda: auction._solve_kernel(*args), reps),
            "plain_ms": _host_ms(lambda: auction._solve_eager(*args),
                                 max(1, reps // 10))})
    b, m, n = benefit.shape
    kernel_ms = [r["kernel_ms"] for r in rows]
    rounds = [r["rounds"] for r in rows]
    return {
        "shape": [b, m, n], "problems": problems,
        "equal": all(r["equal"] for r in rows), "rounds": rounds,
        "kernel_ms": kernel_ms, "call_ms": [r["call_ms"] for r in rows],
        "plain_ms": [r["plain_ms"] for r in rows],
        "benefit_bytes": b * m * n * 4,
        "bytes_bound_ms": b * m * n * 4 / HBM_BYTES_PER_S * 1e3,
        "us_per_round": [k * 1e3 / r for k, r in zip(kernel_ms, rounds)],
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[128, 16])
    ap.add_argument("--problems", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_auction: no CUDA device")
    for batch in args.batches:
        print(json.dumps({"bench_auction": bench(batch, args.problems,
                                                 args.reps, args.seed)}),
              flush=True)
    print(json.dumps({"card": card_line(),
                      "device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
