"""qkv parameter-layout microbenchmark (counterpart of
tools/bench_qkv_layout.py).

Question: is storing q, k and v as one fused [D, 3D] parameter worth it?
The backbone is frozen (its base kernels get no gradient), so the only
cost of per-projection storage is each block's forward concat of three
[D, D] kernels into [D, 3D] before the fused activation GEMM.

This times that pattern: a `--depth`-deep loop of x @ W where W is
(a) the pre-fused [L, D, 3D] stacked storage, against
(b) a concat of three [L, D, D] stacked tensors at every step,
at ViT-B b32 shapes in bf16 by default. The GEMMs are cuBLAS's
(`torch.matmul`), as the JAX tool's were XLA's: neither is a Pallas or
hand-written kernel. The difference is the whole win of the refactor per
forward.

    python -m dinov2_od_tpu_torch.tools.bench_qkv_layout [--batch 32]
        [--seq 272] [--dim 768] [--depth 12] [--device cuda]

Prints the JAX tool's one JSON line (metric naming the card,
prefused_ms, per_step_concat_ms, delta_ms_per_fwd). Runs on the CUDA
card; `--device cpu` runs it on the CPU (no CPU time is a device time).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=272)
    p.add_argument("--dim", type=int, default=768)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def run_fused(x, w):
    """The loop over pre-fused [L, D, 3D] weights; the three projections
    summed back to D so the carry keeps its shape (standing in for the
    rest of the block)."""
    for wi in w:
        q, k, v = (x @ wi).chunk(3, dim=-1)
        x = q + k + v
    return x


def run_concat(x, wq, wk, wv):
    """The same loop over three [L, D, D] stacks, concatenated each step."""
    for a, b, c in zip(wq, wk, wv):
        q, k, v = (x @ torch.cat([a, b, c], dim=1)).chunk(3, dim=-1)
        x = q + k + v
    return x


def run(args, out=None, **time_kw) -> dict:
    from ..utils.benchmark import time_fn

    b, s, d, depth = args.batch, args.seq, args.dim, args.depth
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_qkv_layout: no CUDA device (pass "
                           "--device cpu to run on the CPU)")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32)
                         ).to(device, torch.bfloat16)
    wq, wk, wv = (
        torch.from_numpy(rng.normal(size=(depth, d, d)).astype(np.float32)
                         * 0.02).to(device, torch.bfloat16)
        for _ in range(3))
    w_fused = torch.cat([wq, wk, wv], dim=2)  # [L, D, 3D]
    with torch.inference_mode():
        t_fused = time_fn(run_fused, x, w_fused, device=device.type,
                          **time_kw)
        t_concat = time_fn(run_concat, x, wq, wk, wv, device=device.type,
                           **time_kw)
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    rec = {
        "metric": f"{depth}-deep qkv GEMM loop, b{b} s{s} d{d} bf16 "
                  f"({card})",
        "prefused_ms": round(t_fused * 1e3, 4),
        "per_step_concat_ms": round(t_concat * 1e3, 4),
        "delta_ms_per_fwd": round((t_concat - t_fused) * 1e3, 4),
    }
    print(json.dumps(rec), file=out or sys.stdout, flush=True)
    return rec


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
