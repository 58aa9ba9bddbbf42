"""Roofline decomposition of the attention forward at one shape, on the
card (counterpart of tools/bench_attn_roofline.py).

Times ablated variants of the attention forward, each adding one piece
of the softmax to the two products (kernel T1, csrc/attn_roofline.cu):

  1. mxu_only   - the two products, the logits cast to bf16 as p;
  2. plus_max   - adds the row max (one traversal of [S, S]);
  3. plus_exp2  - adds exp2(s - m) (the transcendental traversal);
  4. production - the port's forward on the same tensors (flash_attention
                  with flat=False: B5f at the default shape, B4f where
                  the JAX routing takes the all-heads kernel, e.g. --seq
                  272), which adds the row sum, the division and the lse.

Each delta is the cost of one softmax component on this card. As in the
JAX tool, q' is fp32 in the three stages (the tool's float64 scale
promotes q) and bf16 in production.

Usage: python -m dinov2_od_tpu_torch.tools.bench_attn_roofline
       [--seq 1370 --heads 16 --batch 8 --dh 64 --repeats 3]
prints one JSON line per variant: variant, ms, mxu_tf_s (the two
products' FLOPs over the time: on this card, tensor-core TF/s) and, from
the second on, delta_ms_vs_prev. Runs on the CUDA card only.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, TextIO

import numpy as np
import torch

from ..ops.attn_roofline import STAGES, attn_roofline
from ..ops.flash_attention import _SUBLANE, _round_up, flash_attention
from ..utils.benchmark import time_fn


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq", type=int, default=1370)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dh", type=int, default=64)
    ap.add_argument("--repeats", type=int, default=3)
    return ap.parse_args(argv)


def run(args: argparse.Namespace,
        out: TextIO = sys.stdout) -> Dict[str, int]:
    """Time every variant and print its JSON line to `out`; returns the
    number of calls each variant made (warm-up included)."""
    b, h, s, dh = args.batch, args.heads, args.seq, args.dh
    scale = 1.0 / np.sqrt(dh)
    s_pad = _round_up(s, _SUBLANE)
    rng = np.random.default_rng(0)
    qp, kp, vp = (
        torch.from_numpy(rng.normal(size=(b, h, s_pad, dh)).astype(
            np.float32)).to("cuda", torch.bfloat16)
        for _ in range(3))
    calls = {}

    def best(name, fn):
        calls[name] = 0

        def counted():
            calls[name] += 1
            fn()

        return min(time_fn(counted) for _ in range(args.repeats))

    qt, kt, vt = (x.transpose(1, 2) for x in (qp, kp, vp))

    def production():
        with torch.no_grad():
            flash_attention(qt, kt, vt, scale=float(scale), kv_len=s,
                            flat=False)

    matmul_flops = 2 * (2 * s_pad * s_pad * dh) * b * h
    prev = None
    for variant in (*STAGES, "production"):
        if variant == "production":
            t = best(variant, production)
        else:
            t = best(variant, lambda st=variant: attn_roofline(
                qp, kp, vp, scale=float(scale), stage=st))
        rec = {
            "variant": variant,
            "ms": round(t * 1e3, 4),
            "mxu_tf_s": round(matmul_flops / t / 1e12, 1),
        }
        if prev is not None:
            rec["delta_ms_vs_prev"] = round((t - prev) * 1e3, 4)
        prev = t
        print(json.dumps(rec), file=out, flush=True)
    return calls


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_attn_roofline: no CUDA device", file=sys.stderr)
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
