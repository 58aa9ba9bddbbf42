"""Attention-kernel batch-scaling probe (counterpart of
tools/bench_attn_scaling.py).

The JAX tool asked whether the attention kernel's per-image cost holds
from batch 32 to 64, and tried TPU grid strategies (forced head groups)
to find one that does. The port's kernels have no head groups; it asks
the same question of each kernel family the port has:

- `flat`: B1 forward, B2 backward (`flash_attention(..., flat=True)`);
- `allheads`: B4f / B4b (the BHSD family with `_allheads_fwd` and
  `_allheads_bwd` patched to answer yes, as the JAX tool patched
  `_head_group`, and restored afterwards);
- `bhsd`: B5f / B5b (the same two patched to answer no).

    python -m dinov2_od_tpu_torch.tools.bench_attn_scaling [--seq 272]
        [--heads 12] [--dh 64] [--kv_len 257] [--batches 32 64]
        [--variants flat allheads bhsd] [--device cuda]

Prints one JSON line a (batch, variant) with the JAX tool's keys (batch,
variant, fwd_ms, fwdbwd_ms, fwd_us_per_img, fwdbwd_us_per_img: CUDA-event
times of back-to-back calls, which include the host's cost of a call
where it exceeds the card's), then `fwd_device_ms` and
`fwdbwd_device_ms`, the summed time of the CUDA kernels of one call from
torch.profiler (`utils/benchmark.device_ms`; the fwdbwd call's loss and
autograd kernels included), and `launches`, the port's kernels launched
while that line was measured (`ops/_build.launch_counts`), so each line
shows which kernels ran. bf16 q, k, v from seed 0; fwdbwd is the
gradient of sum(o^2) in fp32 with respect to q, k and v. Runs on the
CUDA card; `--device cpu` runs the plain versions on the CPU (no CPU
time is a device time: the device times are null there, and the plain
versions launch nothing).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

VARIANTS = ("flat", "allheads", "bhsd")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seq", type=int, default=272)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--dh", type=int, default=64)
    p.add_argument("--kv_len", type=int, default=257)
    p.add_argument("--batches", type=int, nargs="+", default=[32, 64])
    p.add_argument("--variants", nargs="+", default=list(VARIANTS),
                   choices=VARIANTS)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


@contextlib.contextmanager
def forced(variant: str):
    """The BHSD family's kernel choice forced to `variant` ('allheads'
    or 'bhsd'; 'flat' changes nothing), restored on exit."""
    from ..ops import flash_attention as fa

    saved = fa._allheads_fwd, fa._allheads_bwd
    if variant != "flat":
        answer = variant == "allheads"
        fa._allheads_fwd = fa._allheads_bwd = lambda q, k: answer
    try:
        yield
    finally:
        fa._allheads_fwd, fa._allheads_bwd = saved


def run(args, out=None, **time_kw) -> list:
    """Time every (batch, variant); print and return the records."""
    from ..ops import _build
    from ..ops import flash_attention as fa
    from ..utils.benchmark import device_ms, time_fn

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_attn_scaling: no CUDA device (pass "
                           "--device cpu to run on the CPU)")
    out = out or sys.stdout
    scale = 1.0 / float(np.sqrt(args.dh))
    recs = []
    for b in args.batches:
        rng = np.random.default_rng(0)
        q, k, v = (
            torch.from_numpy(rng.normal(size=(b, args.seq, args.heads,
                                              args.dh)).astype(np.float32)
                             ).to(device, torch.bfloat16).requires_grad_()
            for _ in range(3))
        for variant in args.variants:
            flat = variant == "flat"

            def fwd():
                with torch.no_grad():
                    return fa.flash_attention(q, k, v, scale=scale,
                                              kv_len=args.kv_len, flat=flat)

            def fwdbwd():
                o = fa.flash_attention(q, k, v, scale=scale,
                                       kv_len=args.kv_len, flat=flat)
                loss = (o.float() ** 2).sum()
                return torch.autograd.grad(loss, (q, k, v))

            with forced(variant):
                before = dict(_build.launch_counts)
                t_f = time_fn(fwd, device=device.type, **time_kw)
                t_fb = time_fn(fwdbwd, device=device.type, **time_kw)
                cuda = device.type == "cuda"
                d_f = device_ms(fwd, iters=20) if cuda else None
                d_fb = device_ms(fwdbwd, iters=20) if cuda else None
                launches = {n: c - before[n]
                            for n, c in _build.launch_counts.items()
                            if c != before[n]}
            rec = {
                "batch": b, "variant": variant,
                "fwd_ms": round(t_f * 1e3, 4),
                "fwdbwd_ms": round(t_fb * 1e3, 4),
                "fwd_us_per_img": round(t_f * 1e6 / b, 2),
                "fwdbwd_us_per_img": round(t_fb * 1e6 / b, 2),
                "fwd_device_ms": d_f,
                "fwdbwd_device_ms": d_fb,
                "launches": launches,
            }
            print(json.dumps(rec), file=out, flush=True)
            recs.append(rec)
    return recs


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
