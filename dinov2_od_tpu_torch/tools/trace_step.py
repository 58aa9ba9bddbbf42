"""Capture and summarise a device trace of the bench's step, on the card
(counterpart of tools/trace_step.py).

Builds the bench's configuration from the same environment knobs
(`bench.bench_config`: BENCH_MODEL, BENCH_IMAGE_SIZE, BENCH_BATCH,
BENCH_MODE=eval with BENCH_QUANT=int8, ...), runs one untraced step, then
`--steps` steps under `utils.profiling.trace`, and sums the Chrome trace's
CUDA kernel events (not the host's op events, which would count the same
work twice) by kernel family.

Usage:
  BENCH_MODEL=large BENCH_IMAGE_SIZE=560 BENCH_BATCH=8 BENCH_MODE=eval \\
      python -m dinov2_od_tpu_torch.tools.trace_step [--steps 3] [--top 30]

Prints one JSON line with the device ms and kernels per step, one per
group with its ms and share, sorted by time, then the `--top` kernels
with their ms and launches per step.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import re
import sys
import tempfile
from typing import Dict, List, Mapping, Optional, TextIO

import torch

from ..ops import _build

# The port's own kernels, by the __global__ functions of each source in
# `_build.SOURCES`; every flash-attention source (B1-B5) is one group.
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")

# Then the card's library kernels, first match wins: copies before the
# elementwise family, since PyTorch's copies and casts run as
# elementwise_kernel<..., direct_copy_kernel_cuda ...>.
GROUPS = [
    ("gemm", re.compile(
        r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitKreduce|"
        r"implicit_convolve|conv2d|_fprop_", re.I)),
    ("copy_transpose", re.compile(
        r"copy|transpose|CatArray|permute|index_select|gather|scatter", re.I)),
    ("elementwise", re.compile(r"elementwise|multi_tensor_apply", re.I)),
    ("reduce_norm", re.compile(
        r"reduce|norm|GammaBeta|softmax|argmax|topk|sort|radix|scan|cub::",
        re.I)),
]
OTHER = "other"


@functools.lru_cache(maxsize=None)
def port_kernels() -> Dict[str, str]:
    """{__global__ function name: its `_build.SOURCES` name}."""
    out = {}
    for name, src in _build.SOURCES.items():
        for fn in _GLOBAL.findall((_build.CSRC / src).read_text()):
            out[fn] = name
    return out


def port_source(kernel: str) -> Optional[str]:
    """The `_build.SOURCES` name of a port kernel's trace name, else None."""
    for fn, name in port_kernels().items():
        if re.search(rf"\b{fn}\b", kernel):
            return name
    return None


def classify(kernel: str) -> str:
    """The group of a CUDA kernel's name as the profiler records it."""
    src = port_source(kernel)
    if src is not None:
        return "flash_attn" if src.startswith("flash_attn") else src
    for group, rx in GROUPS:
        if rx.search(kernel):
            return group
    return OTHER


def summarize(trace_path: str, steps: int) -> dict:
    """Device time per step of a Chrome trace's CUDA kernel events: the
    total, by group, by `_build.SOURCES` name and by kernel, in ms, and
    the launches per step of each kernel."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    by_name = collections.Counter()
    by_group = collections.Counter()
    by_source = collections.Counter()
    launches = collections.Counter()
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "kernel":
            continue
        name = ev.get("name", "")
        ms = ev.get("dur", 0.0) / 1e3 / steps
        by_name[name] += ms
        by_group[classify(name)] += ms
        src = port_source(name)
        if src is not None:
            by_source[src] += ms
        launches[name] += 1
    calls = collections.Counter({n: c / steps for n, c in launches.items()})
    return {"device_ms_per_step": sum(by_name.values()),
            "kernels_per_step": sum(calls.values()), "by_group": by_group,
            "by_source": by_source, "by_name": by_name, "calls": calls}


def build_step(env: Mapping[str, str]):
    """(step, state, batch, generator) of the bench's configuration; under
    BENCH_MODE=eval the step is the serving forward on the folded (and,
    with BENCH_QUANT=int8, quantized) params, state passed through."""
    from ..bench import bench_config, bench_inputs, eval_params
    from ..models.detector import detector_apply
    from ..train.state import create_train_state
    from ..train.step import make_train_step

    cfg = bench_config(env)
    det = cfg.detector
    params, batch = bench_inputs(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    if env.get("BENCH_MODE") == "eval":
        p = eval_params(params, cfg, env.get("BENCH_QUANT", ""))

        def eval_step(state, batch, gen):
            with torch.no_grad():
                return state, detector_apply(p, det, batch["images"],
                                             deterministic=True)

        return eval_step, None, batch, gen
    state = create_train_state(params, cfg.optim, det)
    return make_train_step(cfg), state, batch, gen


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--logdir", default=None,
                    help="where the Chrome trace goes (default: a "
                         "temporary directory, removed afterwards)")
    return ap.parse_args(argv)


def report(summary: dict, top: int, out: TextIO = sys.stdout) -> None:
    total = summary["device_ms_per_step"]
    print(json.dumps({
        "device_ms_per_step": round(total, 3),
        "kernels_per_step": summary["kernels_per_step"],
        "device": torch.cuda.get_device_name(0),
    }), file=out)
    for g, ms in summary["by_group"].most_common():
        print(json.dumps({"group": g, "ms": round(ms, 3),
                          "pct": round(100 * ms / max(total, 1e-9), 1)}),
              file=out)
    for n, ms in summary["by_name"].most_common(top):
        print(json.dumps({"op": n[:240], "group": classify(n),
                          "ms": round(ms, 4),
                          "calls": summary["calls"][n]}), file=out)
    out.flush()


def run(args: argparse.Namespace, env: Mapping[str, str],
        out: TextIO = sys.stdout) -> dict:
    """Trace `args.steps` steps, print the report, return the summary."""
    from ..utils.profiling import TRACE_FILE, trace

    step, state, batch, gen = build_step(env)
    state, _ = step(state, batch, gen)  # warm-up, outside the trace
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        logdir = args.logdir or tmp
        with trace(logdir):
            for _ in range(args.steps):
                state, _ = step(state, batch, gen)
            torch.cuda.synchronize()
        summary = summarize(os.path.join(logdir, TRACE_FILE), args.steps)
    report(summary, args.top, out)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_step: no CUDA device", file=sys.stderr)
        return 1
    run(args, os.environ)
    return 0


if __name__ == "__main__":
    sys.exit(main())
