"""Capture and summarise a device trace of the bench's step, on the card
(counterpart of tools/trace_step.py).

Builds the bench's configuration from the same environment knobs
(`bench.bench_config`: BENCH_MODEL, BENCH_IMAGE_SIZE, BENCH_BATCH,
BENCH_MODE=eval with BENCH_QUANT=int8, ...), runs one untraced step, then
`--steps` steps under `utils.profiling.trace`, and sums the Chrome trace's
CUDA kernel events (not the host's op events, which would count the same
work twice) by kernel family. Then it splits the card's busy and idle
time by the train step's phases (`phase_split`: the `step.*` spans of
train/step.py and ops/matching.py).

Usage:
  BENCH_MODEL=large BENCH_IMAGE_SIZE=560 BENCH_BATCH=8 BENCH_MODE=eval \\
      python -m dinov2_od_tpu_torch.tools.trace_step [--steps 3] [--top 30]

Prints one JSON line with the device ms and kernels per step, one per
group with its ms and share, sorted by time, then the `--top` kernels
with their ms and launches per step, then one line a phase with its busy
and idle ms per step.
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

# The traced steps' span, the phases' prefix, and the trace's categories
# of the card's operations and of the host calls that launched them.
WINDOW = "trace_step.window"
PHASE_PREFIX = "step."
NO_PHASE = "none"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


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


def phase_split(events: List[dict], window: str = WINDOW) -> dict:
    """The card's busy and idle seconds inside the `window` span of a
    Chrome trace's events (times in us), by the train step's phase.

    An operation (kernel, copy, set) belongs to the narrowest `step.*`
    span open on the host when the call that launched it ran, found
    through the trace's `correlation` id (a CUDA graph's kernels share
    their `cudaGraphLaunch`'s); where operations overlap, the time goes to
    the one that started first, so the phases' busy seconds sum to the
    union of the operations' intervals. An idle gap belongs to the
    narrowest `step.*` span open at its start. Time outside every phase
    is under "none"; a phase that ran and got nothing reads 0.0.

    Returns {"window_s", "busy_s", "phase_busy_s", "phase_idle_s",
    "phase_counts"}."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == window]
    if not win:
        raise ValueError(f"the trace holds no {window} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    phases, launched, ops = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        s, cat = float(e.get("ts", 0.0)), e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and \
                e.get("name", "").startswith(PHASE_PREFIX):
            phases.append((s, s + float(e.get("dur", 0.0)), e["name"]))
        elif cat in LAUNCH_CATS and corr is not None:
            launched[corr] = s
        elif cat in DEVICE_CATS:
            s0 = max(s, w0)
            s1 = min(s + float(e.get("dur", 0.0)), w1)
            if s1 > s0:
                ops.append((s0, s1, corr))

    def phase_at(t: float) -> str:
        open_ = [(e - s, n) for s, e, n in phases if s <= t < e]
        return min(open_)[1] if open_ else NO_PHASE

    busy = collections.Counter({n: 0.0 for _, _, n in phases})
    idle = collections.Counter({n: 0.0 for _, _, n in phases})
    counts = collections.Counter(n for _, _, n in phases)
    # Each op's time past the end of what earlier-starting ops covered.
    cursor, gaps = w0, []
    for s0, s1, corr in sorted(ops, key=lambda o: (o[0], o[1])):
        if s0 > cursor:
            gaps.append((cursor, s0))
        if s1 > cursor:
            t = launched.get(corr)
            phase = NO_PHASE if t is None else phase_at(t)
            busy[phase] += (s1 - max(s0, cursor)) / 1e6
            cursor = s1
    if w1 > cursor:
        gaps.append((cursor, w1))
    for g0, g1 in gaps:
        idle[phase_at(g0)] += (g1 - g0) / 1e6
    busy.setdefault(NO_PHASE, 0.0)
    idle.setdefault(NO_PHASE, 0.0)
    return {"window_s": (w1 - w0) / 1e6, "busy_s": sum(busy.values()),
            "phase_busy_s": dict(busy), "phase_idle_s": dict(idle),
            "phase_counts": dict(counts)}


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


def report_phases(split: dict, steps: int, out: TextIO = sys.stdout) -> None:
    """One JSON line a phase: busy and idle ms and spans per step."""
    for p in sorted(split["phase_busy_s"],
                    key=lambda p: -(split["phase_busy_s"][p]
                                    + split["phase_idle_s"][p])):
        print(json.dumps({
            "phase": p,
            "busy_ms": round(1e3 * split["phase_busy_s"][p] / steps, 3),
            "idle_ms": round(1e3 * split["phase_idle_s"][p] / steps, 3),
            "spans": split["phase_counts"].get(p, 0) / steps}), file=out)
    out.flush()


def run(args: argparse.Namespace, env: Mapping[str, str],
        out: TextIO = sys.stdout) -> dict:
    """Trace `args.steps` steps, print the report, return the summary."""
    from ..utils.profiling import TRACE_FILE, annotate, trace

    step, state, batch, gen = build_step(env)
    state, _ = step(state, batch, gen)  # warm-up, outside the trace
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        logdir = args.logdir or tmp
        with trace(logdir), annotate(WINDOW):
            for _ in range(args.steps):
                state, _ = step(state, batch, gen)
            torch.cuda.synchronize()
        path = os.path.join(logdir, TRACE_FILE)
        summary = summarize(path, args.steps)
        with open(path) as f:
            split = phase_split(json.load(f).get("traceEvents", []))
    report(summary, args.top, out)
    report_phases(split, args.steps, out)
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
