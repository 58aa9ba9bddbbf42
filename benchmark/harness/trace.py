"""The profiled sub-window of a traced run and its reduction to numbers.

`profile_window` runs a callable under `torch.profiler` (host ops and the
card's kernels), inside the benchmark's own `bench.window` span, and
reduces the Chrome trace to a `TraceSummary`: the device's busy time as
the union of its operations' intervals (kernels, copies, sets) inside
the window, the idle gaps between them with the narrowest host span open
at each gap's start, the operations' time by name, the attention
kernels' time, and the spans' total time by name.

Kernel families (`classify`) copy the grouping of the port's
`tools/trace_step.py`; the attention kernels are those named in the
files under `benchmark/kernels/attention/` (the port's flash kernels,
one name a line; a kernel that takes over attention work is named in a
file added there) and PyTorch's own SDPA and flash kernels, so the same
work is found whichever runs it.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import re
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from .common import BENCH_DIR, TRACE_DIR

WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ATTENTION_KERNELS = BENCH_DIR / "kernels" / "attention"
# PyTorch's attention kernels (SDPA's flash, memory-efficient and cuDNN
# paths).
_TORCH_ATTENTION = re.compile(
    r"flash_fwd|flash_bwd|fmha|efficient_attention|attention_kernel|"
    r"scaled_dot_product|sdpa", re.I)

GROUPS = [
    ("gemm", re.compile(
        r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitKreduce|"
        r"implicit_convolve|conv2d|_fprop_", re.I)),
    ("copy_transpose", re.compile(
        r"copy|transpose|CatArray|permute|index_select|gather|scatter|"
        r"Memcpy|Memset", re.I)),
    ("elementwise", re.compile(r"elementwise|multi_tensor_apply", re.I)),
    ("reduce_norm", re.compile(
        r"reduce|norm|GammaBeta|softmax|argmax|topk|sort|radix|scan|cub::",
        re.I)),
]


def attention_kernel_names(folder: Path = ATTENTION_KERNELS) -> List[str]:
    """The kernel names listed in the folder's `*.txt` files, one a line
    (`#` starts a comment)."""
    names = []
    for f in sorted(folder.glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                names.append(line)
    return names


def attention_matcher(folder: Path = ATTENTION_KERNELS
                      ) -> Callable[[str], bool]:
    names = attention_kernel_names(folder)
    port = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b") \
        if names else None

    def is_attention(kernel: str) -> bool:
        return bool((port is not None and port.search(kernel))
                    or _TORCH_ATTENTION.search(kernel))
    return is_attention


def classify(kernel: str, is_attention: Callable[[str], bool]) -> str:
    if is_attention(kernel):
        return "attention"
    for group, rx in GROUPS:
        if rx.search(kernel):
            return group
    return "other"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    ops_s: Dict[str, float]          # device time by operation name
    groups_s: Dict[str, float]       # device time by family
    attention_s: float
    spans_s: Dict[str, float]        # host span time by name
    span_counts: Dict[str, int]
    gaps: List[Tuple[str, float]]    # longest idle gaps, by open span
    device_ops: int

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events: List[dict], folder: Path = ATTENTION_KERNELS,
              top: int = 10) -> TraceSummary:
    """The numbers of a Chrome trace's events (times in microseconds)."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_SPAN]
    if not win:
        raise ValueError("the trace holds no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    is_attention = attention_matcher(folder)
    dev, spans = [], []
    ops = collections.Counter()
    groups = collections.Counter()
    attention = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        s, d = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            s0, s1 = max(s, w0), min(s + d, w1)
            if s1 <= s0:
                continue
            dev.append((s0, s1))
            name = e.get("name", "")
            ops[name] += (s1 - s0) / 1e6
            groups[classify(name, is_attention)] += (s1 - s0) / 1e6
            if cat == "kernel" and is_attention(name):
                attention += (s1 - s0) / 1e6
        elif cat == "user_annotation" and e.get("name") != WINDOW_SPAN:
            spans.append((s, s + d, e.get("name", "")))
    busy = merge(dev)
    busy_us = sum(e - s for s, e in busy)
    # Idle gaps inside the window, each named by the narrowest span open
    # on the host at its start.
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    named = []
    for g0, g1 in gaps[:top]:
        open_ = [(e - s, n) for s, e, n in spans if s <= g0 < e]
        named.append((min(open_)[1] if open_ else "none", (g1 - g0) / 1e6))
    span_s = collections.Counter()
    span_n = collections.Counter()
    for s, e, n in spans:
        span_s[n] += (e - s) / 1e6
        span_n[n] += 1
    return TraceSummary(
        window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6, ops_s=dict(ops),
        groups_s=dict(groups), attention_s=attention,
        spans_s=dict(span_s), span_counts=dict(span_n), gaps=named,
        device_ops=len(dev))


def profile_window(body: Callable[[], None], sync: Callable[[], None],
                   trace_dir: Path = TRACE_DIR,
                   attempts: int = 3) -> TraceSummary:
    """Runs `body` under the profiler inside the `bench.window` span, then
    `sync` (the card's synchronise) inside it too, and summarises the
    trace. The profiler has been seen to return no device events for a
    window now and then: such a window is run again, up to `attempts`
    times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / "trace.json"
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_SPAN):
                body()
                sync()
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        path.unlink()
        summary = summarize(events)
        if summary.device_ops:
            return summary
        time.sleep(0.1)
    raise RuntimeError("the profiler recorded no device operation")


def breakdown(summary: TraceSummary, top: int = 10) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time and the longest idle gaps by what the host was doing."""
    ops = sorted(summary.ops_s.items(), key=lambda kv: kv[1], reverse=True)
    return {"device_ops": [[n[:160], s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in summary.gaps[:top]]}
