#!/usr/bin/env python3
"""Drive the PyTorch port (dinov2_od_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Run from the root of the repository, on a machine with an H100, the CUDA
toolkit and PyTorch built for CUDA. Phases, in order; any failure exits
non-zero and prints no result:

1. card    - the card's name and power limit, from nvidia-smi;
2. build   - every CUDA kernel of the port, compiled with nvcc for sm_90a
             from the sources in the checkout, one nvcc per source at once;
3. kernels - each kernel against its plain PyTorch version at the shapes
             of the main paths, within stated tolerances, and timed
             (device time from torch.profiler; CUDA events as event_ms)
             beside its bound, the plain version and a library call: the
             flash-attention forward (B1) and backward (B2) at B=32,
             S=257, H=12, dh=64, bf16 and fp32, all keys and kv_len=200;
             the fused quantize + int8 GEMM (B6) at the fc2 shapes of
             INT8_CASES, with a control (a K tile dropped) that must fail;
4. slice   - the bf16 serving path: a full-width ViT-B/14 + deformable
             DETR Predictor behind a DynamicBatcher answers concurrent
             requests; 12 forward launches per device batch;
             detector_apply with the kernel against the same model with
             plain attention (fp32 and bf16, a limit per output), beside
             controls (the kernel with keys dropped) that must fail the
             same check; images/s of the batch-32 forward plus top-k;
5. int8    - the int8 W8A8 serving path: the same model through
             Predictor(quantize="int8") behind a DynamicBatcher; 12 B6 and
             12 B1 launches per device batch; detector_apply on the int8
             tree against B6's plain version and against the bf16 model,
             with a control that must fail; images/s beside the bf16 one;
6. train   - the train path: 20 full-width train steps (bf16 backbone,
             LoRA on the last 2 blocks, fp32 decoder with dropout 0.1,
             batch 32 with 25 GT slots) on a fixed synthetic batch; finite
             losses that drop, frozen leaves and the non-adapted LoRA rows
             bit-identical, 12 forward + 2 backward launches per step; the
             loss and trainable gradients of one step with the kernels
             against plain attention (fp32 and bf16, a limit per leaf
             group), beside controls (the backward with keys dropped) that
             must fail the same check; images/s of the train step;
7. prefix  - the same train step with the frozen prefix in int8
             (prefix_int8): 10 steps with the same checks, 12 B1, 2 B2 and
             10 B6 launches per step; one step's loss and gradients against
             B6's plain version, with a control that must fail; images/s
             beside the bf16 step's.

Every path is driven with the launch counts set to 0 just before it and
read just after. The line before the last is {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}. `--profile` adds a torch.profiler
breakdown by kernel of each serving forward and each train step.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import threading
import time

import numpy as np

# H100 SXM: HBM rate and dense peak rates (NVIDIA data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# The backbone's attention on both paths: ViT-B/14 at 224 px, batch 32.
B, S, H, DH = 32, 257, 12, 64
KV_MASKED = 200  # kv_len of the masked cases
# Kernel against plain version, max abs error. bf16: both round p to bf16
# (2^-9 relative), the kernel against its running max (online softmax),
# the plain version against the row max, so p may round apart: l then
# differs by at most 2^-9 relative, lse2 = m + log2 l by 2^-9 / ln 2 =
# 2.8e-3, and o by about one bf16 ulp (2^-7 for |o| in [1, 2)). fp32: fp32
# CUDA cores against fp32 matmuls (TF32 off) in another summation order.
TOL = {
    "bfloat16": {"o": 1e-2, "lse": 3e-3},
    "float32": {"o": 1e-5, "lse": 1e-5},
}
# detector_apply with the kernel against attention in plain torch ops
# (impl="xla"), max abs error of each output. fp32: the attention outputs
# differ by ~1e-6 and 12 blocks plus the decoder amplify that modestly.
# bf16: every block rounds its activations to bf16 (2^-8 relative), so the
# two attention paths drift apart by bf16 ulps. Each limit lies between
# the sound kernel's reading and the smallest reading of a faulty one
# (CONTROLS), seed 0 on an H100 (PERF.md): fp32 logits 1.4e-5 | 0.19,
# boxes 9.2e-7 | 1.7e-2; bf16 logits 0.088 | 0.22, boxes 0.012 | 0.018.
# Every control must exceed a limit.
MODEL_TOL = {
    "float32": {"pred_logits": 1e-3, "pred_boxes": 1e-4},
    "bfloat16": {"pred_logits": 0.15, "pred_boxes": 0.015},
}
# Faulty kernels, run through the same check: the kernel with the keys
# from this index on dropped. S - 1 drops the ragged last key tile (one
# key); 192 also drops the last full 64-key tile.
CONTROLS = (S - 1, 192)
OUTPUTS = ("pred_logits", "pred_boxes")
REQUEST_SIZES = (8, 16, 4, 12)
# Backward kernel against its plain version: max abs error of each of dq,
# dk, dv over max(1, its largest magnitude). bf16: both round p and ds to
# bf16 before their products, from fp32 values the tensor cores and the
# plain einsums sum in other orders, so an element may round to the
# neighbouring bf16 value; with the outputs' own rounding (2^-8) that
# stays within two bf16 ulps of the largest gradient (measured 2.6e-3 on
# an H100). fp32: CUDA cores against fp32 matmuls (TF32 off); measured
# bit-identical, both sum each product in one sequential order.
BWD_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# Train phase: steps on the fixed batch, and the step's gradient check.
TRAIN_STEPS = 20
MAX_BOXES = 25
# One step's loss and trainable gradients with the kernels, decoder
# dropout 0, the same assignment for every run, against two references:
# "plain attention" (attn_impl="xla": einsum forward, autograd backward)
# and "plain backward" (the kernel forward, then the backward's plain
# version on the card), which shares the forward's roundings and so
# isolates the backward kernel. Per leaf group, the relative error
# ||g - g_ref|| / ||g_ref|| (the loss: |l - l_ref| / |l_ref|). Each limit
# lies between the sound kernels' reading and the smallest reading of a
# faulty backward (GRAD_CONTROLS), seed 0 on an H100 under deterministic
# algorithms (PERF.md): lora, the group the backward reaches, fp32 0 |
# 1.2e-3 against plain backward and 1.5e-7 | 1.2e-3 against plain
# attention; bf16 6.2e-5 | 1.7e-3 against plain backward, but 2.2e-3 |
# 2.6e-3 against plain attention, where the forward's bf16 roundings
# swamp a one-key fault. The decoder's and the projection's gradients do
# not depend on the backward: they check the forward and the loss. The
# sound kernels must pass every limit; every control must exceed one.
GRAD_TOL = {
    "float32": {
        "plain attention": {"loss": 1e-5, "lora": 1e-4, "decoder": 1e-4,
                            "projection": 1e-4},
        "plain backward": {"loss": 1e-5, "lora": 1e-4, "decoder": 1e-4,
                           "projection": 1e-4},
    },
    "bfloat16": {
        "plain attention": {"loss": 1e-3, "lora": 0.01, "decoder": 0.01,
                            "projection": 0.01},
        "plain backward": {"loss": 1e-5, "lora": 3e-4, "decoder": 1e-5,
                           "projection": 1e-5},
    },
}
# Faulty backward kernels, through the same check: B2 handed a smaller
# kv_len than its forward, so it drops the keys from this index on.
GRAD_CONTROLS = (S - 1, 192)

# B6, the fused quantize + int8 GEMM, against its plain version: (M, K, N,
# x dtype) of the ViT-B serving fc2 (32 images x 257 tokens, 3072 -> 768)
# in bf16 and fp32, the K = 4096 branch at the ViT-L/518 batch-8 fc2
# (8 x 1370 tokens, 4096 -> 1024) and a ragged M. Codes and int32 sums are
# exact and both epilogues are one fp32 fma, so the outputs agree bit for
# bit where the card's addcmul contracts as the kernel does, and within one
# rounding of the output dtype where not: the limit is
# |out - ref| <= eps(dtype) * max(|ref|, 1) element by element.
INT8_CASES = ((8224, 3072, 768, "bfloat16"), (8224, 3072, 768, "float32"),
              (10960, 4096, 1024, "bfloat16"), (8224 - 5, 3072, 768,
                                                "bfloat16"))
# The controls of every B6 check: B6 given x with its last 64-wide K tile
# zeroed, what a kernel that drops that tile computes (but for the scales).
INT8_DROP = 64
# int8 serving, detector_apply on the int8 tree. Against the same tree with
# B6's plain version on the card: max abs error, expected 0 (B6 matches its
# plain version bit for bit), limits far below the control. Against the
# same weights unquantized in bf16: relative error in norm, the W8A8
# quantization error, with limits between it and the control's. Seed 0 on
# an H100 (PERF.md), sound | control: plain B6 logits 0 | 1.22, boxes 0 |
# 0.078; bf16 model logits 0.036 | 0.345, boxes 0.0043 | 0.040.
INT8_MODEL_TOL = {
    "plain B6": {"pred_logits": 1e-3, "pred_boxes": 1e-4},
    "bf16 model": {"pred_logits": 0.1, "pred_boxes": 0.015},
}
# Prefix-int8 train phase: steps, and one step's loss and trainable
# gradients with B6 against the same step with B6's plain version on the
# card (relative error per group; expected 0, see INT8_CASES). Seed 0 on
# an H100 (PERF.md), sound | control: loss 0 | 2.4e-3, lora 0 | 0.176,
# decoder 0 | 0.169.
INT8_TRAIN_STEPS = 10
INT8_GRAD_TOL = {"loss": 1e-6, "lora": 1e-5, "decoder": 1e-5,
                 "projection": 1e-5}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int, warmup: int = 10, repeats: int = 5) -> float:
    """Median over `repeats` of the mean time of `iters` back-to-back
    calls, from CUDA events, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time of one call of `fn`: the summed durations of the CUDA
    kernels it launched, from torch.profiler over `iters` calls. Gaps
    between launches do not count, so a contended host, which stretches
    back-to-back CUDA-event timings of short kernels, does not inflate
    it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev_us = getattr(ev, "self_device_time_total", None)
            total_us += ev.self_cuda_time_total if dev_us is None else dev_us
    if total_us <= 0:
        raise AssertionError("the profiler saw no device time")
    return total_us / 1e3 / iters


def _bound(dtype: str, n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(dtype: str, kv_len: int):
    """(bound_ms, bound_by) of one forward at the serving shape: q, o once,
    the first kv_len rows of k, v once, the fp32 lse once; two products
    of 2 * S * kv_len * dh operations per (batch, head)."""
    item = 2 if dtype == "bfloat16" else 4
    n_bytes = (2 * S + 2 * kv_len) * B * H * DH * item + B * H * S * 4
    return _bound(dtype, n_bytes, 4.0 * B * H * S * kv_len * DH)


def attention_bwd_bound(dtype: str, kv_len: int):
    """(bound_ms, bound_by) of one backward at the train shape: q and dO
    read once, the first kv_len rows of k and v read once, the fp32 lse
    and delta read once, dq, dk and dv written once; five products (s, dp,
    dv, dk, dq) of 2 * S * kv_len * dh operations per (batch, head)."""
    item = 2 if dtype == "bfloat16" else 4
    n_bytes = ((2 * S + 2 * kv_len + 3 * S) * B * H * DH * item
               + 2 * B * H * S * 4)
    return _bound(dtype, n_bytes, 10.0 * B * H * S * kv_len * DH)


def phase_build():
    from dinov2_od_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{sorted(_build.SOURCES)}")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")


def phase_kernels(seed: int):
    """Flash-attention forward against its plain version; returns the
    kernel's entry of the kernels line (launches filled in later)."""
    import torch
    import torch.nn.functional as F

    from dinov2_od_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(seed)
    scale = DH ** -0.5
    entry = None
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        # q, k, v as the three strided views of one fused qkv GEMM output,
        # as the backbone hands them to the kernel.
        qkv = torch.randn((B, S, 3 * H * DH), generator=gen)
        qkv = qkv.to("cuda", dtype)
        q, k, v = (t.view(B, S, H, DH) for t in qkv.chunk(3, dim=-1))
        for kv_len in (S, KV_MASKED):
            o, lse = fa.flash_attention_fwd(q, k, v, scale=scale,
                                            kv_len=kv_len)
            o_ref, lse_ref = fa.flash_attention_fwd_plain(
                q, k, v, scale=scale, kv_len=kv_len)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
            def kernel():
                fa.flash_attention_fwd(q, k, v, scale=scale, kv_len=kv_len)

            ms = device_ms(kernel, iters=50)
            event_ms = time_ms(kernel, iters=50)
            plain_ms = device_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, scale=scale, kv_len=kv_len), iters=10)
            # The library yardstick: SDPA on the first kv_len keys.
            qt, kt, vt = (t.transpose(1, 2) for t in
                          (q, k[:, :kv_len], v[:, :kv_len]))
            library_ms = device_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, scale=scale), iters=50)
            bound_ms, bound_by = attention_bound(name, kv_len)
            row = {
                "dtype": name, "kv_len": kv_len, "shape": [B, S, H, DH],
                "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            log("kernels: flash_attn_fwd " + json.dumps(row))
            tol = TOL[name]
            if not finite or err_o > tol["o"] or err_lse > tol["lse"]:
                failures.append(
                    f"{name} kv_len={kv_len}: o err {err_o:.3g} "
                    f"(tol {tol['o']}), lse err {err_lse:.3g} "
                    f"(tol {tol['lse']}), finite={finite}")
            if name == "bfloat16" and kv_len == S:
                entry = {
                    "name": "flash_attn_fwd",
                    "route": "cuda",
                    "source": "dinov2_od_tpu_torch/csrc/flash_attn_fwd.cu",
                    "replaces": "dinov2_od_tpu/ops/flash_attention.py:357",
                    "replaces_function": "_fwd_kernel_flat",
                    "launches": 0,
                    "launches_per_forward": 0,
                    "max_abs_err": err_o,
                    "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms,
                }
        del qkv, q, k, v
    if failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return entry


def phase_bwd_kernel(seed: int):
    """Flash-attention backward against its plain version; returns the
    kernel's entry of the kernels line (launches filled in later)."""
    import torch
    import torch.nn.functional as F

    from dinov2_od_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 1)
    scale = DH ** -0.5
    entry = None
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        # q, k, v as the three strided views of one fused qkv GEMM output,
        # as the forward saved them.
        qkv = torch.randn((B, S, 3 * H * DH), generator=gen).to("cuda", dtype)
        q, k, v = (t.view(B, S, H, DH) for t in qkv.chunk(3, dim=-1))
        do = torch.randn((B, S, H, DH), generator=gen).to("cuda", dtype)
        for kv_len in (S, KV_MASKED):
            o, lse = fa.flash_attention_fwd(q, k, v, scale=scale,
                                            kv_len=kv_len)
            delta = fa._delta(do, o, None)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                         kv_len=kv_len)
            ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                               scale=scale, kv_len=kv_len)
            torch.cuda.synchronize()
            err, abs_err = {}, {}
            for gname, g, r in zip(("dq", "dk", "dv"), got, ref):
                abs_err[gname] = (g.float() - r.float()).abs().max().item()
                err[gname] = abs_err[gname] / max(
                    1.0, r.float().abs().max().item())
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            masked_zero = bool(not got[1][:, kv_len:].any()
                               and not got[2][:, kv_len:].any())
            def kernel():
                fa._launch_bwd(q, k, v, do, lse, delta, scale, kv_len)

            ms = device_ms(kernel, iters=50)
            event_ms = time_ms(kernel, iters=50)
            plain_ms = device_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, do, lse, delta, scale=scale, kv_len=kv_len),
                iters=5)
            # The library yardstick: SDPA forward + backward on the first
            # kv_len keys, less SDPA forward alone.
            qt, kt, vt = (t.transpose(1, 2).detach().clone()
                          .requires_grad_(True)
                          for t in (q, k[:, :kv_len], v[:, :kv_len]))
            dot = do.transpose(1, 2)

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
                torch.autograd.grad(out, (qt, kt, vt), dot)

            def sdpa_fwd():
                with torch.no_grad():
                    F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

            library_ms = (device_ms(sdpa_fwd_bwd, iters=20)
                          - device_ms(sdpa_fwd, iters=20))
            bound_ms, bound_by = attention_bwd_bound(name, kv_len)
            row = {
                "dtype": name, "kv_len": kv_len, "shape": [B, S, H, DH],
                "max_abs_err": abs_err, "max_rel_err": err,
                "masked_dk_dv_exactly_zero": masked_zero,
                "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            log("kernels: flash_attn_bwd " + json.dumps(row))
            tol = BWD_TOL[name]
            bad = [g for g, e in err.items() if e > tol]
            if not finite or bad or not masked_zero:
                failures.append(
                    f"{name} kv_len={kv_len}: errors {err} (tol {tol}), "
                    f"finite={finite}, masked dk/dv zero={masked_zero}")
            if name == "bfloat16" and kv_len == S:
                entry = {
                    "name": "flash_attn_bwd",
                    "route": "cuda",
                    "source": "dinov2_od_tpu_torch/csrc/flash_attn_bwd.cu",
                    "replaces": "dinov2_od_tpu/ops/flash_attention.py:403",
                    "replaces_function": "_bwd_kernel_flat",
                    "launches": 0,
                    "launches_per_step": 0,
                    "max_abs_err": max(abs_err.values()),
                    "max_rel_err": max(err.values()),
                    "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": library_ms,
                }
            del qt, kt, vt
        del qkv, q, k, v, do
    if failures:
        raise AssertionError("backward kernel disagrees with its plain "
                             "version: " + "; ".join(failures))
    return entry


def _requests(seed: int, image_size: int):
    rng = np.random.default_rng(seed)
    return [[rng.uniform(size=(image_size, image_size, 3)).astype(np.float32)
             for _ in range(n)] for n in REQUEST_SIZES]


def _serve(predictor, requests, phase: str):
    """The serving main path: counts to 0, the requests sent at once by
    concurrent clients through a DynamicBatcher, the counts read. Returns
    (launch counts, device batches, each request's detections)."""
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.serve import DynamicBatcher

    _build.reset_launch_counts()
    predictor.device_batches = 0
    batcher = DynamicBatcher(predictor, max_batch=32, max_wait_ms=20.0)
    results = [None] * len(requests)
    errors = []

    def client(i):
        try:
            results[i] = batcher.submit(requests[i], 0.0)
        except Exception as e:  # reported below; the phase fails
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    batcher.close()
    counts = dict(_build.launch_counts)
    device_batches = predictor.device_batches
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"requests failed: {errors}")
    log(f"{phase}: {len(requests)} requests of {list(REQUEST_SIZES)} images "
        f"in {wall:.3f} s, {batcher.batches} batcher calls, "
        f"{device_batches} device batches, launches {counts}")
    return counts, device_batches, results


def _check_alone(predictor, requests, results, phase: str):
    """Every request got its own detections: each one answered alone must
    give what the coalesced batch gave it."""
    for i, (imgs, res) in enumerate(zip(requests, results)):
        if len(res) != len(imgs):
            raise AssertionError(f"request {i}: {len(res)} results for "
                                 f"{len(imgs)} images")
        alone = predictor.detect(imgs, score_threshold=0.0)
        for got, want in zip(res, alone):
            g = np.array([[d["score"], *d["bbox"]] for d in got])
            w = np.array([[d["score"], *d["bbox"]] for d in want])
            if g.shape != w.shape or not np.isfinite(g).all():
                raise AssertionError(f"request {i}: bad detections")
            # Scores to 1e-3, boxes (pixels of a 224 px image) to 0.25 px.
            if (np.abs(g[:, 0] - w[:, 0]).max() > 1e-3
                    or np.abs(g[:, 1:] - w[:, 1:]).max() > 0.25):
                raise AssertionError(f"request {i}: detections differ from "
                                     f"the same images run alone")
    log(f"{phase}: every request got its own detections back, all finite")


def _serving_model(seed: int):
    """The serving configuration (ViT-B/14 at 224 px + deformable DETR,
    full width and depth) and its random params from `seed`, on the card:
    (fp32 cfg, bf16-backbone cfg, params)."""
    import torch

    from dinov2_od_tpu_torch.config import detector_config_for_model_name
    from dinov2_od_tpu_torch.models.detector import init_detector_params

    cfg = detector_config_for_model_name("facebook/dinov2-base")
    cfg16 = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="bfloat16"))
    params = init_detector_params(torch.Generator().manual_seed(seed), cfg,
                                  device="cuda")
    return cfg, cfg16, params


def _forward_ms(predictor, image_size: int):
    """(ms per batch, the timed call) of the batch-32 forward plus top-k."""
    import torch

    xb = torch.zeros((32, image_size, image_size, 3), device="cuda")
    sizes = torch.full((32, 2), image_size, device="cuda", dtype=torch.int32)

    def fwd():
        with torch.inference_mode():
            predictor._forward_topk(xb, sizes, 100)

    return time_ms(fwd, iters=20), fwd


def int8_bound(m: int, k: int, n: int, item: int):
    """(bound_ms, bound_by) of one fused int8 linear: x [M, K] read once,
    the int8 W [K, N] and the fp32 w_scale and bias read once, out [M, N]
    in x's dtype written once; 2 M K N int8 operations."""
    n_bytes = m * k * item + k * n + 2 * n * 4 + m * n * item
    return _bound("int8", n_bytes, 2.0 * m * k * n)


def phase_int8_kernel(seed: int):
    """B6 against its plain version at the main paths' shapes, with a
    control that must fail; returns the kernel's entry of the kernels line
    (launches filled in later)."""
    import torch

    from dinov2_od_tpu_torch.models.quantize import quantize_linear
    from dinov2_od_tpu_torch.ops import int8_gemm as ig

    gen = torch.Generator().manual_seed(seed + 4)
    entry = None
    failures = []
    for m, k, n, name in INT8_CASES:
        dtype = getattr(torch, name)
        # Weights at the init's scale, activations as a LayerNormed fc1
        # output would be: unit normal.
        qp = quantize_linear({
            "kernel": torch.randn((k, n), generator=gen) / k ** 0.5,
            "bias": torch.randn((n,), generator=gen) * 0.02})
        qp = {key: v.to("cuda") for key, v in qp.items()}
        x = torch.randn((m, k), generator=gen).to("cuda", dtype)
        out = ig.fused_int8_linear(x, qp)
        ref = ig.fused_int8_linear_plain(x, qp)
        xc = x.clone()
        xc[:, -INT8_DROP:] = 0
        control = ig.fused_int8_linear(xc, qp)
        torch.cuda.synchronize()
        limit = torch.finfo(dtype).eps * ref.float().abs().clamp_min(1.0)
        diff = (out.float() - ref.float()).abs()
        ok = bool((diff <= limit).all()) and bool(torch.isfinite(out).all())
        control_ok = bool(((control.float() - ref.float()).abs()
                           <= limit).all())
        err = diff.max().item()

        def kernel():
            ig.fused_int8_linear(x, qp)

        ms = device_ms(kernel, iters=50)
        event_ms = time_ms(kernel, iters=50)
        plain_ms = device_ms(lambda: ig.fused_int8_linear_plain(x, qp),
                             iters=10)
        # Library yardsticks: the GEMM alone (torch._int_mm, cuBLASLt) on
        # the pre-quantized operands, with W as stored ([K, N] row-major)
        # and K-major (a [N, K] copy, cuBLASLt's native int8 layout); the
        # unfused path as a whole (quantization, _int_mm, epilogue); a bf16
        # matmul of the same shape for context.
        xq, xs = ig.quantize_acts(x)
        kq = qp["kernel_q"]
        kq_kmajor = kq.t().contiguous().t()
        int_mm_ms = device_ms(lambda: torch._int_mm(xq, kq), iters=20)
        int_mm_kmajor_ms = device_ms(lambda: torch._int_mm(xq, kq_kmajor),
                                     iters=20)

        def unfused():  # the port's path below K = 2048, K-major W
            q, s = ig.quantize_acts(x)
            ig.dequant_epilogue(torch._int_mm(q, kq_kmajor), s,
                                qp["w_scale"], qp["bias"], x.dtype)

        unfused_ms = device_ms(unfused, iters=20)
        xb = x.to(torch.bfloat16)
        wb = torch.randn((k, n), generator=gen).to("cuda", torch.bfloat16)
        bf16_ms = device_ms(lambda: xb @ wb, iters=20)
        bound_ms, bound_by = int8_bound(m, k, n, x.element_size())
        row = {
            "dtype": name, "shape": [m, k, n], "max_abs_err": err,
            "mismatches": int((diff > 0).sum()), "within_limit": ok,
            "control_max_abs_err": (control.float() - ref.float()).abs()
            .max().item(),
            "control_within_limit": control_ok,
            "ms": ms, "event_ms": event_ms, "plain_ms": plain_ms,
            "int_mm_ms": int_mm_ms, "int_mm_kmajor_ms": int_mm_kmajor_ms,
            "unfused_ms": unfused_ms, "bf16_matmul_ms": bf16_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log("kernels: int8_gemm " + json.dumps(row))
        if not ok:
            failures.append(f"{name} {m}x{k}x{n}: max abs err {err:.4g}")
        if control_ok:
            failures.append(f"{name} {m}x{k}x{n}: the control (last "
                            f"{INT8_DROP} of K dropped) passes the check")
        if entry is None:
            entry = {
                "name": "int8_gemm",
                "route": "cuda",
                "source": "dinov2_od_tpu_torch/csrc/int8_gemm.cu",
                "replaces": "dinov2_od_tpu/ops/int8_gemm.py:36",
                "replaces_function": "_kernel",
                "launches": 0,
                "shape": [m, k, n], "dtype": name,
                "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": min(int_mm_ms, int_mm_kmajor_ms),
                "library": "torch._int_mm on the pre-quantized operands",
                "unfused_ms": unfused_ms, "bf16_matmul_ms": bf16_ms,
            }
        del x, xc, xq, xb, wb, out, ref, control, qp
    if failures:
        raise AssertionError("int8 GEMM kernel disagrees with its plain "
                             "version: " + "; ".join(failures))
    return entry


def phase_slice(seed: int, kernels: dict, profile: bool = False) -> float:
    """The bf16 serving path; returns its images/s."""
    import torch

    from dinov2_od_tpu_torch.inference import Predictor, prepare_images
    from dinov2_od_tpu_torch.models.detector import (
        cast_frozen_weights, detector_apply, fold_detector_lora)

    cfg, cfg16, params = _serving_model(seed)
    bb = cfg.backbone
    log(f"slice: ViT-{bb.variant} hidden {bb.hidden_dim} depth {bb.depth} "
        f"heads {bb.num_heads} {bb.image_size} px ({bb.seq_len} tokens); "
        f"decoder {cfg.decoder.num_layers} layers dim "
        f"{cfg.decoder.hidden_dim} queries {cfg.decoder.num_queries} "
        f"classes {cfg.decoder.num_classes}")
    predictor = Predictor(cast_frozen_weights(params, cfg16), cfg16,
                          device="cuda", batch_size=32)
    requests = _requests(seed, bb.image_size)

    counts, device_batches, results = _serve(predictor, requests, "slice")
    want = {"flash_attn_fwd": bb.depth * device_batches, "flash_attn_bwd": 0,
            "int8_gemm": 0}
    if counts != want or device_batches == 0:
        raise AssertionError(f"serving launches {counts} for "
                             f"{device_batches} device batches; expected "
                             f"{want} ({bb.depth} forward launches each)")
    fwd = kernels["flash_attn_fwd"]
    fwd["launches"] = counts["flash_attn_fwd"]
    fwd["launches_serving"] = counts["flash_attn_fwd"]
    fwd["launches_per_forward"] = counts["flash_attn_fwd"] / device_batches
    _check_alone(predictor, requests, results, "slice")

    # detector_apply with the kernel against plain attention.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pixels, _ = prepare_images(requests[0], bb.image_size, normalize=True)
    x = torch.from_numpy(pixels).to("cuda")
    folded = fold_detector_lora(params, cfg)
    for name, c, p in (("float32", cfg, folded),
                       ("bfloat16", cfg16, cast_frozen_weights(folded, cfg16))):
        with torch.inference_mode():
            ref = detector_apply(p, c, x, attn_impl="xla")
            runs = {"kernel": detector_apply(p, c, x, attn_impl="auto")}
            for kv_len in CONTROLS:
                with _keys_dropped(kv_len):
                    runs[f"control kv_len={kv_len}"] = detector_apply(
                        p, c, x, attn_impl="auto")
        _check_model(f"slice: detector_apply {name}", "plain attention",
                     runs, ref, MODEL_TOL[name], _max_abs, "max abs err")

    ms, fwd_call = _forward_ms(predictor, bb.image_size)
    ips = 32 / ms * 1e3
    log("slice: " + json.dumps({
        "metric": "batch-32 forward + top-k, bf16 backbone",
        "ms_per_batch": ms, "images_per_s": ips, "card": card_line(),
    }))
    if profile:
        profile_device(fwd_call, ms, "serving forward")
    return ips


def _max_abs(out, ref):
    return (out.float() - ref.float()).abs().max().item()


def _rel_norm(out, ref):
    return ((out.float() - ref.float()).norm() / ref.float().norm()).item()


def _check_model(what: str, ref_name: str, runs: dict, ref: dict, tol: dict,
                 metric, metric_name: str) -> dict:
    """Each run's outputs against `ref` by `metric`: the sound run
    ("kernel") must keep every output within its limit, each control must
    exceed one. Returns the sound run's readings."""
    import torch

    readings = {}
    for run, out in runs.items():
        err = {key: metric(out[key], ref[key]) for key in OUTPUTS}
        finite = all(bool(torch.isfinite(out[key]).all()) for key in OUTPUTS)
        failed = [k for k in OUTPUTS if err[k] > tol[k]]
        log(f"{what} {run} vs {ref_name}: "
            + ", ".join(f"{k} {metric_name} {err[k]:.4g} (tol {tol[k]})"
                        for k in OUTPUTS)
            + f", finite={finite}, over the limit: {failed or 'none'}")
        if run == "kernel":
            readings = err
            if not finite or failed:
                raise AssertionError(f"{what} disagrees with {ref_name}")
        elif not failed:
            raise AssertionError(
                f"{what}: the check against {ref_name} passes a faulty "
                f"kernel ({run}); its limits are too loose")
    return readings


@contextlib.contextmanager
def _int8_gemm_as(kind: str):
    """B6 inside the model swapped for the gradient and model checks:
    "plain" runs its plain version on the card; "control" is a faulty
    kernel, B6 with the last 64-wide K tile of x zeroed (the output of a
    kernel that drops that tile, but for the row scales)."""
    from dinov2_od_tpu_torch.ops import int8_gemm

    sound = int8_gemm.fused_int8_linear

    def control(x, p):
        x = x.clone()
        x[..., -INT8_DROP:] = 0
        return sound(x, p)

    int8_gemm.fused_int8_linear = {
        "plain": int8_gemm.fused_int8_linear_plain, "control": control}[kind]
    try:
        yield
    finally:
        int8_gemm.fused_int8_linear = sound


def phase_int8_serving(seed: int, kernels: dict, bf16_ips: float,
                       profile: bool = False):
    """The int8 W8A8 serving path: Predictor(quantize="int8")."""
    import torch

    from dinov2_od_tpu_torch.inference import Predictor, prepare_images
    from dinov2_od_tpu_torch.models.detector import (
        cast_frozen_weights, detector_apply, fold_detector_lora)
    from dinov2_od_tpu_torch.models.quantize import quantize_detector_int8

    cfg, cfg16, params = _serving_model(seed)
    bb = cfg.backbone
    predictor = Predictor(cast_frozen_weights(params, cfg16), cfg16,
                          device="cuda", batch_size=32, quantize="int8")
    log(f"int8 serving: the slice's model, LoRA folded, then the 6 linears "
        f"of each block int8 (per-channel weights, per-token activations); "
        f"{bb.depth} fc2 (K {bb.mlp_dim}) per forward on B6")
    requests = _requests(seed, bb.image_size)
    counts, device_batches, results = _serve(predictor, requests,
                                             "int8 serving")
    want = {"flash_attn_fwd": bb.depth * device_batches, "flash_attn_bwd": 0,
            "int8_gemm": bb.depth * device_batches}
    if counts != want or device_batches == 0:
        raise AssertionError(f"int8 serving launches {counts} for "
                             f"{device_batches} device batches; expected "
                             f"{want}")
    fwd, b6 = kernels["flash_attn_fwd"], kernels["int8_gemm"]
    fwd["launches"] += counts["flash_attn_fwd"]
    fwd["launches_int8_serving"] = counts["flash_attn_fwd"]
    b6["launches"] = counts["int8_gemm"]
    b6["launches_int8_serving"] = counts["int8_gemm"]
    b6["launches_per_forward"] = counts["int8_gemm"] / device_batches
    _check_alone(predictor, requests, results, "int8 serving")

    # detector_apply on the int8 tree: B6 against its plain version on the
    # card, and the int8 model against the same weights in bf16.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pixels, _ = prepare_images(requests[0], bb.image_size, normalize=True)
    x = torch.from_numpy(pixels).to("cuda")
    p16 = cast_frozen_weights(fold_detector_lora(params, cfg), cfg16)
    q16 = quantize_detector_int8(p16, cfg16)
    with torch.inference_mode():
        bf16 = detector_apply(p16, cfg16, x)
        runs = {"kernel": detector_apply(q16, cfg16, x)}
        with _int8_gemm_as("plain"):
            plain = detector_apply(q16, cfg16, x)
        with _int8_gemm_as("control"):
            runs[f"control last {INT8_DROP} of K dropped"] = detector_apply(
                q16, cfg16, x)
    _check_model("int8 serving: detector_apply", "plain B6", runs, plain,
                 INT8_MODEL_TOL["plain B6"], _max_abs, "max abs err")
    _check_model("int8 serving: detector_apply", "the bf16 model", runs, bf16,
                 INT8_MODEL_TOL["bf16 model"], _rel_norm, "rel err")

    ms, fwd_call = _forward_ms(predictor, bb.image_size)
    log("int8 serving: " + json.dumps({
        "metric": "batch-32 forward + top-k, int8 W8A8 backbone",
        "ms_per_batch": ms, "images_per_s": 32 / ms * 1e3,
        "bf16_images_per_s": bf16_ips, "card": card_line(),
    }))
    if profile:
        profile_device(fwd_call, ms, "int8 serving forward")


def _groups(params, cfg):
    """The trainable leaves in the gradient check's groups: "lora" (the
    adapted blocks' rows of every LoRA leaf, by (name, first row)),
    "decoder" and, when there is one, "projection"."""
    blocks = params["backbone"]["blocks"]
    first = cfg.backbone.depth - cfg.backbone.lora_last_n_blocks
    groups = {"lora": [(blocks[lin][f], first) for lin in sorted(blocks)
                       if isinstance(blocks[lin], dict)
                       for f in ("lora_A", "lora_B") if f in blocks[lin]],
              "decoder": []}

    def walk(t):
        for v in t.values():
            if isinstance(v, dict):
                walk(v)
            else:
                groups["decoder"].append((v, 0))

    walk(params["decoder"])
    if "projection" in params["backbone"]:
        groups["projection"] = [(params["backbone"]["projection"][f], 0)
                                for f in ("kernel", "bias")]
    return groups


def _group_grads(loss, groups):
    """The gradient of each group, flattened into one fp32 vector."""
    import torch

    leaves = [t for g in groups.values() for t, _ in g]
    grads = iter(torch.autograd.grad(loss, leaves))
    return {name: torch.cat([next(grads)[row:].reshape(-1).float()
                             for _, row in items])
            for name, items in groups.items()}


@contextlib.contextmanager
def _bwd_keys_dropped(kv_len: int):
    """The flash backward as a faulty kernel: B2 handed a smaller kv_len
    than its forward used, so it drops the keys from `kv_len` on."""
    from dinov2_od_tpu_torch.ops import flash_attention as fa

    sound = fa.flash_attention_bwd

    def faulty(q, k, v, o, lse, do, *, scale, kv_len=None, glse2=None):
        return sound(q, k, v, o, lse, do, scale=scale,
                     kv_len=min(kv_len or q.shape[1], drop), glse2=glse2)

    drop = kv_len
    fa.flash_attention_bwd = faulty
    try:
        yield
    finally:
        fa.flash_attention_bwd = sound


@contextlib.contextmanager
def _plain_backward():
    """The flash backward's plain version on the card, behind the kernel
    forward: the gradient check's reference for the backward alone."""
    from dinov2_od_tpu_torch.ops import flash_attention as fa

    sound = fa.flash_attention_bwd

    def plain(q, k, v, o, lse, do, *, scale, kv_len=None, glse2=None):
        return fa.flash_attention_bwd_plain(
            q, k, v, do, lse, fa._delta(do, o, glse2), scale=scale,
            kv_len=kv_len)

    fa.flash_attention_bwd = plain
    try:
        yield
    finally:
        fa.flash_attention_bwd = sound


def _drive_train(seed: int, det, steps: int, want_per_step: dict,
                 phase: str, profile: bool):
    """The train main path: `steps` full-width steps on a fixed synthetic
    batch with the launch counts set to 0 before and read after, held to
    `want_per_step` launches; finite losses that drop, frozen leaves and
    the non-adapted LoRA rows bit-identical; then the step's throughput.
    Returns (train config, batch, launch counts, images/s)."""
    import torch

    from dinov2_od_tpu_torch.config import DataConfig, OptimConfig, TrainConfig
    from dinov2_od_tpu_torch.data.synthetic import make_batch
    from dinov2_od_tpu_torch.models.detector import (
        cast_frozen_weights, init_detector_params, trainable_mask)
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.train.state import create_train_state
    from dinov2_od_tpu_torch.train.step import make_train_step

    cfg = TrainConfig(detector=det,
                      data=DataConfig(batch_size=B, max_boxes=MAX_BOXES),
                      optim=OptimConfig())
    bb, dec = det.backbone, det.decoder
    log(f"{phase}: ViT-{bb.variant} depth {bb.depth} ({bb.seq_len} tokens) "
        f"bf16, LoRA r={bb.lora_r} {bb.lora_mode} on the last "
        f"{bb.lora_last_n_blocks} blocks, prefix_int8={bb.prefix_int8}; "
        f"decoder {dec.num_layers} layers fp32 dropout {dec.dropout}; batch "
        f"{B}, {MAX_BOXES} GT slots, matcher {cfg.matcher.assignment}; "
        f"{cfg.optim}")
    params = cast_frozen_weights(init_detector_params(
        torch.Generator().manual_seed(seed), det, device="cuda"), det)
    state = create_train_state(params, cfg.optim, det)
    raw = make_batch(np.random.default_rng(seed), B, image_size=bb.image_size,
                     max_boxes=MAX_BOXES)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in raw.items()}
    mask = trainable_mask(params, det)
    frozen, lora_rows = [], []
    first = bb.depth - bb.lora_last_n_blocks

    def snapshot(t, m):
        for key in t:
            if isinstance(t[key], dict):
                snapshot(t[key], m[key])
            elif not m[key]:
                frozen.append((t[key], t[key].clone()))
            elif key in ("lora_A", "lora_B") and t[key].dim() == 3:
                lora_rows.append((t[key], t[key][:first].clone()))

    snapshot(params, mask)
    step = make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    # The main path: counts to 0, drive, read the counts.
    _build.reset_launch_counts()
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    losses = torch.stack(losses).tolist()
    log(f"{phase}: {steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"grad_norm {metrics['grad_norm'].item():.4f}, launches {counts}")
    want = {name: n * steps for name, n in want_per_step.items()}
    if counts != want:
        raise AssertionError(f"{phase} launches {counts}; expected {want} "
                             f"({want_per_step} per step)")
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not drop: {losses[0]} -> "
                             f"{losses[-1]}")
    changed = sum(not torch.equal(t, before) for t, before in frozen)
    changed_rows = sum(not torch.equal(t[:first], before)
                       for t, before in lora_rows)
    if changed or changed_rows:
        raise AssertionError(f"{changed} frozen leaves and {changed_rows} "
                             f"non-adapted LoRA leaves changed")
    log(f"{phase}: losses finite and dropping; {len(frozen)} frozen leaves "
        f"and the non-adapted rows of {len(lora_rows)} LoRA leaves "
        f"bit-identical")

    # Throughput of the train step on the fixed batch.
    ms = time_ms(lambda: step(state, batch, gen), iters=5, warmup=2,
                 repeats=5)
    ips = B / ms * 1e3
    log(f"{phase}: " + json.dumps({
        "metric": f"train step, batch {B}, bf16 backbone, "
                  f"prefix_int8={bb.prefix_int8}, {MAX_BOXES} GT slots",
        "ms_per_step": ms, "images_per_s": ips,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card_line(),
    }))
    if profile:
        profile_device(lambda: step(state, batch, gen), ms, f"{phase} step")
    del state, params, frozen, lora_rows
    torch.cuda.empty_cache()
    return cfg, batch, counts, ips


def _train_dets(**backbone):
    """The train configuration: ViT-B/14 + deformable DETR with a bf16
    backbone, and the same in fp32 for the gradient check."""
    from dinov2_od_tpu_torch.config import detector_config_for_model_name

    det32 = detector_config_for_model_name("facebook/dinov2-base",
                                           hidden_dim=768)
    det32 = dataclasses.replace(det32, backbone=dataclasses.replace(
        det32.backbone, **backbone))
    det = dataclasses.replace(det32, backbone=dataclasses.replace(
        det32.backbone, dtype="bfloat16"))
    return det32, det


def phase_train(seed: int, kernels: dict, profile: bool = False) -> float:
    """The bf16 train step; returns its images/s."""
    import torch

    det32, det = _train_dets()
    bb = det.backbone
    cfg, batch, counts, ips = _drive_train(
        seed, det, TRAIN_STEPS,
        {"flash_attn_fwd": bb.depth, "flash_attn_bwd": bb.lora_last_n_blocks,
         "int8_gemm": 0}, "train", profile)
    fwd = kernels["flash_attn_fwd"]
    fwd["launches"] += counts["flash_attn_fwd"]
    fwd["launches_train"] = counts["flash_attn_fwd"]
    fwd["launches_per_step"] = counts["flash_attn_fwd"] / TRAIN_STEPS
    bwd = kernels["flash_attn_bwd"]
    bwd["launches"] = counts["flash_attn_bwd"]
    bwd["launches_train"] = counts["flash_attn_bwd"]
    bwd["launches_per_step"] = counts["flash_attn_bwd"] / TRAIN_STEPS

    # One step's loss and gradients with the kernels against plain
    # attention and against the plain backward, the same assignment for
    # every run. Deterministic algorithms (the deformable gather's backward
    # otherwise scatters with atomics), so that a reading moves only with
    # the attention it checks; the plain backward run twice shows the
    # floor that is left.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _gradient_check(seed, cfg, det32, det, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    return ips


def phase_prefix_int8_train(seed: int, kernels: dict, bf16_ips: float,
                            profile: bool = False):
    """The train step with the frozen prefix in int8 (prefix_int8)."""
    import torch

    _, det = _train_dets(prefix_int8=True)
    bb = det.backbone
    prefix = bb.depth - bb.lora_last_n_blocks
    cfg, batch, counts, ips = _drive_train(
        seed, det, INT8_TRAIN_STEPS,
        {"flash_attn_fwd": bb.depth, "flash_attn_bwd": bb.lora_last_n_blocks,
         "int8_gemm": prefix}, "prefix-int8 train", profile)
    log("prefix-int8 train: " + json.dumps({
        "images_per_s": ips, "bf16_train_images_per_s": bf16_ips}))
    for name in ("flash_attn_fwd", "flash_attn_bwd", "int8_gemm"):
        k = kernels[name]
        k["launches"] += counts[name]
        k["launches_prefix_int8_train"] = counts[name]
    kernels["int8_gemm"]["launches_per_step"] = (
        counts["int8_gemm"] / INT8_TRAIN_STEPS)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _int8_gradient_check(seed, cfg, det, batch)
    finally:
        torch.use_deterministic_algorithms(False)


def _step_loss_grads(seed, cfg, c, batch):
    """A closure giving one step's loss and trainable gradients by group
    (`_groups`) on fixed params from `seed` (nonzero LoRA B, so every LoRA
    leaf has a gradient) and one fixed assignment."""
    import torch

    from dinov2_od_tpu_torch.models.detector import (
        cast_frozen_weights, detector_apply, init_detector_params)
    from dinov2_od_tpu_torch.ops.losses import set_criterion
    from dinov2_od_tpu_torch.ops.matching import hungarian_match
    from dinov2_od_tpu_torch.train.state import create_train_state

    x = batch["images"]
    gt = (batch["labels"], batch["boxes"], batch["valid"])
    p = init_detector_params(torch.Generator().manual_seed(seed + 2), c,
                             device="cuda")
    lg = torch.Generator().manual_seed(seed + 3)
    for lin in p["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = (0.05 * torch.randn(
                lin["lora_B"].shape, generator=lg)).to("cuda")
    if c.backbone.dtype == "bfloat16":
        p = cast_frozen_weights(p, c)
    create_train_state(p, cfg.optim, c)  # marks the trainable leaves
    groups = _groups(p, c)
    with torch.no_grad():
        out = detector_apply(p, c, x, attn_impl="xla")
    match = hungarian_match(out["pred_logits"], out["pred_boxes"], *gt)

    def loss_grads(impl="auto"):
        o = detector_apply(p, c, x, attn_impl=impl)
        loss = set_criterion(o["pred_logits"], o["pred_boxes"], *gt,
                             num_classes=c.decoder.num_classes,
                             match=match)["loss"]
        return loss.detach(), _group_grads(loss, groups)

    return loss_grads


def _grad_errors(run, ref):
    (loss, grads), (ref_loss, ref_grads) = run, ref
    err = {"loss": abs((loss - ref_loss) / ref_loss).item()}
    for g in grads:
        err[g] = ((grads[g] - ref_grads[g]).norm()
                  / ref_grads[g].norm()).item()
    return err


def _int8_gradient_check(seed, cfg, det, batch):
    """One prefix-int8 step's loss and trainable gradients with B6 against
    the same step with B6's plain version on the card, beside a control
    (B6 with the last K tile dropped) that must fail the same check."""
    import torch

    c = dataclasses.replace(det, decoder=dataclasses.replace(
        det.decoder, dropout=0.0))
    loss_grads = _step_loss_grads(seed, cfg, c, batch)
    with _int8_gemm_as("plain"):
        ref = loss_grads()
    runs = {"kernel": loss_grads()}
    with _int8_gemm_as("control"):
        runs[f"control last {INT8_DROP} of K dropped"] = loss_grads()
    for run, result in runs.items():
        err = _grad_errors(result, ref)
        finite = bool(torch.isfinite(result[0])) and all(
            bool(torch.isfinite(g).all()) for g in result[1].values())
        over = [g for g in err if err[g] > INT8_GRAD_TOL[g]]
        log(f"prefix-int8 train: gradients {run} vs plain B6: "
            + ", ".join(f"{g} rel err {err[g]:.4g} (tol {INT8_GRAD_TOL[g]})"
                        for g in err)
            + f", finite={finite}, over the limit: {over or 'none'}")
        if run == "kernel" and (over or not finite):
            raise AssertionError(f"prefix-int8 gradients disagree: {over}")
        if run != "kernel" and not over:
            raise AssertionError(
                f"prefix-int8 gradients: the check passes a faulty B6 "
                f"({run}); its limits are too loose")
    del loss_grads, runs, ref
    torch.cuda.empty_cache()


def _gradient_check(seed, cfg, det32, det, batch):
    import torch

    for name in ("float32", "bfloat16"):
        c = dataclasses.replace(
            det32 if name == "float32" else det,
            decoder=dataclasses.replace(det.decoder, dropout=0.0))
        loss_grads = _step_loss_grads(seed, cfg, c, batch)
        refs = {"plain attention": loss_grads("xla")}
        with _plain_backward():
            refs["plain backward"] = loss_grads("auto")
            again = loss_grads("auto")
        floor = _grad_errors(again, refs["plain backward"])
        log(f"train: gradients {name} plain backward run twice: rel err "
            + ", ".join(f"{g} {e:.4g}" for g, e in floor.items()
                        if g != "loss"))
        runs = {"kernel": loss_grads("auto")}
        for kv_len in GRAD_CONTROLS:
            with _bwd_keys_dropped(kv_len):
                runs[f"control kv_len={kv_len}"] = loss_grads("auto")
        verdicts = {}
        for run, result in runs.items():
            finite = bool(torch.isfinite(result[0])) and all(
                bool(torch.isfinite(g).all()) for g in result[1].values())
            failed = [] if finite else ["non-finite"]
            for ref_name, ref in refs.items():
                tol = GRAD_TOL[name][ref_name]
                err = _grad_errors(result, ref)
                over = [g for g in err if err[g] > tol[g]]
                failed += [f"{ref_name}: {g}" for g in over]
                log(f"train: gradients {name} {run} vs {ref_name}: "
                    + ", ".join(f"{g} rel err {err[g]:.4g} (tol {tol[g]})"
                                for g in err)
                    + f", finite={finite}, over the limit: {over or 'none'}")
            verdicts[run] = failed
        if verdicts["kernel"]:
            raise AssertionError(f"train gradients {name} disagree: "
                                 f"{verdicts['kernel']}")
        passed = [r for r, f in verdicts.items() if r != "kernel" and not f]
        if passed:
            raise AssertionError(
                f"train gradients {name}: the check passes a backward that "
                f"drops keys ({passed}); its limits are too loose")
        del loss_grads, runs, refs
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _keys_dropped(kv_len: int):
    """The backbone's attention as a faulty kernel that ignores the keys
    from `kv_len` on, for the controls of the model check."""
    from dinov2_od_tpu_torch.models import vit

    sound = vit.multi_head_attention

    def faulty(q, k, v, **kwargs):
        return sound(q, k, v, **{**kwargs, "kv_valid_len": kv_len})

    vit.multi_head_attention = faulty
    try:
        yield
    finally:
        vit.multi_head_attention = sound


def profile_device(fn, unprofiled_ms: float, what: str, steps: int = 5,
                   top: int = 12):
    """Device time of `steps` calls of `fn` by CUDA kernel, from
    torch.profiler: the largest kernels, the shares of GEMMs and of the
    flash kernels, the device's idle share of the unprofiled step time,
    and the host time of the matcher's solve per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = []
    matcher_ms = 0.0
    for ev in prof.key_averages():
        if ev.key == "matcher_host_solve":
            # A host span; its GPU-side annotation is no kernel either.
            matcher_ms = max(matcher_ms, ev.cpu_time_total / 1e3 / steps)
            continue
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us / 1e3 / steps, ev.count // steps, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if total <= 0:
        raise AssertionError("the profiler saw no device time")

    def share(*tags):
        return sum(r[0] for r in rows
                   if any(t in r[2].lower() for t in tags)) / total

    log(f"profile: {what}: " + json.dumps({
        "steps": steps, "kernels_per_step": sum(r[1] for r in rows),
        "device_ms_per_step": total, "unprofiled_ms_per_step": unprofiled_ms,
        "idle_share": max(0.0, 1 - total / unprofiled_ms),
        "gemm_share": share("gemm", "nvjet", "xmma", "cutlass"),
        "flash_fwd_share": share("flash_fwd"),
        "flash_bwd_share": share("dkdv_", "dq_bf16", "dq_f32"),
        "int8_gemm_share": share("int8_gemm_kernel"),
        "layer_norm_share": share("layer_norm"),
        "elementwise_share": share("elementwise", "copy"),
        "matcher_host_ms_per_step": matcher_ms,
        "matcher_host_share": matcher_ms / unprofiled_ms,
    }))
    for ms_step, count, name in rows[:top]:
        log(f"profile: {what}: {ms_step:8.4f} ms/step {count:4d} calls  "
            f"{name[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also break the serving forward's and the train "
                         "step's device time down by kernel with "
                         "torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import dinov2_od_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}",
              file=sys.stderr)
        return 1
    log(card_line())  # as nvidia-smi prints it: name, power limit
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_build()
    kernels = {}
    for entry in (phase_kernels(args.seed), phase_bwd_kernel(args.seed),
                  phase_int8_kernel(args.seed)):
        kernels[entry["name"]] = entry
    serving_ips = phase_slice(args.seed, kernels, profile=args.profile)
    phase_int8_serving(args.seed, kernels, serving_ips, profile=args.profile)
    train_ips = phase_train(args.seed, kernels, profile=args.profile)
    phase_prefix_int8_train(args.seed, kernels, train_ips,
                            profile=args.profile)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
