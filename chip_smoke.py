#!/usr/bin/env python3
"""Drive the PyTorch port (dinov2_od_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Run from the root of the repository, on a machine with an H100, the CUDA
toolkit and PyTorch built for CUDA. Phases, in order; any failure exits
non-zero and prints no result:

1. card    - the card's name and power limit, from nvidia-smi;
2. build   - every CUDA kernel of the port, compiled with nvcc for sm_90a
             from the sources in the checkout, one nvcc per source at once;
             ptxas's registers and spills of each kernel of the eight TMA +
             wgmma sources (B6, B5b, B5f, B4b, B2, B4f, B1, T1), which
             must not spill nor have a wgmma serialised by ptxas;
3. kernels - each kernel against its plain PyTorch version at the shapes
             of the main paths, within stated tolerances, and timed
             (device time from torch.profiler; CUDA events as event_ms)
             beside its bound, the plain version and a library call: the
             flash-attention forward (B1) at FWD_CASES (B=32, S=257,
             H=12, dh=64 with all keys and kv_len=200, ViT-L/518's 1370
             tokens, and the lengths about its tile edges at 4 images),
             bf16 and fp32, each with a control (a key tile dropped) that
             must fail, o and lse bit-equal from run to run, timed on the
             fused qkv views beside SDPA; the backward (B2) at
             BWD_CASES (that shape, both kv_len, and ViT-L/518's 1370
             tokens, 16 heads), bf16 and fp32, with a control (a key tile
             dropped) that must fail, dq, dk, dv bit-equal from run to
             run, timed on the step's strided qkv views beside SDPA's
             backward on the same views;
             the fused quantize + int8 GEMM (B6) at the fc2 shapes of
             INT8_CASES, with a control (a K tile dropped) that must fail,
             its row-quantization and GEMM launches timed apart beside
             `_int_mm` on the same codes;
             the long-sequence forward (B5f) and backward (B5b) at
             BHSD_CASES (ViT-L/560: B=8, S=1601, H=16, all keys and
             kv_len=1500; Sq=50 over Sk=1601; 3 heads at 257 tokens), bf16
             and fp32, each with a control (a key tile dropped) that must
             fail, timed at ViT-L/560 beside B1 and B2 at the same shape,
             SDPA, and `_scaled_dot_product_flash_attention` as the lse
             variant's (B3's) yardstick; the all-heads forward (B4f) and
             backward (B4b) at ALLHEADS_CASES (ViT-B's 3 heads a rank
             under 4-way tensor parallelism, B=32, S=257, all keys and
             kv_len=200; Sq=50 over Sk=1601; S 1024 and S 640, the
             routing edges), bf16 and fp32, each with a control that must
             fail, B4b's three gradients bit-equal from run to run, timed
             at the TP shape beside B5f/B5b and SDPA; the attention
             roofline tool's ablation kernel (T1), every stage, at
             ROOFLINE_CASES (the tool's default [8, 16, 1376, 64] and
             ViT-L/560's [2, 16, 1616, 64]) with a control (the last key
             tile dropped) that must fail and a length past its limit that
             must raise, timed beside its bound, the plain version and,
             for mxu_only, two cuBLAS products;
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
             beside the bf16 step's;
8. large   - the long-sequence serving path: a full-width ViT-L/14 at
             560 px (1601 tokens) + deformable DETR Predictor (batch 8)
             behind a DynamicBatcher answers concurrent requests; 24 B5f
             and no B1 launches per device batch; detector_apply with the
             kernels against plain attention (fp32 and bf16), beside
             controls (keys dropped) that must fail; images/s of the
             batch-8 forward plus top-k;
9. large train - 10 full-width train steps of that model at batch 8 (bf16
             backbone, LoRA r=2 on the last 2 blocks): the train phase's
             checks, 24 B5f + 2 B5b and no B1/B2 launches per step, the
             gradient check against plain attention and B5b's plain
             version with controls (B5b dropping keys); images/s.
10. tp      - the train step under Megatron tensor parallelism on a
             ('data', 'model') mesh of 1 x 4: four ranks, processes on the
             one card in a gloo process group (host-staged collectives),
             each holding its shard of the full-width ViT-B/14 detector
             drawn in the parent; the TP eval forward (fp32 and bf16)
             against one process's with controls (keys dropped); one TP
             step's loss and gathered gradients against one process's,
             with controls that must fail (B4b dropping keys; the LoRA
             factors' partial gradients not summed over the model group);
             10 TP steps with the train phase's checks and exactly 12 B4f
             and 2 B4b launches per rank per step, no other flash kernel.
             Each rank's step time is printed, labelled as four ranks
             sharing one card: it is not a tensor-parallel speed.
11. roofline tool - the port's tools/bench_attn_roofline.py at its
             defaults, in-process: its four JSON lines (mxu_only, plus_max,
             plus_exp2, production) in order with the JAX tool's keys, T1
             launched exactly by the stages' calls and production through
             B5f and nothing else;
12. bench   - dinov2_od_tpu_torch.bench in-process, the ViT-B/224 b32 train
             step (its default) and BENCH_MODE=eval: bench.py's four keys,
             a positive images/s, the card's name in the metric, B1 and B2
             launched (B1 alone in eval) and nothing else;
13. trace   - tools/trace_step.py over 3 steps of the ViT-B train step, of
             the ViT-B batch-32 forward and of the ViT-L/560 batch-8
             forward: the groups sum to the total device time, the flash
             group holds B1 and B2 (B1 alone in the ViT-B forward, B5f at
             560 px), and the largest elementwise and copy kernels by name.

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
import re
import subprocess
import sys
import threading
import time

import numpy as np

from dinov2_od_tpu_torch.utils.benchmark import device_ms, time_ms

# H100 SXM: HBM rate and dense peak rates (NVIDIA data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

# The backbone's attention on both paths: ViT-B/14 at 224 px, batch 32.
B, S, H, DH = 32, 257, 12, 64
KV_MASKED = 200  # kv_len of the masked cases
# B5f against its plain version, max abs error. bf16: both round p to bf16
# (2^-9 relative), the kernel against its running max (online softmax),
# the plain version against the row max, so p may round apart: l then
# differs by at most 2^-9 relative, lse2 = m + log2 l by 2^-9 / ln 2 =
# 2.8e-3, and o by about one bf16 ulp (2^-7 for |o| in [1, 2)). fp32: fp32
# CUDA cores against fp32 matmuls (TF32 off) in another summation order.
# B1 takes p against the exact row max (B4f's body) and is held to the
# tighter ALLHEADS_TOL, which lies within this one.
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
# B1's cases (batch, S, heads, kv_len): the serving shape with all keys and
# with the keys from 200 on masked; ViT-L/14 at 518 px (1370 tokens, 16
# heads), the longest self-attention the flat rule sends to B1; and, at 4
# images, each length on either side of the design's tile edges (128 | 129,
# the first to take the fitted 8-key tail; 256 | 257, ViT-B's; 264, the
# last tail, | 265, a ragged 128-key tile; and tails behind five or more
# full tiles, where the 5-stage ring must move past the tail's slot: 641,
# 1025, ViT-B/14 at 448 px, and 1157, at 476 px), each with all keys, all
# but one and one. Each case with a control (the last 64-key tile dropped,
# where one is left) that must fail, and o and the lse bit-equal from run
# to run.
FWD_CASES = ((B, S, H, S), (B, S, H, KV_MASKED), (8, 1370, 16, 1370)) + tuple(
    (4, s, H, kv) for s in (128, 129, 256, 257, 264, 265, 641, 1025, 1157)
    for kv in (s, s - 1, 1))
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
# B2's cases (batch, S, heads, kv_len): the train shape with all keys and
# with the keys from 200 on masked, and ViT-L/14 at 518 px (1370 tokens, 16
# heads), the longest configuration the flat rule (`_flat_eligible`, S <=
# 1536) sends to B2.
BWD_CASES = ((B, S, H, S), (B, S, H, KV_MASKED), (8, 1370, 16, 1370))
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

# The long-sequence configuration: ViT-L/14 at 560 px (1601 tokens) +
# deformable DETR, detector_config_for_model_name("facebook/dinov2-large",
# hidden_dim=768, image_size=560) as bench.py:60-62 builds it with
# BENCH_MODEL=large BENCH_IMAGE_SIZE=560, at the JAX package's ViT-L batch
# of 8 (BENCH.md). At 1601 tokens the family choice (`_flat_eligible`)
# refuses the flat kernels, so its attention runs B5f and B5b.
LARGE_MODEL, LARGE_IMAGE, LARGE_BATCH = "facebook/dinov2-large", 560, 8
LS, LH = 1601, 16  # its attention: 1601 tokens, 16 heads of 64
# BHSD kernel cases (batch, Sq, Sk, heads, kv_len): ViT-L/560 with all keys
# and with the keys from 1500 on masked; a cross shape (50 queries, the
# decoder's count, over 1601 keys); ViT-B's 3 head-local heads under
# 4-way tensor parallelism at 257 tokens, batch 32 (the routing sends that
# shape to B4f/B4b, and the cross shape too; B5f and B5b, called directly,
# take any shape and are held to their plain versions there as well, as
# the blocked kernels JAX runs with an explicit block_q). Tolerances: TOL
# and BWD_TOL, for the reasons
# given there (B5f's online softmax rounds p apart from the plain version's
# exact row max); B5b's dq is
# summed over key tiles by fp32 reduce-adds in a varying order, a few fp32
# ulps that stay far inside BWD_TOL's bf16 ulps.
BHSD_CASES = ((LARGE_BATCH, LS, LS, LH, LS), (LARGE_BATCH, LS, LS, LH, 1500),
              (LARGE_BATCH, 50, LS, LH, LS), (B, S, S, 3, S))
LARGE_REQUEST_SIZES = (3, 5, 2, 6)
# All-heads kernel cases (batch, Sq, Sk, heads, kv_len): ViT-B/14's 3 heads
# a rank under 4-way tensor parallelism at 257 tokens, batch 32, with all
# keys and with the keys from 200 on masked (the TP phase's shape); the
# cross shape (the decoder's 50 queries over ViT-L/560's 1601 keys), which
# the JAX rule sends to B4 both ways; and a length at each routing edge:
# S 1024, the longest self-attention the forward rule sends to B4f (its
# backward goes to B5b), and S 640, the longest the backward rule sends to
# B4b; and S 641, a fitted 8-key tail behind five full key tiles (the
# forward's 5-stage ring must move past the tail's slot). Both kernels are
# held to their plain versions at every case.
ALLHEADS_CASES = ((B, S, S, 3, S), (B, S, S, 3, KV_MASKED),
                  (LARGE_BATCH, 50, LS, LH, LS), (4, 1024, 1024, 4, 1024),
                  (4, 640, 640, 4, 600), (4, 641, 641, 4, 641))
# B4f against its plain version, max abs error. bf16: both take p against
# the exact row max and round it to bf16 at the same point, so p rounds
# apart only where the two fp32 sums of s fall on either side of a bf16
# rounding step: l then moves by a fraction of 2^-9 of one p, the lse by
# less than 1e-3, and o by at most one bf16 ulp where it rounds apart
# (2^-7 for |o| in [1, 2): the limit of B5f's TOL). B5f's lse limit is 3x
# looser, since its running max rounds p apart from the plain version's.
# fp32: fp32 CUDA cores against fp32 matmuls (TF32 off).
ALLHEADS_TOL = {
    "bfloat16": {"o": 1e-2, "lse": 1e-3},
    "float32": {"o": 1e-5, "lse": 1e-5},
}
# detector_apply of the large model with the kernels against plain
# attention, max abs error per output, each limit set like MODEL_TOL
# between the sound kernels' reading and the controls'. Controls: the
# backbone's attention with the keys from 1600 on (the ragged last key
# tile: one key) or from 1536 on (the last full tile too) dropped. Seed 0
# on an H100 (PERF.md), sound | 1600 | 1536: fp32 logits 2.9e-5 |
# 0.038 | 0.30, boxes 2.7e-6 | 3.3e-3 | 0.036; bf16 logits 0.149 | 0.183 |
# 0.332, boxes 9.8e-3 | 0.0127 | 0.036. In bf16 every one of the 24 blocks
# rounds its activations, and that noise (0.149) swamps a one-key fault
# (0.183) as it swamps any reference that does not round bit for bit as
# the kernel does; so bf16 holds the 1536 control only, and the one-key
# fault is caught by the kernel phase (BHSD_CASES' controls) and by fp32.
LARGE_MODEL_TOL = {
    "float32": {"pred_logits": 1e-3, "pred_boxes": 1e-4},
    "bfloat16": {"pred_logits": 0.25, "pred_boxes": 0.025},
}
LARGE_CONTROLS = {"float32": (LS - 1, 1536), "bfloat16": (1536,)}
LARGE_TRAIN_STEPS = 10
# One large train step's loss and gradients against plain attention and
# against B5b's plain version, per leaf group as GRAD_TOL, each limit set
# between the sound kernels' reading and the controls' (B5b handed a
# smaller kv_len than its forward: 1600 | 1536). Seed 0 on an H100
# (PERF.md), relative error of the adapted LoRA gradients, sound |
# 1600 | 1536: fp32 vs plain attention 5.3e-7 | 3.7e-4 | 0.024, vs plain
# backward 4.2e-8 | 3.7e-4 | 0.024; bf16 vs plain attention 4.9e-3 |
# 4.8e-3 | 0.024 (the forward's bf16 roundings through 24 blocks swamp a
# one-key fault there, and move the decoder's gradients by 1.5e-2), vs
# plain backward 2.9e-4 | 1.2e-3 | 0.024 (B5b's dq reduce-adds add their
# run-to-run order on top of the bf16 roundings both share).
LARGE_GRAD_TOL = {
    "float32": {
        "plain attention": {"loss": 1e-5, "lora": 1e-4, "decoder": 1e-4,
                            "projection": 1e-4},
        "plain backward": {"loss": 1e-5, "lora": 1e-4, "decoder": 1e-4,
                           "projection": 1e-4},
    },
    "bfloat16": {
        "plain attention": {"loss": 1e-3, "lora": 0.015, "decoder": 0.03,
                            "projection": 0.015},
        "plain backward": {"loss": 1e-5, "lora": 6e-4, "decoder": 1e-5,
                           "projection": 1e-5},
    },
}
LARGE_GRAD_CONTROLS = (LS - 1, 1536)

# The tensor-parallel configuration: the train phase's ViT-B/14 +
# deformable DETR (full width and depth, bf16 backbone, LoRA r=2 on the
# last 2 blocks, fp32 decoder with dropout 0.1, batch 32 with 25 GT slots,
# OptimConfig()) on a ('data', 'model') mesh of 1 x 4, as the JAX train CLI
# builds it with --model_parallel 4: 12 / 4 = 3 heads a rank at 257 tokens,
# which the flat kernels cannot pair, so every block's attention runs B4f
# (12 a step) and the adapted blocks' backward B4b (2 a step). The card is
# one: the four ranks are four processes on cuda:0 in a gloo process group
# whose collectives are staged through the host. That checks the layout,
# the collectives' placement, the kernels at their head-local shapes and
# the numbers against one process on the same card; it measures no
# tensor-parallel speed.
TP = 4
TP_STEPS = 10
# The TP forward (eval mode, the ranks' outputs) against one process's
# (B1), max abs error per output, each limit between the sound reading and
# the controls' (every rank's B4f with the keys from S - 1 or 192 on
# dropped). fp32: both sides fp32, kernels and partial sums in other
# orders; bf16: the row-parallel GEMMs round their bf16 partial products
# before the sum, so bf16 holds the 192 control only (as the large phase
# does). The limits were set while B1 took p against a running max, which
# rounded p apart from B4f's exact one; B1 takes the exact max too now.
TP_MODEL_TOL = {
    "float32": {"pred_logits": 1e-3, "pred_boxes": 1e-4},
    "bfloat16": {"pred_logits": 0.15, "pred_boxes": 0.015},
}
TP_CONTROLS = {"float32": (S - 1, 192), "bfloat16": (192,)}
# One TP step's loss and gathered trainable gradients (decoder dropout 0,
# the single process's assignment) against one process's step, relative
# error per leaf group as GRAD_TOL, each limit between the sound reading
# and the controls': B4b handed a smaller kv_len than its forward (keys
# from S - 1 or 192 on dropped; bf16 192 only, as above), and the step
# without the model group's sum of the replicated LoRA factors' partial
# gradients (lora_A of q/k/v/fc1, lora_B of proj/fc2).
TP_GRAD_TOL = {
    "float32": {"loss": 1e-5, "lora": 1e-4, "decoder": 1e-4,
                "projection": 1e-4},
    "bfloat16": {"loss": 1e-3, "lora": 0.01, "decoder": 0.03,
                 "projection": 0.015},
}
TP_GRAD_CONTROLS = {"float32": (S - 1, 192), "bfloat16": (192,)}

# T1, the attention roofline tool's ablation kernel, bf16 [B, H, S_pad, 64]:
# the tool's default shape (1370 tokens, ViT-L/518, padded to 1376) and
# ViT-L/560's (1601 padded to 1616), every stage.
ROOFLINE_CASES = ((8, 16, 1376), (2, 16, 1616))
# T1 against its plain version: the relative Frobenius error of o and its
# max abs error over the largest |o|. Both take s in fp32 (the kernel as
# q_hi + q_lo products on the tensor cores, 2^-17 of q' short per term,
# the plain version as an fp32 GEMM) and round p and o to bf16 at the same
# points, so only an fp32 sum in another order flips a bf16(p) or a bf16(o)
# by one ulp: a few 1e-4 relative, and one bf16 ulp of the largest |o|
# (2^-7 of it) plus the p flips' share. The control drops the last key
# tile (32 of 1376 keys, 16 of 1616), which moves o by about 0.1 relative.
T1_TOL = {"rel": 1e-3, "max_over_peak": 2.0 ** -6}
# trace_step's runs: 3 ViT-B train steps (bench.py's default), the ViT-B
# batch-32 forward, then the ViT-L/560 batch-8 forward, whose elementwise
# kernels are logged by name; each with the flash kernels it must hold.
TRACE_RUNS = (("ViT-B/224 b32 train", {},
               ("flash_attn_fwd", "flash_attn_bwd")),
              ("ViT-B/224 b32 eval", {"BENCH_MODE": "eval"},
               ("flash_attn_fwd",)),
              ("ViT-L/560 b8 eval", {"BENCH_MODE": "eval",
                                     "BENCH_MODEL": "large",
                                     "BENCH_IMAGE_SIZE": "560",
                                     "BENCH_BATCH": "8"},
               ("flash_attn_bhsd_fwd",)))


# The sources designed for Hopper with TMA and wgmma, all eight (B6, B5b,
# B5f, B4b, B2, B4f, B1, T1): ptxas must report no spills for any of their
# kernels, fp32 CUDA-core kernels included, and must serialise no wgmma.
HOPPER_SOURCES = ("int8_gemm", "flash_attn_bhsd_bwd", "flash_attn_bhsd_fwd",
                  "flash_attn_allheads_bwd", "flash_attn_bwd",
                  "flash_attn_allheads_fwd", "flash_attn_fwd",
                  "attn_roofline")
# ptxas's note that it serialised a kernel's wgmma instructions (C7510).
WGMMA_SERIALIZED = "wgmma.mma_async instructions are serialized"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _bound(dtype: str, n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(dtype: str, kv_len: int, b: int = B, sq: int = S,
                    h: int = H):
    """(bound_ms, bound_by) of one forward (the serving shape unless
    given): q, o once, the first kv_len rows of k, v once, the fp32 lse
    once; two products of 2 * Sq * kv_len * dh operations per (batch,
    head)."""
    item = 2 if dtype == "bfloat16" else 4
    n_bytes = (2 * sq + 2 * kv_len) * b * h * DH * item + b * h * sq * 4
    return _bound(dtype, n_bytes, 4.0 * b * h * sq * kv_len * DH)


def attention_bwd_bound(dtype: str, kv_len: int, b: int = B, sq: int = S,
                        sk: int = S, h: int = H):
    """(bound_ms, bound_by) of one backward (the train shape unless
    given): q and dO read once, the first kv_len rows of k and v read
    once, the fp32 lse and delta read once, dq, dk and dv written once
    (the function's bytes: a kernel's own scratch, such as B5b's fp32 dq,
    is not counted); five products (s, dp, dv, dk, dq) of 2 * Sq * kv_len
    * dh operations per (batch, head)."""
    item = 2 if dtype == "bfloat16" else 4
    n_bytes = ((3 * sq + 2 * kv_len + 2 * sk) * b * h * DH * item
               + 2 * b * h * sq * 4)
    return _bound(dtype, n_bytes, 10.0 * b * h * sq * kv_len * DH)


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
    # The Hopper designs (TMA + wgmma): every kernel of their sources
    # without spills, and no wgmma serialised.
    from dinov2_od_tpu_torch.ops import _build as build

    for name in HOPPER_SOURCES:
        report = ptxas_report(name)
        log(f"build: {name}: ptxas " + json.dumps(report))
        spilled = {k: v for k, v in report.items()
                   if v["spill_stores"] or v["spill_loads"]}
        if spilled:
            raise AssertionError(f"{name}: ptxas spills in {spilled}")
        serial = [line.strip() for line in build.ptxas_log(name).splitlines()
                  if WGMMA_SERIALIZED in line]
        if serial:
            raise AssertionError(f"{name}: ptxas serialised wgmma: {serial}")


def ptxas_report(source: str) -> dict:
    """{kernel: registers, stack and spill bytes} of one source as ptxas
    reports them (`-Xptxas -v`, this run's build or a compile of the
    source), each kernel named by its __global__ function and, for a
    template, its element type."""
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.tools.trace_step import port_kernels

    names = [fn for fn, src in port_kernels().items() if src == source]
    out = {}
    for mangled, info in _build.ptxas_summary(
            _build.ptxas_log(source)).items():
        fn = next((f for f in names if f in mangled), mangled)
        kind = ("<bf16>" if "nv_bfloat16" in mangled
                else "<float>" if f"{fn}IfE" in mangled
                else _template_values(mangled, fn))
        out[fn + kind] = info
    if not out:
        raise AssertionError(f"ptxas reported no kernel of {source}")
    return out


def _template_values(mangled: str, fn: str) -> str:
    """The integer and bool template arguments of a mangled kernel name
    (`fnILi2ELi4EE...` -> "<2, 4>", `fnILb1EE...` -> "<true>"), else ""."""
    m = re.search(rf"{fn}I((?:L[a-z]n?\d+E)+)E", mangled)
    if not m:
        return ""
    vals = []
    for kind, val in re.findall(r"L([a-z])(n?\d+)E", m.group(1)):
        val = val.replace("n", "-")
        vals.append(("false", "true")[int(val)] if kind == "b" else val)
    return "<" + ", ".join(vals) + ">"


def phase_kernels(seed: int):
    """B1 against its plain version at FWD_CASES, bf16 and fp32, each with a
    control (the last key tile dropped) that must fail the same check and
    o and the lse bit-equal from run to run; timed at the serving shape on
    the fused qkv views beside SDPA. Returns the kernel's entry of the
    kernels line (launches filled in later)."""
    import torch

    from dinov2_od_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(seed)
    scale = DH ** -0.5
    entry = None
    failures = []
    for b, s, h, kv_len in FWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            # q, k, v as the three strided views of one fused qkv GEMM
            # output, as the backbone hands them to the kernel.
            q, k, v, _ = _bhsd_inputs(gen, b, s, s, h, dtype)
            o, lse = fa.flash_attention_fwd(q, k, v, scale=scale,
                                            kv_len=kv_len)
            o2, lse2 = fa.flash_attention_fwd(q, k, v, scale=scale,
                                              kv_len=kv_len)
            o_ref, lse_ref = fa.flash_attention_fwd_plain(
                q, k, v, scale=scale, kv_len=kv_len)
            ctl_len = _last_tile_dropped(kv_len)
            if ctl_len:
                o_c, lse_c = fa.flash_attention_fwd(q, k, v, scale=scale,
                                                    kv_len=ctl_len)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
            equal = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
            row = {
                "dtype": name, "kv_len": kv_len, "shape": [b, s, h, DH],
                "tail8": 128 < kv_len and 1 <= kv_len % 128 <= 8,
                "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                "o_lse_run_to_run_equal": equal,
            }
            tol = ALLHEADS_TOL[name]
            if not finite or err_o > tol["o"] or err_lse > tol["lse"]:
                failures.append(
                    f"{name} {row['shape']} kv_len={kv_len}: o err "
                    f"{err_o:.3g} (tol {tol['o']}), lse err {err_lse:.3g} "
                    f"(tol {tol['lse']}), finite={finite}")
            if not equal:
                failures.append(f"{name} {row['shape']} kv_len={kv_len}: "
                                f"o or lse differ from run to run")
            if ctl_len:
                ctl_o = (o_c.float() - o_ref.float()).abs().max().item()
                ctl_lse = (lse_c - lse_ref).abs().max().item()
                row.update(control_kv_len=ctl_len, control_err_o=ctl_o,
                           control_err_lse=ctl_lse)
                if ctl_o <= tol["o"] and ctl_lse <= tol["lse"]:
                    failures.append(f"{name} {row['shape']}: the control "
                                    f"(kv_len {ctl_len}) passes the check")
                del o_c, lse_c
            if (b, s, h) == (B, S, H) and kv_len in (S, KV_MASKED):
                row.update(_time_fwd(q, k, v, kv_len, name,
                                     spread=name == "bfloat16"
                                     and kv_len == S))
            log("kernels: flash_attn_fwd " + json.dumps(row))
            if name == "bfloat16" and (b, s, h, kv_len) == FWD_CASES[0]:
                entry = {
                    "name": "flash_attn_fwd",
                    "route": "cuda",
                    "source": "dinov2_od_tpu_torch/csrc/flash_attn_fwd.cu",
                    "replaces": "dinov2_od_tpu/ops/flash_attention.py:357",
                    "replaces_function": "_fwd_kernel_flat",
                    "launches": 0,
                    "launches_per_forward": 0,
                    "max_abs_err": err_o,
                    **{key: row[key] for key in (
                        "ms", "ms_min", "ms_max", "event_ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms")},
                    "kernel_ms": row["ms"],
                    "ptxas": ptxas_report("flash_attn_fwd"),
                }
            del q, k, v, o, lse, o2, lse2, o_ref, lse_ref
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return entry


def _time_fwd(q, k, v, kv_len, name, spread):
    """B1's device and event times on the fused qkv views beside its
    bound, its plain version and SDPA on the first kv_len keys of the same
    views. `spread`: B1 and SDPA over three profiler windows each, with
    their least and largest readings."""
    import torch.nn.functional as F

    from dinov2_od_tpu_torch.ops import flash_attention as fa

    scale = DH ** -0.5

    def kernel():
        fa.flash_attention_fwd(q, k, v, scale=scale, kv_len=kv_len)

    qt, kt, vt = (t.transpose(1, 2) for t in
                  (q, k[:, :kv_len], v[:, :kv_len]))
    repeats = 3 if spread else 1
    ms = _spread_ms(kernel, 100, repeats)
    lib = _spread_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, scale=scale), 100, repeats)
    bound_ms, bound_by = attention_bound(name, kv_len)
    return {
        "ms": ms[0], "ms_min": ms[1], "ms_max": ms[2],
        "event_ms": time_ms(kernel, iters=50),
        "plain_ms": device_ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, scale=scale, kv_len=kv_len), iters=10),
        "library_ms": lib[0], "library_ms_min": lib[1],
        "library_ms_max": lib[2],
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def _spread_ms(fn, iters: int, repeats: int = 3):
    """(median, min, max) device ms of `fn` over `repeats` profiler windows
    of `iters` calls each: the run-to-run spread of one reading."""
    runs = sorted(device_ms(fn, iters=iters) for _ in range(repeats))
    return runs[len(runs) // 2], runs[0], runs[-1]


def phase_bwd_kernel(seed: int):
    """B2 against its plain version at BWD_CASES, bf16 and fp32, with a
    control (the last key tile dropped) that must fail the same check and
    dq, dk, dv bit-equal from run to run; timed at the train shape on the
    step's strided qkv views beside SDPA's backward on the same views.
    Returns the kernel's entry of the kernels line (launches filled in
    later)."""
    import torch

    from dinov2_od_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 1)
    scale = DH ** -0.5
    entry = None
    failures = []
    for b, s, h, kv_len in BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            # q, k, v as the three strided views of one fused qkv GEMM
            # output, as the forward saved them.
            q, k, v, do = _bhsd_inputs(gen, b, s, s, h, dtype)
            o, lse = fa.flash_attention_fwd(q, k, v, scale=scale,
                                            kv_len=kv_len)
            delta = fa._delta(do, o, None)
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                         kv_len=kv_len)
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                           kv_len=kv_len)
            ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                               scale=scale, kv_len=kv_len)
            # Control: the kernel handed a smaller kv_len than the check.
            ctl_len = _last_tile_dropped(kv_len)
            got_c = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                           kv_len=ctl_len)
            torch.cuda.synchronize()
            err, abs_err = _grad_errs(got, ref)
            ctl_err, _ = _grad_errs(got_c, ref)
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            masked_zero = bool(not got[1][:, kv_len:].any()
                               and not got[2][:, kv_len:].any())
            deterministic = all(torch.equal(x, y) for x, y in zip(got, again))
            row = {
                "dtype": name, "kv_len": kv_len, "shape": [b, s, h, DH],
                "max_abs_err": abs_err, "max_rel_err": err,
                "masked_dk_dv_exactly_zero": masked_zero,
                "dq_dk_dv_run_to_run_equal": deterministic,
                "control_kv_len": ctl_len, "control_rel_err": ctl_err,
            }
            tol = BWD_TOL[name]
            bad = [g for g, e in err.items() if e > tol]
            if not finite or bad or not masked_zero or not deterministic:
                failures.append(
                    f"{name} {row['shape']} kv_len={kv_len}: errors {err} "
                    f"(tol {tol}), finite={finite}, masked dk/dv "
                    f"zero={masked_zero}, deterministic {deterministic}")
            if max(ctl_err.values()) <= tol:
                failures.append(f"{name} {row['shape']}: the control "
                                f"(kv_len {ctl_len}) passes the check")
            if (b, s, h) == (B, S, H):
                row.update(_time_bwd(q, k, v, do, o, lse, delta, kv_len,
                                     name, spread=name == "bfloat16"
                                     and kv_len == S))
            log("kernels: flash_attn_bwd " + json.dumps(row))
            if name == "bfloat16" and (b, s, h, kv_len) == BWD_CASES[0]:
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
                    **{key: row[key] for key in (
                        "ms", "ms_min", "ms_max", "event_ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms",
                        "library_clone_ms")},
                    "ptxas": ptxas_report("flash_attn_bwd"),
                }
            del q, k, v, do, o, lse, got, again, ref, got_c
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError("backward kernel disagrees with its plain "
                             "version: " + "; ".join(failures))
    return entry


def _time_bwd(q, k, v, do, o, lse, delta, kv_len, name, spread):
    """B2's device and event times on the step's strided qkv views beside
    its bound, its plain version and SDPA's backward (forward + backward
    less forward) on the same views, and on contiguous copies as earlier
    runs took it. `spread`: B2 and SDPA over three profiler windows each,
    with their least and largest readings."""
    import torch
    import torch.nn.functional as F

    from dinov2_od_tpu_torch.ops import flash_attention as fa

    scale = DH ** -0.5
    b, s, h, _ = q.shape

    def kernel():
        fa._launch_bwd(q, k, v, do, lse, delta, scale, kv_len)

    def sdpa_bwd_ms(copies: bool, repeats: int):
        # SDPA on the first kv_len keys, [B, H, S, 64] views of the same
        # storage (last dim contiguous), or contiguous copies of them.
        views = [t.detach().transpose(1, 2) for t in
                 (q, k[:, :kv_len], v[:, :kv_len])]
        qt, kt, vt = ((t.clone() if copies else t).requires_grad_(True)
                      for t in views)
        dot = do.transpose(1, 2)

        def fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
            torch.autograd.grad(out, (qt, kt, vt), dot)

        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

        both = _spread_ms(fwd_bwd, 100, repeats)
        alone = _spread_ms(fwd, 100, repeats)
        return [x - y for x, y in zip(both, alone)]

    repeats = 3 if spread else 1
    ms = _spread_ms(kernel, 200, repeats)
    lib = sdpa_bwd_ms(False, repeats)
    bound_ms, bound_by = attention_bwd_bound(name, kv_len, b, s, s, h)
    return {
        "ms": ms[0], "ms_min": ms[1], "ms_max": ms[2],
        "event_ms": time_ms(kernel, iters=200),
        "plain_ms": device_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, do, lse, delta, scale=scale, kv_len=kv_len), iters=5),
        "library_ms": lib[0], "library_ms_min": lib[1],
        "library_ms_max": lib[2],
        "library_clone_ms": sdpa_bwd_ms(True, 1)[0],
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def _requests(seed: int, image_size: int, sizes=REQUEST_SIZES):
    rng = np.random.default_rng(seed)
    return [[rng.uniform(size=(image_size, image_size, 3)).astype(np.float32)
             for _ in range(n)] for n in sizes]


def _counts(**launches) -> dict:
    """Launch counts of every kernel: the given ones, 0 for the rest."""
    from dinov2_od_tpu_torch.ops import _build

    return {name: launches.get(name, 0) for name in _build.SOURCES}


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
    log(f"{phase}: {len(requests)} requests of {[len(r) for r in requests]} "
        f"images "
        f"in {wall:.3f} s, {batcher.batches} batcher calls, "
        f"{device_batches} device batches, launches {counts}")
    return counts, device_batches, results


def _check_alone(predictor, requests, results, phase: str):
    """Every request got its own detections: each one answered alone must
    give what the coalesced batch gave it (scores to 1e-3, boxes to a
    quarter pixel of a 224 px image, scaled with the image)."""
    px_tol = 0.25 * predictor.cfg.backbone.image_size / 224
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
            if (np.abs(g[:, 0] - w[:, 0]).max() > 1e-3
                    or np.abs(g[:, 1:] - w[:, 1:]).max() > px_tol):
                raise AssertionError(f"request {i}: detections differ from "
                                     f"the same images run alone")
    log(f"{phase}: every request got its own detections back, all finite")


def _serving_model(seed: int, model_name: str = "facebook/dinov2-base",
                   image_size: int = 224):
    """A serving configuration (ViT-B/14 at 224 px + deformable DETR unless
    given, full width and depth) and its random params from `seed`, on
    the card: (fp32 cfg, bf16-backbone cfg, params)."""
    import torch

    from dinov2_od_tpu_torch.config import detector_config_for_model_name
    from dinov2_od_tpu_torch.models.detector import init_detector_params

    cfg = detector_config_for_model_name(model_name, image_size=image_size)
    cfg16 = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="bfloat16"))
    params = init_detector_params(torch.Generator().manual_seed(seed), cfg,
                                  device="cuda")
    return cfg, cfg16, params


def _forward_ms(predictor, image_size: int, batch: int = 32):
    """(ms per batch, the timed call) of the forward plus top-k."""
    import torch

    xb = torch.zeros((batch, image_size, image_size, 3), device="cuda")
    sizes = torch.full((batch, 2), image_size, device="cuda",
                       dtype=torch.int32)

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
        # The wrapper's two launches timed apart, on the same call: the
        # row quantization and the s8 GEMM.
        quantize_ms = device_ms(kernel, iters=50, only="int8_quantize_rows")
        gemm_ms = device_ms(kernel, iters=50, only="int8_gemm_kernel")
        plain_ms = device_ms(lambda: ig.fused_int8_linear_plain(x, qp),
                             iters=10)
        # Library yardsticks: the GEMM alone (torch._int_mm, cuBLASLt) on
        # the same codes as B6's GEMM, with W K-major as stored (cuBLASLt's
        # native int8 layout) and N-contiguous (a [K, N] copy); the
        # unfused path as a whole (quantization, _int_mm, epilogue); a bf16
        # matmul of the same shape for context.
        xq, xs = ig.quantize_acts(x)
        kq = qp["kernel_q"]
        kq_ncontig = kq.contiguous()
        int_mm_kmajor_ms = device_ms(lambda: torch._int_mm(xq, kq), iters=20)
        int_mm_ms = device_ms(lambda: torch._int_mm(xq, kq_ncontig),
                              iters=20)

        def unfused():  # the port's path below K = 2048, K-major W
            q, s = ig.quantize_acts(x)
            ig.dequant_epilogue(torch._int_mm(q, kq), s, qp["w_scale"],
                                qp["bias"], x.dtype)

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
            "ms": ms, "event_ms": event_ms, "quantize_ms": quantize_ms,
            "gemm_ms": gemm_ms, "plain_ms": plain_ms,
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
                "quantize_ms": quantize_ms, "gemm_ms": gemm_ms,
                "int_mm_kmajor_ms": int_mm_kmajor_ms,
                "unfused_ms": unfused_ms, "bf16_matmul_ms": bf16_ms,
                "ptxas": ptxas_report("int8_gemm"),
            }
        del x, xc, xq, xb, wb, out, ref, control, qp, kq_ncontig
    if failures:
        raise AssertionError("int8 GEMM kernel disagrees with its plain "
                             "version: " + "; ".join(failures))
    return entry


def _bhsd_inputs(gen, b, sq, sk, h, dtype):
    """q, k, v and dO on the card; q, k, v as the three strided views of
    one fused qkv GEMM output where Sq == Sk, as the backbone hands them
    over."""
    import torch

    if sq == sk:
        qkv = torch.randn((b, sq, 3 * h * DH), generator=gen).to("cuda",
                                                                  dtype)
        q, k, v = (t.view(b, sq, h, DH) for t in qkv.chunk(3, dim=-1))
    else:
        q = torch.randn((b, sq, h, DH), generator=gen).to("cuda", dtype)
        k, v = (torch.randn((b, sk, h, DH), generator=gen).to("cuda", dtype)
                for _ in range(2))
    do = torch.randn((b, sq, h, DH), generator=gen).to("cuda", dtype)
    return q, k, v, do


def _grad_errs(got, ref):
    """(max abs error over max(1, largest magnitude), max abs error) of
    each of dq, dk, dv."""
    rel, err = {}, {}
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        err[name] = (g.float() - r.float()).abs().max().item()
        rel[name] = err[name] / max(1.0, r.float().abs().max().item())
    return rel, err


def _last_tile_dropped(kv_len: int) -> int:
    """kv_len less its last 64-key tile (ragged or full)."""
    return ((kv_len - 1) // 64) * 64


def _time_bhsd(q, k, v, do, o, lse, kv_len, name):
    """Times of B5f and B5b at one shape beside their bounds, their plain
    versions, the library's attention and the flat kernels B1 and B2 on
    the same inputs. Returns (forward row, backward row)."""
    import torch
    import torch.nn.functional as F

    from dinov2_od_tpu_torch.ops import flash_attention as fa

    scale = DH ** -0.5
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    delta = fa._delta(do, o, None)
    args = (q, k, v, do, lse, delta, scale, kv_len)
    qt, kt, vt = (t.transpose(1, 2) for t in
                  (q, k[:, :kv_len], v[:, :kv_len]))

    def fwd():
        fa.flash_attention_bhsd_fwd(q, k, v, scale=scale, kv_len=kv_len)

    def bwd():
        fa._launch_bhsd_bwd(*args, sq)

    fbound, fby = attention_bound(name, kv_len, b, sq, h)
    frow = {
        "ms": device_ms(fwd, iters=20), "event_ms": time_ms(fwd, iters=20),
        "plain_ms": device_ms(lambda: fa.flash_attention_bhsd_fwd_plain(
            q, k, v, scale=scale, kv_len=kv_len), iters=3, warmup=1),
        # The library yardstick: SDPA on the first kv_len keys.
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale), iters=20),
        "bound_ms": fbound, "bound_by": fby,
    }
    bbound, bby = attention_bwd_bound(name, kv_len, b, sq, sk, h)
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qg, kg, vg, scale=scale)

    brow = {
        # The wrapper's whole device time (dq scratch zeroed, B5b, dq cast)
        # and B5b's own.
        "ms": device_ms(bwd, iters=10),
        "kernel_ms": device_ms(bwd, iters=10, only="bhsd_bwd"),
        "event_ms": time_ms(bwd, iters=10),
        "plain_ms": device_ms(lambda: fa.flash_attention_bhsd_bwd_plain(
            q, k, v, do, lse, delta, scale=scale, kv_len=kv_len),
            iters=2, warmup=1),
        "library_ms": (device_ms(sdpa_fwd_bwd, iters=10)
                       - device_ms(sdpa_fwd, iters=10)),
        "bound_ms": bbound, "bound_by": bby,
    }
    if sq == sk:  # the flat kernels take any self-attention length
        frow["b1_ms"] = device_ms(lambda: fa.flash_attention_fwd(
            q, k, v, scale=scale, kv_len=kv_len), iters=20)
        brow["b2_ms"] = device_ms(lambda: fa._launch_bwd(*args), iters=10)
    return frow, brow


def _lse_library_ms(gen, b, s, h):
    """B3's yardstick: one PyTorch call that returns attention and its
    logsumexp, `_scaled_dot_product_flash_attention`, bf16 [B, H, S, 64],
    with the bound of the kernel B3 rides at that shape."""
    import torch

    q, k, v = (torch.randn((b, h, s, DH), generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(3))
    ms = device_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, scale=DH ** -0.5), iters=20)
    bound_ms, bound_by = attention_bound("bfloat16", s, b, s, h)
    return {"shape": [b, s, h, DH], "library_ms": ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_bhsd_kernels(seed: int):
    """B5f and B5b against their plain versions at BHSD_CASES, each with a
    control that must fail the same check, and timed at ViT-L/560; returns
    the two kernels' entries of the kernels line (launches filled in
    later)."""
    import torch

    from dinov2_od_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 5)
    scale = DH ** -0.5
    entries = {}
    failures = []
    for b, sq, sk, h, kv_len in BHSD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, do = _bhsd_inputs(gen, b, sq, sk, h, dtype)
            o, lse = fa.flash_attention_bhsd_fwd(q, k, v, scale=scale,
                                                 kv_len=kv_len)
            o_ref, lse_ref = fa.flash_attention_bhsd_fwd_plain(
                q, k, v, scale=scale, kv_len=kv_len)
            delta = fa._delta(do, o, None)
            got = fa.flash_attention_bhsd_bwd(q, k, v, o, lse, do,
                                              scale=scale, kv_len=kv_len)
            again = fa.flash_attention_bhsd_bwd(q, k, v, o, lse, do,
                                                scale=scale, kv_len=kv_len)
            ref = fa.flash_attention_bhsd_bwd_plain(
                q, k, v, do, lse, delta, scale=scale, kv_len=kv_len)
            # Controls: each kernel handed a smaller kv_len than the check.
            ctl_len = _last_tile_dropped(kv_len)
            o_c, lse_c = fa.flash_attention_bhsd_fwd(q, k, v, scale=scale,
                                                     kv_len=ctl_len)
            got_c = fa.flash_attention_bhsd_bwd(q, k, v, o, lse, do,
                                                scale=scale, kv_len=ctl_len)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            ctl_o = (o_c.float() - o_ref.float()).abs().max().item()
            ctl_lse = (lse_c - lse_ref).abs().max().item()
            rel, err = _grad_errs(got, ref)
            ctl_rel, _ = _grad_errs(got_c, ref)
            finite = all(bool(torch.isfinite(t).all())
                         for t in (o, lse, *got))
            masked_zero = bool(not got[1][:, kv_len:].any()
                               and not got[2][:, kv_len:].any())
            tol, btol = TOL[name], BWD_TOL[name]
            row = {
                "dtype": name, "shape": [b, sq, sk, h, DH], "kv_len": kv_len,
                "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                "bwd_max_rel_err": rel, "bwd_max_abs_err": err,
                "masked_dk_dv_exactly_zero": masked_zero,
                # dq's reduce-adds: two runs of B5b on the same inputs.
                "dq_run_to_run_max_abs": (got[0].float() - again[0].float())
                .abs().max().item(),
                "dk_dv_run_to_run_equal": bool(torch.equal(got[1], again[1])
                                               and torch.equal(got[2],
                                                               again[2])),
                "control_kv_len": ctl_len, "control_err_o": ctl_o,
                "control_err_lse": ctl_lse, "control_bwd_rel_err": ctl_rel,
            }
            fwd_ok = finite and err_o <= tol["o"] and err_lse <= tol["lse"]
            bwd_ok = finite and max(rel.values()) <= btol and masked_zero
            if not fwd_ok:
                failures.append(f"B5f {name} {row['shape']} kv_len={kv_len}: "
                                f"o {err_o:.3g}, lse {err_lse:.3g}, "
                                f"finite={finite}")
            if not bwd_ok:
                failures.append(f"B5b {name} {row['shape']} kv_len={kv_len}: "
                                f"{rel} (tol {btol}), masked zero "
                                f"{masked_zero}, finite={finite}")
            if ctl_o <= tol["o"] and ctl_lse <= tol["lse"]:
                failures.append(f"B5f {name} {row['shape']}: the control "
                                f"(kv_len {ctl_len}) passes the check")
            if max(ctl_rel.values()) <= btol:
                failures.append(f"B5b {name} {row['shape']}: the control "
                                f"(kv_len {ctl_len}) passes the check")
            if (b, sq, sk, h, kv_len) == BHSD_CASES[0]:
                frow, brow = _time_bhsd(q, k, v, do, o, lse, kv_len, name)
                row["fwd_timing"], row["bwd_timing"] = frow, brow
                if name == "bfloat16":
                    common = {"route": "cuda", "launches": 0,
                              "shape": [b, sq, h, DH], "dtype": name}
                    entries["flash_attn_bhsd_fwd"] = {
                        "name": "flash_attn_bhsd_fwd", **common,
                        "source": "dinov2_od_tpu_torch/csrc/"
                                  "flash_attn_bhsd_fwd.cu",
                        "replaces": "dinov2_od_tpu/ops/flash_attention.py:99",
                        "replaces_function": "_fwd_kernel",
                        "max_abs_err": err_o, **frow,
                        "ptxas": ptxas_report("flash_attn_bhsd_fwd")}
                    entries["flash_attn_bhsd_bwd"] = {
                        "name": "flash_attn_bhsd_bwd", **common,
                        "source": "dinov2_od_tpu_torch/csrc/"
                                  "flash_attn_bhsd_bwd.cu",
                        "replaces": "dinov2_od_tpu/ops/flash_attention.py:138",
                        "replaces_function": "_dkv_kernel",
                        "max_abs_err": max(err.values()),
                        "max_rel_err": max(rel.values()), **brow,
                        "ptxas": ptxas_report("flash_attn_bhsd_bwd")}
            log("kernels: flash_attn_bhsd " + json.dumps(row))
            del q, k, v, do, o, lse, got, again, ref, o_c, got_c, o_ref
            torch.cuda.empty_cache()
    for b, s, h in ((B, S, H), (LARGE_BATCH, LS, LH)):
        log("kernels: flash_attention_lse yardstick " + json.dumps(
            _lse_library_ms(gen, b, s, h)))
    if failures:
        raise AssertionError("BHSD kernels disagree with their plain "
                             "versions: " + "; ".join(failures))
    return entries


def _time_allheads(q, k, v, do, o, lse, kv_len, name):
    """Times of B4f and B4b at one shape beside their bounds, their plain
    versions, B5f and B5b on the same inputs and SDPA. Returns (forward
    row, backward row)."""
    import torch
    import torch.nn.functional as F

    from dinov2_od_tpu_torch.ops import flash_attention as fa

    scale = DH ** -0.5
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    delta = fa._delta(do, o, None)
    args = (q, k, v, do, lse, delta, scale, kv_len)
    qt, kt, vt = (t.transpose(1, 2) for t in
                  (q, k[:, :kv_len], v[:, :kv_len]))

    def fwd():
        fa.flash_attention_allheads_fwd(q, k, v, scale=scale, kv_len=kv_len)

    def bwd():
        fa._launch_allheads_bwd(*args, sq)

    fbound, fby = attention_bound(name, kv_len, b, sq, h)
    frow = {
        "ms": device_ms(fwd, iters=50), "event_ms": time_ms(fwd, iters=50),
        "plain_ms": device_ms(lambda: fa.flash_attention_allheads_fwd_plain(
            q, k, v, scale=scale, kv_len=kv_len), iters=5, warmup=1),
        "b5f_ms": device_ms(lambda: fa.flash_attention_bhsd_fwd(
            q, k, v, scale=scale, kv_len=kv_len), iters=50),
        # The library yardstick: SDPA on the first kv_len keys.
        "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale), iters=50),
        "bound_ms": fbound, "bound_by": fby,
    }
    bbound, bby = attention_bwd_bound(name, kv_len, b, sq, sk, h)
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qg, kg, vg, scale=scale)

    brow = {
        "ms": device_ms(bwd, iters=50), "event_ms": time_ms(bwd, iters=50),
        "plain_ms": device_ms(lambda: fa.flash_attention_allheads_bwd_plain(
            q, k, v, do, lse, delta, scale=scale, kv_len=kv_len),
            iters=3, warmup=1),
        # B5b's wrapper as a whole (dq scratch zeroed, kernel, dq cast).
        "b5b_ms": device_ms(lambda: fa._launch_bhsd_bwd(*args, sq),
                            iters=50),
        "library_ms": (device_ms(sdpa_fwd_bwd, iters=20)
                       - device_ms(sdpa_fwd, iters=20)),
        "bound_ms": bbound, "bound_by": bby,
    }
    return frow, brow


def phase_allheads_kernels(seed: int):
    """B4f and B4b against their plain versions at ALLHEADS_CASES, each with
    a control (a key tile dropped) that must fail the same check, and timed
    at the tensor-parallel shape; returns the two kernels' entries of the
    kernels line (launches filled in later)."""
    import torch

    from dinov2_od_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 6)
    scale = DH ** -0.5
    entries = {}
    failures = []
    for b, sq, sk, h, kv_len in ALLHEADS_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, do = _bhsd_inputs(gen, b, sq, sk, h, dtype)
            o, lse = fa.flash_attention_allheads_fwd(q, k, v, scale=scale,
                                                     kv_len=kv_len)
            o_ref, lse_ref = fa.flash_attention_allheads_fwd_plain(
                q, k, v, scale=scale, kv_len=kv_len)
            delta = fa._delta(do, o, None)
            got = fa.flash_attention_allheads_bwd(q, k, v, o, lse, do,
                                                  scale=scale, kv_len=kv_len)
            again = fa.flash_attention_allheads_bwd(q, k, v, o, lse, do,
                                                    scale=scale,
                                                    kv_len=kv_len)
            ref = fa.flash_attention_allheads_bwd_plain(
                q, k, v, do, lse, delta, scale=scale, kv_len=kv_len)
            # Controls: each kernel handed a smaller kv_len than the check.
            ctl_len = _last_tile_dropped(kv_len)
            o_c, lse_c = fa.flash_attention_allheads_fwd(
                q, k, v, scale=scale, kv_len=ctl_len)
            got_c = fa.flash_attention_allheads_bwd(
                q, k, v, o, lse, do, scale=scale, kv_len=ctl_len)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            ctl_o = (o_c.float() - o_ref.float()).abs().max().item()
            ctl_lse = (lse_c - lse_ref).abs().max().item()
            rel, err = _grad_errs(got, ref)
            ctl_rel, _ = _grad_errs(got_c, ref)
            finite = all(bool(torch.isfinite(t).all())
                         for t in (o, lse, *got))
            masked_zero = bool(not got[1][:, kv_len:].any()
                               and not got[2][:, kv_len:].any())
            deterministic = all(torch.equal(x, y) for x, y in zip(got, again))
            tol, btol = ALLHEADS_TOL[name], BWD_TOL[name]
            row = {
                "dtype": name, "shape": [b, sq, sk, h, DH], "kv_len": kv_len,
                "routes": {"fwd": "B4f" if fa._allheads_fwd(q, k) else "B5f",
                           "bwd": "B4b" if fa._allheads_bwd(q, k) else "B5b"},
                "max_abs_err_o": err_o, "max_abs_err_lse": err_lse,
                "bwd_max_rel_err": rel, "bwd_max_abs_err": err,
                "masked_dk_dv_exactly_zero": masked_zero,
                "dq_dk_dv_run_to_run_equal": deterministic,
                "control_kv_len": ctl_len, "control_err_o": ctl_o,
                "control_err_lse": ctl_lse, "control_bwd_rel_err": ctl_rel,
            }
            if not (finite and err_o <= tol["o"] and err_lse <= tol["lse"]):
                failures.append(f"B4f {name} {row['shape']} kv_len={kv_len}: "
                                f"o {err_o:.3g}, lse {err_lse:.3g}, "
                                f"finite={finite}")
            if not (finite and max(rel.values()) <= btol and masked_zero
                    and deterministic):
                failures.append(f"B4b {name} {row['shape']} kv_len={kv_len}: "
                                f"{rel} (tol {btol}), masked zero "
                                f"{masked_zero}, deterministic "
                                f"{deterministic}, finite={finite}")
            if ctl_o <= tol["o"] and ctl_lse <= tol["lse"]:
                failures.append(f"B4f {name} {row['shape']}: the control "
                                f"(kv_len {ctl_len}) passes the check")
            if max(ctl_rel.values()) <= btol:
                failures.append(f"B4b {name} {row['shape']}: the control "
                                f"(kv_len {ctl_len}) passes the check")
            if (b, sq, sk, h, kv_len) == ALLHEADS_CASES[0]:
                frow, brow = _time_allheads(q, k, v, do, o, lse, kv_len, name)
                row["fwd_timing"], row["bwd_timing"] = frow, brow
                if name == "bfloat16":
                    common = {"route": "cuda", "launches": 0,
                              "shape": [b, sq, h, DH], "dtype": name}
                    entries["flash_attn_allheads_fwd"] = {
                        "name": "flash_attn_allheads_fwd", **common,
                        "source": "dinov2_od_tpu_torch/csrc/"
                                  "flash_attn_allheads_fwd.cu",
                        "replaces": "dinov2_od_tpu/ops/flash_attention.py:231",
                        "replaces_function": "_fwd_kernel_allheads",
                        "max_abs_err": err_o, **frow,
                        "ptxas": ptxas_report("flash_attn_allheads_fwd")}
                    entries["flash_attn_allheads_bwd"] = {
                        "name": "flash_attn_allheads_bwd", **common,
                        "source": "dinov2_od_tpu_torch/csrc/"
                                  "flash_attn_allheads_bwd.cu",
                        "replaces": "dinov2_od_tpu/ops/flash_attention.py:265",
                        "replaces_function": "_bwd_kernel_allheads",
                        "max_abs_err": max(err.values()),
                        "max_rel_err": max(rel.values()), **brow,
                        "ptxas": ptxas_report("flash_attn_allheads_bwd")}
            log("kernels: flash_attn_allheads " + json.dumps(row))
            del q, k, v, do, o, lse, got, again, ref, o_c, got_c, o_ref
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError("all-heads kernels disagree with their plain "
                             "versions: " + "; ".join(failures))
    return entries


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
    want = _counts(flash_attn_fwd=bb.depth * device_batches)
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

    verdicts = {}
    for run, out in runs.items():  # every reading logged, then judged
        err = {key: metric(out[key], ref[key]) for key in OUTPUTS}
        finite = all(bool(torch.isfinite(out[key]).all()) for key in OUTPUTS)
        failed = [k for k in OUTPUTS if err[k] > tol[k]]
        log(f"{what} {run} vs {ref_name}: "
            + ", ".join(f"{k} {metric_name} {err[k]:.4g} (tol {tol[k]})"
                        for k in OUTPUTS)
            + f", finite={finite}, over the limit: {failed or 'none'}")
        verdicts[run] = (err, finite, failed)
    err, finite, failed = verdicts.pop("kernel")
    if not finite or failed:
        raise AssertionError(f"{what} disagrees with {ref_name}")
    passed = [run for run, (_, _, f) in verdicts.items() if not f]
    if passed:
        raise AssertionError(
            f"{what}: the check against {ref_name} passes a faulty "
            f"kernel ({passed}); its limits are too loose")
    return err


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
    want = _counts(flash_attn_fwd=bb.depth * device_batches,
                   int8_gemm=bb.depth * device_batches)
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
def _backwards_as(make):
    """Every flash backward (flat B2, all-heads B4b and blocked B5b, which
    `_FlashAttention` looks up at call time) replaced by make(sound
    wrapper, plain version) for the gradient check."""
    from dinov2_od_tpu_torch.ops import flash_attention as fa

    pairs = {"flash_attention_bwd": fa.flash_attention_bwd_plain,
             "flash_attention_allheads_bwd":
                 fa.flash_attention_allheads_bwd_plain,
             "flash_attention_bhsd_bwd": fa.flash_attention_bhsd_bwd_plain}
    sound = {name: getattr(fa, name) for name in pairs}
    for name, plain in pairs.items():
        setattr(fa, name, make(sound[name], plain))
    try:
        yield
    finally:
        for name, fn in sound.items():
            setattr(fa, name, fn)


def _bwd_keys_dropped(drop: int):
    """The flash backward as a faulty kernel: B2, B4b or B5b handed a
    smaller kv_len than its forward used, so it drops the keys from `drop`
    on."""
    def make(sound, plain):
        def faulty(q, k, v, o, lse, do, *, scale, kv_len=None, glse2=None):
            return sound(q, k, v, o, lse, do, scale=scale,
                         kv_len=min(kv_len or k.shape[1], drop), glse2=glse2)
        return faulty

    return _backwards_as(make)


def _plain_backward():
    """The flash backward's plain version on the card, behind the kernel
    forward: the gradient check's reference for the backward alone."""
    from dinov2_od_tpu_torch.ops import flash_attention as fa

    def make(sound, plain):
        def run(q, k, v, o, lse, do, *, scale, kv_len=None, glse2=None):
            return plain(q, k, v, do, lse, fa._delta(do, o, glse2),
                         scale=scale, kv_len=kv_len)
        return run

    return _backwards_as(make)


def _drive_train(seed: int, det, steps: int, want_per_step: dict,
                 phase: str, profile: bool, batch_size: int = B):
    """The train main path: `steps` full-width steps on a fixed synthetic
    batch with the launch counts set to 0 before and read after, held to
    `want_per_step` launches; finite losses that drop, frozen leaves and
    the non-adapted LoRA rows bit-identical; then the step's throughput.
    Returns (train config, batch, launch counts, images/s)."""
    import torch

    from dinov2_od_tpu_torch.config import DataConfig, OptimConfig, TrainConfig
    from dinov2_od_tpu_torch.data.synthetic import make_batch
    from dinov2_od_tpu_torch.models.detector import (
        cast_frozen_weights, init_detector_params)
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.train.state import create_train_state
    from dinov2_od_tpu_torch.train.step import make_train_step

    cfg = TrainConfig(detector=det,
                      data=DataConfig(batch_size=batch_size,
                                      max_boxes=MAX_BOXES),
                      optim=OptimConfig())
    bb, dec = det.backbone, det.decoder
    log(f"{phase}: ViT-{bb.variant} depth {bb.depth} ({bb.seq_len} tokens) "
        f"bf16, LoRA r={bb.lora_r} {bb.lora_mode} on the last "
        f"{bb.lora_last_n_blocks} blocks, prefix_int8={bb.prefix_int8}; "
        f"decoder {dec.num_layers} layers fp32 dropout {dec.dropout}; batch "
        f"{batch_size}, {MAX_BOXES} GT slots, matcher "
        f"{cfg.matcher.assignment}; "
        f"{cfg.optim}")
    params = cast_frozen_weights(init_detector_params(
        torch.Generator().manual_seed(seed), det, device="cuda"), det)
    state = create_train_state(params, cfg.optim, det)
    raw = make_batch(np.random.default_rng(seed), batch_size,
                     image_size=bb.image_size, max_boxes=MAX_BOXES)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in raw.items()}
    snap = _snapshot(params, det)
    step = make_train_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    # The main path: counts to 0, drive, read the counts.
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch, gen)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    _check_steps(phase, torch.stack(losses).tolist(), metrics, counts,
                 want_per_step, steps, snap)

    # Throughput of the train step on the fixed batch.
    ms = time_ms(lambda: step(state, batch, gen), iters=5, warmup=2,
                 repeats=5)
    ips = batch_size / ms * 1e3
    log(f"{phase}: " + json.dumps({
        "metric": f"train step, batch {batch_size}, bf16 backbone, "
                  f"prefix_int8={bb.prefix_int8}, {MAX_BOXES} GT slots",
        "ms_per_step": ms, "images_per_s": ips,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card_line(),
    }))
    if profile:
        profile_device(lambda: step(state, batch, gen), ms, f"{phase} step")
    del state, params, snap
    torch.cuda.empty_cache()
    return cfg, batch, counts, ips


def _snapshot(params, det):
    """Copies of the frozen leaves and of the non-adapted blocks' rows of
    the stacked LoRA leaves, for `_check_steps`."""
    from dinov2_od_tpu_torch.models.detector import trainable_mask

    first = det.backbone.depth - det.backbone.lora_last_n_blocks
    frozen, lora_rows = [], []

    def walk(t, m):
        for key in t:
            if isinstance(t[key], dict):
                walk(t[key], m[key])
            elif not m[key]:
                frozen.append((t[key], t[key].clone()))
            elif key in ("lora_A", "lora_B") and t[key].dim() == 3:
                lora_rows.append((t[key], t[key][:first].clone()))

    walk(params, trainable_mask(params, det))
    return first, frozen, lora_rows


def _check_steps(phase, losses, metrics, counts, want_per_step, steps, snap):
    """The train checks of a run of `steps` steps: the launch counts are
    `want_per_step` times the steps, the losses finite and dropping, the
    frozen leaves and the non-adapted LoRA rows bit-identical."""
    import torch

    first, frozen, lora_rows = snap
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


def _train_dets(model_name: str = "facebook/dinov2-base",
                image_size: int = 224, **backbone):
    """A train configuration (ViT-B/14 + deformable DETR unless given)
    with a bf16 backbone, and the same in fp32 for the gradient check."""
    from dinov2_od_tpu_torch.config import detector_config_for_model_name

    det32 = detector_config_for_model_name(model_name, hidden_dim=768,
                                           image_size=image_size)
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
        _counts(flash_attn_fwd=bb.depth,
                flash_attn_bwd=bb.lora_last_n_blocks), "train", profile)
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
        _counts(flash_attn_fwd=bb.depth,
                flash_attn_bwd=bb.lora_last_n_blocks, int8_gemm=prefix),
        "prefix-int8 train", profile)
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


def phase_large_serving(seed: int, kernels: dict, profile: bool = False):
    """The long-sequence serving path: a ViT-L/14 560 px Predictor
    (batch 8) behind a DynamicBatcher, on B5f."""
    import torch

    from dinov2_od_tpu_torch.inference import Predictor, prepare_images
    from dinov2_od_tpu_torch.models.detector import (
        cast_frozen_weights, detector_apply, fold_detector_lora)

    cfg, cfg16, params = _serving_model(seed, LARGE_MODEL, LARGE_IMAGE)
    bb = cfg.backbone
    log(f"large serving: ViT-{bb.variant} hidden {bb.hidden_dim} depth "
        f"{bb.depth} heads {bb.num_heads} {bb.image_size} px ({bb.seq_len} "
        f"tokens), projection to {bb.target_dim}; decoder "
        f"{cfg.decoder.num_layers} layers dim {cfg.decoder.hidden_dim}; "
        f"batch {LARGE_BATCH}")
    predictor = Predictor(cast_frozen_weights(params, cfg16), cfg16,
                          device="cuda", batch_size=LARGE_BATCH)
    requests = _requests(seed, bb.image_size, LARGE_REQUEST_SIZES)
    counts, device_batches, results = _serve(predictor, requests,
                                             "large serving")
    want = _counts(flash_attn_bhsd_fwd=bb.depth * device_batches)
    if counts != want or device_batches == 0:
        raise AssertionError(f"large serving launches {counts} for "
                             f"{device_batches} device batches; expected "
                             f"{want} ({bb.depth} B5f launches each)")
    fwd = kernels["flash_attn_bhsd_fwd"]
    fwd["launches"] += counts["flash_attn_bhsd_fwd"]
    fwd["launches_large_serving"] = counts["flash_attn_bhsd_fwd"]
    fwd["launches_per_forward"] = (counts["flash_attn_bhsd_fwd"]
                                   / device_batches)
    _check_alone(predictor, requests, results, "large serving")

    # detector_apply with B5f against plain attention, one batch of 8.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images = [im for r in requests for im in r][:LARGE_BATCH]
    pixels, _ = prepare_images(images, bb.image_size, normalize=True)
    x = torch.from_numpy(pixels).to("cuda")
    folded = fold_detector_lora(params, cfg)
    for name, c, p in (("float32", cfg, folded),
                       ("bfloat16", cfg16, cast_frozen_weights(folded, cfg16))):
        with torch.inference_mode():
            ref = detector_apply(p, c, x, attn_impl="xla")
            runs = {"kernel": detector_apply(p, c, x, attn_impl="auto")}
            for kv_len in LARGE_CONTROLS[name]:
                with _keys_dropped(kv_len):
                    runs[f"control kv_len={kv_len}"] = detector_apply(
                        p, c, x, attn_impl="auto")
        _check_model(f"large serving: detector_apply {name}",
                     "plain attention", runs, ref, LARGE_MODEL_TOL[name],
                     _max_abs, "max abs err")
        del ref, runs
    ms, fwd_call = _forward_ms(predictor, bb.image_size, LARGE_BATCH)
    log("large serving: " + json.dumps({
        "metric": f"batch-{LARGE_BATCH} forward + top-k, ViT-L/14 "
                  f"{bb.image_size} px, bf16 backbone",
        "ms_per_batch": ms, "images_per_s": LARGE_BATCH / ms * 1e3,
        "card": card_line(),
    }))
    if profile:
        profile_device(fwd_call, ms, "large serving forward")
    del predictor, params, folded
    torch.cuda.empty_cache()


def phase_large_train(seed: int, kernels: dict, profile: bool = False):
    """The long-sequence train step: ViT-L/14 at 560 px, batch 8, on B5f
    and B5b."""
    import torch

    det32, det = _train_dets(LARGE_MODEL, LARGE_IMAGE)
    bb = det.backbone
    cfg, batch, counts, ips = _drive_train(
        seed, det, LARGE_TRAIN_STEPS,
        _counts(flash_attn_bhsd_fwd=bb.depth,
                flash_attn_bhsd_bwd=bb.lora_last_n_blocks),
        "large train", profile, batch_size=LARGE_BATCH)
    for name in ("flash_attn_bhsd_fwd", "flash_attn_bhsd_bwd"):
        k = kernels[name]
        k["launches"] += counts[name]
        k["launches_large_train"] = counts[name]
        k["launches_per_step"] = counts[name] / LARGE_TRAIN_STEPS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _gradient_check(seed, cfg, det32, det, batch, LARGE_GRAD_TOL,
                        LARGE_GRAD_CONTROLS, "large train")
    finally:
        torch.use_deterministic_algorithms(False)
    del batch
    torch.cuda.empty_cache()


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


def _gradient_check(seed, cfg, det32, det, batch, tols=GRAD_TOL,
                    controls=GRAD_CONTROLS, phase="train"):
    """One step's loss and trainable gradients with the kernels against
    plain attention and the plain backward, fp32 and bf16, each limit in
    `tols`, beside controls (the backward dropping the keys from each of
    `controls` on) that must fail the same check."""
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
        log(f"{phase}: gradients {name} plain backward run twice: rel err "
            + ", ".join(f"{g} {e:.4g}" for g, e in floor.items()
                        if g != "loss"))
        runs = {"kernel": loss_grads("auto")}
        for kv_len in controls:
            with _bwd_keys_dropped(kv_len):
                runs[f"control kv_len={kv_len}"] = loss_grads("auto")
        verdicts = {}
        for run, result in runs.items():
            finite = bool(torch.isfinite(result[0])) and all(
                bool(torch.isfinite(g).all()) for g in result[1].values())
            failed = [] if finite else ["non-finite"]
            for ref_name, ref in refs.items():
                tol = tols[name][ref_name]
                err = _grad_errors(result, ref)
                over = [g for g in err if err[g] > tol[g]]
                failed += [f"{ref_name}: {g}" for g in over]
                log(f"{phase}: gradients {name} {run} vs {ref_name}: "
                    + ", ".join(f"{g} rel err {err[g]:.4g} (tol {tol[g]})"
                                for g in err)
                    + f", finite={finite}, over the limit: {over or 'none'}")
            verdicts[run] = failed
        if verdicts["kernel"]:
            raise AssertionError(f"{phase} gradients {name} disagree: "
                                 f"{verdicts['kernel']}")
        passed = [r for r, f in verdicts.items() if r != "kernel" and not f]
        if passed:
            raise AssertionError(
                f"{phase} gradients {name}: the check passes a backward that "
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


def _tp_trees(seed: int, det32):
    """The TP phase's two param trees as numpy, drawn on the CPU: the
    train phase's init from `seed`, and the gradient check's from seed + 2
    with every lora_B nonzero (as `_step_loss_grads` draws them)."""
    import torch

    from dinov2_od_tpu_torch.models.detector import init_detector_params
    from dinov2_od_tpu_torch.params import params_to_numpy

    train = init_detector_params(torch.Generator().manual_seed(seed), det32,
                                 device="cpu")
    check = init_detector_params(torch.Generator().manual_seed(seed + 2),
                                 det32, device="cpu")
    lg = torch.Generator().manual_seed(seed + 3)
    for lin in check["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = 0.05 * torch.randn(lin["lora_B"].shape,
                                               generator=lg)
    return params_to_numpy(train), params_to_numpy(check)


def _grad_tree(p, c, x, gt, match, mesh=None):
    """(loss, masked gradient tree) of one train-mode step on fixed params
    with a fixed assignment; under `mesh` this rank's, with the train
    step's reductions (`reduce_gradients`)."""
    import torch

    from dinov2_od_tpu_torch.config import OptimConfig
    from dinov2_od_tpu_torch.models.detector import detector_apply
    from dinov2_od_tpu_torch.ops.losses import set_criterion
    from dinov2_od_tpu_torch.parallel.collectives import reduce_gradients
    from dinov2_od_tpu_torch.parallel.sharding import leaf_paths
    from dinov2_od_tpu_torch.train.state import (
        create_train_state, mask_gradients, trainable_leaves, tree_unflatten)

    state = create_train_state(p, OptimConfig(), c)
    o = detector_apply(p, c, x, deterministic=False, mesh=mesh)
    loss = set_criterion(o["pred_logits"], o["pred_boxes"], *gt,
                         num_classes=c.decoder.num_classes, match=match,
                         mesh=mesh)["loss"]
    grads = list(torch.autograd.grad(
        loss, trainable_leaves(p, state.opt_state)))
    if mesh is not None:
        reduce_gradients(grads, leaf_paths(state.opt_state.mu), mesh)
    return loss.detach(), mask_gradients(
        tree_unflatten(state.opt_state.mu, grads), p, c)


def _tree_groups(grads, det):
    """A gradient tree in `_groups`' groups, each flattened to fp32 on the
    host."""
    import torch

    from dinov2_od_tpu_torch.train.state import tree_leaves

    blocks = grads["backbone"]["blocks"]
    first = det.backbone.depth - det.backbone.lora_last_n_blocks
    out = {"lora": [blocks[lin][f][first:] for lin in sorted(blocks)
                    if isinstance(blocks[lin], dict)
                    for f in ("lora_A", "lora_B")
                    if blocks[lin].get(f) is not None],
           "decoder": tree_leaves(grads["decoder"])}
    if "projection" in grads["backbone"]:
        out["projection"] = [grads["backbone"]["projection"][f]
                             for f in ("kernel", "bias")]
    return {name: torch.cat([g.reshape(-1).float().cpu() for g in gs])
            for name, gs in out.items()}


@contextlib.contextmanager
def _lora_grads_unreduced():
    """The train step's reduction without the model group's sum of the
    replicated LoRA factors' partial gradients: the TP gradient check's
    second control."""
    from dinov2_od_tpu_torch.parallel import sharding

    sound = sharding.partial_grad

    def faulty(path):
        return path[-1] not in ("lora_A", "lora_B") and sound(path)

    sharding.partial_grad = faulty
    try:
        yield
    finally:
        sharding.partial_grad = sound


def _tp_rank(rank: int, world: int, port: int, work: str, seed: int):
    """One rank of the TP phase: a process on cuda:0 in a gloo group of
    `world`, on a 1 x TP mesh. Reads the parent's inputs from `work`,
    writes its results there (rank{r}.pt)."""
    import pickle
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from dinov2_od_tpu_torch.config import (
        DataConfig, MeshConfig, OptimConfig, TrainConfig)
    from dinov2_od_tpu_torch.models.detector import (
        cast_frozen_weights, detector_apply)
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.ops.matching import MatchResult
    from dinov2_od_tpu_torch.parallel import create_mesh, gather_params
    from dinov2_od_tpu_torch.params import params_from_numpy
    from dinov2_od_tpu_torch.train.state import create_train_state
    from dinov2_od_tpu_torch.train.step import make_train_step

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        work = Path(work)
        with open(work / "inputs.pkl", "rb") as f:
            inp = pickle.load(f)
        mesh_cfg = MeshConfig(model_parallel_size=TP)
        mesh = create_mesh(TP, mesh_cfg)
        det32, det = _train_dets()
        batch = {k: torch.from_numpy(v).to("cuda")
                 for k, v in inp["batch"].items()}
        x = batch["images"]
        gt = (batch["labels"], batch["boxes"], batch["valid"])
        out = {}
        for name, c in (("float32", det32), ("bfloat16", det)):
            c = dataclasses.replace(c, decoder=dataclasses.replace(
                c.decoder, dropout=0.0))
            p = params_from_numpy(inp["check"], device="cuda", mesh=mesh)
            if name == "bfloat16":
                p = cast_frozen_weights(p, c)
            with torch.inference_mode():
                runs = {"kernel": detector_apply(p, c, x, mesh=mesh)}
                for kv_len in TP_CONTROLS[name]:
                    with _keys_dropped(kv_len):
                        runs[f"control kv_len={kv_len}"] = detector_apply(
                            p, c, x, mesh=mesh)
            out[f"forward {name}"] = {
                run: {k: o[k].float().cpu() for k in OUTPUTS}
                for run, o in runs.items()}
            match = MatchResult(*(t.to("cuda") for t in inp["match"][name]))
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                grads = {"kernel": _grad_tree(p, c, x, gt, match, mesh)}
                for kv_len in TP_GRAD_CONTROLS[name]:
                    with _bwd_keys_dropped(kv_len):
                        grads[f"control B4b kv_len={kv_len}"] = _grad_tree(
                            p, c, x, gt, match, mesh)
                with _lora_grads_unreduced():
                    grads["control LoRA factors' partial gradients not "
                          "summed over the model group"] = _grad_tree(
                              p, c, x, gt, match, mesh)
            finally:
                torch.use_deterministic_algorithms(False)
            out[f"grads {name}"] = {
                run: (loss.cpu(), _tree_groups(gather_params(g, mesh), c))
                for run, (loss, g) in grads.items()}
            del p, runs, grads
            torch.cuda.empty_cache()

        # The main path: TP_STEPS train steps, counts to 0 before and read
        # after.
        cfg = TrainConfig(detector=det,
                          data=DataConfig(batch_size=B, max_boxes=MAX_BOXES),
                          optim=OptimConfig(), mesh=mesh_cfg)
        params = cast_frozen_weights(
            params_from_numpy(inp["train"], device="cuda", mesh=mesh), det)
        state = create_train_state(params, cfg.optim, det)
        snap = _snapshot(params, det)
        step = make_train_step(cfg, mesh)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        _build.reset_launch_counts()
        losses = []
        for _ in range(TP_STEPS):
            state, metrics = step(state, batch, gen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        counts = dict(_build.launch_counts)
        _check_steps(f"tp rank {rank}", torch.stack(losses).tolist(),
                     metrics, counts,
                     _counts(flash_attn_allheads_fwd=det.backbone.depth,
                             flash_attn_allheads_bwd=
                             det.backbone.lora_last_n_blocks),
                     TP_STEPS, snap)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, batch, gen)
        torch.cuda.synchronize()
        out["step_s"] = (time.perf_counter() - t0) / 3
        out["counts"] = counts
        out["losses"] = torch.stack(losses).tolist()
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _judge_grads(phase: str, name: str, runs: dict, ref, tol: dict):
    """Each run's loss and gradient groups against `ref` (relative errors,
    `_grad_errors`): the sound run ("kernel") within every limit, each
    control over one."""
    import torch

    verdicts = {}
    for run, result in runs.items():
        finite = bool(torch.isfinite(result[0])) and all(
            bool(torch.isfinite(g).all()) for g in result[1].values())
        err = _grad_errors(result, ref)
        over = [g for g in err if err[g] > tol[g]]
        verdicts[run] = over + ([] if finite else ["non-finite"])
        log(f"{phase}: gradients {name} {run} vs one process: "
            + ", ".join(f"{g} rel err {err[g]:.4g} (tol {tol[g]})"
                        for g in err)
            + f", finite={finite}, over the limit: {over or 'none'}")
    if verdicts["kernel"]:
        raise AssertionError(f"{phase} gradients {name} disagree: "
                             f"{verdicts['kernel']}")
    passed = [r for r, v in verdicts.items() if r != "kernel" and not v]
    if passed:
        raise AssertionError(f"{phase} gradients {name}: the check passes "
                             f"a faulty run ({passed}); its limits are too "
                             f"loose")


def phase_tp(seed: int, kernels: dict):
    """The tensor-parallel train step: ViT-B/14 on a 1 x 4 mesh, four
    ranks sharing the card. The parent draws the params, runs one process's
    forward and gradients on the card (B1/B2) as the references, and
    spawns the ranks (`_tp_rank`), which run the TP forward, the gradient
    check with its controls and TP_STEPS train steps on B4f/B4b."""
    import pickle
    import shutil
    import socket
    import tempfile
    from pathlib import Path

    import torch
    import torch.multiprocessing as mp

    from dinov2_od_tpu_torch.data.synthetic import make_batch
    from dinov2_od_tpu_torch.models.detector import (
        cast_frozen_weights, detector_apply)
    from dinov2_od_tpu_torch.ops.matching import hungarian_match
    from dinov2_od_tpu_torch.params import params_from_numpy

    det32, det = _train_dets()
    bb = det.backbone
    log(f"tp: ViT-{bb.variant} depth {bb.depth} heads {bb.num_heads} "
        f"({bb.num_heads // TP} a rank) at {bb.seq_len} tokens; mesh "
        f"(data 1, model {TP}): {TP} processes on cuda:0, gloo, host-staged "
        f"collectives; batch {B}, {MAX_BOXES} GT slots")
    train_tree, check_tree = _tp_trees(seed, det32)
    raw = make_batch(np.random.default_rng(seed), B, image_size=bb.image_size,
                     max_boxes=MAX_BOXES)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in raw.items()}
    x = batch["images"]
    gt = (batch["labels"], batch["boxes"], batch["valid"])

    # One process's references on the card, the same fixed assignment for
    # every run of a dtype.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs, matches = {}, {}
    for name, c in (("float32", det32), ("bfloat16", det)):
        c = dataclasses.replace(c, decoder=dataclasses.replace(
            c.decoder, dropout=0.0))
        p = params_from_numpy(check_tree, device="cuda")
        if name == "bfloat16":
            p = cast_frozen_weights(p, c)
        with torch.inference_mode():
            fwd = detector_apply(p, c, x)
        match = hungarian_match(fwd["pred_logits"], fwd["pred_boxes"], *gt)
        matches[name] = tuple(t.cpu() for t in match)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss, grads = _grad_tree(p, c, x, gt, match)
        finally:
            torch.use_deterministic_algorithms(False)
        refs[name] = ({k: fwd[k].float().cpu() for k in OUTPUTS},
                      (loss.cpu(), _tree_groups(grads, c)))
        del p, fwd, grads
    torch.cuda.empty_cache()

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="tp_phase_", dir=root))
    try:
        with open(work / "inputs.pkl", "wb") as f:
            pickle.dump({"train": train_tree, "check": check_tree, "batch": raw,
                         "match": matches}, f)
        del train_tree, check_tree
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        mp.start_processes(_tp_rank, args=(TP, port, str(work), seed),
                           nprocs=TP, join=True, start_method="spawn")
        wall = time.perf_counter() - t0
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
                 for r in range(TP)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"tp: {TP} ranks done in {wall:.1f} s")

    for name in ("float32", "bfloat16"):
        ref_fwd, ref_grads = refs[name]
        for r, res in enumerate(ranks):
            _check_model(f"tp: rank {r} forward {name}", "one process",
                         res[f"forward {name}"], ref_fwd, TP_MODEL_TOL[name],
                         _max_abs, "max abs err")
        # Gathered gradients: every rank holds the same after the gather.
        _judge_grads("tp", name, ranks[0][f"grads {name}"], ref_grads,
                     TP_GRAD_TOL[name])
        for res in ranks[1:]:
            loss, groups = res[f"grads {name}"]["kernel"]
            loss0, groups0 = ranks[0][f"grads {name}"]["kernel"]
            if not all(torch.equal(groups[g], groups0[g]) for g in groups):
                raise AssertionError("tp: the ranks' gathered gradients "
                                     "differ")

    want = _counts(flash_attn_allheads_fwd=bb.depth * TP_STEPS,
                   flash_attn_allheads_bwd=bb.lora_last_n_blocks * TP_STEPS)
    for r, res in enumerate(ranks):
        if res["counts"] != want:
            raise AssertionError(f"tp: rank {r} launches {res['counts']}; "
                                 f"expected {want}")
    for name, per_step in (("flash_attn_allheads_fwd", bb.depth),
                           ("flash_attn_allheads_bwd",
                            bb.lora_last_n_blocks)):
        k = kernels[name]
        k["launches"] += sum(res["counts"][name] for res in ranks)
        k["launches_tp_train"] = [res["counts"][name] for res in ranks]
        k["launches_per_step_per_rank"] = per_step
    log("tp: " + json.dumps({
        "metric": f"train step, {TP} ranks of a 1 x {TP} mesh sharing one "
                  f"card over host-staged gloo collectives: not a "
                  f"tensor-parallel speed",
        "losses_rank0": ranks[0]["losses"],
        "s_per_step_per_rank": [res["step_s"] for res in ranks],
        "card": card_line(),
    }))


def _t1_errors(out, ref):
    """(relative Frobenius error, max abs error over the largest |ref|,
    max abs error) of a bf16 T1 output."""
    d = out.float() - ref.float()
    peak = ref.float().abs().max().item()
    err = d.abs().max().item()
    return (d.norm() / ref.float().norm()).item(), err / peak, err


def phase_roofline_kernel(seed: int):
    """T1 against its plain version for every stage at ROOFLINE_CASES,
    with a control (the last key tile dropped) that must fail the same
    check and a sequence past the kernel's limit that must raise; then
    timed at the tool's default shape. Returns T1's entry of the kernels
    line (launches filled in by the tool's phase)."""
    import torch

    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.ops import attn_roofline as t1

    gen = torch.Generator().manual_seed(seed + 11)
    scale = DH ** -0.5
    failures = []
    worst = 0.0
    for b, h, s in ROOFLINE_CASES:
        q, k, v = (torch.randn((b, h, s, DH), generator=gen).to(
            "cuda", torch.bfloat16) for _ in range(3))
        ctl_keys = _last_tile_dropped(s)
        for stage in t1.STAGES:
            o = t1.attn_roofline(q, k, v, scale=scale, stage=stage)
            ref = t1.attn_roofline_plain(q, k, v, scale=scale, stage=stage)
            ctl = t1._launch(q, k, v, scale, stage, ctl_keys)
            torch.cuda.synchronize()
            rel, over_peak, err = _t1_errors(o, ref)
            c_rel, c_over_peak, _ = _t1_errors(ctl, ref)
            finite = bool(torch.isfinite(o.float()).all())
            row = {"shape": [b, h, s, DH], "stage": stage, "rel_err": rel,
                   "max_abs_err": err, "max_err_over_peak": over_peak,
                   "control_keys": ctl_keys, "control_rel_err": c_rel,
                   "control_max_err_over_peak": c_over_peak}
            log("kernels: attn_roofline " + json.dumps(row))
            worst = max(worst, err)
            if not (finite and rel <= T1_TOL["rel"]
                    and over_peak <= T1_TOL["max_over_peak"]):
                failures.append(f"T1 {stage} {row['shape']}: rel {rel:.3g}, "
                                f"max/peak {over_peak:.3g}, finite={finite}")
            if (c_rel <= T1_TOL["rel"]
                    and c_over_peak <= T1_TOL["max_over_peak"]):
                failures.append(f"T1 {stage} {row['shape']}: the control "
                                f"({ctl_keys} keys) passes the check")
            del o, ref, ctl
        del q, k, v
        torch.cuda.empty_cache()
    long = torch.zeros((1, 1, t1.MAX_SEQ + 16, DH), dtype=torch.bfloat16,
                       device="cuda")
    try:
        t1.attn_roofline(long, long, long, scale=scale, stage="mxu_only")
        failures.append(f"T1 took S {t1.MAX_SEQ + 16} past its limit")
    except ValueError as e:
        if str(t1.MAX_SEQ) not in str(e):
            failures.append(f"T1's refusal does not name its limit: {e}")
    if _build.load("attn_roofline").attn_roofline_max_seq() != t1.MAX_SEQ:
        failures.append("the kernel's and the wrapper's S limits differ")
    if failures:
        raise AssertionError("T1 disagrees with its plain version: "
                             + "; ".join(failures))

    # Timed at the tool's default shape, beside the bound (the function's
    # two products at the bf16 tensor-core rate, and its bytes: q, k, v
    # read and o written once) and, for mxu_only, the two cuBLAS products
    # that compute it: (q' k^T) into bf16, then times v (q' rounded to
    # bf16 there). No one PyTorch call computes the other two stages.
    b, h, s = ROOFLINE_CASES[0]
    q, k, v = (torch.randn((b, h, s, DH), generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(3))
    bound_ms, bound_by = _bound("bfloat16", 4 * b * h * s * DH * 2,
                                4.0 * b * h * s * s * DH)
    stages = {}
    for stage in t1.STAGES:
        def kern(stage=stage):
            t1.attn_roofline(q, k, v, scale=scale, stage=stage)

        stages[stage] = {
            "ms": device_ms(kern, iters=20),
            "event_ms": time_ms(kern, iters=20),
            "plain_ms": device_ms(lambda stage=stage: t1.attn_roofline_plain(
                q, k, v, scale=scale, stage=stage), iters=2, warmup=1),
        }
    qb = (q.float() * t1.q_multiplier(scale)).to(torch.bfloat16)
    kt = k.transpose(-1, -2)
    library_ms = device_ms(lambda: torch.matmul(torch.matmul(qb, kt), v),
                           iters=20)
    log("kernels: attn_roofline timing " + json.dumps({
        "shape": [b, h, s, DH], "stages": stages, "library_ms_mxu_only":
        library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "card": card_line()}))
    del q, k, v, qb, kt
    torch.cuda.empty_cache()
    return {"name": "attn_roofline", "route": "cuda",
            "source": "dinov2_od_tpu_torch/csrc/attn_roofline.cu",
            "replaces": "tools/bench_attn_roofline.py:69",
            "replaces_function": "kernel", "launches": 0,
            "shape": [b, h, s, DH], "dtype": "bfloat16",
            "stage": "mxu_only", "max_abs_err": worst,
            **stages["mxu_only"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library": "torch.matmul(torch.matmul(bf16 q', k^T), v)",
            "stages": stages, "ptxas": ptxas_report("attn_roofline")}


def phase_roofline_tool(kernels: dict):
    """The port's roofline tool at its defaults, in-process: its four JSON
    lines in order, T1 launched exactly by the stages' calls, and the
    production variant through B5f and nothing else."""
    import io

    import torch

    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.ops.attn_roofline import STAGES
    from dinov2_od_tpu_torch.tools import bench_attn_roofline as tool

    out = io.StringIO()
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    calls = tool.run(tool.parse_args([]), out=out)
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    lines = out.getvalue().splitlines()
    for line in lines:
        log("roofline tool: " + line)
    recs = [json.loads(line) for line in lines]
    keys = [["variant", "ms", "mxu_tf_s"]] + [
        ["variant", "ms", "mxu_tf_s", "delta_ms_vs_prev"]] * 3
    want = _counts(attn_roofline=sum(calls[st] for st in STAGES),
                   flash_attn_bhsd_fwd=calls["production"])
    problems = []
    if [r["variant"] for r in recs] != [*STAGES, "production"]:
        problems.append(f"variants {[r['variant'] for r in recs]}")
    if [list(r) for r in recs] != keys:
        problems.append(f"keys {[list(r) for r in recs]}")
    if not all(r["ms"] > 0 for r in recs):
        problems.append("a time is not positive")
    if counts != want:
        problems.append(f"launches {counts}, expected {want}")
    if problems:
        raise AssertionError("roofline tool: " + "; ".join(problems))
    entry = kernels["attn_roofline"]
    entry["launches"] = counts["attn_roofline"]
    entry["tool"] = recs
    log("roofline tool: deltas " + json.dumps({
        r["variant"]: r.get("delta_ms_vs_prev") for r in recs}))
    log(f"roofline tool: {time.perf_counter() - t0:.1f} s, launches "
        f"{counts['attn_roofline']} T1 + {counts['flash_attn_bhsd_fwd']} B5f; "
        f"{card_line()}")


def phase_bench():
    """`dinov2_od_tpu_torch.bench` in-process, train (its default) and
    BENCH_MODE=eval: the four keys of bench.py's line, a positive value,
    the card's name in the metric, and the flash kernels launched (B1 and
    B2 in the train step, B1 in the forward), nothing else."""
    import torch

    from dinov2_od_tpu_torch import bench
    from dinov2_od_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    for env, want in (({}, _counts(flash_attn_fwd=1, flash_attn_bwd=1)),
                      ({"BENCH_MODE": "eval"}, _counts(flash_attn_fwd=1))):
        t0 = time.perf_counter()
        _build.reset_launch_counts()
        rec = bench.run(env)
        torch.cuda.synchronize()
        launched = {k: int(n > 0) for k, n in _build.launch_counts.items()}
        log("bench: " + json.dumps(rec))
        log(f"bench: {env or 'default'}: {time.perf_counter() - t0:.1f} s, "
            f"launches {dict(_build.launch_counts)}; {card_line()}")
        problems = []
        if list(rec) != ["metric", "value", "unit", "vs_baseline"]:
            problems.append(f"keys {list(rec)}")
        if not rec["value"] > 0:
            problems.append(f"value {rec['value']}")
        if name not in rec["metric"]:
            problems.append(f"the metric does not name {name}")
        if launched != want:
            problems.append(f"launched {launched}, expected {want}")
        if problems:
            raise AssertionError(f"bench {env}: " + "; ".join(problems))
        torch.cuda.empty_cache()


def phase_trace():
    """`trace_step` for TRACE_RUNS: the groups sum to the total device
    time within 1%; the flash group holds the run's kernels (B1 and B2 in
    the ViT-B train step, B1 in its forward, B5f in the ViT-L/560
    forward); the largest elementwise and copy kernels are logged by
    name."""
    import io

    import torch

    from dinov2_od_tpu_torch.tools import trace_step

    for what, env, want in TRACE_RUNS:
        out = io.StringIO()
        t0 = time.perf_counter()
        summary = trace_step.run(trace_step.parse_args(["--steps", "3"]), env,
                                 out=out)
        for line in out.getvalue().splitlines():
            log(f"trace: {what}: {line}")
        total = summary["device_ms_per_step"]
        groups = sum(summary["by_group"].values())
        src = summary["by_source"]
        problems = []
        if not total > 0 or abs(groups - total) > 0.01 * total:
            problems.append(f"groups {groups} against the total {total}")
        if not all(src.get(k, 0) > 0 for k in want):
            problems.append(f"the flash group holds {dict(src)}")
        flash = sum(v for k, v in src.items() if k.startswith("flash_attn"))
        if abs(summary["by_group"]["flash_attn"] - flash) > 1e-9:
            problems.append("the flash group is not its kernels' sum")
        if problems:
            raise AssertionError(f"trace_step {what}: " + "; ".join(problems))
        pointwise = [(ms, n) for n, ms in summary["by_name"].items()
                     if trace_step.classify(n) in ("elementwise",
                                                   "copy_transpose")]
        for ms, n in sorted(pointwise, reverse=True)[:12]:
            log(f"trace: {what}: pointwise {ms:.4f} ms/step "
                f"{summary['calls'][n]:g} calls {n[:400]}")
        log(f"trace: {what}: {time.perf_counter() - t0:.1f} s; "
            f"{card_line()}")
        torch.cuda.empty_cache()


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
        "flash_fwd_share": share("flash_fwd", "bhsd_fwd", "allheads_fwd"),
        "flash_bwd_share": share("flat_bwd", "dkdv_", "dq_f32", "bhsd_bwd",
                                 "allheads_bwd"),
        "int8_gemm_share": share("int8_gemm_kernel", "int8_quantize_rows"),
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
    log(card_line())  # as nvidia-smi prints it: name, power limit
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_build()
    kernels = {}
    for entry in (phase_kernels(args.seed), phase_bwd_kernel(args.seed),
                  phase_int8_kernel(args.seed)):
        kernels[entry["name"]] = entry
    kernels.update(phase_bhsd_kernels(args.seed))
    kernels.update(phase_allheads_kernels(args.seed))
    kernels["attn_roofline"] = phase_roofline_kernel(args.seed)
    serving_ips = phase_slice(args.seed, kernels, profile=args.profile)
    phase_int8_serving(args.seed, kernels, serving_ips, profile=args.profile)
    train_ips = phase_train(args.seed, kernels, profile=args.profile)
    phase_prefix_int8_train(args.seed, kernels, train_ips,
                            profile=args.profile)
    phase_large_serving(args.seed, kernels, profile=args.profile)
    phase_large_train(args.seed, kernels, profile=args.profile)
    phase_tp(args.seed, kernels)
    phase_roofline_tool(kernels)
    phase_bench()
    phase_trace()
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
