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
             for mxu_only, two cuBLAS products; B3, flash_attention_lse,
             with a nonzero cotangent of its lse on each family at
             LSE_CASES (flat at ring attention's [8, 801, 16, 64] shard,
             kv_len 801 and 800; all-heads at [32, 257, 3, 64]; blocked at
             [8, 1601, 16, 64]) against its plain version, with a control
             (the backward without the lse cotangent) that must fail,
             timed at the ring's shard beside its bound, its plain version
             and `_scaled_dot_product_flash_attention`;
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
7. train cli - the training CLI from a dataset to a checkpoint to the
             server: packed synthetic splits (640 train, 64 val images at
             224 px, 100 GT slots, no Pillow), `train.cli.main` for 2
             epochs of 20 ViT-B/14 bf16 steps at batch 32 through the
             auction matcher with validation (COCO AP) and a checkpoint
             each epoch; exactly 12 B1 + 2 B2 a step and 12 B1 a val
             batch, the auction once a step (one launch of its kernel
             each, csrc/auction.cu), finite losses whose last
             epoch's mean is below the first's; the auction on the card
             against its eager CPU run on the matcher's inputs, timed
             beside scipy's JV on the same costs; a checkpoint's save and
             restore timed; a resume from checkpoint_epoch_0 within
             CLI_RESUME_*; `--only_evaluate` in bf16 and int8 (12 B6 a
             val batch, AP within CLI_INT8_AP_TOL);
             Predictor.from_checkpoint equal to the in-memory Predictor;
             serve.main in a thread (GET endpoints, concurrent POST
             /detect, 12 B1 a batch);
7a. import export - pretrained weights in and serving bundles out at
             ViT-B/14 224 px: a random state dict under HF Dinov2Model's
             names at 518 px (37 x 37 positions) through the HF importer,
             every copied leaf equal to its source and pos_embed to the
             16 x 16 resample on the CPU, the imported model's b32 eval
             forward (12 B1) against plain attention with controls;
             `train.cli.main --pretrained_backbone` for one epoch (12 B1 +
             2 B2 a step, 12 B1 a val batch); its final params through
             save_reference_checkpoint and `--import_reference_checkpoint
             --only_evaluate`, equal to the run's validation metrics;
             tools/export.main to a bf16 and an int8 bundle (batch sizes
             1, 8, 32), each reloaded and against a Predictor over the
             same params bit for bit on 32 and 41 images, 3 images padded
             onto 8 equal to an 8-image call's first 3 (12 B1, and 12 B6
             in int8, a forward); `serve.main --bundle` answering POST
             /detect with ServingModel.detect's detections;
7a2. moe   - the MoE backbone FFN at bench.py's BENCH_FFN=moe (ViT-B/14
             224 px bf16, 8 experts, top-2, capacity factor 1.25 in the 2
             adapted blocks): moe_routing on [32, 257, 8] fp32 logits with
             tied rows, the card against the CPU (the same experts and
             slots, the lower index first on ties); the b32 forward (12
             B1) against plain attention in fp32 and bf16 with the same
             forward at top-1 as the control; 3 train steps (12 B1 + 2 B2
             a step) and 3 under remat (14 B1 + 2 B2), finite loss and
             loss_moe_aux, every router and expert leaf moved, the frozen
             prefix and its LoRA factors bit-identical; Predictor in bf16
             (12 B1) and int8 (12 B1 + 10 B6: the dense prefix's fc2s) on
             32 images, images/s beside the dense model's; `train.cli.main
             --ffn_type moe` for one epoch, `--only_evaluate`,
             Predictor.from_checkpoint equal to the in-memory Predictor,
             the final params as a bundle behind `serve.main --bundle`;
7b. train recipes - the recorded recipes' options at ViT-B/224 b32 (bf16,
             25 GT slots unless named): remat (14 B1 + 2 B2 a step, the
             LoRA gradients bit-equal to the step's without it under
             deterministic algorithms, a backward dropping keys as the
             control; peak memory and ms a step both ways); gradient
             accumulation k=2 over two copies of one batch against k=1 on
             it (params untouched after the first mini-step, the update
             and Adam's moments equal; a sum as the control); fold-mode
             LoRA in fp32 against the factored step (2 alpha as the
             control); the augmentation on the card against its CPU run on
             the same draws (inverted flips as the control); then
             `train.cli.main --device_cache --steps_per_dispatch 8` with
             hflip and scale jitter on 1024 packed images, 2 epochs with
             cached validation: 12 B1 + 2 B2 a step and 12 B1 a val batch,
             images/s beside the loader loop's and the bare step's, host
             syncs in one dispatch (torch.cuda's sync debug mode), a run
             preempted after its first dispatch of epoch 1 and resumed,
             bit-equal to an uninterrupted run under deterministic
             algorithms, and the cached validation's AP and detections
             equal to
             `--only_evaluate`'s on the same checkpoint (another
             checkpoint's as the control);
8. prefix  - the same train step with the frozen prefix in int8
             (prefix_int8): 10 steps with the same checks, 12 B1, 2 B2 and
             10 B6 launches per step; one step's loss and gradients against
             B6's plain version, with a control that must fail; images/s
             beside the bf16 step's;
9. large   - the long-sequence serving path: a full-width ViT-L/14 at
             560 px (1601 tokens) + deformable DETR Predictor (batch 8)
             behind a DynamicBatcher answers concurrent requests; 24 B5f
             and no B1 launches per device batch; detector_apply with the
             kernels against plain attention (fp32 and bf16), beside
             controls (keys dropped) that must fail; images/s of the
             batch-8 forward plus top-k;
10. large train - 10 full-width train steps of that model at batch 8 (bf16
             backbone, LoRA r=2 on the last 2 blocks): the train phase's
             checks, 24 B5f + 2 B5b and no B1/B2 launches per step, the
             gradient check against plain attention and B5b's plain
             version with controls (B5b dropping keys); images/s.
11. tp      - the train step under Megatron tensor parallelism on a
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
11b. cp     - context parallelism and the TP layouts it came with, each
             mesh's ranks processes on the one card in a gloo group (the
             ring's K and V staged through the host: correctness, not a
             speed): ring attention (ops/ring_attention.py, B3's route) at
             ViT-L/14 560 px, batch 8, bf16, on the legacy mode's 1 x 2
             mesh (the ring over the model axis, 801 tokens a rank) and on
             DP 1 x CP 2 x TP 2 (8 heads a rank): the eval forward and one
             step's loss and gradients against one process's (B5f/B5b),
             with a control (each rank's own keys only) that must fail;
             then CP_STEPS train steps and an eval top-k batch, exactly
             52 B1 + 4 B2 (56 through B3) a step a rank and 48 B1 a batch;
             SwiGLU ViT-g/14 at 224 px on 1 x 4 (6 heads a rank, flat):
             forward and gradients against one process's with a control
             (fc1 split as one contiguous slice) and one train step (40
             B1 + 2 B2); int8 ViT-B/14 on 1 x 4: the fp32 int8 forward
             within the quantization noise of one process's, the
             prefix-int8 step's gradients against one process's, an eval
             top-k batch (12 B4f) and a prefix-int8 step (12 B4f + 2 B4b),
             B6 launched 0 times. The ring's share of the main path's host
             time is printed.
11c. mesh cli - the training CLI on a mesh of processes, one process a
             rank: 4 ranks a job, each `python -m dinov2_od_tpu_torch.train`
             (run as __main__ by `chip_smoke.py --cli-rank`, which writes
             the rank's launch counts) on cuda:0 in a gloo group, joined
             through --coordinator_address/--num_processes/--process_id;
             ViT-B/14 bf16 at 224 px, 32 train and 16 val packed synthetic
             images, global batch 8, 100 GT slots. (a) --model_parallel 4
             for 2 epochs with validation and a checkpoint each: exactly
             12 B4f + 2 B4b a step and 12 B4f a val batch a rank, rank
             0's files alone; (b) --context_parallel_size 2 (DP 2 x CP 2,
             129-token shards) from --device_cache --device_cache_layout
             sharded for 1 epoch: exactly 28 B1 + 4 B2 a step and 24 B1 a
             val batch a rank, every one through B3's route; (a) and (b)
             run at once, each beside one process's run of the same flags,
             per-step losses and the validation's AP held to it (MESH_*);
             (c) --only_evaluate --quantize int8 --model_parallel 4 from
             (a)'s last checkpoint: 12 B4f a val batch and B6 0 times, the
             same checkpoint's one-process bf16 evaluation held to (a)'s
             last validation. Each job's wall time and s a step are
             printed, labelled as gloo ranks sharing one card.
11d. pp     - pipeline parallelism of the backbone through the training
             CLI, run as phase_mesh_cli runs its jobs (4 ranks a job on
             cuda:0, gloo; ViT-B/14 bf16 at 224 px, its packed splits,
             global batch 8, one epoch with validation and a checkpoint):
             (a) --model_parallel 4 --pipeline_parallel
             --pipeline_microbatches 4 (GPipe, 4 stages of 3 blocks) and
             (b) --pipeline_parallel_size 2 --model_parallel 2
             --pipeline_chunks 2 --pipeline_microbatches 2 (interleaved,
             2 stages x 2 chunks of 3 blocks, 6 heads a rank) at once,
             each beside one process's run of the same flags (losses and
             AP to MESH_*); bubbles skipped, so each rank launches B1 for
             its own blocks and B2 for its own adapted blocks: (a) 12 B1
             a step on every stage and 8 B2 on the last only, (b) 12 B1
             a step on every rank and 4 B2 on stage 1 only, 12 B1 a val
             batch everywhere, held exactly (PP_WANT); rank 0's files
             alone; --only_evaluate under (a)'s mesh from its checkpoint
             beside one process's; that checkpoint through
             Predictor.from_checkpoint bit-equal to a Predictor over the
             params the file holds. Wall times and s a step are printed,
             labelled as gloo ranks sharing one card.
11e. fsdp   - FSDP (ZeRO-3 over the data axis) through the training CLI,
             run as phase_pp runs its jobs (4 ranks a job on cuda:0, gloo;
             bf16 at 224 px, its packed splits, global batch 8, one epoch
             with validation and a checkpoint): (a) --fsdp over 4 data
             ranks at ViT-L/14 and (b) --fsdp --model_parallel 2 at
             ViT-B/14 at once, each beside one process's run of the same
             model (losses and AP to MESH_*); FSDP changes no launch
             count: (a) 24 B1 + 2 B2 a step and 24 B1 a val batch a rank,
             (b) 12 B1 + 2 B2 and 12 B1, held exactly (FSDP_WANT); every
             rank's param and Adam-moment elements equal to JAX's per-
             device counts (FSDP_ELEMENTS); rank 0's files alone, every
             rank's mesh logged with "fsdp"; --only_evaluate --quantize
             int8 --fsdp under (a)'s mesh from its checkpoint, 24 B1 and
             24 B6 a val batch a rank (B6 on the gathered fc2 kernels),
             beside one process's; that checkpoint through
             Predictor.from_checkpoint bit-equal to a Predictor over the
             params the file holds. Each rank's peak allocated memory is
             printed beside one process's (informational: the ranks share
             the card).
11f. moe ep - the MoE FFN under a mesh through the training CLI, run as
             phase_fsdp runs its jobs, at bench.py's BENCH_FFN=moe model
             (ViT-B/14 bf16 at 224 px, 8 experts, top-2, capacity factor
             1.25 in the 2 adapted blocks), its routers scaled x10 so that
             capacity drops tokens: (a) DP 2 x EP 2, (b) FSDP 2 x EP 2 and
             (c) DP 1 x CP 2 x EP 2 at once beside one process's run;
             per-rank launches (MOE_EP_WANT) and param and Adam-moment
             elements (MOE_EP_ELEMENTS) exact; losses and loss_moe_aux to
             MESH_*, (c)'s first step to MOE_EP_RING_FIRST_LOSS_TOL;
             --only_evaluate --quantize int8 from (a)'s checkpoint on DP 4
             (B6 on) and under (a)'s mesh (B6 0); Predictor.from_checkpoint
             bit-equal. Beside them, 4 ranks of DP 1 x CP 2 x EP 2 run
             ops/moe.py moe_ffn on the ring against the whole rows, with
             drops in the later shard, and its control without the earlier
             shard's counts (MOE_RING_*). `chip_smoke.py --moe-ring-fault`
             runs (c) with that fault instead, which must break (c)'s
             first-step limit.
12. roofline tool - the port's tools/bench_attn_roofline.py at its
             defaults, in-process: its four JSON lines (mxu_only, plus_max,
             plus_exp2, production) in order with the JAX tool's keys, T1
             launched exactly by the stages' calls and production through
             B5f and nothing else;
13. bench   - dinov2_od_tpu_torch.bench in-process, the ViT-B/224 b32 train
             step (its default), BENCH_MODE=eval and BENCH_FFN=moe:
             bench.py's four keys, a positive images/s, the card's name in
             the metric, B1 and B2 launched (B1 alone in eval) and nothing
             else;
14. trace   - tools/trace_step.py over 3 steps of the ViT-B train step, of
             the ViT-B batch-32 forward and of the ViT-L/560 batch-8
             forward: the groups sum to the total device time, the flash
             group holds B1 and B2 (B1 alone in the ViT-B forward, B5f at
             560 px), and the largest elementwise and copy kernels by name.
15. measurement tools - the tools in-process at full width, each with a
             control that must fail: bench_serving at ViT-B/224 b1 (bf16
             and int8; 50 requests, 4 client threads; the JAX tool's
             keys, p50 <= p95 <= p99, the card in the metric, exactly 12
             B1 (and 12 B6 in int8) a forward and nothing else);
             Predictor.detect over 8 chunks of 32 double-buffered against
             its sequential schedule, and ViT-L/560 over 8 chunks of 32
             (equal detections, a shuffled chunk as the control; chunk
             i+1 dispatched before chunk i is read back, the sequential
             order as the control; the device's idle time both ways from
             torch.profiler, lower double-buffered at ViT-L/560);
             bench_attn_scaling
             at b32 and b64 (flat: B1/B2, allheads: B4f/B4b, bhsd:
             B5f/B5b, and an unforced control); bench_qkv_layout;
             bench_evaluator at 1,000 images (C++ and numpy metrics
             equal); bench_input on 512 written 640 px JPEGs with its
             train and eval phases (B1 and B2 only), and the backend
             'auto' resolved to on a line of its own.

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
from typing import Optional

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
# 1025, ViT-B/14 at 448 px, and 1157, at 476 px; 800 and 801, ring
# attention's local shard of ViT-L/560 on a ring of 2), each with all
# keys, all but one and one. Each case with a control (the last 64-key tile dropped,
# where one is left) that must fail, and o and the lse bit-equal from run
# to run.
FWD_CASES = ((B, S, H, S), (B, S, H, KV_MASKED), (8, 1370, 16, 1370)) + tuple(
    (4, s, H, kv) for s in (128, 129, 256, 257, 264, 265, 641, 800, 801,
                            1025, 1157)
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
# Train CLI phase: `python -m dinov2_od_tpu_torch.train` on packed synthetic
# splits (make_sample rectangles, up to 4 a 224 px image, the category ids
# of write_coco_dataset), ViT-B/14 bf16 at batch 32 with the default 100
# GT slots (the auction matcher), 2 epochs of 20 steps, validation and a
# checkpoint each epoch; 2 validation batches an epoch.
CLI_TRAIN_IMAGES, CLI_VAL_IMAGES, CLI_EPOCHS = 640, 64, 2
CLI_BATCH = 32
# A run resumed from checkpoint_epoch_0 repeats epoch 1. Its first step
# is the same function of the same params (restored bit for bit), batch
# and dropout seed, so its loss must equal the uninterrupted run's within
# CLI_RESUME_FIRST_TOL, relative (the forward has no atomics). After it,
# the deformable gathers' backward adds with atomics on CUDA, so the
# gradients' low bits vary from run to run; Adam carries them on, and
# where two of the auction's bids nearly tie a step can match another
# query and move its loss by a few percent: each later loss within
# CLI_RESUME_TOL, relative, and the epoch's mean loss within
# CLI_RESUME_MEAN_TOL. The first chip run read 0 on the first step, at
# most 4.1e-2 on a later one and 7.4e-3 on the mean (NVIDIA H100 80GB
# HBM3, 700 W). Bit-equality of a resume is held on the CPU
# (tests/test_torch_train_loop.py).
CLI_RESUME_FIRST_TOL = 1e-6
CLI_RESUME_TOL = 0.1
CLI_RESUME_MEAN_TOL = 0.02
# int8 evaluation of the final checkpoint against the bf16 evaluation of
# the same checkpoint: |AP_int8 - AP_bf16| (COCO AP in [0, 1]).
CLI_INT8_AP_TOL = 0.02
# Import/export phase: an HF-named random ViT-B/14 state dict at DINOv2's
# 518 px (a 37 x 37 position grid) imported into 224 px; one epoch of the
# CLI from it on IMPORT_TRAIN_IMAGES packed images (10 steps at batch 32)
# and CLI_VAL_IMAGES val images; bundles exported at BUNDLE_BATCHES and
# checked on BUNDLE_IMAGES images (and 41, 8, 3 and 1).
IMPORT_SRC_GRID = 37
IMPORT_TRAIN_IMAGES = 320
BUNDLE_BATCHES = (1, 8, 32)
BUNDLE_IMAGES = 32
# Train recipes phase (the recorded recipes' step options and the cached
# loop at ViT-B/224 b32, bf16 unless named, 25 GT slots for the step
# checks). Steps driven each way with remat; its LoRA gradients must be
# bit-equal to the step's without it (B1, B2 and, under deterministic
# algorithms, the deformable backward are deterministic), the decoder's
# within RECIPE_REMAT_DECODER_TOL (relative norm). Accumulation: k=2 over
# two copies of one batch against k=1 on it, Adam's moments and the
# params after the update within RECIPE_ACC_TOL (relative norm; the two
# mini-steps' gradients are equal under deterministic algorithms, so the
# mean is the gradient); the control sums instead, doubling mu. Fold:
# fp32, loss and gradient groups of the fold-mode step against the
# factored step within RECIPE_FOLD_TOL (fp32 reassociation of x @ (W +
# A B) against x @ W + (x @ A) @ B); the control folds 2 alpha A B.
# Augmentation: hflip 0.5, scale 0.25, colour 0.3 on the card against the
# same draws applied on the CPU, pixels within RECIPE_AUG_PIXEL_TOL
# (cuBLAS against the host's matmul order), boxes and valid bits equal;
# the control inverts the flip mask.
# MoE phase (bench.py's BENCH_FFN=moe: ViT-B/14 224 px, bf16, the MoE FFN
# with 8 experts, top-2, capacity factor 1.25 (81 slots an expert for 257
# tokens) in the last 2 blocks). Routing: the card against the CPU on the
# same fp32 logits, combine and aux within MOE_ROUTING_TOL (max abs; the
# two softmaxes' exp may round apart in the last bit) and the same
# experts and slots for every token. The b32 forward with the kernels
# against plain attention: fp32, max abs error per output; bf16, relative
# error in norm, because the bf16 router logits of the two attention
# paths send some tokens to other experts, which moves those tokens'
# outputs by as much as the control moves every token's (a max abs
# reading cannot tell them apart). The control is the same forward at
# top-1, which must exceed a limit. Each limit lies between the sound
# reading and the control's, seed 0 on an H100 (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md §6): routing combine and aux 1.19e-7; fp32 logits
# 2.17e-5 | 1.407, boxes 1.10e-6 | 0.0946; bf16 (184 and 192 of 8224
# tokens on other experts in the two MoE blocks) logits 0.0530 | 0.313,
# boxes 0.00455 | 0.0275. MOE_STEPS train steps each way (with and
# without remat); the CLI on MOE_CLI_*_IMAGES packed images (4 steps of
# 32, one val batch).
MOE_ROUTING_TOL = 1e-6
MOE_MODEL_TOL = {
    "float32": {"pred_logits": 1e-3, "pred_boxes": 1e-4},
    "bfloat16": {"pred_logits": 0.15, "pred_boxes": 0.015},
}
MOE_STEPS = 3
MOE_CLI_TRAIN_IMAGES, MOE_CLI_VAL_IMAGES = 128, 32
RECIPE_STEPS = 3
RECIPE_REMAT_DECODER_TOL = 1e-5
RECIPE_ACC_TOL = 1e-6
RECIPE_FOLD_TOL = {"loss": 1e-4, "lora": 1e-3, "decoder": 1e-3,
                   "projection": 1e-3}
RECIPE_AUG_PIXEL_TOL = 1e-5
# The cached loop: `train.cli.main --device_cache --steps_per_dispatch 8`
# with the aug recipe's hflip 0.5 and scale jitter 0.25, 2 epochs of 32
# steps on 1024 packed images (100 GT slots, the auction), validation on
# 64 each epoch; under deterministic algorithms a run preempted after its
# first dispatch of epoch 1 and resumed, equal to the bit to an
# uninterrupted run; the cached validation's AP and detections equal to
# `--only_evaluate`'s on the same checkpoint.
RECIPE_CLI_TRAIN_IMAGES, RECIPE_CLI_VAL_IMAGES = 1024, 64
RECIPE_DISPATCH = 8
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
# B3 (`flash_attention_lse`) with a nonzero lse cotangent, bf16, one
# case a family at a shape a path gives it (batch, S, heads, kv_len, the
# forward and backward kernels): the flat pair at ring attention's local
# shard of ViT-L/560 on a ring of 2 (801 tokens, 16 heads; kv_len 801 and
# the straddling shard's 800), the all-heads pair at ViT-B's 3 heads a
# rank under TP 4, the blocked pair at ViT-L/560 whole. Tolerances: TOL
# (o, the lse in log2 units) and BWD_TOL, for the reasons given there.
LSE_CASES = (
    (8, 801, 16, 801, "flash_attn_fwd", "flash_attn_bwd"),
    (8, 801, 16, 800, "flash_attn_fwd", "flash_attn_bwd"),
    (B, S, 3, S, "flash_attn_allheads_fwd", "flash_attn_allheads_bwd"),
    (8, 1601, 16, 1601, "flash_attn_bhsd_fwd", "flash_attn_bhsd_bwd"),
)
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

# Context parallelism (phase_cp): ViT-L/14 at 560 px (1601 tokens, 16
# heads of 64), bf16 backbone, LoRA r=2 on the last 2 blocks, batch 8 with
# 25 GT slots, from seed 0; and the two tensor-parallel layouts this slice
# lifted: SwiGLU (ViT-g/14 at 224 px: 1536 wide, 40 blocks, 24 heads) and
# int8 (ViT-B/14 at 224 px), each on a 1 x 4 mesh. Every mesh's ranks are
# processes on the one card in a gloo process group (the ring's K and V
# staged through the host): a correctness run, not a CP or TP speed.
# mesh name: the MeshConfig fields. The legacy mode's ring runs over the
# two-axis mesh's model axis (1 x 2): 1601 tokens padded to 1602, 801 a
# rank, the second rank's shard straddling the pad at kv_len 800; the
# three-axis mesh's ring of 2 runs on 8 heads a rank (DP 1 x CP 2 x TP 2).
# Both shards are flat-eligible, so the ring launches B1/B2 where the
# unsharded model launches B5f/B5b.
CP_MESHES = {"legacy 1x2": dict(model_parallel_size=2, context_parallel=True),
             "dp1 x cp2 x tp2": dict(model_parallel_size=2,
                                      context_parallel_size=2)}
CP_STEPS = 3
# The ring's outputs (eval mode) and one step's loss and gradients, both
# bf16, against one process's (B5f/B5b at 1601 tokens), as LARGE_MODEL_TOL
# and LARGE_GRAD_TOL's "plain attention" hold the large model to a
# reference that does not round as its kernels do (24 bf16 blocks); the
# ring merges per-step partials in fp32 where B5f runs one online pass.
# Control: the ring without its remote shards (each rank's own keys only),
# which must fail both checks. SwiGLU under TP 4 (bf16 through 40 blocks)
# is held to the same limits; its control, fc1 sharded as one contiguous
# slice of 2M (each rank's gates paired with another rank's values), must
# fail them.
CP_MODEL_TOL = LARGE_MODEL_TOL["bfloat16"]
CP_GRAD_TOL = LARGE_GRAD_TOL["bfloat16"]["plain attention"]
GIANT_MODEL = "facebook/dinov2-giant"
# int8 under TP 4 (B6 off) against one process's int8 (B6 on fc2), fp32
# activations: within the quantization noise JAX's
# test_int8_tp_forward_matches_single_device accepts, 1.5 x the single
# process's error against the fp32 model, + 1e-6. The prefix-int8 step's
# loss and gradients (bf16) against one process's prefix-int8 step: 1.5 x
# that step's own distance from the bf16 step, or TP_GRAD_TOL (the bf16
# TP noise) where larger.
INT8_TP_NOISE = 1.5

# The training CLI on a mesh of processes (phase_mesh_cli): each rank a
# `python -m dinov2_od_tpu_torch.train` process (`--cli-rank` below runs
# the module as __main__ and writes its launch counts), MESH_WORLD of them
# on cuda:0 in a gloo group, joined through --coordinator_address/
# --num_processes/--process_id; ViT-B/14 bf16 at 224 px with the CLI's
# defaults (LoRA on the last 2 blocks, decoder dropout 0.1, 100 GT slots:
# the auction); packed synthetic splits of MESH_TRAIN_IMAGES and
# MESH_VAL_IMAGES images, global batch MESH_BATCH. Jobs: (a) 1 x TP 4 for
# 2 epochs with validation and a checkpoint each; (b) DP 2 x CP 2 from the
# sharded device cache for 1 epoch; (c) `--only_evaluate --quantize int8
# --model_parallel 4` from (a)'s last checkpoint. (a) and (b) run at
# once, each beside its one-process reference in this process.
MESH_WORLD = 4
MESH_TRAIN_IMAGES, MESH_VAL_IMAGES, MESH_BATCH = 32, 16, 8
MESH_RING = 2
# A rank that has not exited by then fails the phase (its peers killed).
MESH_JOB_TIMEOUT_S = 480
# Each job against one process on the same flags and data, both bf16:
# the first step is the same function of the same params, batch and
# dropout masks (`keep_mask` draws them whole), through other kernels
# (B4f/B4b or the ring's B1/B2 against B1/B2 whole) and sums split over
# the ranks: within MESH_FIRST_LOSS_TOL, relative (TP_GRAD_TOL's bf16
# loss limit, 1e-3, for a step of fixed assignment, x 5 for the auction's
# own rounding). Later steps carry that noise on through Adam, and where
# two of the auction's bids nearly tie a step can match another query: as
# a resume on one card (CLI_RESUME_TOL, CLI_RESUME_MEAN_TOL), each later
# loss within MESH_LOSS_TOL and each epoch's mean within
# MESH_MEAN_LOSS_TOL. The validation's COCO AP by the mesh and by one
# process, and the int8 TP evaluation's against the bf16 one: within
# MESH_AP_TOL, absolute (CLI_INT8_AP_TOL). AP50 and AP75 are logged, not
# held: on 16 images of a model 8 steps from random weights one
# detection that changes rank moves AP50 by ~0.03 (a CPU dry run of this
# phase at ViT-S/56 read AP 0.0057 and AP50 0.0286 apart).
MESH_FIRST_LOSS_TOL = 5e-3
MESH_LOSS_TOL = CLI_RESUME_TOL
MESH_MEAN_LOSS_TOL = CLI_RESUME_MEAN_TOL
MESH_AP_TOL = CLI_INT8_AP_TOL

# Pipeline parallelism through the training CLI (phase_pp), as
# phase_mesh_cli runs its jobs (MESH_WORLD `--cli-rank` processes a job on
# cuda:0 in a gloo group; ViT-B/14 bf16 at 224 px, its packed splits and
# global batch; LoRA on blocks 10-11). (a) legacy GPipe: 4 stages of 3
# blocks, 4 microbatches of 2; (b) interleaved PP x TP: 2 stages x 2
# chunks of 3 blocks (stage 0 blocks 0-2 and 6-8, stage 1 blocks 3-5 and
# 9-11), 6 heads a rank, 2 microbatches of 4. One epoch each with
# validation and a checkpoint, both jobs at once beside one process's run
# of the same flags (MESH_*_TOL; the one process is the same run for
# both); then `--only_evaluate` under (a)'s mesh from its checkpoint
# beside one process's. Bubbles are skipped, so each rank launches B1 for
# its own blocks only and B2 for its own adapted blocks only: per rank,
# in rank order, the launches a step and a val batch (a val batch runs
# the eval forward, no backward).
PP_JOBS = {
    "a_legacy_gpipe": ["--model_parallel", "4", "--pipeline_parallel",
                       "--pipeline_microbatches", "4"],
    "b_pp2_tp2_interleaved": ["--pipeline_parallel_size", "2",
                              "--model_parallel", "2", "--pipeline_chunks",
                              "2", "--pipeline_microbatches", "2"],
}
PP_WANT = {
    # (B1 a step, B2 a step, B1 a val batch) for ranks 0-3.
    "a_legacy_gpipe": ((12, 12, 12, 12), (0, 0, 0, 8), (12, 12, 12, 12)),
    "b_pp2_tp2_interleaved": ((12, 12, 12, 12), (0, 0, 4, 4),
                              (12, 12, 12, 12)),
}

# FSDP (ZeRO-3 over the data axis) through the training CLI (phase_fsdp),
# as phase_pp runs its jobs (MESH_WORLD `--cli-rank` processes a job on
# cuda:0 in a gloo group; bf16 at 224 px, its packed splits and global
# batch, one epoch with validation and a checkpoint; LoRA on the last 2
# blocks). (a) FSDP over 4 data ranks at ViT-L/14: every leaf of at least
# 65,536 elements cut on a free linear dim, the 2-D fc1 bias [24, 4096] on
# its depth axis; (b) FSDP 2 x TP 2 at ViT-B/14 (6 heads a rank): the LoRA
# factors cut on their rank dim, the deformable offsets kernel, a
# partial-grad leaf, cut too. FSDP changes no launch count: each data
# rank runs the whole model on its batch / data rows. Per rank: (B1 a
# step, B2 a step, B1 a val batch); under `--only_evaluate --quantize
# int8 --fsdp`, B1 and B6 (each block's fc2) a val batch, one a block.
# FSDP_ELEMENTS: each rank's (param, Adam-moment) elements, JAX's
# per-device counts for these configs (tests/test_torch_fsdp.py holds the
# port's rule to JAX's and pins these numbers).
FSDP_JOBS = {
    "a_fsdp4_vit_l": ["--dino_model", "facebook/dinov2-large", "--fsdp"],
    "b_fsdp2_tp2_vit_b": ["--dino_model", "facebook/dinov2-base", "--fsdp",
                          "--model_parallel", "2"],
}
FSDP_WANT = {"a_fsdp4_vit_l": (24, 2, 24), "b_fsdp2_tp2_vit_b": (12, 2, 12)}
FSDP_ELEMENTS = {"a_fsdp4_vit_l": (81_153_461, 5_140_661),
                 "b_fsdp2_tp2_vit_b": (25_938_869, 4_271_669)}

# The MoE FFN under a mesh through the training CLI (phase_moe_ep), as
# phase_fsdp runs its jobs (MESH_WORLD `--cli-rank` processes a job on
# cuda:0 in a gloo group; its packed splits and global batch, one epoch
# with validation and a checkpoint) at bench.py's BENCH_FFN=moe model
# (ViT-B/14 224 px bf16, 8 experts, top-2, capacity factor 1.25 in the 2
# adapted blocks): (a) DP 2 x EP 2 and (b) FSDP 2 x EP 2, 4 experts and
# 6 heads a rank (the flat pair); (c) DP 1 x CP 2 x EP 2, the ring of 2
# padding the 257 tokens to 258 (the pad row claims no expert slot). All
# three at once beside one process's run of the MoE flags. Per rank: (B1
# a step, B2 a step, B3 a step, B1 a val batch, B3 a val batch): (a) and
# (b) as FSDP_WANT's ViT-B; (c) as phase_mesh_cli's DP 2 x CP 2 (each
# ring step launches B1 twice a block, once more a ring step for the
# adapted blocks' backward, every launch B3's route). MOE_EP_ELEMENTS:
# each rank's (param, Adam-moment) elements of (a) and (b), JAX's
# per-device counts (tests/test_torch_moe_ep.py pins them); (c) holds
# (a)'s. Then `--only_evaluate --quantize int8` from (a)'s checkpoint on
# a DP 4 mesh (B6 on: the 10 dense prefix blocks' fc2, a val batch; the
# MoE blocks have no fc2) and under (a)'s mesh (B6 off, as in JAX).
MOE_EP_JOBS = {
    "a_dp2_ep2": ["--model_parallel", "2"],
    "b_fsdp2_ep2": ["--fsdp", "--model_parallel", "2"],
    "c_cp2_ep2": ["--context_parallel_size", "2", "--model_parallel", "2"],
}
MOE_EP_WANT = {"a_dp2_ep2": (12, 2, 0, 12, 0),
               "b_fsdp2_ep2": (12, 2, 0, 12, 0),
               "c_cp2_ep2": (28, 4, 32, 24, 24)}
MOE_EP_ELEMENTS = {"a_dp2_ep2": (84_563_381, 46_061_237),
                   "b_fsdp2_ep2": (42_510_773, 23_207_477),
                   "c_cp2_ep2": (84_563_381, 46_061_237)}
MOE_EP_INT8_FC2 = 10
# The ring's real routing on the card (phase_moe_ep, `_moe_ring_rank`):
# MESH_WORLD ranks of DP 1 x CP 2 x EP 2, as job (c), each running
# ops/moe.py `moe_ffn` (its `route` fed by `ring_counts`) on its shard of
# MESH_BATCH rows of 257 tokens padded to 258 (d 768, the ViT-B MLP's
# 3072 hidden, bf16, 8 experts, top-2, 81 slots), beside `moe_ffn` on the
# whole rows in the same process. The router picks x's first 8 features
# as the logits (a 0/1 kernel: exact in any product order, so both sides
# see the same logits), drawn N(0, 1) plus MOE_RING_SKEW, a router that
# prefers some experts as a trained one does: the first shard fills them
# and tokens of the second are dropped (the seed's draw drops 188 of the
# first shard's 2064 choices and 370 of the second's 2048). Held: the same
# slots and gates exactly, the pad row no slot and a zero output, the
# output within MOE_RING_OUT_TOL of the whole rows' largest |out| (two
# bf16 roundings: each model rank's partial sum over its 4 experts and
# their sum), the aux within MOE_ROUTING_TOL. The control routes with
# `ring_counts` replaced by the shard's own counts (no earlier shard's
# claims, the row's total its own): its slots move and its output parts
# from the whole rows' by more than the limit.
MOE_RING_SKEW = (1.0, 0.75, 0.5, 0.25, 0.0, 0.0, 0.0, 0.0)
MOE_RING_OUT_TOL = 1e-2
# The CLI jobs' routers (phase_moe_ep and its dropped-prefix control):
# the seed's init times MOE_EP_ROUTER_SCALE (std 0.02 x 10: logits of
# std about 5.5 on unit-variance LayerNorm'd tokens, against 0.55), so
# that routing is skewed and capacity drops tokens, as a trained router's
# does; near-flat logits drop few (N(0, 1) logits at these shapes dropped
# none), and then the ring's prefix counts change little. The one
# process's first routing logs its drops (on the H100 it kept 1509 of
# 4112 choices, 394 of the row's later half's 2064) and must drop some in
# the later half.
MOE_EP_ROUTER_SCALE = 10.0
# (c)'s first step against one process's, relative: at the x10 routers
# it read 1.106e-4, and the dropped-prefix control (`python3
# chip_smoke.py --moe-ring-fault`, every rank's `ring_counts` replaced as
# above) 4.028e-3, inside MESH_FIRST_LOSS_TOL (H100 80GB HBM3, 700 W).
# This limit parts the two by 9x and 4x.
MOE_EP_RING_FIRST_LOSS_TOL = 1e-3

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

# The measurement and input tools (phase 15): bench_serving's requests and
# client threads; detect's double buffer over DETECT_CHUNKS chunks of
# DETECT_BATCH at ViT-B/224 and of DETECT_LARGE_BATCH at ViT-L/560;
# bench_attn_scaling's batches and each variant's kernels; the evaluator
# at EVAL_IMAGES; bench_input over INPUT_IMAGES 640 px JPEGs written under
# INPUT_DIR. detect's two schedules agree to DETECT_TOL (score, box
# pixels).
SERVING_REQUESTS, SERVING_THREADS = 50, 4
DETECT_CHUNKS, DETECT_BATCH, DETECT_LARGE_BATCH = 8, 32, 32
DETECT_TOL = (1e-5, 1e-3)
SCALING_BATCHES = (32, 64)
SCALING_KERNELS = {
    "flat": ("flash_attn_fwd", "flash_attn_bwd"),
    "allheads": ("flash_attn_allheads_fwd", "flash_attn_allheads_bwd"),
    "bhsd": ("flash_attn_bhsd_fwd", "flash_attn_bhsd_bwd"),
}
EVAL_IMAGES = 1000
INPUT_IMAGES = 512
INPUT_DIR = "build/chip_smoke_input"


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


# The matcher's kernel: one auction launch a match at 40 or more GT
# slots, wherever a step or a loss evaluation meets them. The launch
# checks of the phases are of the model's kernels; phase_train_cli holds
# the auction's launches to the matcher's calls.
MATCHER_KERNEL = "auction"


def _launches() -> dict:
    """The launch counts of the model's kernels (all but the matcher's)."""
    from dinov2_od_tpu_torch.ops import _build

    return {name: n for name, n in _build.launch_counts.items()
            if name != MATCHER_KERNEL}


def _counts(**launches) -> dict:
    """Launch counts of every model kernel: the given ones, 0 for the
    rest."""
    from dinov2_od_tpu_torch.ops import _build

    return {name: launches.get(name, 0) for name in _build.SOURCES
            if name != MATCHER_KERNEL}


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
    counts = _launches()
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


def _lse_plain(q, k, v, do, dlse, kv_len, with_lse_cotangent=True):
    """B3's plain version on the card: the plain forward, then the lse's
    cotangent folded into delta (d lse2 = ln 2 * d lse) and the plain
    backward. Returns (o, lse, (dq, dk, dv))."""
    from dinov2_od_tpu_torch.ops import flash_attention as fa

    scale = DH ** -0.5
    o, lse2 = fa.flash_attention_bhsd_fwd_plain(q, k, v, scale=scale,
                                                kv_len=kv_len)
    glse2 = ((dlse * fa._LN2).transpose(1, 2) if with_lse_cotangent
             else None)
    grads = fa.flash_attention_bhsd_bwd_plain(
        q, k, v, do, lse2, fa._delta(do, o, glse2), scale=scale,
        kv_len=kv_len)
    return o, lse2.transpose(1, 2) * fa._LN2, grads


def phase_lse_kernel(seed: int):
    """B3, `flash_attention_lse`, with a nonzero cotangent of its lse (as
    ring attention's backward gives it) on each family, against its plain
    version on the same inputs, at LSE_CASES; each case with a control
    (the backward without the lse cotangent) that must fail the same
    check; timed at the ring's local shard (LSE_CASES[0]) beside its
    bound, its plain version and `_scaled_dot_product_flash_attention`.
    Returns B3's entry of the kernels line (launches filled in by
    phase_cp)."""
    import torch

    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator().manual_seed(seed + 11)
    scale = DH ** -0.5
    tol, btol = TOL["bfloat16"], BWD_TOL["bfloat16"]
    failures, entry = [], None
    for b, s, h, kv_len, fwd_name, bwd_name in LSE_CASES:
        q, k, v, do = (torch.randn((b, s, h, DH), generator=gen).to(
            "cuda", torch.bfloat16) for _ in range(4))
        dlse = torch.randn((b, s, h), generator=gen).cuda()
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        _build.reset_launch_counts()
        o, lse = fa.flash_attention_lse(qq, kk, vv, scale=scale,
                                        kv_len=kv_len)
        got = torch.autograd.grad((o, lse), (qq, kk, vv), (do, dlse))
        torch.cuda.synchronize()
        launched = ({n: c for n, c in _launches().items() if c},
                    dict(_build.route_counts))
        o_ref, lse_ref, ref = _lse_plain(q, k, v, do, dlse, kv_len)
        _, _, ctl = _lse_plain(q, k, v, do, dlse, kv_len, False)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        # The lse in log2 units, as TOL states its limit.
        err_lse = ((lse - lse_ref).abs().max() / fa._LN2).item()
        rel, err = _grad_errs(got, ref)
        ctl_rel, _ = _grad_errs(got, ctl)
        finite = all(bool(torch.isfinite(t).all()) for t in (o, lse, *got))
        row = {"shape": [b, s, h, DH], "kv_len": kv_len, "family":
               fwd_name, "max_abs_err_o": err_o,
               "max_abs_err_lse2": err_lse, "bwd_max_rel_err": rel,
               "bwd_max_abs_err": err,
               "control_without_lse_cotangent_rel_err": ctl_rel,
               "launches": launched}
        want = ({fwd_name: 1, bwd_name: 1}, {"flash_attention_lse": 2})
        if launched != want:
            failures.append(f"{row['shape']} kv_len={kv_len}: launches "
                            f"{launched}, expected {want}")
        if not (finite and err_o <= tol["o"] and err_lse <= tol["lse"]
                and max(rel.values()) <= btol):
            failures.append(f"{row['shape']} kv_len={kv_len}: o {err_o:.3g}"
                            f", lse {err_lse:.3g}, grads {rel}, "
                            f"finite={finite}")
        if max(ctl_rel.values()) <= btol:
            failures.append(f"{row['shape']} kv_len={kv_len}: the control "
                            f"(no lse cotangent) passes the check")
        if entry is None:
            fwd = lambda: fa.flash_attention_lse(q, k, v, scale=scale,
                                                 kv_len=kv_len)
            ms = device_ms(fwd, iters=20)
            plain_ms = device_ms(lambda: fa.flash_attention_bhsd_fwd_plain(
                q, k, v, scale=scale, kv_len=kv_len), iters=5)
            both = lambda: torch.autograd.grad(
                fa.flash_attention_lse(qq, kk, vv, scale=scale,
                                       kv_len=kv_len), (qq, kk, vv),
                (do, dlse))
            lib = _lse_library_ms(gen, b, s, h)
            bound_ms, bound_by = attention_bound("bfloat16", kv_len, b, s, h)
            row.update(ms=ms, plain_ms=plain_ms,
                       fwd_bwd_ms=device_ms(both, iters=10),
                       library_ms=lib["library_ms"], bound_ms=bound_ms,
                       bound_by=bound_by)
            entry = {
                "name": "flash_attention_lse", "route": "cuda",
                "source": "dinov2_od_tpu_torch/ops/flash_attention.py",
                "replaces": "dinov2_od_tpu/ops/flash_attention.py:831",
                "replaces_function": "flash_attention_lse",
                "kernels": "flat B1/B2 here; B4f/B4b and B5f/B5b by shape",
                "launches": 0, "shape": [b, s, h, DH], "dtype": "bfloat16",
                "max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib["library_ms"],
                "fwd_bwd_ms": row["fwd_bwd_ms"]}
        log("kernels: flash_attention_lse " + json.dumps(row))
        del q, k, v, do, qq, kk, vv, o, lse, got, ref, ctl, o_ref
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("B3 disagrees with its plain version: "
                             + "; ".join(failures))
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
                       profile: bool = False) -> float:
    """The int8 W8A8 serving path: Predictor(quantize="int8"); returns its
    images/s."""
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
    return 32 / ms * 1e3


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
                 phase: str, profile: bool, batch_size: int = B,
                 use_remat: bool = False):
    """The train main path: `steps` full-width steps on a fixed synthetic
    batch with the launch counts set to 0 before and read after, held to
    `want_per_step` launches; finite losses that drop, frozen leaves and
    the non-adapted LoRA rows bit-identical (under the MoE FFN also a
    finite loss_moe_aux and every router and expert leaf moved); then the
    step's throughput. Returns (train config, batch, launch counts,
    images/s)."""
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
                      optim=OptimConfig(), use_remat=use_remat)
    bb, dec = det.backbone, det.decoder
    log(f"{phase}: ViT-{bb.variant} depth {bb.depth} ({bb.seq_len} tokens) "
        f"bf16, LoRA r={bb.lora_r} {bb.lora_mode} on the last "
        f"{bb.lora_last_n_blocks} blocks, prefix_int8={bb.prefix_int8}, "
        f"ffn {bb.ffn_type}, remat={use_remat}; "
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
    experts = {}
    if "moe_blocks" in params["backbone"]:
        experts = {k: (v, v.clone()) for k, v in
                   params["backbone"]["moe_blocks"]["moe"].items()}
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
    counts = _launches()
    _check_steps(phase, torch.stack(losses).tolist(), metrics, counts,
                 want_per_step, steps, snap)
    if experts:
        aux = metrics["loss_moe_aux"].item()
        still = [k for k, (t, before) in experts.items()
                 if torch.equal(t, before)]
        log(f"{phase}: loss_moe_aux {aux:.4f} at the last step; routers "
            f"and experts unchanged: {still or 'none'}")
        if not np.isfinite(aux) or still:
            raise AssertionError(f"{phase}: loss_moe_aux {aux}, unchanged "
                                 f"MoE leaves {still}")

    # Throughput of the train step on the fixed batch.
    ms = time_ms(lambda: step(state, batch, gen), iters=5, warmup=2,
                 repeats=5)
    ips = batch_size / ms * 1e3
    log(f"{phase}: " + json.dumps({
        "metric": f"train step, batch {batch_size}, bf16 backbone, "
                  f"prefix_int8={bb.prefix_int8}, ffn {bb.ffn_type}, "
                  f"remat={use_remat}, {MAX_BOXES} GT slots",
        "ms_per_step": ms, "images_per_s": ips,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card_line(),
    }))
    if profile:
        profile_device(lambda: step(state, batch, gen), ms, f"{phase} step")
    del state, params, snap, experts
    torch.cuda.empty_cache()
    return cfg, batch, counts, ips


def _snapshot(params, det):
    """Copies of the frozen leaves and of the non-adapted blocks' rows of
    the stacked LoRA leaves in "blocks" (all of them under the MoE FFN,
    whose adapted blocks are "moe_blocks"), for `_check_steps`."""
    from dinov2_od_tpu_torch.models.detector import trainable_mask

    first = det.backbone.depth - det.backbone.lora_last_n_blocks
    frozen, lora_rows = [], []

    def walk(t, m, path):
        for key in t:
            if isinstance(t[key], dict):
                walk(t[key], m[key], path + (key,))
            elif not m[key]:
                frozen.append((t[key], t[key].clone()))
            elif (key in ("lora_A", "lora_B") and t[key].dim() == 3
                  and "blocks" in path):
                lora_rows.append((t[key], t[key][:first].clone()))

    walk(params, trainable_mask(params, det), ())
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


class _MemoryDataset:
    """Packed-format examples from `make_sample` arrays (no Pillow): uint8
    images, targets padded to `max_boxes`, the category ids 10, 20, ... of
    write_coco_dataset, and for the val split its COCO annotation file."""

    def __init__(self, rng, n, first_id, image_size, max_boxes, coco_path):
        from dinov2_od_tpu_torch.data.synthetic import make_sample

        self.examples = []
        self.coco = {"images": [], "annotations": [], "categories": [
            {"id": 10 * (i + 1), "name": f"color_{i}"} for i in range(6)]}
        for img_id in range(first_id, first_id + n):
            img, boxes, labels = make_sample(rng, image_size, max_objects=4)
            k = len(labels)
            ex = {"images": (img * 255).astype(np.uint8),
                  "boxes": np.zeros((max_boxes, 4), np.float32),
                  "labels": np.zeros((max_boxes,), np.int32),
                  "valid": np.arange(max_boxes) < k,
                  "image_id": np.int64(img_id),
                  "orig_size": np.asarray([image_size] * 2, np.int32)}
            ex["boxes"][:k], ex["labels"][:k] = boxes, labels
            self.examples.append(ex)
            self.coco["images"].append({"id": img_id, "width": image_size,
                                        "height": image_size,
                                        "file_name": f"{img_id:012d}.png"})
            for b, lab in zip(boxes, labels):
                cx, cy, bw, bh = (float(v) * image_size for v in b)
                self.coco["annotations"].append({
                    "id": len(self.coco["annotations"]) + 1,
                    "image_id": img_id, "category_id": 10 * (int(lab) + 1),
                    "bbox": [cx - bw / 2, cy - bh / 2, bw, bh],
                    "area": bw * bh, "iscrowd": 0})
        self.coco_path = coco_path
        self.label_to_cat_id = {i: 10 * (i + 1) for i in range(6)}
        self.num_classes = 6
        self.images_dir = None
        with open(coco_path, "w") as f:
            json.dump(self.coco, f)

    def __len__(self):
        return len(self.examples)

    def get_example(self, i):
        return self.examples[i]


def _cli_splits(seed: int, root: str, image_size: int,
                n_train: int = CLI_TRAIN_IMAGES, n_val: int = CLI_VAL_IMAGES):
    """Packed train and val splits under `root` (pack_dataset's format)."""
    import os

    from dinov2_od_tpu_torch.data.packed import pack_dataset

    rng = np.random.default_rng(seed)
    out = {}
    for name, n, first in (("train", n_train, 1),
                           ("val", n_val, n_train + 1)):
        ds = _MemoryDataset(rng, n, first, image_size, 100,
                            os.path.join(root, f"{name}.json"))
        out[name] = pack_dataset(ds, os.path.join(root, name))
    return out


def _epoch_logs(out_dir: str, epochs):
    import os

    logs = {}
    for e in epochs:
        with open(os.path.join(out_dir, f"train_epoch_{e}.json")) as f:
            logs[e] = json.load(f)
    return logs


def _ap(out_dir: str, epoch: int) -> dict:
    import os

    with open(os.path.join(out_dir, f"metrics_epoch_{epoch}.json")) as f:
        return json.load(f)


@contextlib.contextmanager
def _serve_main(args):
    """serve.main(args) in a thread: yields the listening server, then
    shuts it down and fails unless main returned 0."""
    from dinov2_od_tpu_torch import serve

    ready, result = [], {}
    thread = threading.Thread(target=lambda: result.setdefault(
        "rc", serve.main(args, on_ready=ready.append)))
    thread.start()
    try:
        for _ in range(3000):
            if ready or not thread.is_alive():
                break
            thread.join(timeout=0.1)
        if not ready:
            raise AssertionError(f"serve.main {args[:2]} did not start")
        yield ready[0]
    finally:
        if ready:
            ready[0].shutdown()
        thread.join(timeout=120)
    if thread.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"serve.main {args[:2]}: rc {result.get('rc')}")


def _cli_serve(final: str, seed: int, image_size: int):
    """serve.main in a thread on a free port with the final checkpoint:
    its GET endpoints, then concurrent POST /detect requests (PNG bodies)
    through its DynamicBatcher; 12 B1 launches a device batch."""
    import base64
    import io
    import urllib.request

    from PIL import Image

    from dinov2_od_tpu_torch.ops import _build

    args = ["--checkpoint", final, "--image_size", str(image_size),
            "--batch_size", "16", "--host", "127.0.0.1", "--port", "0",
            "--max_batch", "16", "--batch_wait_ms", "50"]
    _build.reset_launch_counts()
    with _serve_main(args) as server:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.load(r)
        rng = np.random.default_rng(seed)

        def png():
            arr = (rng.uniform(size=(image_size, image_size, 3))
                   * 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG")
            return base64.b64encode(buf.getvalue()).decode()

        bodies = [json.dumps({"images": [png() for _ in range(n)],
                              "score_threshold": 0.0}).encode()
                  for n in (3, 5, 2, 6)]
        answers, errors = [None] * len(bodies), []

        def client(i):
            req = urllib.request.Request(
                url + "/detect", data=bodies[i],
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=300) as r:
                    answers[i] = json.load(r)["detections"]
            except Exception as e:  # reported below; the phase fails
                errors.append(repr(e))

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
    counts = _launches()
    if errors:
        raise AssertionError(f"serve.main: {errors}")
    if health.get("status") != "ok" or any(
            a is None or len(a) != n or not all(len(d) for d in a)
            for a, n in zip(answers, (3, 5, 2, 6))):
        raise AssertionError(f"serve.main answers: {health}, {answers}")
    batches = int(re.search(r"serving_device_batches_total (\d+)",
                            metrics).group(1))
    want = _counts(flash_attn_fwd=12 * (batches + 1))  # + the warm-up
    if counts != want or "serving_images_total 16" not in metrics:
        raise AssertionError(f"serve.main launches {counts} for {batches} "
                             f"batcher batches + 1 warm-up; expected {want}"
                             f"\n{metrics}")
    log(f"train cli: serve.main on the final checkpoint: /healthz {health}; "
        f"4 concurrent /detect requests of 3, 5, 2, 6 PNG images in "
        f"{batches} batcher batches, launches {counts}")
    return counts


def phase_train_cli(seed: int, kernels: dict, bare_ips: float) -> float:
    """The training CLI from a packed COCO-format dataset to a checkpoint
    to the server: `train.cli.main` for 2 epochs through the auction
    matcher with validation and checkpoints, a resume, an int8 evaluation,
    `Predictor.from_checkpoint` and `serve.main`. Returns the loop's
    images/s in its last epoch."""
    import os
    import tempfile

    import torch

    from dinov2_od_tpu_torch.config import (
        MatcherConfig, detector_config_for_model_name)
    from dinov2_od_tpu_torch.inference import Predictor
    from dinov2_od_tpu_torch.ops import _build, matching
    from dinov2_od_tpu_torch.ops.hungarian import hungarian_assign_batched
    from dinov2_od_tpu_torch.train import checkpoint as ckpt
    from dinov2_od_tpu_torch.train import cli, loop
    from dinov2_od_tpu_torch.train.state import tree_leaves
    from dinov2_od_tpu_torch.train.step import make_eval_step

    image_size = 224
    steps = CLI_EPOCHS * (CLI_TRAIN_IMAGES // CLI_BATCH)
    val_batches = -(-CLI_VAL_IMAGES // CLI_BATCH)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="train_cli_", dir=build) as root:
        t0 = time.perf_counter()
        splits = _cli_splits(seed, root, image_size)
        log(f"train cli: packed {CLI_TRAIN_IMAGES} train and "
            f"{CLI_VAL_IMAGES} val images at {image_size} px (up to 4 "
            f"objects, 100 GT slots) in {time.perf_counter() - t0:.1f} s")
        out = os.path.join(root, "out")
        common = ["--packed_train_data", splits["train"],
                  "--packed_val_data", splits["val"],
                  "--dino_model", "facebook/dinov2-base",
                  "--image_size", str(image_size),
                  "--backbone_dtype", "bfloat16",
                  "--batch_size", str(CLI_BATCH),
                  "--num_epochs", str(CLI_EPOCHS), "--val_frequency", "1",
                  "--checkpoint_frequency", "1", "--log_frequency", "5"]

        # The main path: counts to 0, `main`, the counts read. The loop's
        # final state is kept from its return value for the Predictor
        # check below.
        real_run, state = loop.run_training, {}

        def keep_state(*a, **k):
            state["s"] = real_run(*a, **k)
            return state["s"]

        loop.run_training = keep_state
        _build.reset_launch_counts()
        matching.reset_solver_stats()
        t0 = time.perf_counter()
        try:
            rc = cli.main(common + ["--output_dir", out])
        finally:
            loop.run_training = real_run
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launches()
        solver = dict(matching.solver_stats)
        want = _counts(flash_attn_fwd=12 * (steps + CLI_EPOCHS * val_batches),
                       flash_attn_bwd=2 * steps)
        logs = _epoch_logs(out, range(CLI_EPOCHS))
        losses = [x for e in range(CLI_EPOCHS) for x in logs[e]["losses"]]
        log(f"train cli: main() rc {rc} in {wall:.1f} s: {steps} steps, "
            f"epoch mean losses "
            f"{[logs[e]['mean_loss'] for e in range(CLI_EPOCHS)]}, launches "
            f"{counts}, matcher {solver}")
        if rc != 0:
            raise AssertionError(f"train cli: main returned {rc}")
        if counts != want:
            raise AssertionError(f"train cli launches {counts}; expected "
                                 f"{want} (12 B1 + 2 B2 a step, 12 B1 a val "
                                 f"batch)")
        if (solver["auction"] != steps or solver["jv"]
                or _build.launch_counts["auction"] != steps):
            raise AssertionError(f"train cli matcher {solver}, auction "
                                 f"launches {_build.launch_counts['auction']}"
                                 f": expected the auction once a step, one "
                                 f"kernel launch each")
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"train cli losses: {losses}")
        if not logs[CLI_EPOCHS - 1]["mean_loss"] < logs[0]["mean_loss"]:
            raise AssertionError("train cli: the last epoch's mean loss is "
                                 "not below the first's")
        for e in range(CLI_EPOCHS):
            m = _ap(out, e)
            if not all(np.isfinite(m[k]) for k in ("AP", "AP50", "AP75")):
                raise AssertionError(f"metrics_epoch_{e}.json: {m}")
            if not os.path.isdir(os.path.join(out, f"checkpoint_epoch_{e}")):
                raise AssertionError(f"no checkpoint_epoch_{e}")
        for name in ("flash_attn_fwd", "flash_attn_bwd"):
            kernels[name]["launches"] += counts[name]
            kernels[name]["launches_train_cli"] = counts[name]
        log("train cli: " + json.dumps({
            "metric": "training loop images/s per epoch (packed loader, "
                      "copies, steps with the auction at 100 GT slots), "
                      "beside the bare step's (phase train: fixed batch, "
                      "25 GT slots, JV)",
            "loop_images_per_s": [logs[e]["images_per_sec"]
                                  for e in range(CLI_EPOCHS)],
            "bare_step_images_per_s": bare_ips,
            "val_AP": [_ap(out, e)["AP"] for e in range(CLI_EPOCHS)],
            "card": card_line()}))

        # The matcher at these shapes: the auction against the JV host
        # solve on the same costs, from the trained model's predictions.
        det = state["s"].params
        cfg16 = dataclasses.replace(
            detector_config_for_model_name("facebook/dinov2-base"),
            backbone=dataclasses.replace(
                detector_config_for_model_name(
                    "facebook/dinov2-base").backbone, dtype="bfloat16"))
        from dinov2_od_tpu_torch.data.packed import PackedDataset
        from dinov2_od_tpu_torch.config import TrainConfig

        batch = PackedDataset(splits["train"]).get_batch(range(CLI_BATCH))
        gt = [torch.from_numpy(batch[k]).cuda()
              for k in ("labels", "boxes", "valid")]
        pred = make_eval_step(TrainConfig(detector=cfg16))(
            det, torch.from_numpy(batch["images"]).cuda())
        args = (pred["pred_logits"], pred["pred_boxes"], *gt)
        auction_cfg, jv_cfg = MatcherConfig(), MatcherConfig(assignment="jv")
        cost = matching.matching_cost_matrix(*args, auction_cfg)
        # The auction on the card (one kernel launch a solve) against its
        # eager run on the CPU, on the inputs the matcher gives it: the
        # same assignment bit for bit, in as many rounds.
        seen, real_auction = [], matching.auction_assign
        matching.auction_assign = (
            lambda *a, **k: seen.append((a, k)) or real_auction(*a, **k))
        try:
            matching.hungarian_match(*args, auction_cfg)
        finally:
            matching.auction_assign = real_auction
        a_args, a_kw = seen[0]
        on_card = real_auction(*a_args, **a_kw)
        on_cpu = real_auction(*(x.cpu() for x in a_args), **a_kw)
        if not (torch.equal(on_card[0].cpu(), on_cpu[0])
                and on_card[1] == on_cpu[1]):
            raise AssertionError(f"the auction on the card ({on_card[1]} "
                                 f"rounds) differs from its CPU run "
                                 f"({on_cpu[1]} rounds)")
        log(f"train cli: the auction on the card equals its eager CPU run "
            f"on the matcher's inputs ({on_card[1]} rounds, "
            f"{int((on_card[0] >= 0).sum())} columns assigned)")
        for _ in range(2):  # warm both (scipy's import included)
            matching.hungarian_match(*args, auction_cfg)
            hungarian_assign_batched(cost, gt[2])
        torch.cuda.synchronize()
        matching.reset_solver_stats()
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            a = matching.hungarian_match(*args, auction_cfg)
        torch.cuda.synchronize()
        auction_ms = (time.perf_counter() - t0) / reps * 1e3
        rounds = matching.solver_stats["auction_rounds"] / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            j = matching.hungarian_match(*args, jv_cfg)
        torch.cuda.synchronize()
        jv_ms = (time.perf_counter() - t0) / reps * 1e3
        c = cost.cpu().numpy()
        totals = [float(sum(c[b][q[b][m[b]].cpu().numpy(),
                                  np.nonzero(m[b].cpu().numpy())[0]].sum()
                            for b in range(CLI_BATCH)))
                  for q, m in ((a.query_of_gt, a.match_valid),
                               (j.query_of_gt, j.match_valid))]
        log("train cli: " + json.dumps({
            "metric": "matcher a criterion call, batch 32, 50 queries, 100 "
                      "GT slots (1-4 valid), host clock around a synchronise",
            "auction_ms": auction_ms, "auction_rounds": rounds,
            "jv_host_ms": jv_ms, "auction_total_cost": totals[0],
            "jv_total_cost": totals[1], "card": card_line()}))

        # Checkpoint save and restore of the final state, timed.
        s = state["s"]
        t0 = time.perf_counter()
        path = ckpt.save_checkpoint(root, 99, s.params, s.opt_state, 0.0,
                                    step=s.step)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ckpt.restore_checkpoint(path, s.params, s.opt_state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(path, ckpt.STATE_FILE))
        log("train cli: " + json.dumps({
            "metric": "checkpoint of the ViT-B train state (bf16 frozen "
                      "backbone, fp32 trainable leaves and Adam moments)",
            "save_s": save_s, "restore_s": restore_s, "bytes": size,
            "card": card_line()}))

        # Resume: epoch 1 again from checkpoint_epoch_0.
        out_r = os.path.join(root, "resume")
        rc = cli.main(common + ["--output_dir", out_r, "--checkpoint",
                                os.path.join(out, "checkpoint_epoch_0")])
        last = CLI_EPOCHS - 1
        again = _epoch_logs(out_r, [last])[last]
        if rc != 0 or again["steps"] != logs[last]["steps"]:
            raise AssertionError(f"resume: rc {rc}, steps {again['steps']}")
        first, ref = np.array(again["losses"]), np.array(logs[last]["losses"])
        rel = np.abs(first - ref) / np.abs(ref)
        mean_rel = abs(first.mean() - ref.mean()) / abs(ref.mean())
        log(f"train cli: resumed from checkpoint_epoch_0, epoch {last}'s "
            f"{len(first)} losses against the uninterrupted run's: first "
            f"step {rel[0]:.3g} relative (limit {CLI_RESUME_FIRST_TOL}), "
            f"the others at most {rel.max():.3g} (limit {CLI_RESUME_TOL}), "
            f"the mean {mean_rel:.3g} (limit {CLI_RESUME_MEAN_TOL})")
        if not (rel[0] <= CLI_RESUME_FIRST_TOL and rel.max() <= CLI_RESUME_TOL
                and mean_rel <= CLI_RESUME_MEAN_TOL):
            raise AssertionError(f"resume: losses off by {rel.tolist()}")

        # Evaluation of the final model, bf16 and int8.
        final = os.path.join(out, "final_model")
        aps = {}
        for quant in ("bf16", "int8"):
            extra = ["--quantize", "int8"] if quant == "int8" else []
            ev_out = os.path.join(root, f"eval_{quant}")
            _build.reset_launch_counts()
            rc = cli.main(common + ["--only_evaluate", "--checkpoint", final,
                                    "--output_dir", ev_out] + extra)
            torch.cuda.synchronize()
            ev_counts = _launches()
            aps[quant] = _ap(ev_out, 0)
            want = _counts(flash_attn_fwd=12 * val_batches,
                           int8_gemm=12 * val_batches if extra else 0)
            if rc != 0 or ev_counts != want:
                raise AssertionError(f"{quant} evaluation: rc {rc}, "
                                     f"launches {ev_counts}, expected {want}")
            if quant == "int8":
                kernels["int8_gemm"]["launches"] += ev_counts["int8_gemm"]
                kernels["int8_gemm"]["launches_train_cli_int8_eval"] = (
                    ev_counts["int8_gemm"])
        gap = abs(aps["int8"]["AP"] - aps["bf16"]["AP"])
        log(f"train cli: --only_evaluate on final_model: AP bf16 "
            f"{aps['bf16']['AP']:.4f}, int8 {aps['int8']['AP']:.4f} (gap "
            f"{gap:.4f}, limit {CLI_INT8_AP_TOL}); AP50 "
            f"{aps['bf16']['AP50']:.4f} / {aps['int8']['AP50']:.4f}")
        if not gap <= CLI_INT8_AP_TOL:
            raise AssertionError(f"int8 AP off the bf16 AP by {gap}")

        # Predictor.from_checkpoint against a Predictor on the loop's final
        # params in memory: the same detections on 32 val images.
        val = PackedDataset(splits["val"]).get_batch(range(32))
        images = list(val["images"].astype(np.float32) / 255.0)
        served = Predictor.from_checkpoint(final, detector_cfg=cfg16,
                                           batch_size=32)
        direct = Predictor(s.params, cfg16, batch_size=32)
        same_params = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(served.params), tree_leaves(direct.params)))
        got = served.detect(images, score_threshold=0.0)
        ref = direct.detect(images, score_threshold=0.0)
        if not same_params or got != ref:
            raise AssertionError(f"from_checkpoint: params equal "
                                 f"{same_params}; detections differ from "
                                 f"the in-memory Predictor's")
        log(f"train cli: Predictor.from_checkpoint(final_model) holds the "
            f"in-memory Predictor's params bit for bit and gives its "
            f"{sum(map(len, got))} detections on 32 val images exactly")
        del served, direct, det, s, state
        torch.cuda.empty_cache()

        serve_counts = _cli_serve(final, seed, image_size)
        kernels["flash_attn_fwd"]["launches"] += serve_counts[
            "flash_attn_fwd"]
    return logs[CLI_EPOCHS - 1]["images_per_sec"]


# HF Dinov2 names of each block linear, by the port's leaf name.
HF_BLOCK_LINEARS = {"q": "attention.attention.query",
                    "k": "attention.attention.key",
                    "v": "attention.attention.value",
                    "proj": "attention.output.dense",
                    "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def _hf_state_dict(seed: int, bb, grid: int = IMPORT_SRC_GRID) -> dict:
    """A random state dict under HF Dinov2Model's key names for the
    backbone `bb` at a `grid` x `grid` patch grid (37: DINOv2's 518 px),
    fp32 on the CPU, drawn from `seed` with the port's init distributions
    (nn.Linear's uniform, truncated normals of std 0.02 for the
    embeddings, unit norms and LayerScale)."""
    import math

    import torch

    gen = torch.Generator().manual_seed(seed)
    d, m = bb.hidden_dim, bb.mlp_dim
    shapes = {"q": (d, d), "k": (d, d), "v": (d, d), "proj": (d, d),
              "fc1": (m, d), "fc2": (d, m)}

    def uniform(*shape, fan_in):
        return (torch.rand(shape, generator=gen) * 2 - 1) / math.sqrt(fan_in)

    def normal(*shape):
        return torch.randn(shape, generator=gen).clamp_(-2, 2) * 0.02

    sd = {"embeddings.cls_token": normal(1, 1, d),
          "embeddings.mask_token": torch.zeros(1, d),
          "embeddings.position_embeddings": normal(1, 1 + grid * grid, d),
          "embeddings.patch_embeddings.projection.weight": normal(
              d, 3, bb.patch_size, bb.patch_size),
          "embeddings.patch_embeddings.projection.bias": torch.zeros(d),
          "layernorm.weight": torch.ones(d), "layernorm.bias": torch.zeros(d)}
    for i in range(bb.depth):
        pre = f"encoder.layer.{i}."
        for ours, hf in HF_BLOCK_LINEARS.items():
            n_out, n_in = shapes[ours]
            sd[pre + hf + ".weight"] = uniform(n_out, n_in, fan_in=n_in)
            sd[pre + hf + ".bias"] = uniform(n_out, fan_in=n_in)
        for norm in ("norm1", "norm2"):
            sd[pre + norm + ".weight"] = torch.ones(d)
            sd[pre + norm + ".bias"] = torch.zeros(d)
        for scale in ("layer_scale1", "layer_scale2"):
            sd[pre + scale + ".lambda1"] = torch.full((d,),
                                                      bb.layerscale_init)
    return sd


def _check_hf_import(bb, sd: dict, imported: dict) -> int:
    """Every leaf the importer copies equals its source exactly (moved to
    the CPU; linear weights transposed, the patch kernel OIHW -> HWIO),
    and pos_embed is the 37 x 37 -> 16 x 16 resample run on the CPU.
    Returns the number of leaves checked."""
    import torch

    from dinov2_od_tpu_torch.models.vit import interpolate_pos_embed

    pairs = [
        (imported["patch_embed"]["kernel"],
         sd["embeddings.patch_embeddings.projection.weight"]
         .permute(2, 3, 1, 0)),
        (imported["patch_embed"]["bias"],
         sd["embeddings.patch_embeddings.projection.bias"]),
        (imported["cls_token"], sd["embeddings.cls_token"]),
        (imported["pos_embed"], interpolate_pos_embed(
            sd["embeddings.position_embeddings"], IMPORT_SRC_GRID,
            bb.grid_size)),
        (imported["ln_f"]["scale"], sd["layernorm.weight"]),
        (imported["ln_f"]["bias"], sd["layernorm.bias"]),
    ]
    blocks = imported["blocks"]
    for i in range(bb.depth):
        pre = f"encoder.layer.{i}."
        for ours, hf in HF_BLOCK_LINEARS.items():
            pairs += [(blocks[ours]["kernel"][i], sd[pre + hf + ".weight"].t()),
                      (blocks[ours]["bias"][i], sd[pre + hf + ".bias"])]
        pairs += [(blocks["ln1"]["scale"][i], sd[pre + "norm1.weight"]),
                  (blocks["ln1"]["bias"][i], sd[pre + "norm1.bias"]),
                  (blocks["ln2"]["scale"][i], sd[pre + "norm2.weight"]),
                  (blocks["ln2"]["bias"][i], sd[pre + "norm2.bias"]),
                  (blocks["ls1"][i], sd[pre + "layer_scale1.lambda1"]),
                  (blocks["ls2"][i], sd[pre + "layer_scale2.lambda1"])]
    bad = [n for n, (got, want) in enumerate(pairs)
           if got.dtype != torch.float32 or not torch.equal(got.cpu(), want)]
    if bad or imported["pos_embed"].shape != (1, bb.seq_len, bb.hidden_dim):
        raise AssertionError(f"import: {len(bad)} of {len(pairs)} leaves "
                             f"differ from their source (first: {bad[:5]})")
    return len(pairs)


def _bundle_checks(model, predictor, pixel, sizes, quantize, bb):
    """One bundle against a Predictor over the same params and config:
    call_packed on BUNDLE_IMAGES images bit for bit against the
    Predictor's batch-32 forward plus top-k; 41 images chunked as
    _chunks gives them (32, then 9 padded onto 32), each chunk bit for
    bit; 3 images padded onto 8 equal to the first 3 of an 8-image call;
    1 image on the b1 size. Returns (launch counts, device batches)."""
    import torch

    from dinov2_od_tpu_torch.ops import _build

    def ref(x, s):
        pad = BUNDLE_IMAGES - len(x)
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        s = np.concatenate([s, np.ones((pad, 2), s.dtype)])
        out = predictor._forward_topk(predictor._upload(x),
                                      predictor._upload(s), 100)
        return out[:BUNDLE_IMAGES - pad].cpu().numpy()

    want32 = ref(pixel[:32], sizes[:32])
    want_tail = ref(pixel[32:41], sizes[32:41])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    model.device_batches = 0
    got32 = model.call_packed(pixel[:32], sizes[:32])
    got41 = model.call_packed(pixel[:41], sizes[:41])
    got8 = model.call_packed(pixel[:8], sizes[:8])
    got3 = model.call_packed(pixel[:3], sizes[:3])
    got1 = model.call_packed(pixel[:1], sizes[:1])
    torch.cuda.synchronize()
    counts = _launches()
    batches = model.device_batches
    chunks = [model._chunks(n) for n in (32, 41, 8, 3, 1)]
    want_chunks = [[(0, 32)], [(0, 32), (32, 32)], [(0, 8)], [(0, 8)],
                   [(0, 1)]]
    what = f"bundle {quantize or 'bf16'}"
    if chunks != want_chunks:
        raise AssertionError(f"{what}: chunks {chunks}, expected "
                             f"{want_chunks}")
    checks = {
        "32 images == Predictor(batch_size=32)": np.array_equal(got32,
                                                                want32),
        "41 images: chunk 0 == the 32-image call": np.array_equal(
            got41[:32], got32),
        "41 images: 9 padded onto 32 == the Predictor's": np.array_equal(
            got41[32:], want_tail),
        "3 images padded onto 8 == the first 3 of an 8-image call":
            np.array_equal(got3, got8[:3]),
        "1 image on b1: finite, [1, 100, 6]": got1.shape == (1, 100, 6)
            and bool(np.isfinite(got1).all()),
    }
    log(f"import export: {what}: " + ", ".join(
        f"{k}: {v}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"{what} differs from the Predictor")
    want = _counts(flash_attn_fwd=bb.depth * batches,
                   int8_gemm=bb.depth * batches if quantize else 0)
    if counts != want or batches != 6:
        raise AssertionError(f"{what}: launches {counts} for {batches} "
                             f"device batches; expected {want} "
                             f"({bb.depth} B1{' and B6' if quantize else ''}"
                             f" a forward, 6 forwards)")
    return counts, batches


def _bundle_serve(bundle: str, model, images_u8,
                  phase: str = "import export") -> dict:
    """serve.main --bundle in a thread on a free port: POST /detect with
    PNG bodies answers what ServingModel.detect returns on the decoded
    images, and B1 runs 12 times a device batch of the server's model
    (the warm-up included)."""
    import base64
    import io
    import urllib.request

    from PIL import Image

    from dinov2_od_tpu_torch.ops import _build

    def png(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    body = json.dumps({"images": [png(a) for a in images_u8],
                       "score_threshold": 0.0}).encode()
    args = ["--bundle", bundle, "--host", "127.0.0.1", "--port", "0",
            "--max_batch", "32", "--batch_wait_ms", "20"]
    _build.reset_launch_counts()
    with _serve_main(args) as server:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.load(r)
        req = urllib.request.Request(
            url + "/detect", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            answer = json.load(r)["detections"]
        served_batches = server.RequestHandlerClass.model.device_batches
    counts = _launches()
    want = model.detect([a.astype(np.float32) / 255.0 for a in images_u8],
                        score_threshold=0.0)
    want_counts = _counts(flash_attn_fwd=12 * served_batches)
    if (health.get("model") != "bundle:" + bundle or answer != want
            or not all(len(d) for d in answer)):
        raise AssertionError(f"serve.main --bundle answered {health}, "
                             f"detections equal to ServingModel.detect's: "
                             f"{answer == want}")
    if counts != want_counts:
        raise AssertionError(f"serve.main --bundle launches {counts} for "
                             f"{served_batches} device batches; expected "
                             f"{want_counts}")
    log(f"{phase}: serve.main --bundle: /healthz {health}; POST "
        f"/detect of {len(images_u8)} PNG images answered "
        f"ServingModel.detect's {sum(map(len, answer))} detections "
        f"exactly; {served_batches} device batches (the warm-up "
        f"included), launches {counts}")
    return counts


def phase_import_export(seed: int, kernels: dict) -> None:
    """Pretrained weights in and serving bundles out at ViT-B/14 224 px:
    an HF-named state dict (518 px grid) through the importer and an eval
    forward against plain attention; `train.cli.main --pretrained_backbone`
    for one epoch; its final params through save_reference_checkpoint and
    back through `--import_reference_checkpoint --only_evaluate` to the
    same validation AP; tools/export.main to a bf16 and an int8 bundle,
    each against a Predictor over the same params bit for bit; and
    `serve.main --bundle` over HTTP."""
    import os
    import tempfile

    import torch

    from dinov2_od_tpu_torch.config import detector_config_for_model_name
    from dinov2_od_tpu_torch.data.packed import PackedDataset
    from dinov2_od_tpu_torch.export import load_serving_bundle
    from dinov2_od_tpu_torch.inference import (Predictor, checkpoint_params,
                                               prepare_images)
    from dinov2_od_tpu_torch.models.detector import (
        detector_apply, fold_detector_lora, init_detector_params)
    from dinov2_od_tpu_torch.models.export_reference import (
        save_reference_checkpoint)
    from dinov2_od_tpu_torch.models.import_torch import (
        load_dinov2_backbone_params)
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.tools import export as export_tool
    from dinov2_od_tpu_torch.train import cli

    t_phase = time.perf_counter()
    image_size = 224
    cfg = detector_config_for_model_name("facebook/dinov2-base",
                                         image_size=image_size)
    cfg16 = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="bfloat16"))
    bb = cfg.backbone
    steps = IMPORT_TRAIN_IMAGES // CLI_BATCH
    val_batches = -(-CLI_VAL_IMAGES // CLI_BATCH)
    timings = {}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="import_export_",
                                     dir=build) as root:
        # 1. The HF importer on a 518 px checkpoint, into 224 px.
        hf_dir = os.path.join(root, "hf")
        os.makedirs(hf_dir)
        sd = _hf_state_dict(seed, bb)
        torch.save(sd, os.path.join(hf_dir, "pytorch_model.bin"))
        template = init_detector_params(torch.Generator().manual_seed(0),
                                        cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imported = load_dinov2_backbone_params(hf_dir, bb,
                                               template["backbone"])
        torch.cuda.synchronize()
        timings["hf_import_s"] = time.perf_counter() - t0
        n_leaves = _check_hf_import(bb, sd, imported)
        log(f"import export: HF state dict of ViT-B/14 at 518 px "
            f"({len(sd)} tensors, position grid {IMPORT_SRC_GRID}^2) "
            f"imported into {image_size} px in {timings['hf_import_s']:.2f} "
            f"s; {n_leaves} copied leaves equal their sources exactly, "
            f"pos_embed equal to the {IMPORT_SRC_GRID} -> {bb.grid_size} "
            f"resample on the CPU")
        del sd

        # The imported model's eval forward: the kernel against plain
        # attention, with controls (keys dropped) that must fail.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        params = fold_detector_lora({**template, "backbone": imported}, cfg)
        pixels, _ = prepare_images(_requests(seed, image_size, (32,))[0],
                                   image_size, normalize=True)
        x = torch.from_numpy(pixels).to("cuda")
        with torch.inference_mode():
            ref = detector_apply(params, cfg, x, attn_impl="xla")
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            runs = {"kernel": detector_apply(params, cfg, x,
                                             attn_impl="auto")}
            torch.cuda.synchronize()
            fwd_counts = _launches()
            for kv_len in CONTROLS:
                with _keys_dropped(kv_len):
                    runs[f"control kv_len={kv_len}"] = detector_apply(
                        params, cfg, x, attn_impl="auto")
        if fwd_counts != _counts(flash_attn_fwd=bb.depth):
            raise AssertionError(f"import: the b32 forward launched "
                                 f"{fwd_counts}; expected {bb.depth} B1")
        _check_model("import export: imported ViT-B detector_apply float32",
                     "plain attention", runs, ref, MODEL_TOL["float32"],
                     _max_abs, "max abs err")
        del params, runs, ref, x, template, imported
        torch.cuda.empty_cache()

        # 2. The CLI from the HF directory, then the reference round trip.
        splits = _cli_splits(seed, root, image_size,
                             n_train=IMPORT_TRAIN_IMAGES)
        common = ["--packed_train_data", splits["train"],
                  "--packed_val_data", splits["val"],
                  "--dino_model", "facebook/dinov2-base",
                  "--image_size", str(image_size),
                  "--backbone_dtype", "bfloat16",
                  "--batch_size", str(CLI_BATCH), "--num_epochs", "1",
                  "--val_frequency", "1", "--log_frequency", "5"]
        out = os.path.join(root, "pretrained")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(common + ["--pretrained_backbone", hf_dir,
                                "--output_dir", out])
        torch.cuda.synchronize()
        timings["cli_pretrained_s"] = time.perf_counter() - t0
        counts = _launches()
        want = _counts(flash_attn_fwd=bb.depth * (steps + val_batches),
                       flash_attn_bwd=2 * steps)
        logs = _epoch_logs(out, [0])[0]
        log(f"import export: train.cli.main --pretrained_backbone: rc {rc} "
            f"in {timings['cli_pretrained_s']:.1f} s, {steps} steps, mean "
            f"loss {logs['mean_loss']}, launches {counts}")
        if rc != 0 or counts != want:
            raise AssertionError(f"--pretrained_backbone run: rc {rc}, "
                                 f"launches {counts}, expected {want}")
        if not np.isfinite(logs["losses"]).all():
            raise AssertionError(f"--pretrained_backbone losses: "
                                 f"{logs['losses']}")
        trained = _ap(out, 0)
        for name in ("flash_attn_fwd", "flash_attn_bwd"):
            kernels[name]["launches"] += counts[name]
            kernels[name]["launches_import_export_cli"] = counts[name]

        final = os.path.join(out, "final_model")
        final_params = checkpoint_params(final, cfg16, "cuda")
        ref_file = os.path.join(root, "reference.pt")
        t0 = time.perf_counter()
        save_reference_checkpoint(ref_file, final_params, cfg16)
        timings["reference_save_s"] = time.perf_counter() - t0
        ev_out = os.path.join(root, "reference_eval")
        _build.reset_launch_counts()
        rc = cli.main(common + ["--only_evaluate",
                                "--import_reference_checkpoint", ref_file,
                                "--output_dir", ev_out])
        torch.cuda.synchronize()
        counts = _launches()
        migrated = _ap(ev_out, 0)
        log(f"import export: the run's final params through "
            f"save_reference_checkpoint ({os.path.getsize(ref_file)} bytes "
            f"in {timings['reference_save_s']:.2f} s) and "
            f"--import_reference_checkpoint --only_evaluate: AP "
            f"{migrated['AP']} against the run's final validation AP "
            f"{trained['AP']} (AP50 {migrated['AP50']} / "
            f"{trained['AP50']}), launches {counts}")
        if rc != 0 or counts != _counts(flash_attn_fwd=bb.depth
                                        * val_batches):
            raise AssertionError(f"reference evaluation: rc {rc}, launches "
                                 f"{counts}")
        if migrated != trained:
            raise AssertionError(f"the migrated checkpoint's metrics "
                                 f"{migrated} differ from the run's "
                                 f"{trained}")
        kernels["flash_attn_fwd"]["launches"] += counts["flash_attn_fwd"]

        # 3. The serving bundles, bf16 and int8, from the final checkpoint.
        val = PackedDataset(splits["val"]).get_batch(range(BUNDLE_IMAGES + 9))
        images = list(val["images"].astype(np.float32) / 255.0)
        pixel, sizes = prepare_images(images, image_size, normalize=True)
        x32 = torch.from_numpy(pixel[:32]).to("cuda")
        s32 = torch.from_numpy(sizes[:32]).to("cuda")
        for quantize in (None, "int8"):
            what = quantize or "bf16"
            bundle = os.path.join(root, f"bundle_{what}")
            t0 = time.perf_counter()
            rc = export_tool.main(
                ["--checkpoint", final, "--output_dir", bundle,
                 "--image_size", str(image_size), "--batch_sizes",
                 ",".join(map(str, BUNDLE_BATCHES)),
                 "--backbone_dtype", "bfloat16"]
                + (["--quantize", quantize] if quantize else []))
            timings[f"export_{what}_s"] = time.perf_counter() - t0
            size = sum(os.path.getsize(os.path.join(bundle, f))
                       for f in os.listdir(bundle))
            t0 = time.perf_counter()
            model = load_serving_bundle(bundle)
            torch.cuda.synchronize()
            timings[f"load_{what}_s"] = time.perf_counter() - t0
            if rc != 0 or sorted(os.listdir(bundle)) != ["manifest.json",
                                                         "params.npz"]:
                raise AssertionError(f"tools/export {what}: rc {rc}")
            predictor = Predictor(final_params, cfg16, batch_size=32,
                                  quantize=quantize)
            counts, batches = _bundle_checks(model, predictor, pixel, sizes,
                                             quantize, bb)
            kernels["flash_attn_fwd"]["launches"] += counts["flash_attn_fwd"]
            kernels["flash_attn_fwd"][f"launches_bundle_{what}"] = counts[
                "flash_attn_fwd"]
            if quantize:
                kernels["int8_gemm"]["launches"] += counts["int8_gemm"]
                kernels["int8_gemm"]["launches_bundle_int8"] = counts[
                    "int8_gemm"]
            bundle_ms, pred_ms = (
                time_ms(lambda p=p: p._forward_topk(x32, s32, 100), iters=5,
                        warmup=3, repeats=3)
                for p in (model._predictor, predictor))
            log("import export: " + json.dumps({
                "metric": f"serving bundle ({what}): tools/export and load "
                          f"times, the b32 forward + top-k of the bundle's "
                          f"model and of a Predictor over the same params",
                "export_s": timings[f"export_{what}_s"],
                "load_s": timings[f"load_{what}_s"], "bytes": size,
                "bundle_ms_per_batch": bundle_ms,
                "predictor_ms_per_batch": pred_ms, "card": card_line()}))
            if quantize is None:
                u8 = val["images"][:5]
                serve_counts = _bundle_serve(bundle, model, u8)
                kernels["flash_attn_fwd"]["launches"] += serve_counts[
                    "flash_attn_fwd"]
            del model, predictor
            torch.cuda.empty_cache()
        del final_params
        torch.cuda.empty_cache()
    timings["phase_s"] = time.perf_counter() - t_phase
    log("import export: " + json.dumps({
        "metric": "phase wall time and its parts (host clock)",
        **timings, "card": card_line()}))


def _moe_dets(**backbone):
    """bench.py's BENCH_FFN=moe configuration: ViT-B/14 224 px + 3-layer
    deformable DETR, the MoE FFN (8 experts, top-2, capacity factor 1.25,
    aux weight 0.01) in the 2 adapted blocks; (fp32, bf16 backbone)."""
    return _train_dets(ffn_type_override="moe", **backbone)


def _moe_routing_check(seed: int) -> None:
    """moe_routing on one fp32 logits tensor [32, 257, 8], with tied rows,
    on the CPU and on the card: the same experts and slots for every
    token, combine and aux within MOE_ROUTING_TOL."""
    import torch

    from dinov2_od_tpu_torch.ops.moe import moe_capacity, moe_routing

    e, k, cf = 8, 2, 1.25
    cap = moe_capacity(S, e, k, cf)
    logits = torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1.0, (B, S, e)).astype(np.float32))
    logits[0, 0] = torch.tensor([np.log(0.9)] + [np.log(0.1 / 7)] * 7)
    logits[0, 1] = 0.0
    cpu = moe_routing(logits, k, cap)
    card = moe_routing(logits.cuda(), k, cap)
    torch.cuda.synchronize()
    combine, aux = (t.cpu() for t in card)
    same_support = torch.equal(combine > 0, cpu[0] > 0)
    err = (combine - cpu[0]).abs().max().item()
    aux_err = abs(aux.item() - cpu[1].item())
    bits = torch.equal(combine, cpu[0]) and aux.item() == cpu[1].item()
    tied = [torch.nonzero(combine[0, t].sum(-1) > 0).ravel().tolist()
            for t in (0, 1)]
    log(f"moe: moe_routing [{B}, {S}, {e}] fp32, top-{k}, capacity {cap}: "
        f"card against CPU: the same experts and slots {same_support}, "
        f"combine max abs err {err:.3g}, aux {aux.item():.6f} err "
        f"{aux_err:.3g} (tol {MOE_ROUTING_TOL}), bit-equal {bits}; "
        f"{int((combine > 0).sum())} of {B * S * k} assignments kept; the "
        f"tied rows chose experts {tied}")
    if not (same_support and err <= MOE_ROUTING_TOL
            and aux_err <= MOE_ROUTING_TOL and tied == [[0, 1], [0, 1]]):
        raise AssertionError("moe: routing on the card differs from the "
                             "CPU's")


@contextlib.contextmanager
def _routing_recorded(into: list):
    """Each routing (ops/moe.py `route`) of the model appends the experts
    every token reaches, [B, N, E] bool (a dropped assignment reaches
    none)."""
    from dinov2_od_tpu_torch.ops import moe

    real = moe.route

    def recorded(*args, **kwargs):
        combine, probs, top1 = real(*args, **kwargs)
        into.append(combine.sum(-1) > 0)
        return combine, probs, top1

    moe.route = recorded
    try:
        yield
    finally:
        moe.route = real


def _moe_forward_check(seed: int, kernels: dict) -> None:
    """The b32 eval forward with the kernels (exactly 12 B1) against plain
    attention, fp32 and bf16, and the tokens whose experts differ between
    the two; the same forward at top-1 as the control."""
    import torch

    from dinov2_od_tpu_torch.inference import prepare_images
    from dinov2_od_tpu_torch.models.detector import (
        cast_frozen_weights, detector_apply, fold_detector_lora,
        init_detector_params)
    from dinov2_od_tpu_torch.ops import _build

    det32, det16 = _moe_dets()
    params = fold_detector_lora(init_detector_params(
        torch.Generator().manual_seed(seed), det32, device="cuda"), det32)
    pixels, _ = prepare_images(_requests(seed, 224, (B,))[0], 224,
                               normalize=True)
    x = torch.from_numpy(pixels).to("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, c, p in (("float32", det32, params),
                       ("bfloat16", det16, cast_frozen_weights(params,
                                                               det16))):
        top1 = dataclasses.replace(c, backbone=dataclasses.replace(
            c.backbone, moe_top_k=1))
        plain_routes, kernel_routes = [], []
        with torch.inference_mode():
            with _routing_recorded(plain_routes):
                ref = detector_apply(p, c, x, attn_impl="xla")
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            with _routing_recorded(kernel_routes):
                runs = {"kernel": detector_apply(p, c, x, attn_impl="auto")}
            torch.cuda.synchronize()
            counts = _launches()
            runs["control top-1"] = detector_apply(p, top1, x,
                                                   attn_impl="auto")
        aux = runs["kernel"]["moe_aux"].item()
        moved = [int((a != b).any(-1).sum())
                 for a, b in zip(plain_routes, kernel_routes)]
        log(f"moe: b{B} forward {name}: launches {counts}, moe_aux "
            f"{aux:.4f} (plain attention {ref['moe_aux'].item():.4f}); "
            f"tokens whose experts differ from plain attention's, by MoE "
            f"block: {moved} of {B * S}; max abs err "
            + ", ".join(f"{k} {_max_abs(runs['kernel'][k], ref[k]):.4g}"
                        for k in OUTPUTS))
        if counts != _counts(flash_attn_fwd=det32.backbone.depth):
            raise AssertionError(f"moe forward launched {counts}; expected "
                                 f"{det32.backbone.depth} B1")
        if not np.isfinite(aux):
            raise AssertionError(f"moe forward: moe_aux {aux}")
        kernels["flash_attn_fwd"]["launches"] += counts["flash_attn_fwd"]
        if name == "float32":
            _check_model(f"moe: detector_apply {name}", "plain attention",
                         runs, ref, MOE_MODEL_TOL[name], _max_abs,
                         "max abs err")
        else:
            _check_model(f"moe: detector_apply {name}", "plain attention",
                         runs, ref, MOE_MODEL_TOL[name], _rel_norm,
                         "rel err")
    del params, runs, ref, x
    torch.cuda.empty_cache()


def _moe_serving(seed: int, kernels: dict, dense_ips: dict) -> None:
    """Predictor over the MoE model in bf16 (12 B1 a forward) and int8 (12
    B1 + 10 B6: the dense prefix's fc2s) on 32 images, and the b32
    forward's images/s beside the dense model's."""
    import torch

    from dinov2_od_tpu_torch.inference import Predictor
    from dinov2_od_tpu_torch.models.detector import (
        cast_frozen_weights, init_detector_params)
    from dinov2_od_tpu_torch.ops import _build

    _, det16 = _moe_dets()
    bb = det16.backbone
    prefix = bb.depth - bb.lora_last_n_blocks
    params = cast_frozen_weights(init_detector_params(
        torch.Generator().manual_seed(seed), det16, device="cuda"), det16)
    images = _requests(seed, bb.image_size, (B,))[0]
    for quantize in (None, "int8"):
        what = quantize or "bf16"
        predictor = Predictor(params, det16, batch_size=B, device="cuda",
                              quantize=quantize)
        predictor.device_batches = 0
        _build.reset_launch_counts()
        dets = predictor.detect(images, score_threshold=0.0)
        torch.cuda.synchronize()
        counts = _launches()
        n = predictor.device_batches
        want = _counts(flash_attn_fwd=bb.depth * n,
                       int8_gemm=prefix * n if quantize else 0)
        if counts != want or n != 1 or len(dets) != B or not all(
                np.isfinite([d["score"] for d in im]).all() for im in dets):
            raise AssertionError(f"moe {what} serving: launches {counts} in "
                                 f"{n} device batches, expected {want}")
        kernels["flash_attn_fwd"]["launches"] += counts["flash_attn_fwd"]
        kernels["flash_attn_fwd"][f"launches_moe_{what}_serving"] = counts[
            "flash_attn_fwd"]
        if quantize:
            kernels["int8_gemm"]["launches"] += counts["int8_gemm"]
            kernels["int8_gemm"]["launches_moe_int8_serving"] = counts[
                "int8_gemm"]
        ms, _ = _forward_ms(predictor, bb.image_size)
        log("moe: " + json.dumps({
            "metric": f"batch-32 forward + top-k, {what} backbone, MoE FFN "
                      f"(E {bb.moe_num_experts}, top-{bb.moe_top_k}) in the "
                      f"last {bb.lora_last_n_blocks} blocks",
            "launches_per_forward": counts, "ms_per_batch": ms,
            "images_per_s": B / ms * 1e3,
            "dense_images_per_s": dense_ips[what], "card": card_line()}))
        del predictor
        torch.cuda.empty_cache()


def _moe_cli(seed: int, kernels: dict) -> None:
    """`train.cli.main --ffn_type moe` for one epoch on packed synthetic
    splits, `--only_evaluate` from its checkpoint, Predictor.from_checkpoint
    against a Predictor over the loop's final params, and the final params
    through export_serving_bundle and `serve.main --bundle`."""
    import os
    import tempfile

    import torch

    from dinov2_od_tpu_torch.data.packed import PackedDataset
    from dinov2_od_tpu_torch.export import (export_serving_bundle,
                                            load_serving_bundle)
    from dinov2_od_tpu_torch.inference import Predictor
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.train import cli, loop
    from dinov2_od_tpu_torch.train.state import tree_leaves

    _, det16 = _moe_dets()
    steps = MOE_CLI_TRAIN_IMAGES // CLI_BATCH
    val_batches = -(-MOE_CLI_VAL_IMAGES // CLI_BATCH)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="moe_", dir=build) as root:
        splits = _cli_splits(seed, root, 224, n_train=MOE_CLI_TRAIN_IMAGES,
                             n_val=MOE_CLI_VAL_IMAGES)
        common = ["--packed_train_data", splits["train"],
                  "--packed_val_data", splits["val"],
                  "--dino_model", "facebook/dinov2-base",
                  "--image_size", "224", "--backbone_dtype", "bfloat16",
                  "--batch_size", str(CLI_BATCH), "--num_epochs", "1",
                  "--val_frequency", "1", "--log_frequency", "1",
                  "--ffn_type", "moe"]
        det = cli.build_detector_config(cli.build_arg_parser().parse_args(
            common))
        if det.backbone != det16.backbone:
            raise AssertionError(f"the CLI's MoE backbone {det.backbone} is "
                                 f"not the bench's {det16.backbone}")
        out = os.path.join(root, "out")
        real_run, state = loop.run_training, {}

        def keep_state(*a, **k):
            state["s"] = real_run(*a, **k)
            return state["s"]

        loop.run_training = keep_state
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rc = cli.main(common + ["--output_dir", out])
        finally:
            loop.run_training = real_run
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launches()
        want = _counts(flash_attn_fwd=12 * (steps + val_batches),
                       flash_attn_bwd=2 * steps)
        rec = _epoch_logs(out, [0])[0]
        aux = rec.get("loss_moe_aux", [])
        log(f"moe: train.cli.main --ffn_type moe: rc {rc} in {wall:.1f} s, "
            f"{steps} steps, losses {rec['losses']}, loss_moe_aux {aux}, "
            f"AP {_ap(out, 0)['AP']}, launches {counts}")
        if rc != 0 or counts != want:
            raise AssertionError(f"moe cli: rc {rc}, launches {counts}, "
                                 f"expected {want}")
        if len(aux) != steps or not np.isfinite(aux + rec["losses"]).all():
            raise AssertionError(f"moe cli: train_epoch_0.json {rec}")
        for name in ("flash_attn_fwd", "flash_attn_bwd"):
            kernels[name]["launches"] += counts[name]
            kernels[name]["launches_moe_cli"] = counts[name]

        final = os.path.join(out, "final_model")
        ev_out = os.path.join(root, "eval")
        _build.reset_launch_counts()
        rc = cli.main(common + ["--only_evaluate", "--checkpoint", final,
                                "--output_dir", ev_out])
        torch.cuda.synchronize()
        counts = _launches()
        log(f"moe: --only_evaluate on final_model: rc {rc}, AP "
            f"{_ap(ev_out, 0)['AP']} (the run's last validation "
            f"{_ap(out, 0)['AP']}), launches {counts}")
        if rc != 0 or counts != _counts(flash_attn_fwd=12 * val_batches):
            raise AssertionError(f"moe evaluation: rc {rc}, launches "
                                 f"{counts}")
        kernels["flash_attn_fwd"]["launches"] += counts["flash_attn_fwd"]

        val = PackedDataset(splits["val"]).get_batch(range(B))
        images = list(val["images"].astype(np.float32) / 255.0)
        served = Predictor.from_checkpoint(final, detector_cfg=det,
                                           batch_size=B)
        direct = Predictor(state["s"].params, det, batch_size=B)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(served.params), tree_leaves(direct.params)))
        _build.reset_launch_counts()
        got = served.detect(images, score_threshold=0.0)
        torch.cuda.synchronize()
        counts = _launches()
        ref = direct.detect(images, score_threshold=0.0)
        log(f"moe: Predictor.from_checkpoint(final_model): params equal "
            f"the loop's {same}, detections on {B} val images equal "
            f"{got == ref}, launches {counts}")
        if not same or got != ref:
            raise AssertionError("moe: from_checkpoint differs from the "
                                 "in-memory Predictor")
        kernels["flash_attn_fwd"]["launches"] += counts["flash_attn_fwd"]

        bundle = export_serving_bundle(direct.params, det,
                                       os.path.join(root, "bundle"),
                                       batch_sizes=(8, 32), fold_lora=False)
        model = load_serving_bundle(bundle)
        if model.cfg != det:
            raise AssertionError(f"moe bundle config {model.cfg}")
        serve_counts = _bundle_serve(bundle, model, val["images"][:5],
                                     "moe")
        kernels["flash_attn_fwd"]["launches"] += serve_counts[
            "flash_attn_fwd"]
        del served, direct, model, state
        torch.cuda.empty_cache()


def phase_moe(seed: int, kernels: dict, bf16_ips: float, int8_ips: float,
              train_ips: float) -> None:
    """The MoE backbone FFN at bench.py's BENCH_FFN=moe configuration:
    routing on the card against the CPU, the b32 forward against plain
    attention with a top-1 control, 3 train steps (and 3 under remat),
    Predictor in bf16 and int8, and the CLI from a dataset to a checkpoint
    to the server."""
    t0 = time.perf_counter()
    _moe_routing_check(seed)
    _moe_forward_check(seed, kernels)
    _, det16 = _moe_dets()
    bb = det16.backbone
    for remat, want in ((False, _counts(flash_attn_fwd=bb.depth,
                                        flash_attn_bwd=2)),
                        (True, _counts(flash_attn_fwd=bb.depth + 2,
                                       flash_attn_bwd=2))):
        what = "moe remat train" if remat else "moe train"
        _, _, counts, ips = _drive_train(seed, det16, MOE_STEPS, want, what,
                                         False, use_remat=remat)
        for name in ("flash_attn_fwd", "flash_attn_bwd"):
            kernels[name]["launches"] += counts[name]
            kernels[name][f"launches_{what.replace(' ', '_')}"] = counts[name]
        log(f"{what}: images/s {ips:.1f} beside the dense step's "
            f"{train_ips:.1f} (phase train); {card_line()}")
    _moe_serving(seed, kernels, {"bf16": bf16_ips, "int8": int8_ips})
    _moe_cli(seed, kernels)
    log(f"moe: phase wall time {time.perf_counter() - t0:.1f} s (host "
        f"clock); {card_line()}")


def _recipe_params(seed: int, det):
    """Params from `seed` on the card with nonzero LoRA B (so every LoRA
    leaf has a gradient), the frozen weights in bf16 for a bf16 backbone."""
    import torch

    from dinov2_od_tpu_torch.models.detector import (
        cast_frozen_weights, init_detector_params)

    p = init_detector_params(torch.Generator().manual_seed(seed + 2), det,
                             device="cuda")
    lg = torch.Generator().manual_seed(seed + 3)
    for lin in p["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = (0.05 * torch.randn(
                lin["lora_B"].shape, generator=lg)).to("cuda")
    return cast_frozen_weights(p, det) if det.backbone.dtype == "bfloat16" \
        else p


def _clone_tree(t):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in t.items()}


def _rel_norm_tree(a: list, b: list) -> float:
    import torch

    num = torch.sqrt(sum(((x.float() - y.float()) ** 2).sum()
                         for x, y in zip(a, b)))
    den = torch.sqrt(sum((y.float() ** 2).sum() for y in b))
    return float(num / den)


def _recipe_remat(seed, kernels, cfg, det, batch):
    """Remat: 14 B1 + 2 B2 a step, the LoRA gradients bit-equal to the
    step's without it (a backward dropping keys as the control), peak
    memory and ms a step both ways."""
    import torch

    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.train.state import create_train_state
    from dinov2_od_tpu_torch.train.step import make_train_step, train_grads

    base = _recipe_params(seed, det)
    depth, adapted = det.backbone.depth, det.backbone.lora_last_n_blocks
    gen = torch.Generator(device="cuda")
    res = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, use_remat=remat)
        state = create_train_state(_clone_tree(base), c.optim, det)
        step = make_train_step(c)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            runs = {}
            for name in (("sound", "control") if remat else ("sound",)):
                ctx = (_bwd_keys_dropped(192) if name == "control"
                       else contextlib.nullcontext())
                with ctx:
                    gen.manual_seed(seed)
                    metrics, grads = train_grads(c, state, batch, gen)
                runs[name] = (metrics["loss"],
                              [g.clone() for g in _tree_lora(grads)],
                              [g.clone() for g in _tree_decoder(grads)])
        finally:
            torch.use_deterministic_algorithms(False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        for _ in range(RECIPE_STEPS):
            gen.manual_seed(seed)
            state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        counts = _launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = _counts(flash_attn_fwd=(depth + adapted * remat) * RECIPE_STEPS,
                       flash_attn_bwd=adapted * RECIPE_STEPS)
        if counts != want or not np.isfinite(float(m["loss"])):
            raise AssertionError(f"train recipes remat={remat}: launches "
                                 f"{counts}, expected {want}; loss "
                                 f"{float(m['loss'])}")
        ms = time_ms(lambda: step(state, batch, gen), iters=3, warmup=1,
                     repeats=3)
        res[remat] = dict(runs=runs, counts=counts, peak_gb=peak, ms=ms)
        del state, step
        torch.cuda.empty_cache()
    ref = res[False]["runs"]["sound"]
    got, ctl = res[True]["runs"]["sound"], res[True]["runs"]["control"]
    lora_equal = all(torch.equal(a, b) for a, b in zip(got[1], ref[1]))
    ctl_equal = all(torch.equal(a, b) for a, b in zip(ctl[1], ref[1]))
    dec_err = _rel_norm_tree(got[2], ref[2])
    log(f"train recipes: remat: launches {res[True]['counts']} over "
        f"{RECIPE_STEPS} steps (without: {res[False]['counts']}); LoRA "
        f"gradients bit-equal {lora_equal} (control, B2 dropping keys from "
        f"192: {ctl_equal}), loss {float(got[0])} vs {float(ref[0])}, "
        f"decoder rel err {dec_err:.3g} (tol {RECIPE_REMAT_DECODER_TOL})")
    if (not lora_equal or not torch.equal(got[0], ref[0])
            or dec_err > RECIPE_REMAT_DECODER_TOL):
        raise AssertionError("train recipes: the step under remat differs "
                             "from the step without it")
    if ctl_equal:
        raise AssertionError("train recipes: the remat check passes a "
                             "backward that drops keys")
    log("train recipes: " + json.dumps({
        "metric": "ViT-B/224 b32 bf16 train step with and without remat of "
                  "the 2 adapted blocks (25 GT slots, JV)",
        "ms_per_step": res[False]["ms"], "ms_per_step_remat": res[True]["ms"],
        "peak_mem_gb": res[False]["peak_gb"],
        "peak_mem_gb_remat": res[True]["peak_gb"], "card": card_line()}))
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        kernels[name]["launches"] += res[True]["counts"][name]
        kernels[name]["launches_per_step_remat"] = (
            res[True]["counts"][name] / RECIPE_STEPS)


def _tree_lora(grads):
    blocks = grads["backbone"]["blocks"]
    return [blocks[lin][f] for lin in sorted(blocks)
            if isinstance(blocks[lin], dict)
            for f in ("lora_A", "lora_B") if blocks[lin].get(f) is not None]


def _tree_decoder(grads):
    from dinov2_od_tpu_torch.train.state import tree_leaves

    return tree_leaves(grads["decoder"])


def _recipe_accumulation(seed, kernels, cfg, det, batch):
    """k=2 over two copies of one batch against k=1 on it: params untouched
    after the first mini-step, then the update and Adam's moments of the
    k=1 step; the control sums the mini-steps' gradients."""
    import torch

    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.train import step as step_mod
    from dinov2_od_tpu_torch.train.state import (create_train_state,
                                                 trainable_leaves,
                                                 tree_leaves)

    base = _recipe_params(seed, det)
    gen = torch.Generator(device="cuda")
    # No clip: clipping by the global norm would hide a sum's doubling.
    optim = dataclasses.replace(cfg.optim, gradient_clip_val=float("inf"))
    real = step_mod.accumulate

    def summed(grads, opt_state, n):
        return torch._foreach_add(tree_leaves(opt_state.acc),
                                  tree_leaves(grads))

    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, k, acc_fn in (("k=1", 1, real), ("k=2", 2, real),
                                ("control (sum)", 2, summed)):
            c = dataclasses.replace(cfg, optim=dataclasses.replace(
                optim, gradient_accumulation_steps=k))
            state = create_train_state(_clone_tree(base), c.optim, det)
            step = step_mod.make_train_step(c)
            step_mod.accumulate = acc_fn
            try:
                _build.reset_launch_counts()
                before = [t.clone() for t in trainable_leaves(state.params,
                                                              state.opt_state)]
                untouched = None
                for i in range(k):
                    gen.manual_seed(seed)
                    state, _ = step(state, batch, gen)
                    if i == 0 and k > 1:
                        untouched = all(torch.equal(a, b) for a, b in zip(
                            trainable_leaves(state.params, state.opt_state),
                            before))
                torch.cuda.synchronize()
            finally:
                step_mod.accumulate = real
            out[name] = dict(
                counts=_launches(), untouched=untouched,
                update=[(a - b).detach() for a, b in zip(trainable_leaves(
                    state.params, state.opt_state), before)],
                mu=[t.clone() for t in tree_leaves(state.opt_state.mu)],
                nu=[t.clone() for t in tree_leaves(state.opt_state.nu)],
                count=int(state.opt_state.count))
            del state, step
    finally:
        torch.use_deterministic_algorithms(False)
    ref = out["k=1"]
    verdict = {}
    for name in ("k=2", "control (sum)"):
        r = out[name]
        errs = {f: _rel_norm_tree(r[f], ref[f])
                for f in ("update", "mu", "nu")}
        verdict[name] = all(e <= RECIPE_ACC_TOL for e in errs.values()) \
            and r["untouched"] and r["count"] == 1
        log(f"train recipes: accumulation {name} against k=1: rel err "
            + ", ".join(f"{f} {e:.3g}" for f, e in errs.items())
            + f" (tol {RECIPE_ACC_TOL}), params untouched after the first "
              f"mini-step {r['untouched']}, updates {r['count']}, launches "
              f"{r['counts']}")
    want = _counts(flash_attn_fwd=2 * det.backbone.depth,
                   flash_attn_bwd=2 * det.backbone.lora_last_n_blocks)
    if not verdict["k=2"] or out["k=2"]["counts"] != want:
        raise AssertionError("train recipes: k=2 accumulation differs from "
                             "k=1 on the same gradient")
    if verdict["control (sum)"]:
        raise AssertionError("train recipes: the accumulation check passes "
                             "a sum of the mini-steps' gradients")
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        kernels[name]["launches"] += out["k=2"]["counts"][name]
        kernels[name]["launches_per_step_accumulation"] = (
            out["k=2"]["counts"][name] / 2)


def _recipe_fold(seed, cfg, det32, batch):
    """lora_mode="fold" in training, fp32: the loss and gradient groups of
    the fold-mode step against the factored step's on the same params and
    assignment; the control folds twice the LoRA delta."""
    import torch

    from dinov2_od_tpu_torch.models import vit

    fold = dataclasses.replace(det32, backbone=dataclasses.replace(
        det32.backbone, lora_mode="fold"))
    c32 = dataclasses.replace(det32, decoder=dataclasses.replace(
        det32.decoder, dropout=0.0))
    f32 = dataclasses.replace(fold, decoder=c32.decoder)
    torch.use_deterministic_algorithms(True, warn_only=True)
    real = vit._eff_kernel
    try:
        ref = _step_loss_grads(seed, cfg, c32, batch)("auto")
        lg = _step_loss_grads(seed, cfg, f32, batch)
        got = lg("auto")
        vit._eff_kernel = lambda p, alpha, dtype, mode: real(
            p, 2 * alpha, dtype, mode)
        try:
            ctl = lg("auto")
        finally:
            vit._eff_kernel = real
    finally:
        torch.use_deterministic_algorithms(False)
    verdicts = {}
    for name, run in (("fold", got), ("control (2 alpha)", ctl)):
        err = _grad_errors(run, ref)
        verdicts[name] = [g for g in err if err[g] > RECIPE_FOLD_TOL[g]]
        log(f"train recipes: {name} step fp32 against the factored step: "
            + ", ".join(f"{g} rel err {e:.3g} (tol {RECIPE_FOLD_TOL[g]})"
                        for g, e in err.items()))
    if verdicts["fold"]:
        raise AssertionError(f"train recipes: the fold-mode step differs "
                             f"from the factored step: {verdicts['fold']}")
    if not verdicts["control (2 alpha)"]:
        raise AssertionError("train recipes: the fold check passes a fold "
                             "of twice the LoRA delta")
    torch.cuda.empty_cache()


def _recipe_augment(seed, cfg):
    """The recipes' augmentation on the card against the same draws applied
    on the CPU; the control inverts the flip mask."""
    import torch

    from dinov2_od_tpu_torch.config import AugmentConfig
    from dinov2_od_tpu_torch.data import augment
    from dinov2_od_tpu_torch.data.synthetic import make_batch

    aug = AugmentConfig(hflip_prob=0.5, scale_jitter=0.25, color_jitter=0.3)
    raw = make_batch(np.random.default_rng(seed + 5), B, image_size=224,
                     max_boxes=MAX_BOXES)
    x01 = torch.from_numpy(np.clip(raw["images"], 0, 1))
    boxes, valid = torch.from_numpy(raw["boxes"]), torch.from_numpy(
        raw["valid"])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    draws = augment.draw_augment(gen, aug, B, 224, 224, "cuda")
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = augment.apply_augment(x01.cuda(), boxes.cuda(), valid.cuda(),
                                     draws, aug)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    host = {k: v.cpu() for k, v in draws.items()}
    runs = {"plain CPU": augment.apply_augment(x01, boxes, valid, host, aug)}
    runs["control (flips inverted)"] = augment.apply_augment(
        x01, boxes, valid, {**host, "flip": ~host["flip"]}, aug)
    ok = {}
    for name, (xi, bx, va) in runs.items():
        pix = float((card[0].cpu() - xi).abs().max())
        box_err = float((card[1].cpu() - bx).abs().max())
        same = torch.equal(card[1].cpu(), bx) and torch.equal(card[2].cpu(),
                                                              va)
        ok[name] = pix <= RECIPE_AUG_PIXEL_TOL and same
        log(f"train recipes: augmentation on the card (flips "
            f"{int(host['flip'].sum())}/{B}, zoom "
            f"{float(host['scale'].min()):.3f}-"
            f"{float(host['scale'].max()):.3f}) against {name}: pixels max "
            f"abs err {pix:.3g} (tol {RECIPE_AUG_PIXEL_TOL}), boxes and valid "
            f"equal {same} (boxes max abs err {box_err:.3g}), "
            f"{int(card[2].sum())} of {int(valid.sum())} boxes kept")
    if not ok["plain CPU"]:
        raise AssertionError("train recipes: augmentation on the card "
                             "differs from its CPU run")
    if ok["control (flips inverted)"]:
        raise AssertionError("train recipes: the augmentation check passes "
                             "inverted flips")


def _syncs_per_dispatch(cfg, params, cache):
    """Host syncs in one K-step dispatch from the cache, counted by
    torch.cuda's sync debug mode (each sync warns once)."""
    import warnings

    import torch

    from dinov2_od_tpu_torch.train import device_cache as dc
    from dinov2_od_tpu_torch.train.state import create_train_state

    state = create_train_state(params, cfg.optim, cfg.detector)
    multi = dc.make_multi_train_step(cfg)
    gen = torch.Generator(device="cuda")
    group = np.arange(RECIPE_DISPATCH * CLI_BATCH).reshape(RECIPE_DISPATCH,
                                                           CLI_BATCH)
    state, _ = multi(state, cache, dc.index_tensor(group, "cuda"), gen)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, m = multi(state, cache, dc.index_tensor(group, "cuda"),
                             gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    where = {}
    for w in syncs:
        key = f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}"
        where[key] = where.get(key, 0) + 1
    return len(syncs), where


def phase_train_recipes(seed: int, kernels: dict, bare_ips: float,
                        loop_ips: float):
    """The recorded recipes' options at ViT-B/224 b32 on the card: remat,
    accumulation, fold, augmentation, then the cached loop of the CLI with
    augmentation (images/s, syncs a dispatch, a mid-epoch resume, cached
    validation against uncached)."""
    import os
    import signal
    import tempfile

    import torch

    from dinov2_od_tpu_torch.config import DataConfig, OptimConfig, TrainConfig
    from dinov2_od_tpu_torch.data.packed import PackedDataset
    from dinov2_od_tpu_torch.data.synthetic import make_batch
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.train import checkpoint as ckpt
    from dinov2_od_tpu_torch.train import cli
    from dinov2_od_tpu_torch.train import device_cache as dc
    from dinov2_od_tpu_torch.train.state import tree_leaves

    t_phase = time.perf_counter()
    det32, det = _train_dets()
    cfg = TrainConfig(detector=det, data=DataConfig(batch_size=B,
                                                    max_boxes=MAX_BOXES),
                      optim=OptimConfig())
    raw = make_batch(np.random.default_rng(seed), B, image_size=224,
                     max_boxes=MAX_BOXES)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in raw.items()}
    _recipe_remat(seed, kernels, cfg, det, batch)
    _recipe_accumulation(seed, kernels, cfg, det, batch)
    _recipe_fold(seed, cfg, det32, batch)
    _recipe_augment(seed, cfg)
    torch.cuda.empty_cache()
    log(f"train recipes: step checks took {time.perf_counter() - t_phase:.1f}"
        f" s")

    image_size = 224
    spe = RECIPE_CLI_TRAIN_IMAGES // CLI_BATCH
    steps = CLI_EPOCHS * spe
    val_batches = -(-RECIPE_CLI_VAL_IMAGES // CLI_BATCH)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="recipes_", dir=build) as root:
        splits = _cli_splits(seed + 1, root, image_size,
                             RECIPE_CLI_TRAIN_IMAGES, RECIPE_CLI_VAL_IMAGES)
        base = ["--packed_train_data", splits["train"],
                "--packed_val_data", splits["val"],
                "--dino_model", "facebook/dinov2-base",
                "--image_size", str(image_size),
                "--backbone_dtype", "bfloat16",
                "--batch_size", str(CLI_BATCH),
                "--num_epochs", str(CLI_EPOCHS), "--val_frequency", "1",
                "--checkpoint_frequency", "1", "--log_frequency", "8"]
        common = base + ["--device_cache", "--steps_per_dispatch",
                         str(RECIPE_DISPATCH), "--hflip_prob", "0.5",
                         "--scale_jitter", "0.25"]
        out = os.path.join(root, "out")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(common + ["--output_dir", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _launches()
        logs = _epoch_logs(out, range(CLI_EPOCHS))
        losses = [x for e in range(CLI_EPOCHS) for x in logs[e]["losses"]]
        want = _counts(flash_attn_fwd=12 * (steps + CLI_EPOCHS * val_batches),
                       flash_attn_bwd=2 * steps)
        log(f"train recipes: cached loop main() rc {rc} in {wall:.1f} s: "
            f"{steps} steps, epoch means "
            f"{[logs[e]['mean_loss'] for e in range(CLI_EPOCHS)]}, launches "
            f"{counts}")
        if rc != 0 or counts != want:
            raise AssertionError(f"cached loop: rc {rc}, launches {counts}, "
                                 f"expected {want}")
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"cached loop losses: {losses}")
        if not logs[CLI_EPOCHS - 1]["mean_loss"] < logs[0]["mean_loss"]:
            raise AssertionError("cached loop: the last epoch's mean loss is "
                                 "not below the first's")
        for name in ("flash_attn_fwd", "flash_attn_bwd"):
            kernels[name]["launches"] += counts[name]
            kernels[name]["launches_train_recipes_cli"] = counts[name]

        # Host syncs in one dispatch of the cached loop's step.
        from dinov2_od_tpu_torch.models.detector import (
            cast_frozen_weights, init_detector_params)

        dcfg = TrainConfig(detector=det, data=DataConfig(batch_size=CLI_BATCH),
                           optim=OptimConfig(),
                           augment=dataclasses.replace(
                               cfg.augment, hflip_prob=0.5,
                               scale_jitter=0.25))
        cache = dc.upload_train_cache(PackedDataset(splits["train"]), "cuda")
        params = cast_frozen_weights(init_detector_params(
            torch.Generator().manual_seed(seed), det, device="cuda"), det)
        n_sync, where = _syncs_per_dispatch(dcfg, params, cache)
        del cache, params
        torch.cuda.empty_cache()
        log("train recipes: " + json.dumps({
            "metric": "the cached training loop (ViT-B/224 b32 bf16, 100 GT "
                      "slots, the auction, hflip 0.5 + scale jitter 0.25, "
                      f"{RECIPE_DISPATCH} steps a dispatch) images/s per "
                      "epoch, beside phase train cli's loader loop (no "
                      "augmentation) and the bare step (25 GT slots, JV)",
            "cached_loop_images_per_s": [logs[e]["images_per_sec"]
                                         for e in range(CLI_EPOCHS)],
            "loader_loop_images_per_s": loop_ips,
            "bare_step_images_per_s": bare_ips,
            "host_syncs_per_dispatch": n_sync,
            "host_syncs_per_step": n_sync / RECIPE_DISPATCH,
            "sync_sites": where,
            "val_AP": [_ap(out, e)["AP"] for e in range(CLI_EPOCHS)],
            "card": card_line()}))

        # Exact resume: an uninterrupted run and a run preempted after its
        # first dispatch of epoch 1 (SIGTERM while the next index group is
        # copied: the guard stops the loop after that dispatch), resumed
        # from its checkpoint, both under deterministic algorithms (the
        # deformable backward's atomics otherwise differ from run to run):
        # the resumed steps' losses and the final params to the bit.
        out_u = os.path.join(root, "uninterrupted")
        out_p = os.path.join(root, "preempted")
        calls, real_index = [0], dc.index_tensor

        def index_then_signal(*a, **k):
            calls[0] += 1
            if calls[0] == spe // RECIPE_DISPATCH + 1:
                signal.raise_signal(signal.SIGTERM)
            return real_index(*a, **k)

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            rc_u = cli.main(common + ["--output_dir", out_u])
            dc.index_tensor = index_then_signal
            try:
                rc = cli.main(common + ["--output_dir", out_p])
            finally:
                dc.index_tensor = real_index
            ckpt_dir = os.path.join(out_p, "checkpoint_epoch_0")
            with open(os.path.join(ckpt_dir, "metrics_history.json")) as f:
                index = json.load(f).get("_preempt_batch_index")
            if rc_u != 0 or rc != 0 or index != RECIPE_DISPATCH or \
                    os.path.isdir(os.path.join(out_p, "final_model")):
                raise AssertionError(f"preempted cached run: rc {rc_u}, "
                                     f"{rc}, batch index {index}")
            _build.reset_launch_counts()
            rc = cli.main(common + ["--output_dir", out_p, "--checkpoint",
                                    ckpt_dir])
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        counts_r = _launches()
        last = CLI_EPOCHS - 1
        again = _epoch_logs(out_p, [last])[last]
        ref = _epoch_logs(out_u, [last])[last]
        left = spe - RECIPE_DISPATCH
        want_r = _counts(flash_attn_fwd=12 * (left + val_batches),
                         flash_attn_bwd=2 * left)
        if (rc != 0 or again["steps"] != ref["steps"][RECIPE_DISPATCH:]
                or counts_r != want_r):
            raise AssertionError(f"resumed cached run: rc {rc}, steps "
                                 f"{again['steps']}, launches {counts_r}, "
                                 f"expected {want_r}")
        finals = [torch.load(os.path.join(o, "final_model", ckpt.STATE_FILE),
                             weights_only=True)["params"]
                  for o in (out_u, out_p)]
        same_params = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(finals[0]), tree_leaves(finals[1])))
        same_losses = again["losses"] == ref["losses"][RECIPE_DISPATCH:]
        # The control: the first run's, whose atomics were not held.
        control = again["losses"] == logs[last]["losses"][RECIPE_DISPATCH:]
        log(f"train recipes: preempted after {index} steps of epoch {last} "
            f"and resumed, deterministic algorithms: its {len(again['losses'])}"
            f" steps {again['steps'][0]}-{again['steps'][-1]} equal to the "
            f"uninterrupted run's {same_losses}, final params equal "
            f"{same_params}; equal to the first run's (the control) "
            f"{control}; launches {counts_r}")
        if not (same_losses and same_params):
            raise AssertionError("resumed cached run differs from the "
                                 "uninterrupted one")
        if control:
            raise AssertionError("the resume check passes a run whose "
                                 "atomics were not held")
        for name in ("flash_attn_fwd", "flash_attn_bwd"):
            kernels[name]["launches"] += counts_r[name]

        # Cached validation against the loader's on the same checkpoints;
        # the epoch-0 checkpoint's as the control.
        evals = {}
        for name, path in (("final_model", "final_model"),
                           ("control (checkpoint_epoch_0)",
                            "checkpoint_epoch_0")):
            ev_out = os.path.join(root, f"eval_{path}")
            rc = cli.main(base + ["--only_evaluate", "--checkpoint",
                                         os.path.join(out, path),
                                         "--output_dir", ev_out])
            # --only_evaluate names its files by the checkpoint's epoch + 1.
            epoch = 0 if path == "final_model" else 1
            with open(os.path.join(ev_out,
                                   f"predictions_epoch_{epoch}.json")) as f:
                evals[name] = (rc, _ap(ev_out, epoch), json.load(f))
        with open(os.path.join(out, f"predictions_epoch_{last}.json")) as f:
            cached_preds = json.load(f)
        cached = _ap(out, last)
        same = {n: e[1] == cached and e[2] == cached_preds
                for n, e in evals.items()}
        log(f"train recipes: cached validation AP {cached['AP']:.4f}, AP50 "
            f"{cached['AP50']:.4f} ({len(cached_preds)} detections) against "
            f"--only_evaluate: final_model AP "
            f"{evals['final_model'][1]['AP']:.4f}, equal {same['final_model']};"
            f" control (checkpoint_epoch_0) AP "
            f"{evals['control (checkpoint_epoch_0)'][1]['AP']:.4f}, equal "
            f"{same['control (checkpoint_epoch_0)']}")
        if any(e[0] != 0 for e in evals.values()) or not same["final_model"]:
            raise AssertionError("cached validation differs from the "
                                 "loader's evaluation of the same params")
        if same["control (checkpoint_epoch_0)"]:
            raise AssertionError("the cached validation check passes another "
                                 "checkpoint's evaluation")
    log(f"train recipes: phase took {time.perf_counter() - t_phase:.1f} s")


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


def _grad_tree(p, c, x, gt, match, mesh=None, **apply_kw):
    """(loss, masked gradient tree) of one train-mode step on fixed params
    with a fixed assignment; under `mesh` this rank's, with the train
    step's reductions (`reduce_gradients`). `apply_kw` goes to
    detector_apply (the ring's attn_impl and seq_axis)."""
    import torch

    from dinov2_od_tpu_torch.config import OptimConfig
    from dinov2_od_tpu_torch.models.detector import detector_apply
    from dinov2_od_tpu_torch.ops.losses import set_criterion
    from dinov2_od_tpu_torch.parallel.collectives import reduce_gradients
    from dinov2_od_tpu_torch.parallel.sharding import leaf_paths
    from dinov2_od_tpu_torch.train.state import (
        create_train_state, mask_gradients, trainable_leaves, tree_unflatten)

    state = create_train_state(p, OptimConfig(), c)
    o = detector_apply(p, c, x, deterministic=False, mesh=mesh, **apply_kw)
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
        counts = _launches()
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


def _cp_tree(seed: int, det32):
    """The phase's params on the CPU, drawn from `seed`, every lora_B
    nonzero (drawn alike by the parent and by each rank)."""
    import torch

    from dinov2_od_tpu_torch.models.detector import init_detector_params

    tree = init_detector_params(torch.Generator().manual_seed(seed), det32,
                                device="cpu")
    lg = torch.Generator().manual_seed(seed + 1)
    for lin in tree["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = 0.05 * torch.randn(lin["lora_B"].shape,
                                               generator=lg)
    return tree


def _on_card(tree, det, mesh=None, cast=True):
    """This rank's shard of a CPU tree on the card, frozen weights cast to
    the backbone's dtype."""
    from dinov2_od_tpu_torch.models.detector import cast_frozen_weights
    from dinov2_od_tpu_torch.parallel.sharding import (
        map_with_path, shard_params)

    if mesh is not None:
        tree = shard_params(tree, mesh)
    p = map_with_path(lambda _, t: t.to("cuda"), tree)
    return cast_frozen_weights(p, det) if cast else p


def _cp_dets(model_name: str, image_size: int, **backbone):
    """(fp32, bf16) train configurations, decoder dropout 0."""
    det32, det = _train_dets(model_name, image_size, **backbone)
    return tuple(dataclasses.replace(c, decoder=dataclasses.replace(
        c.decoder, dropout=0.0)) for c in (det32, det))


def _cp_batch(inp, name):
    import torch

    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in inp["batch " + name].items()}
    return batch, (batch["labels"], batch["boxes"], batch["valid"])


@contextlib.contextmanager
def _remote_shards_dropped(mesh):
    """The ring as a faulty kernel route: each rank's own shard of keys
    only, the other ring steps skipped: the CP checks' control."""
    from dinov2_od_tpu_torch.ops import ring_attention as ra

    sound = ra._kv_len
    ra._kv_len = lambda src, sk, valid: (sound(src, sk, valid)
                                         if src == mesh.context_index else 0)
    try:
        yield
    finally:
        ra._kv_len = sound


@contextlib.contextmanager
def _ring_shift_timed(into: list):
    """Each ring_shift's host seconds appended to `into` (the staging
    copies and the gloo transfer, the wait for the peer included)."""
    from dinov2_od_tpu_torch.ops import ring_attention as ra

    sound = ra.ring_shift

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = sound(*a, **kw)
        into.append(time.perf_counter() - t0)
        return out

    ra.ring_shift = timed
    try:
        yield
    finally:
        ra.ring_shift = sound


def _launched():
    from dinov2_od_tpu_torch.ops import _build

    return {**{n: c for n, c in _launches().items() if c},
            **{n: c for n, c in _build.route_counts.items() if c}}


def _cp_ring_job(name: str, inp: dict, seed: int) -> dict:
    """One CP mesh on this rank: the eval forward and one step's gradients
    (fixed assignment) with the control, then the main path: CP_STEPS
    train steps and an eval top-k batch, launches counted."""
    import torch

    from dinov2_od_tpu_torch.config import (
        DataConfig, MeshConfig, OptimConfig, TrainConfig)
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.ops.matching import MatchResult
    from dinov2_od_tpu_torch.parallel import create_mesh, gather_params
    from dinov2_od_tpu_torch.train.state import create_train_state
    from dinov2_od_tpu_torch.train.step import (
        make_eval_step, make_eval_topk_step, make_train_step)

    mesh_cfg = MeshConfig(**CP_MESHES[name])
    mesh = create_mesh(mesh_cfg.model_parallel_size, mesh_cfg)
    det32, det = _cp_dets(LARGE_MODEL, LARGE_IMAGE)
    p = _on_card(_cp_tree(seed, det32), det, mesh)
    batch, gt = _cp_batch(inp, "large")
    x = batch["images"]
    cfg = TrainConfig(detector=det, data=DataConfig(
        batch_size=LARGE_BATCH, max_boxes=MAX_BOXES), optim=OptimConfig(),
        mesh=mesh_cfg)
    out = {"place": (mesh.data_index, mesh.context_index, mesh.model_index)}
    with torch.inference_mode():
        runs = {"kernel": make_eval_step(cfg, mesh)(p, x)}
        with _remote_shards_dropped(mesh):
            runs["control remote shards dropped"] = make_eval_step(
                cfg, mesh)(p, x)
    out["forward"] = {run: {k: o[k].float().cpu() for k in OUTPUTS}
                      for run, o in runs.items()}
    match = MatchResult(*(t.to("cuda") for t in inp["match large"]))
    kw = dict(attn_impl="ring", seq_axis=mesh.seq_axis)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        grads = {"kernel": _grad_tree(p, det, x, gt, match, mesh, **kw)}
        with _remote_shards_dropped(mesh):
            grads["control remote shards dropped"] = _grad_tree(
                p, det, x, gt, match, mesh, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    out["grads"] = {run: (loss.cpu(), _tree_groups(gather_params(g, mesh),
                                                   det))
                    for run, (loss, g) in grads.items()}
    del runs, grads

    # The main path, counts to 0 before and read after.
    state = create_train_state(p, cfg.optim, det)
    snap = _snapshot(p, det)
    step = make_train_step(cfg, mesh)
    topk_step = make_eval_topk_step(cfg, mesh)
    sizes = torch.full((LARGE_BATCH, 2), float(LARGE_IMAGE), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shifts, losses = [], []
    torch.distributed.barrier()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with _ring_shift_timed(shifts):
        for _ in range(CP_STEPS):
            state, metrics = step(state, batch, gen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        train_counts = _launched()
        topk = topk_step(state.params, x, sizes)["topk"]
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    out["counts"] = _launched()
    out["train_counts"] = train_counts
    out["losses"] = torch.stack(losses).tolist()
    out["topk_finite"] = bool(torch.isfinite(topk).all())
    out["topk_shape"] = list(topk.shape)
    out["train_s"], out["topk_s"] = t1 - t0, t2 - t1
    out["shift_s"], out["shifts"] = sum(shifts), len(shifts)
    first, frozen, lora_rows = snap
    out["frozen_changed"] = sum(not torch.equal(t, b) for t, b in frozen)
    out["lora_rows_changed"] = sum(not torch.equal(t[:first], b)
                                   for t, b in lora_rows)
    del state, p
    torch.cuda.empty_cache()
    return out


def _swiglu_job(inp: dict, seed: int) -> dict:
    """ViT-g (SwiGLU) on a 1 x 4 mesh: the eval forward with its control
    (fc1 sharded as one contiguous slice), one step's gradients (fixed
    assignment), then the main path: one train step, launches counted."""
    import torch

    from dinov2_od_tpu_torch.config import (
        DataConfig, MeshConfig, OptimConfig, TrainConfig)
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.ops.matching import MatchResult
    from dinov2_od_tpu_torch.parallel import create_mesh, gather_params
    from dinov2_od_tpu_torch.parallel.sharding import local_slice
    from dinov2_od_tpu_torch.train.state import create_train_state
    from dinov2_od_tpu_torch.train.step import make_eval_step, make_train_step

    mesh_cfg = MeshConfig(model_parallel_size=TP)
    mesh = create_mesh(TP, mesh_cfg)
    det32, det = _cp_dets(GIANT_MODEL, 224)
    tree = _cp_tree(seed, det32)
    fc1 = {n: (t[..., local_slice(t.shape[-1], mesh)].contiguous()
               if n in ("kernel", "bias", "lora_B") else None)
           for n, t in tree["backbone"]["blocks"]["fc1"].items()}
    p = _on_card(tree, det, mesh)
    del tree
    faulty_fc1 = {n: (p["backbone"]["blocks"]["fc1"][n] if t is None
                      else t.to("cuda", p["backbone"]["blocks"]["fc1"][n]
                                .dtype)) for n, t in fc1.items()}
    faulty = {**p, "backbone": {**p["backbone"], "blocks": {
        **p["backbone"]["blocks"], "fc1": faulty_fc1}}}
    batch, gt = _cp_batch(inp, "giant")
    x = batch["images"]
    cfg = TrainConfig(detector=det, data=DataConfig(
        batch_size=LARGE_BATCH, max_boxes=MAX_BOXES), optim=OptimConfig(),
        mesh=mesh_cfg)
    out = {}
    with torch.inference_mode():
        runs = {"kernel": make_eval_step(cfg, mesh)(p, x),
                "control fc1 as one contiguous slice of 2M":
                    make_eval_step(cfg, mesh)(faulty, x)}
    out["forward"] = {run: {k: o[k].float().cpu() for k in OUTPUTS}
                      for run, o in runs.items()}
    del faulty, faulty_fc1, runs
    match = MatchResult(*(t.to("cuda") for t in inp["match giant"]))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss, g = _grad_tree(p, det, x, gt, match, mesh)
    finally:
        torch.use_deterministic_algorithms(False)
    out["grads"] = {"kernel": (loss.cpu(), _tree_groups(
        gather_params(g, mesh), det))}
    del g
    state = create_train_state(p, cfg.optim, det)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.distributed.barrier()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = make_train_step(cfg, mesh)(state, batch, gen)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["counts"] = _launched()
    out["loss"] = metrics["loss"].item()
    del state, p
    torch.cuda.empty_cache()
    return out


def _int8_tp_job(inp: dict, seed: int) -> dict:
    """int8 ViT-B on a 1 x 4 mesh (B6 off): the fp32 eval forward of the
    int8 tree, the prefix-int8 step's gradients (fixed assignment), then
    the main path: an eval top-k batch on the int8 tree and one
    prefix-int8 train step, launches counted."""
    import torch

    from dinov2_od_tpu_torch.config import (
        DataConfig, MeshConfig, OptimConfig, TrainConfig)
    from dinov2_od_tpu_torch.models.detector import fold_detector_lora
    from dinov2_od_tpu_torch.models.quantize import quantize_detector_int8
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.ops.matching import MatchResult
    from dinov2_od_tpu_torch.parallel import create_mesh, gather_params
    from dinov2_od_tpu_torch.train.state import create_train_state
    from dinov2_od_tpu_torch.train.step import (
        make_eval_step, make_eval_topk_step, make_train_step)

    mesh_cfg = MeshConfig(model_parallel_size=TP)
    mesh = create_mesh(TP, mesh_cfg)
    det32, det = _cp_dets("facebook/dinov2-base", 224)
    _, pdet = _cp_dets("facebook/dinov2-base", 224, prefix_int8=True)
    tree = _cp_tree(seed, det32)
    q = quantize_detector_int8(fold_detector_lora(tree, det32))
    batch, gt = _cp_batch(inp, "base")
    x = batch["images"]
    out = {}
    cfg32 = TrainConfig(detector=det32, mesh=mesh_cfg)
    with torch.inference_mode():
        fwd = make_eval_step(cfg32, mesh)(_on_card(q, det32, mesh, False), x)
    out["forward"] = {k: fwd[k].float().cpu() for k in OUTPUTS}
    p = _on_card(tree, pdet, mesh)
    match = MatchResult(*(t.to("cuda") for t in inp["match base"]))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss, g = _grad_tree(p, pdet, x, gt, match, mesh)
    finally:
        torch.use_deterministic_algorithms(False)
    out["grads"] = (loss.cpu(), _tree_groups(gather_params(g, mesh), pdet))
    cfg = TrainConfig(detector=det, data=DataConfig(batch_size=B,
                                                    max_boxes=MAX_BOXES),
                      mesh=mesh_cfg)
    pcfg_ = dataclasses.replace(cfg, detector=pdet, optim=OptimConfig())
    qp = _on_card(q, det, mesh, cast=False)
    state = create_train_state(p, pcfg_.optim, pdet)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sizes = torch.full((B, 2), 224.0, device="cuda")
    torch.distributed.barrier()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    topk = make_eval_topk_step(cfg, mesh)(qp, x, sizes)["topk"]
    torch.cuda.synchronize()
    out["topk_counts"] = _launched()
    state, metrics = make_train_step(pcfg_, mesh)(state, batch, gen)
    torch.cuda.synchronize()
    out["counts"] = _launched()
    out["topk_finite"] = bool(torch.isfinite(topk).all())
    out["loss"] = metrics["loss"].item()
    del state, p, qp
    torch.cuda.empty_cache()
    return out


def _cp_rank(rank: int, world: int, port: int, work: str, seed: int,
             jobs: tuple):
    """One rank of phase_cp: a process on cuda:0 in a gloo group of
    `world` running `jobs` (each builds its own mesh) on the parent's
    inputs from `work`; writes its results there (rank{r}.pt)."""
    import pickle
    from pathlib import Path

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        work = Path(work)
        with open(work / "inputs.pkl", "rb") as f:
            inp = pickle.load(f)
        out = {}
        for job in jobs:
            if job in CP_MESHES:
                out[job] = _cp_ring_job(job, inp, seed)
            elif job == "swiglu":
                out[job] = _swiglu_job(inp, seed)
            else:
                out[job] = _int8_tp_job(inp, seed)
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _cp_references(seed: int, raw: dict):
    """One process's references on the card, fixed assignments for the
    gradient checks (fp32 inputs, bf16 backbones, decoder dropout 0)."""
    import torch

    from dinov2_od_tpu_torch.models.detector import (
        detector_apply, fold_detector_lora)
    from dinov2_od_tpu_torch.models.quantize import quantize_detector_int8
    from dinov2_od_tpu_torch.ops.matching import hungarian_match

    refs, matches = {}, {}
    models = {"large": _cp_dets(LARGE_MODEL, LARGE_IMAGE),
              "giant": _cp_dets(GIANT_MODEL, 224),
              "base": _cp_dets("facebook/dinov2-base", 224)}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, (det32, det) in models.items():
        batch = {k: torch.from_numpy(v).to("cuda")
                 for k, v in raw[name].items()}
        x, gt = batch["images"], (batch["labels"], batch["boxes"],
                                  batch["valid"])
        tree = _cp_tree(seed, det32)
        p = _on_card(tree, det)
        with torch.inference_mode():
            fwd = detector_apply(p, det, x)
        match = hungarian_match(fwd["pred_logits"], fwd["pred_boxes"], *gt)
        matches[name] = tuple(t.cpu() for t in match)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss, grads = _grad_tree(p, det, x, gt, match)
            ref = {"forward": {k: fwd[k].float().cpu() for k in OUTPUTS},
                   "grads": (loss.cpu(), _tree_groups(grads, det))}
            if name == "base":
                # int8: the fp32 model and its int8 tree (B6 on fc2), and
                # the prefix-int8 step beside the bf16 one.
                p32 = _on_card(tree, det32, cast=False)
                q = _on_card(quantize_detector_int8(
                    fold_detector_lora(tree, det32)), det32, cast=False)
                with torch.inference_mode():
                    ref["fp32"] = {k: v.float().cpu() for k, v in
                                   detector_apply(p32, det32, x).items()
                                   if k in OUTPUTS}
                    ref["int8"] = {k: v.float().cpu() for k, v in
                                   detector_apply(q, det32, x).items()
                                   if k in OUTPUTS}
                pdet = dataclasses.replace(det, backbone=dataclasses.replace(
                    det.backbone, prefix_int8=True))
                loss, grads = _grad_tree(p, pdet, x, gt, match)
                ref["prefix grads"] = (loss.cpu(), _tree_groups(grads, pdet))
                del p32, q
        finally:
            torch.use_deterministic_algorithms(False)
        refs[name] = ref
        del p, fwd, grads, tree
        torch.cuda.empty_cache()
    return refs, matches


def _spawn_cp(jobs: tuple, world: int, inputs: dict, seed: int):
    """Start `world` ranks on `jobs`; returns (their results, wall s)."""
    import pickle
    import shutil
    import socket
    import tempfile
    from pathlib import Path

    import torch
    import torch.multiprocessing as mp

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="cp_phase_", dir=root))
    try:
        with open(work / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        mp.start_processes(_cp_rank, args=(world, port, str(work), seed,
                                           jobs),
                           nprocs=world, join=True, start_method="spawn")
        wall = time.perf_counter() - t0
        return [torch.load(work / f"rank{r}.pt", weights_only=False)
                for r in range(world)], wall
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _judge_model(phase: str, runs: dict, ref: dict, tol: dict):
    """The sound run's outputs within `tol`, every control's over it."""
    import torch

    errs = {run: {k: (o[k] - ref[k]).abs().max().item() for k in OUTPUTS}
            for run, o in runs.items()}
    for run, err in errs.items():
        finite = all(bool(torch.isfinite(runs[run][k]).all())
                     for k in OUTPUTS)
        log(f"{phase}: forward {run} vs one process: "
            + ", ".join(f"{k} max abs err {err[k]:.4g} (tol {tol[k]})"
                        for k in OUTPUTS) + f", finite={finite}")
        over = any(err[k] > tol[k] for k in OUTPUTS) or not finite
        if run == "kernel" and over:
            raise AssertionError(f"{phase}: forward disagrees: {err}")
        if run != "kernel" and not over:
            raise AssertionError(f"{phase}: the control {run} passes the "
                                 f"forward check")


def phase_cp(seed: int, kernels: dict):
    """Context parallelism: ring attention over B3's route at ViT-L/560 on
    the legacy mode's 1 x 2 mesh and on DP 1 x CP 2 x TP 2; then SwiGLU
    (ViT-g) and int8 (ViT-B) under TP on 1 x 4 meshes. Every mesh's ranks
    share the card over gloo; each is held against one process's path on
    the same params and batch, with controls, and its main path's
    launches are counted."""
    from dinov2_od_tpu_torch.data.synthetic import make_batch

    t_phase = time.perf_counter()
    raw = {name: make_batch(np.random.default_rng(seed), bs,
                            image_size=size, max_boxes=MAX_BOXES)
           for name, bs, size in (("large", LARGE_BATCH, LARGE_IMAGE),
                                  ("giant", LARGE_BATCH, 224),
                                  ("base", B, 224))}
    log(f"cp: ViT-L/14 at {LARGE_IMAGE} px (1601 tokens, 16 heads of 64), "
        f"bf16, batch {LARGE_BATCH}; meshes {CP_MESHES}; SwiGLU ViT-g/14 "
        f"and int8 ViT-B/14 on 1 x {TP}; every rank a process on cuda:0 in "
        f"a gloo group (host-staged ring): correctness, not a CP or TP "
        f"speed")
    refs, matches = _cp_references(seed, raw)
    inputs = {**{f"batch {n}": b for n, b in raw.items()},
              **{f"match {n}": m for n, m in matches.items()}}
    legacy, wall2 = _spawn_cp(("legacy 1x2",), 2, inputs, seed)
    four, wall4 = _spawn_cp(("dp1 x cp2 x tp2", "swiglu", "int8"), TP,
                            inputs, seed)
    results = {"legacy 1x2": [r["legacy 1x2"] for r in legacy],
               "dp1 x cp2 x tp2": [r["dp1 x cp2 x tp2"] for r in four]}
    bb = _cp_dets(LARGE_MODEL, LARGE_IMAGE)[1].backbone
    depth, adapted = bb.depth, bb.lora_last_n_blocks
    n_ring = 2
    fwd_b1 = depth * n_ring
    per_step = {"flash_attn_fwd": fwd_b1 + adapted * n_ring,
                "flash_attn_bwd": adapted * n_ring}
    per_step["flash_attention_lse"] = sum(per_step.values())
    want = {k: v * CP_STEPS + (fwd_b1 if k != "flash_attn_bwd" else 0)
            for k, v in per_step.items()}
    for name, ranks in results.items():
        ref = refs["large"]
        for r, res in enumerate(ranks):
            _judge_model(f"cp {name} rank {r}", res["forward"],
                         ref["forward"], CP_MODEL_TOL)
            if res["counts"] != want:
                raise AssertionError(f"cp {name}: rank {r} launches "
                                     f"{res['counts']}; expected {want}")
            if not (np.isfinite(res["losses"]).all() and res["topk_finite"]
                    and res["frozen_changed"] == 0
                    and res["lora_rows_changed"] == 0):
                raise AssertionError(f"cp {name}: rank {r}: losses "
                                     f"{res['losses']}, top-k finite "
                                     f"{res['topk_finite']}, frozen leaves "
                                     f"changed {res['frozen_changed']}, "
                                     f"LoRA rows {res['lora_rows_changed']}")
        _judge_grads(f"cp {name}", "bfloat16", ranks[0]["grads"],
                     ref["grads"], CP_GRAD_TOL)
        log(f"cp {name}: " + json.dumps({
            "place_per_rank": [res["place"] for res in ranks],
            "losses_rank0": ranks[0]["losses"],
            "launches_per_rank": ranks[0]["counts"],
            "launches_train_per_rank": ranks[0]["train_counts"],
            "train_s_per_rank": [res["train_s"] for res in ranks],
            "topk_s_per_rank": [res["topk_s"] for res in ranks],
            "ring_shift_s_per_rank": [res["shift_s"] for res in ranks],
            "ring_shifts_per_rank": ranks[0]["shifts"],
            "ring_share_of_main_path": [
                res["shift_s"] / (res["train_s"] + res["topk_s"])
                for res in ranks],
            "metric": "host seconds with ranks sharing one card over gloo: "
                      "not a CP speed", "card": card_line()}))
        for kname in ("flash_attn_fwd", "flash_attn_bwd",
                      "flash_attention_lse"):
            k = kernels[kname]
            k["launches"] += sum(res["counts"][kname] for res in ranks)
            k.setdefault("launches_cp", {})[name] = [
                res["counts"][kname] for res in ranks]

    sw = [r["swiglu"] for r in four]
    gbb = _cp_dets(GIANT_MODEL, 224)[1].backbone
    want_sw = {"flash_attn_fwd": gbb.depth,
               "flash_attn_bwd": gbb.lora_last_n_blocks}
    for r, res in enumerate(sw):
        _judge_model(f"cp swiglu rank {r}", res["forward"],
                     refs["giant"]["forward"], CP_MODEL_TOL)
        if res["counts"] != want_sw or not np.isfinite(res["loss"]):
            raise AssertionError(f"cp swiglu: rank {r} launches "
                                 f"{res['counts']} (expected {want_sw}), "
                                 f"loss {res['loss']}")
    _judge_grads("cp swiglu", "bfloat16", sw[0]["grads"],
                 refs["giant"]["grads"], CP_GRAD_TOL)
    for kname in ("flash_attn_fwd", "flash_attn_bwd"):
        kernels[kname]["launches"] += sum(res["counts"][kname] for res in sw)
        kernels[kname]["launches_swiglu_tp"] = [res["counts"][kname]
                                                for res in sw]
    log("cp swiglu: " + json.dumps({
        "train_s_per_rank": [res["train_s"] for res in sw],
        "loss_rank0": sw[0]["loss"], "launches_per_rank": sw[0]["counts"]}))

    i8 = [r["int8"] for r in four]
    base = refs["base"]
    for r, res in enumerate(i8):
        for key in OUTPUTS:
            single = (base["fp32"][key] - base["int8"][key]).abs().max()
            tp_err = (base["fp32"][key] - res["forward"][key]).abs().max()
            apart = (base["int8"][key] - res["forward"][key]).abs().max()
            limit = INT8_TP_NOISE * single.item() + 1e-6
            log(f"cp int8 rank {r}: {key} vs fp32 {tp_err.item():.4g}, vs "
                f"one process's int8 {apart.item():.4g}; one process's "
                f"int8 vs fp32 {single.item():.4g} (limit {limit:.4g})")
            if not (tp_err.item() <= limit and apart.item() <= limit):
                raise AssertionError(f"cp int8 rank {r}: {key} outside the "
                                     f"quantization noise")
        bdepth = _cp_dets("facebook/dinov2-base", 224)[1].backbone.depth
        want_i8 = {"flash_attn_allheads_fwd": 2 * bdepth,
                   "flash_attn_allheads_bwd": adapted}
        if (res["topk_counts"] != {"flash_attn_allheads_fwd": bdepth}
                or res["counts"] != want_i8 or not res["topk_finite"]):
            raise AssertionError(f"cp int8 rank {r}: launches "
                                 f"{res['topk_counts']} then "
                                 f"{res['counts']}; expected 12 B4f, then "
                                 f"{want_i8}, and no B6")
    noise = _grad_errors(base["prefix grads"], base["grads"])
    tol = {g: max(TP_GRAD_TOL["bfloat16"][g], INT8_TP_NOISE * e)
           for g, e in noise.items()}
    log(f"cp int8: one process's prefix-int8 step vs its bf16 step {noise}")
    _judge_grads("cp int8 prefix", "bfloat16", {"kernel": i8[0]["grads"]},
                 base["prefix grads"], tol)
    kernels["int8_gemm"]["launches_int8_tp"] = [
        res["counts"].get("int8_gemm", 0) for res in i8]
    for kname in ("flash_attn_allheads_fwd", "flash_attn_allheads_bwd"):
        kernels[kname]["launches"] += sum(res["counts"][kname] for res in i8)
        kernels[kname]["launches_int8_tp"] = [res["counts"][kname]
                                              for res in i8]
    log("cp: " + json.dumps({
        "phase_s": time.perf_counter() - t_phase,
        "spawn_wall_s": {"legacy 1x2": wall2, "four ranks": wall4},
        "card": card_line()}))


def _cli_rank(counts_file: str, args: list) -> int:
    """One rank of phase_mesh_cli: `python -m dinov2_od_tpu_torch.train
    ARGS` (the module run as __main__, as `python -m` runs it), its launch
    counts from a run that starts at 0 written to `counts_file` as
    {"rc", "launches", "eval", "elements", "max_memory"}: "eval" the
    launches inside the loop's validation passes (`loop.validate`,
    `loop.validate_cached`), counted around them; "elements" those of the
    loop's train state's param and Adam-moment trees (this rank's
    shards); "max_memory" the process's peak of allocated card memory."""
    import os
    import runpy

    import torch

    from dinov2_od_tpu_torch.train import loop
    from dinov2_od_tpu_torch.train.state import tree_leaves

    if not torch.cuda.is_available():
        print("chip_smoke --cli-rank: no CUDA device", file=sys.stderr)
        return 1
    evals: dict = {}

    def counted(fn):
        def run(*a, **k):
            before = _launched()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            for name, n in _launched().items():
                evals[name] = evals.get(name, 0) + n - before.get(name, 0)
            return out
        return run

    loop.validate = counted(loop.validate)
    loop.validate_cached = counted(loop.validate_cached)
    # The elements of the train state's param and Adam-moment shards, as
    # the loop creates it (phase_fsdp holds them to JAX's counts).
    elements: dict = {}
    create_train_state = loop.create_train_state

    def counted_state(params, *a, **k):
        state = create_train_state(params, *a, **k)
        for key, tree in (("params", state.params),
                          ("moments", state.opt_state.mu)):
            elements.setdefault(key, sum(t.numel() for t in
                                         tree_leaves(tree)))
        return state

    loop.create_train_state = counted_state
    from dinov2_od_tpu_torch.ops import _build, moe

    # phase_moe_ep's skewed routers and its dropped-prefix control.
    skew = (_skewed_routers() if os.environ.get("CHIP_SMOKE_MOE_SKEW")
            else contextlib.nullcontext())
    if os.environ.get("CHIP_SMOKE_MOE_RING_FAULT"):
        moe.ring_counts = _without_prefix
    _build.reset_launch_counts()
    sys.argv = ["dinov2_od_tpu_torch.train", *args]
    rc = 0
    try:
        with skew:
            runpy.run_module("dinov2_od_tpu_torch.train",
                             run_name="__main__", alter_sys=True)
    except SystemExit as stop:
        rc = stop.code if isinstance(stop.code, int) else 1
    torch.cuda.synchronize()
    with open(counts_file, "w") as f:
        json.dump({"rc": rc, "launches": _launched(),
                   "eval": {k: v for k, v in evals.items() if v},
                   "elements": elements,
                   "max_memory": torch.cuda.max_memory_allocated()}, f)
    return rc


class _MeshJob:
    """MESH_WORLD ranks of the CLI on `args`, each a `--cli-rank` process
    on a free port (`env` added to its environment), writing its output
    to work/name.rank{r}.log."""

    def __init__(self, name: str, work: str, args: list,
                 env: Optional[dict] = None):
        import os
        import socket

        self.name, self.work = name, work
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
        self.procs, self.logs = [], []
        self.t0 = time.perf_counter()
        for r in range(MESH_WORLD):
            path = os.path.join(work, f"{name}.rank{r}.log")
            self.logs.append(path)
            with open(path, "wb") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--cli-rank", self.counts(r), "--", *args,
                     "--coordinator_address", f"127.0.0.1:{port}",
                     "--num_processes", str(MESH_WORLD),
                     "--process_id", str(r)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))

    def counts(self, r: int) -> str:
        import os

        return os.path.join(self.work, f"{self.name}.rank{r}.json")

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self) -> list:
        """Each rank's counts once all exited 0, with the job's wall
        seconds; a rank that fails or outlives MESH_JOB_TIMEOUT_S fails
        the phase, its peers killed first."""
        while any(p.poll() is None for p in self.procs):
            if (any(p.poll() not in (None, 0) for p in self.procs)
                    or time.perf_counter() - self.t0 > MESH_JOB_TIMEOUT_S):
                break
            time.sleep(0.2)
        codes = [p.poll() for p in self.procs]
        self.wall = time.perf_counter() - self.t0
        self.kill()
        if any(c != 0 for c in codes):
            bad = next(r for r, c in enumerate(codes) if c != 0)
            with open(self.logs[bad], errors="replace") as f:
                tail = f.read()[-6000:]
            raise AssertionError(
                f"mesh cli ({self.name}): ranks exited {codes} after "
                f"{self.wall:.1f} s (None: killed at the "
                f"{MESH_JOB_TIMEOUT_S} s timeout); rank {bad}:\n{tail}")
        out = []
        for r in range(MESH_WORLD):
            with open(self.counts(r)) as f:
                out.append(json.load(f))
            with open(self.logs[r], errors="replace") as f:
                out[-1]["log"] = f.read()
        return out


def _mesh_losses(out_dir: str, epochs: int) -> list:
    logs = _epoch_logs(out_dir, range(epochs))
    return [x for e in range(epochs) for x in logs[e]["losses"]]


def _mesh_compare_losses(job: str, got: list, want: list, epochs: int):
    """Per-step losses of a mesh job against one process's (MESH_*_TOL)."""
    if len(got) != len(want) or not np.isfinite(got).all():
        raise AssertionError(f"mesh cli ({job}): losses {got} against one "
                             f"process's {want}")
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    per = len(got) // epochs
    means = [abs(np.mean(got[e * per:(e + 1) * per])
                 - np.mean(want[e * per:(e + 1) * per]))
             / abs(np.mean(want[e * per:(e + 1) * per]))
             for e in range(epochs)]
    log(f"mesh cli ({job}): per-step losses {got}; one process {want}; "
        f"relative differences {rel} (first step limit "
        f"{MESH_FIRST_LOSS_TOL}, later {MESH_LOSS_TOL}), epoch means "
        f"{means} (limit {MESH_MEAN_LOSS_TOL})")
    if (rel[0] > MESH_FIRST_LOSS_TOL or max(rel[1:]) > MESH_LOSS_TOL
            or max(means) > MESH_MEAN_LOSS_TOL):
        raise AssertionError(f"mesh cli ({job}): losses disagree with one "
                             f"process's")


def _mesh_compare_metrics(job: str, got: dict, want: dict,
                          detections: tuple):
    """COCO AP within MESH_AP_TOL; AP50 and AP75 logged beside it, and
    the two runs' counts of detections above the score threshold."""
    diff = {k: abs(got[k] - want[k]) for k in ("AP", "AP50", "AP75")}
    log(f"mesh cli ({job}): AP {got['AP']:.6f}, AP50 {got['AP50']:.6f}, "
        f"AP75 {got['AP75']:.6f} against {want['AP']:.6f}, "
        f"{want['AP50']:.6f}, {want['AP75']:.6f}: {diff} (AP limit "
        f"{MESH_AP_TOL}); detections {detections[0]} against "
        f"{detections[1]}")
    if not all(np.isfinite(got[k]) for k in diff) or (
            diff["AP"] > MESH_AP_TOL):
        raise AssertionError(f"mesh cli ({job}): AP disagrees")


def _mesh_detections(out: dict, *runs) -> tuple:
    """The detections above the score threshold in each run's
    predictions_epoch_N.json, runs given as (name in `out`, N)."""
    import os

    counts = []
    for name, epoch in runs:
        with open(os.path.join(out[name],
                               f"predictions_epoch_{epoch}.json")) as f:
            counts.append(len(json.load(f)))
    return tuple(counts)


def _one_process_cli(args: list) -> tuple:
    """`train.cli.main(args)` in this process on the card: (its launches,
    wall seconds)."""
    import torch

    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.train import cli

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(args)
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"mesh cli: one-process main {args} -> {rc}")
    return _launched(), time.perf_counter() - t0


def phase_mesh_cli(seed: int, kernels: dict):
    """The training CLI on a mesh of processes, one process a rank: (a)
    1 x TP 4 for 2 epochs, validation and checkpoints each; (b) DP 2 x CP
    2 from the sharded device cache for 1 epoch; (c) `--only_evaluate
    --quantize int8` under TP 4 from (a)'s last checkpoint. Each against
    one process's run of the same flags on the same data; the per-rank
    launches of B4f/B4b (a, c), B1/B2/B3 (b) and B6 (c, 0) asserted
    exactly; only rank 0 writes files."""
    import os
    import shutil
    import tempfile

    import torch

    from dinov2_od_tpu_torch.config import detector_config_for_model_name

    bb = detector_config_for_model_name("facebook/dinov2-base").backbone
    depth, adapted = bb.depth, bb.lora_last_n_blocks
    steps_per_epoch = MESH_TRAIN_IMAGES // MESH_BATCH
    val_batches = -(-MESH_VAL_IMAGES // MESH_BATCH)
    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="mesh_cli_", dir=build)
    jobs = []
    try:
        splits = _cli_splits(seed, work, 224, MESH_TRAIN_IMAGES,
                             MESH_VAL_IMAGES)
        out = {k: os.path.join(work, k) for k in (
            "tp", "tp_one", "cp", "cp_one", "int8_tp", "eval_one")}
        common = ["--packed_train_data", splits["train"],
                  "--packed_val_data", splits["val"],
                  "--dino_model", "facebook/dinov2-base",
                  "--image_size", "224", "--backbone_dtype", "bfloat16",
                  "--batch_size", str(MESH_BATCH), "--val_frequency", "1",
                  "--checkpoint_frequency", "1", "--log_frequency", "1",
                  "--num_workers", "2"]
        tp_args = common + ["--num_epochs", "2"]
        cp_args = common + ["--num_epochs", "1", "--device_cache"]
        log(f"mesh cli: ViT-B/14 bf16 at 224 px, {MESH_TRAIN_IMAGES} train "
            f"and {MESH_VAL_IMAGES} val packed images, global batch "
            f"{MESH_BATCH}, 100 GT slots; {MESH_WORLD} ranks a job, each a "
            f"`python -m dinov2_od_tpu_torch.train` process on cuda:0 in a "
            f"gloo group (host-staged collectives on one shared card: "
            f"correctness, not a parallel speed); (a) TP 4 and (b) DP 2 x "
            f"CP 2 run at once")
        jobs.append(_MeshJob("tp", work, tp_args + [
            "--model_parallel", str(MESH_WORLD), "--output_dir", out["tp"]]))
        jobs.append(_MeshJob("cp", work, cp_args + [
            "--context_parallel_size", str(MESH_RING),
            "--device_cache_layout", "sharded", "--output_dir", out["cp"]]))
        one_tp, wall_tp_one = _one_process_cli(tp_args + [
            "--output_dir", out["tp_one"]])
        one_cp, wall_cp_one = _one_process_cli(cp_args + [
            "--output_dir", out["cp_one"]])
        tp, cp = jobs[0].wait(), jobs[1].wait()

        # (a) TP 4: B4f for every block (3 heads a rank), B4b for the
        # adapted ones, nothing else.
        tp_steps, tp_vals = 2 * steps_per_epoch, 2 * val_batches
        want = {"flash_attn_allheads_fwd": depth * (tp_steps + tp_vals),
                "flash_attn_allheads_bwd": adapted * tp_steps}
        want_eval = {"flash_attn_allheads_fwd": depth * tp_vals}
        for r, res in enumerate(tp):
            if res["launches"] != want or res["eval"] != want_eval:
                raise AssertionError(
                    f"mesh cli (a): rank {r} launches {res['launches']} "
                    f"(validation {res['eval']}); expected {want} "
                    f"(validation {want_eval})")
        _mesh_compare_losses("a: TP 4", _mesh_losses(out["tp"], 2),
                             _mesh_losses(out["tp_one"], 2), 2)
        _mesh_compare_metrics("a: TP 4, last validation",
                              _ap(out["tp"], 1), _ap(out["tp_one"], 1),
                              _mesh_detections(out, ("tp", 1),
                                               ("tp_one", 1)))
        names = sorted(os.listdir(out["tp"]))
        logs = [n for n in names if n.endswith("_train.log")]
        want_files = {f"{k}_epoch_{e}.json" for e in (0, 1)
                      for k in ("train", "metrics", "predictions")}
        want_files |= {"checkpoint_epoch_0", "checkpoint_epoch_1",
                       "final_model"}
        # Rank 0's plots and TensorBoard directory, where matplotlib and
        # TensorBoard are installed.
        plots = {"loss_plot.png", "ap_plot.png", "tensorboard"} & set(names)
        if (len(logs) != 1
                or set(names) != want_files | set(logs) | plots
                or not all(f"[rank {r}]" in res["log"]
                           for r, res in enumerate(tp) if r)):
            raise AssertionError(f"mesh cli (a): the run's files {names}: "
                                 f"expected rank 0's alone")

        # (b) DP 2 x CP 2: the ring's B1 (24 forward + the adapted blocks'
        # 4 recomputed a step, 24 a val batch) and B2, every one through
        # B3's route.
        cp_steps, cp_vals = steps_per_epoch, val_batches
        fwd_step = depth * MESH_RING + adapted * MESH_RING
        bwd_step = adapted * MESH_RING
        fwd_val = depth * MESH_RING
        want = {"flash_attn_fwd": fwd_step * cp_steps + fwd_val * cp_vals,
                "flash_attn_bwd": bwd_step * cp_steps}
        want["flash_attention_lse"] = sum(want.values())
        want_eval = {"flash_attn_fwd": fwd_val * cp_vals,
                     "flash_attention_lse": fwd_val * cp_vals}
        for r, res in enumerate(cp):
            if res["launches"] != want or res["eval"] != want_eval:
                raise AssertionError(
                    f"mesh cli (b): rank {r} launches {res['launches']} "
                    f"(validation {res['eval']}); expected {want} "
                    f"(validation {want_eval})")
            if (f"(sharded, {MESH_TRAIN_IMAGES // 2} of "
                    f"{MESH_TRAIN_IMAGES} rows)") not in res["log"]:
                raise AssertionError(f"mesh cli (b): rank {r} did not hold "
                                     f"half the rows")
        _mesh_compare_losses("b: DP 2 x CP 2, sharded cache",
                             _mesh_losses(out["cp"], 1),
                             _mesh_losses(out["cp_one"], 1), 1)
        _mesh_compare_metrics("b: DP 2 x CP 2, validation",
                              _ap(out["cp"], 0), _ap(out["cp_one"], 0),
                              _mesh_detections(out, ("cp", 0),
                                               ("cp_one", 0)))

        # (c) int8 under TP 4 from (a)'s last checkpoint: B6 off (0), 12
        # B4f a val batch; the same checkpoint in one process in bf16.
        last = os.path.join(out["tp"], "checkpoint_epoch_1")
        ev = ["--packed_val_data", splits["val"],
              "--dino_model", "facebook/dinov2-base", "--image_size", "224",
              "--backbone_dtype", "bfloat16", "--batch_size", str(MESH_BATCH),
              "--only_evaluate", "--checkpoint", last]
        jobs.append(_MeshJob("int8_tp", work, ev + [
            "--quantize", "int8", "--model_parallel", str(MESH_WORLD),
            "--output_dir", out["int8_tp"]]))
        one_ev, wall_ev_one = _one_process_cli(ev + [
            "--output_dir", out["eval_one"]])
        i8 = jobs[2].wait()
        want = {"flash_attn_allheads_fwd": depth * val_batches}
        for r, res in enumerate(i8):
            if res["launches"] != want or res["eval"] != want:
                raise AssertionError(f"mesh cli (c): rank {r} launches "
                                     f"{res['launches']}; expected {want} "
                                     f"and no int8_gemm (B6)")
        _mesh_compare_metrics("c: one process bf16 on (a)'s last "
                              "checkpoint vs (a)'s last validation",
                              _ap(out["eval_one"], 2), _ap(out["tp"], 1),
                              _mesh_detections(out, ("eval_one", 2),
                                               ("tp", 1)))
        _mesh_compare_metrics("c: int8 under TP 4 vs one process bf16",
                              _ap(out["int8_tp"], 2), _ap(out["eval_one"], 2),
                              _mesh_detections(out, ("int8_tp", 2),
                                               ("eval_one", 2)))

        for kname, jobs_counts in (
                ("flash_attn_allheads_fwd", (("tp", tp), ("int8_tp", i8))),
                ("flash_attn_allheads_bwd", (("tp", tp),)),
                ("flash_attn_fwd", (("cp", cp),)),
                ("flash_attn_bwd", (("cp", cp),)),
                ("flash_attention_lse", (("cp", cp),)),
                ("int8_gemm", (("int8_tp", i8),))):
            k = kernels[kname]
            for job, ranks in jobs_counts:
                per_rank = [res["launches"].get(kname, 0) for res in ranks]
                k["launches"] += sum(per_rank)
                k.setdefault("launches_mesh_cli", {})[job] = per_rank
        tp_ips = _epoch_logs(out["tp"], (1,))[1]["images_per_sec"]
        cp_ips = _epoch_logs(out["cp"], (0,))[0]["images_per_sec"]
        log("mesh cli: " + json.dumps({
            "metric": "wall seconds of each job and host seconds a step "
                      "(rank 0's epoch records) with the ranks sharing "
                      "one card over host-staged gloo collectives: not a "
                      "parallel speed",
            "jobs_a_b_at_once": True,
            "wall_s": {"a_tp4": jobs[0].wall, "b_dp2_cp2": jobs[1].wall,
                       "c_int8_tp4": jobs[2].wall},
            "s_per_step": {"a_tp4_epoch1": MESH_BATCH / tp_ips,
                           "b_dp2_cp2": MESH_BATCH / cp_ips},
            "one_process_wall_s": {"a": wall_tp_one, "b": wall_cp_one,
                                   "c_bf16_eval": wall_ev_one},
            "one_process_launches": {"a": one_tp, "b": one_cp,
                                     "c": one_ev},
            "phase_s": time.perf_counter() - t_phase,
            "card": card_line()}))
    finally:
        for job in jobs:
            job.kill()
        shutil.rmtree(work, ignore_errors=True)


def _check_rank_files(phase: str, job: str, out_dir: str, ranks: list,
                      mesh_line: str) -> None:
    """One set of files, rank 0's, from a one-epoch run with validation
    and a checkpoint; each rank logged its place on the mesh (its log
    holds `mesh_line`)."""
    import os

    names = sorted(os.listdir(out_dir))
    logs = [n for n in names if n.endswith("_train.log")]
    want = {"train_epoch_0.json", "metrics_epoch_0.json",
            "predictions_epoch_0.json", "checkpoint_epoch_0", "final_model"}
    plots = {"loss_plot.png", "ap_plot.png", "tensorboard"} & set(names)
    if (len(logs) != 1 or set(names) != want | set(logs) | plots
            or not all(f"[rank {r}]" in res["log"]
                       for r, res in enumerate(ranks) if r)
            or not all(mesh_line in res["log"] for res in ranks)):
        raise AssertionError(f"{phase} ({job}): the run's files {names}: "
                             f"expected rank 0's alone, and every rank's "
                             f"log to hold {mesh_line!r}")


def _epoch_jobs(phase: str, work: str, out: dict, common: list,
                flags: dict, ones: dict, refs: dict, want, mesh_lines: dict,
                jobs: dict, elements: Optional[dict] = None,
                env: Optional[dict] = None):
    """The one-epoch CLI jobs of a mesh phase (phase_pp, phase_fsdp,
    phase_moe_ep): each job of `flags` (name: its flags after `common`)
    started at once as MESH_WORLD `--cli-rank` processes writing to
    out[name] and entered in `jobs` (the caller kills them), while this
    process runs the one-process runs of `ones` (name: flags after
    `common`) in order, keeping each one's launches, wall seconds and
    peak of allocated memory. Then each job's ranks are held: launches
    and validation's launches exactly to want(name, rank) -> (launches,
    eval), each rank's param and Adam-moment elements to elements[name]
    (param, moments) where given, the per-step losses and the validation
    AP to its one-process run out[refs[name]] (MESH_*_TOL), rank 0 alone
    writing files and every rank's log holding mesh_lines[name]. `env`
    goes to every rank's environment.
    Returns ({name: its ranks' records}, {one-process name: record})."""
    import torch

    for name, f in flags.items():
        jobs[name] = _MeshJob(name, work, common + f + [
            "--output_dir", out[name]], env)
    one = {}
    for name, f in ones.items():
        torch.cuda.reset_peak_memory_stats()
        launches, wall = _one_process_cli(common + f + [
            "--output_dir", out[name]])
        one[name] = {"launches": launches, "wall_s": wall,
                     "max_memory_allocated": torch.cuda
                     .max_memory_allocated()}
        torch.cuda.empty_cache()
    runs = {name: jobs[name].wait() for name in flags}
    for name, ranks in runs.items():
        for r, res in enumerate(ranks):
            launches, evals = want(name, r)
            if res["launches"] != launches or res["eval"] != evals:
                raise AssertionError(
                    f"{phase} ({name}): rank {r} launches "
                    f"{res['launches']} (validation {res['eval']}); "
                    f"expected {launches} (validation {evals})")
            if elements is not None:
                params, moments = elements[name]
                held = {"params": params, "moments": moments}
                if res["elements"] != held:
                    raise AssertionError(
                        f"{phase} ({name}): rank {r} holds "
                        f"{res['elements']} elements of params and Adam "
                        f"moments; JAX's rule gives each device {held}")
        if elements is not None:
            log(f"{phase} ({name}): every rank holds {elements[name][0]} "
                f"param and {elements[name][1]} Adam-moment elements "
                f"(JAX's per-device counts); peak allocated bytes a rank "
                f"{[res['max_memory'] for res in ranks]}, one process "
                f"{one[refs[name]]['max_memory_allocated']} "
                f"(informational: the ranks share the card)")
        ref = refs[name]
        _mesh_compare_losses(f"{phase} {name}", _mesh_losses(out[name], 1),
                             _mesh_losses(out[ref], 1), 1)
        _mesh_compare_metrics(f"{phase} {name}, validation",
                              _ap(out[name], 0), _ap(out[ref], 0),
                              _mesh_detections(out, (name, 0), (ref, 0)))
        _check_rank_files(phase, name, out[name], ranks, mesh_lines[name])
    return runs, one


def _served_checkpoint(phase: str, ckpt: str, model_flags: list,
                       val_split: str, want: dict) -> dict:
    """A mesh run's checkpoint served from one process:
    Predictor.from_checkpoint against a Predictor over the params the
    file holds, bit-equal params and detections on the first MESH_BATCH
    images of the packed `val_split`, launches exactly `want`. Returns
    the launches."""
    import os

    import torch

    from dinov2_od_tpu_torch.data.packed import PackedDataset
    from dinov2_od_tpu_torch.inference import Predictor
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.train import cli
    from dinov2_od_tpu_torch.train.checkpoint import STATE_FILE
    from dinov2_od_tpu_torch.train.state import tree_leaves, tree_map

    det = cli.build_detector_config(cli.build_arg_parser().parse_args(
        model_flags))
    served = Predictor.from_checkpoint(ckpt, detector_cfg=det,
                                       batch_size=MESH_BATCH)
    held = torch.load(os.path.join(ckpt, STATE_FILE),
                      weights_only=True)["params"]
    direct = Predictor(tree_map(lambda t: t.cuda(), held), det,
                       batch_size=MESH_BATCH)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(served.params), tree_leaves(direct.params)))
    val = PackedDataset(val_split).get_batch(range(MESH_BATCH))
    images = list(val["images"].astype(np.float32) / 255.0)
    _build.reset_launch_counts()
    got = served.detect(images, score_threshold=0.0)
    torch.cuda.synchronize()
    counts = _launched()
    ref = direct.detect(images, score_threshold=0.0)
    log(f"{phase}: Predictor.from_checkpoint({ckpt}): params equal the "
        f"file's {same}, {sum(map(len, got))} detections on {MESH_BATCH} "
        f"val images equal {got == ref}, launches {counts}")
    if not same or got != ref or counts != want:
        raise AssertionError(f"{phase}: the checkpoint does not serve as "
                             f"the params it holds")
    del served, direct
    torch.cuda.empty_cache()
    return counts


def phase_pp(seed: int, kernels: dict):
    """Pipeline parallelism of the backbone through the training CLI, one
    process a rank (PP_JOBS): (a) legacy GPipe over 4 stages and (b)
    interleaved PP 2 x TP 2, each for an epoch with validation and a
    checkpoint, beside one process's run of the same flags; the per-rank
    launches of B1 and B2 held exactly to PP_WANT; only rank 0 writes;
    `--only_evaluate` under (a)'s mesh from its checkpoint beside one
    process's; that checkpoint through `Predictor.from_checkpoint` on one
    process, bit-equal to a Predictor built from the params it holds."""
    import os
    import shutil
    import tempfile

    steps = MESH_TRAIN_IMAGES // MESH_BATCH
    val_batches = -(-MESH_VAL_IMAGES // MESH_BATCH)
    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="pp_", dir=build)
    jobs = {}
    try:
        splits = _cli_splits(seed, work, 224, MESH_TRAIN_IMAGES,
                             MESH_VAL_IMAGES)
        out = {k: os.path.join(work, k)
               for k in (*PP_JOBS, "one", "eval", "eval_one")}
        model = ["--dino_model", "facebook/dinov2-base", "--image_size",
                 "224", "--backbone_dtype", "bfloat16", "--batch_size",
                 str(MESH_BATCH)]
        common = model + [
            "--packed_train_data", splits["train"], "--packed_val_data",
            splits["val"], "--num_epochs", "1", "--val_frequency", "1",
            "--checkpoint_frequency", "1", "--log_frequency", "1",
            "--num_workers", "2"]
        log(f"pp: ViT-B/14 bf16 at 224 px, {MESH_TRAIN_IMAGES} train and "
            f"{MESH_VAL_IMAGES} val packed images, global batch "
            f"{MESH_BATCH}, 100 GT slots, 1 epoch; {MESH_WORLD} ranks a "
            f"job on cuda:0 in a gloo group (activations and cotangents "
            f"between stages staged through the host: correctness, not a "
            f"pipeline speed); {list(PP_JOBS)} at once")

        def want(name, r):
            # Each rank's own blocks' B1, its own adapted blocks' B2.
            fwd_step, bwd_step, fwd_val = PP_WANT[name]
            launches = {"flash_attn_fwd": (fwd_step[r] * steps
                                           + fwd_val[r] * val_batches)}
            if bwd_step[r]:
                launches["flash_attn_bwd"] = bwd_step[r] * steps
            return launches, {"flash_attn_fwd": fwd_val[r] * val_batches}

        runs, one = _epoch_jobs(
            "pp", work, out, common, PP_JOBS, {"one": []},
            dict.fromkeys(PP_JOBS, "one"), want,
            dict.fromkeys(PP_JOBS, "mesh: data 1 x stage"), jobs)

        # --only_evaluate under (a)'s stages from its checkpoint: 12 B1 a
        # val batch on every rank, beside one process's evaluation.
        legacy = "a_legacy_gpipe"
        ckpt = os.path.join(out[legacy], "checkpoint_epoch_0")
        ev = model + ["--packed_val_data", splits["val"], "--only_evaluate",
                      "--checkpoint", ckpt]
        jobs["eval"] = _MeshJob("pp_eval", work, ev + PP_JOBS[legacy] + [
            "--output_dir", out["eval"]])
        one_ev, wall_ev_one = _one_process_cli(ev + ["--output_dir",
                                                     out["eval_one"]])
        evals = jobs["eval"].wait()
        want_ev = {"flash_attn_fwd": 12 * val_batches}
        for r, res in enumerate(evals):
            if res["launches"] != want_ev or res["eval"] != want_ev:
                raise AssertionError(f"pp (eval): rank {r} launches "
                                     f"{res['launches']}; expected "
                                     f"{want_ev}")
        # The checkpoint resumes at epoch 1, which names the files.
        _mesh_compare_metrics("pp --only_evaluate under (a)'s mesh",
                              _ap(out["eval"], 1), _ap(out["eval_one"], 1),
                              _mesh_detections(out, ("eval", 1),
                                               ("eval_one", 1)))

        # (a)'s checkpoint served from one process.
        served_counts = _served_checkpoint("pp", ckpt, model, splits["val"],
                                           {"flash_attn_fwd": 12})

        for kname, key in (("flash_attn_fwd", "flash_attn_fwd"),
                           ("flash_attn_bwd", "flash_attn_bwd")):
            k = kernels[kname]
            for job, ranks in (*runs.items(), ("eval", evals)):
                per_rank = [res["launches"].get(key, 0) for res in ranks]
                k["launches"] += sum(per_rank)
                k.setdefault("launches_pp", {})[job] = per_rank
        kernels["flash_attn_fwd"]["launches"] += served_counts[
            "flash_attn_fwd"]
        log("pp: " + json.dumps({
            "metric": "wall seconds of each job and host seconds a step "
                      "(rank 0's epoch record) with the ranks sharing one "
                      "card over host-staged gloo transfers: not a "
                      "pipeline speed",
            "jobs_at_once": list(PP_JOBS),
            "wall_s": {**{n: j.wall for n, j in jobs.items()}},
            "s_per_step": {n: MESH_BATCH / _epoch_logs(out[n], (0,))[0][
                "images_per_sec"] for n in PP_JOBS},
            "one_process_wall_s": {"train": one["one"]["wall_s"],
                                   "eval": wall_ev_one},
            "one_process_launches": {"train": one["one"]["launches"],
                                     "eval": one_ev},
            "phase_s": time.perf_counter() - t_phase,
            "card": card_line()}))
    finally:
        for job in jobs.values():
            job.kill()
        shutil.rmtree(work, ignore_errors=True)


def phase_fsdp(seed: int, kernels: dict):
    """FSDP (ZeRO-3 over the data axis) through the training CLI, one
    process a rank (FSDP_JOBS): (a) FSDP over 4 data ranks at ViT-L/14
    and (b) FSDP 2 x TP 2 at ViT-B/14, each for an epoch with validation
    and a checkpoint, beside one process's run of the same model; the
    per-rank launches of B1 and B2 held exactly to FSDP_WANT and the
    per-rank param and Adam-moment elements to FSDP_ELEMENTS; only rank 0
    writes; `--only_evaluate --quantize int8 --fsdp` under (a)'s mesh from
    its checkpoint (B6 on the gathered fc2 kernels) beside one process's;
    that checkpoint through `Predictor.from_checkpoint` on one process,
    bit-equal to a Predictor built from the params it holds. Each rank's
    peak of allocated memory is printed beside the one process's."""
    import os
    import shutil
    import tempfile

    steps = MESH_TRAIN_IMAGES // MESH_BATCH
    val_batches = -(-MESH_VAL_IMAGES // MESH_BATCH)
    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="fsdp_", dir=build)
    jobs = {}
    try:
        splits = _cli_splits(seed, work, 224, MESH_TRAIN_IMAGES,
                             MESH_VAL_IMAGES)
        out = {k: os.path.join(work, k) for k in (
            *FSDP_JOBS, *(f"{n}_one" for n in FSDP_JOBS), "eval",
            "eval_one")}
        base = ["--image_size", "224", "--backbone_dtype", "bfloat16",
                "--batch_size", str(MESH_BATCH)]
        common = base + [
            "--packed_train_data", splits["train"], "--packed_val_data",
            splits["val"], "--num_epochs", "1", "--val_frequency", "1",
            "--checkpoint_frequency", "1", "--log_frequency", "1",
            "--num_workers", "2"]
        log(f"fsdp: bf16 at 224 px, {MESH_TRAIN_IMAGES} train and "
            f"{MESH_VAL_IMAGES} val packed images, global batch "
            f"{MESH_BATCH}, 100 GT slots, 1 epoch; {MESH_WORLD} ranks a "
            f"job on cuda:0 in a gloo group (each leaf's gather and its "
            f"gradient's reduce-scatter staged through the host: "
            f"correctness, not a ZeRO-3 speed); {list(FSDP_JOBS)} at once")

        def want(name, r):
            # FSDP changes no launch count: every rank runs the whole
            # model on its batch rows.
            fwd_step, bwd_step, fwd_val = FSDP_WANT[name]
            return ({"flash_attn_fwd": fwd_step * steps
                     + fwd_val * val_batches,
                     "flash_attn_bwd": bwd_step * steps},
                    {"flash_attn_fwd": fwd_val * val_batches})

        def mesh_line(name):
            model = 2 if "--model_parallel" in FSDP_JOBS[name] else 1
            return (f"mesh: data {MESH_WORLD // model} x context 1 x model "
                    f"{model}, fsdp")

        runs, one = _epoch_jobs(
            "fsdp", work, out, common, FSDP_JOBS,
            {f"{n}_one": f[:2] for n, f in FSDP_JOBS.items()},
            {n: f"{n}_one" for n in FSDP_JOBS}, want,
            {n: mesh_line(n) for n in FSDP_JOBS}, jobs, FSDP_ELEMENTS)

        # int8 under (a)'s mesh from its checkpoint: quantized whole, cut,
        # and each block's fc2 through B6 on its gathered kernel_q.
        first = "a_fsdp4_vit_l"
        depth = FSDP_WANT[first][2]
        ckpt = os.path.join(out[first], "checkpoint_epoch_0")
        ev = base + FSDP_JOBS[first][:2] + [
            "--packed_val_data", splits["val"], "--only_evaluate",
            "--quantize", "int8", "--checkpoint", ckpt]
        jobs["eval"] = _MeshJob("fsdp_eval", work, ev + [
            "--fsdp", "--output_dir", out["eval"]])
        one_ev, wall_ev_one = _one_process_cli(ev + ["--output_dir",
                                                     out["eval_one"]])
        evals = jobs["eval"].wait()
        want_ev = {"flash_attn_fwd": depth * val_batches,
                   "int8_gemm": depth * val_batches}
        for r, res in enumerate(evals):
            if res["launches"] != want_ev or res["eval"] != want_ev:
                raise AssertionError(f"fsdp (int8 eval): rank {r} launches "
                                     f"{res['launches']}; expected "
                                     f"{want_ev}")
        if one_ev != want_ev:
            raise AssertionError(f"fsdp (int8 eval): one process launched "
                                 f"{one_ev}; expected {want_ev}")
        # The checkpoint resumes at epoch 1, which names the files.
        _mesh_compare_metrics("fsdp --only_evaluate --quantize int8 under "
                              "(a)'s mesh", _ap(out["eval"], 1),
                              _ap(out["eval_one"], 1),
                              _mesh_detections(out, ("eval", 1),
                                               ("eval_one", 1)))

        # (a)'s checkpoint served from one process.
        served_counts = _served_checkpoint(
            "fsdp", ckpt, base + FSDP_JOBS[first][:2], splits["val"],
            {"flash_attn_fwd": depth})

        for kname in ("flash_attn_fwd", "flash_attn_bwd", "int8_gemm"):
            k = kernels[kname]
            for job, ranks in (*runs.items(), ("eval", evals)):
                per_rank = [res["launches"].get(kname, 0) for res in ranks]
                k["launches"] += sum(per_rank)
                k.setdefault("launches_fsdp", {})[job] = per_rank
        kernels["flash_attn_fwd"]["launches"] += served_counts[
            "flash_attn_fwd"]
        log("fsdp: " + json.dumps({
            "metric": "wall seconds of each job and host seconds a step "
                      "(rank 0's epoch record) with the ranks sharing one "
                      "card over host-staged gloo gathers: not a ZeRO-3 "
                      "speed",
            "jobs_at_once": list(FSDP_JOBS),
            "wall_s": {n: j.wall for n, j in jobs.items()},
            "s_per_step": {n: MESH_BATCH / _epoch_logs(out[n], (0,))[0][
                "images_per_sec"] for n in FSDP_JOBS},
            "max_memory_allocated": {
                n: {"ranks": [res["max_memory"] for res in runs[n]],
                    "one_process": one[f"{n}_one"]["max_memory_allocated"]}
                for n in FSDP_JOBS},
            "one_process_wall_s": {
                **{n: one[f"{n}_one"]["wall_s"] for n in FSDP_JOBS},
                "int8_eval": wall_ev_one},
            "one_process_launches": {
                **{n: one[f"{n}_one"]["launches"] for n in FSDP_JOBS},
                "int8_eval": one_ev},
            "phase_s": time.perf_counter() - t_phase,
            "card": card_line()}))
    finally:
        for job in jobs.values():
            job.kill()
        shutil.rmtree(work, ignore_errors=True)


def _without_prefix(local, mesh):
    """`ring_counts` as the dropped-prefix control has it: no earlier
    shard's claims, the row's total this shard's own."""
    import torch

    return torch.zeros_like(local), local


def _moe_ring_rank(rank: int, world: int, port: int, work: str, seed: int):
    """One rank of phase_moe_ep's ring routing check (MOE_RING_*): DP 1 x
    CP 2 x EP 2 on cuda:0 in a gloo group, `moe_ffn` on its shard and on
    the whole rows, then the control; writes its readings to
    work/rank{r}.json."""
    import os

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from dinov2_od_tpu_torch.config import MeshConfig
    from dinov2_od_tpu_torch.ops import moe
    from dinov2_od_tpu_torch.parallel.sharding import (create_mesh,
                                                       shard_params)

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    route, ring_counts = moe.route, moe.ring_counts
    try:
        mesh = create_mesh(2, MeshConfig(context_parallel_size=2))
        g = torch.Generator().manual_seed(seed)
        e, d, hid = len(MOE_RING_SKEW), 768, 3072
        x = torch.randn((MESH_BATCH, S + 1, d), generator=g)
        x[..., :e] += torch.tensor(MOE_RING_SKEW)
        router = torch.zeros((d, e))
        router[:e] = torch.eye(e)
        mp = {"router_kernel": router}
        for name, shape in (("fc1_kernel", (e, d, hid)),
                            ("fc1_bias", (e, hid)),
                            ("fc2_kernel", (e, hid, d)),
                            ("fc2_bias", (e, d))):
            mp[name] = 0.02 * torch.randn(shape, generator=g)
        x = x.to("cuda", torch.bfloat16)
        mp = {k: v.to("cuda", torch.bfloat16) for k, v in mp.items()}
        combines = []

        def recorded(*a, **k):
            res = route(*a, **k)
            combines.append(res[0])
            return res

        moe.route = recorded
        kw = dict(top_k=2, capacity_factor=1.25, activation=F.gelu)
        n = x.shape[1] // mesh.context_size
        first = mesh.context_index * n
        real = min(n, S - first)
        with torch.no_grad():
            whole, whole_aux = moe.moe_ffn(x[:, :S], mp, **kw)
            ref = combines.pop()[:, first:first + real]
            mine = x[:, first:first + n]
            shard = shard_params({"moe": mp}, mesh)["moe"]
            out = {"experts": shard["fc1_kernel"].shape[0],
                   "choices": 2 * MESH_BATCH * real,
                   "dropped": 2 * MESH_BATCH * real - int((ref > 0).sum())}
            for name, counts in (("sound", ring_counts),
                                 ("control", _without_prefix)):
                moe.ring_counts = counts
                y, aux = moe.moe_ffn(mine, shard, mesh=mesh, valid_len=S,
                                     **kw)
                comb = combines.pop()
                ref_y = whole[:, first:first + real].float()
                out[name] = {
                    "slots_moved": int(((comb[:, :real] > 0)
                                        != (ref > 0)).sum()),
                    "gate_err": (comb[:, :real] - ref).abs().max().item(),
                    "pad_slots": int((comb[:, real:] > 0).sum()),
                    "pad_out": (y[:, real:].float().abs().max().item()
                                if real < n else 0.0),
                    "out_err": ((y[:, :real].float() - ref_y).abs().max()
                                / whole.float().abs().max()).item(),
                    "aux_err": abs(aux.item() - whole_aux.item())}
        torch.cuda.synchronize()
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        moe.route, moe.ring_counts = route, ring_counts
        dist.destroy_process_group()


def _moe_ring_check(ranks: list) -> dict:
    """phase_moe_ep's ring routing readings held (MOE_RING_*); returns
    them."""
    sound = [r["sound"] for r in ranks]
    control = [r["control"] for r in ranks]
    worst = {k: max(r[k] for r in sound) for k in sound[0]}
    moved = sum(r["slots_moved"] for r in control)
    control_err = max(r["out_err"] for r in control)
    dropped = [r["dropped"] for r in ranks]
    log(f"moe ep: the ring's routing on the card (DP 1 x CP 2 x EP 2, "
        f"moe_ffn on [{MESH_BATCH}, {S} + 1 pad, 768] bf16 shards, 8 "
        f"experts, top-2, {[r['experts'] for r in ranks]} a rank) against "
        f"moe_ffn on the whole rows: worst over the ranks {worst} "
        f"(output tol {MOE_RING_OUT_TOL} of the largest |out|, aux and "
        f"gates {MOE_ROUTING_TOL}); choices dropped in each rank's shard "
        f"{dropped} of {[r['choices'] for r in ranks]}; control "
        f"(no earlier shard's counts): {moved} slots moved, output error "
        f"{control_err:.4g}")
    if (worst["slots_moved"] or worst["pad_slots"] or worst["pad_out"]
            or worst["gate_err"] > MOE_ROUTING_TOL
            or worst["aux_err"] > MOE_ROUTING_TOL
            or worst["out_err"] > MOE_RING_OUT_TOL
            or any(r["experts"] != 4 for r in ranks)):
        raise AssertionError("moe ep: the ring's routing is not the whole "
                             "rows'")
    if not dropped[-1] or not moved or control_err <= MOE_RING_OUT_TOL:
        raise AssertionError("moe ep: the later shard dropped no choice, "
                             "or the control did not fail")
    return {"sound": worst, "dropped": dropped, "control_slots_moved": moved,
            "control_out_err": control_err}


@contextlib.contextmanager
def _skewed_routers(routes: Optional[list] = None):
    """Every detector the CLI initialises with its MoE routers times
    MOE_EP_ROUTER_SCALE (models/detector.py `init_detector_params`
    wrapped); with `routes`, each routing of this process appends (the
    choices made, those kept, those kept in the row's later half, the
    later half's choices)."""
    from dinov2_od_tpu_torch.models import detector
    from dinov2_od_tpu_torch.ops import moe

    init, route = detector.init_detector_params, moe.route

    def skewed(*a, **k):
        params = init(*a, **k)
        bb = params["backbone"]
        if "moe_blocks" in bb:
            bb["moe_blocks"]["moe"]["router_kernel"].mul_(
                MOE_EP_ROUTER_SCALE)
        return params

    def recorded(logits, top_k, *a, **k):
        res = route(logits, top_k, *a, **k)
        kept = (res[0] > 0).sum(dim=(-1, -2))  # [B, N]
        half = logits.shape[1] // 2
        routes.append((top_k * kept.numel(), int(kept.sum()),
                       int(kept[:, half:].sum()),
                       top_k * kept[:, half:].numel()))
        return res

    detector.init_detector_params = skewed
    if routes is not None:
        moe.route = recorded
    try:
        yield
    finally:
        detector.init_detector_params, moe.route = init, route


def _moe_ep_flags(seed: int, work: str) -> tuple:
    """phase_moe_ep's packed splits in `work` and its CLI flags: (the
    splits, the model's flags, the training run's)."""
    splits = _cli_splits(seed, work, 224, MESH_TRAIN_IMAGES,
                         MESH_VAL_IMAGES)
    model = ["--dino_model", "facebook/dinov2-base", "--image_size", "224",
             "--backbone_dtype", "bfloat16", "--batch_size", str(MESH_BATCH),
             "--ffn_type", "moe"]
    common = model + [
        "--packed_train_data", splits["train"], "--packed_val_data",
        splits["val"], "--num_epochs", "1", "--val_frequency", "1",
        "--checkpoint_frequency", "1", "--log_frequency", "1",
        "--num_workers", "2"]
    return splits, model, common


def _first_step_error(phase: str, got: str, want: str) -> float:
    """The relative difference of two runs' first-step losses."""
    a, b = _mesh_losses(got, 1)[0], _mesh_losses(want, 1)[0]
    rel = abs(a - b) / abs(b)
    log(f"{phase}: first-step loss {a} against one process's {b}: "
        f"relative difference {rel:.4g} (limit "
        f"{MOE_EP_RING_FIRST_LOSS_TOL})")
    return rel


def phase_moe_ep(seed: int, kernels: dict):
    """The MoE FFN under a mesh through the training CLI, one process a
    rank (MOE_EP_JOBS at bench.py's BENCH_FFN=moe model, its routers
    skewed by MOE_EP_ROUTER_SCALE): (a) DP 2 x EP 2, (b) FSDP 2 x EP 2
    and (c) DP 1 x CP 2 x EP 2, each for an epoch with validation and a
    checkpoint, all at once beside one process's run; the per-rank
    launches of B1, B2 and B3 held exactly to MOE_EP_WANT, the per-rank
    param and Adam-moment elements to MOE_EP_ELEMENTS, the losses and
    loss_moe_aux to one process's (MESH_*_TOL; (c)'s first step also to
    MOE_EP_RING_FIRST_LOSS_TOL); only rank 0 writes; `--only_evaluate
    --quantize int8` from (a)'s checkpoint on a DP 4 mesh (B6 on) and
    under (a)'s mesh (B6 off) beside one process's; that checkpoint
    through `Predictor.from_checkpoint` on one process, bit-equal to a
    Predictor built from the params it holds. Beside the jobs, the ring's
    routing on the card with its control (MOE_RING_*)."""
    import os
    import shutil
    import socket
    import tempfile

    import torch.multiprocessing as mp

    steps = MESH_TRAIN_IMAGES // MESH_BATCH
    val_batches = -(-MESH_VAL_IMAGES // MESH_BATCH)
    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="moe_ep_", dir=build)
    jobs, ring = {}, None
    try:
        ring_dir = os.path.join(work, "ring")
        os.makedirs(ring_dir)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        ring = mp.start_processes(
            _moe_ring_rank, args=(MESH_WORLD, port, ring_dir, seed),
            nprocs=MESH_WORLD, join=False, start_method="spawn")
        splits, model, common = _moe_ep_flags(seed, work)
        out = {k: os.path.join(work, k) for k in (
            *MOE_EP_JOBS, "one", "int8_dp4", "int8_ep", "int8_one")}
        log(f"moe ep: ViT-B/14 bf16 at 224 px, the MoE FFN (8 experts, "
            f"top-2, capacity factor 1.25) in the 2 adapted blocks, its "
            f"routers x{MOE_EP_ROUTER_SCALE}, {MESH_TRAIN_IMAGES} train and "
            f"{MESH_VAL_IMAGES} val packed images, global batch "
            f"{MESH_BATCH}, 100 GT slots, 1 epoch; {MESH_WORLD} ranks a "
            f"job on cuda:0 in a gloo group (host-staged collectives on one "
            f"shared card: correctness, not an expert-parallel speed); "
            f"{list(MOE_EP_JOBS)} at once")

        def want(name, r):
            fs, bs, ls, fv, lv = MOE_EP_WANT[name]
            launches = {"flash_attn_fwd": fs * steps + fv * val_batches,
                        "flash_attn_bwd": bs * steps}
            evals = {"flash_attn_fwd": fv * val_batches}
            if ls:
                launches["flash_attention_lse"] = (ls * steps
                                                   + lv * val_batches)
                evals["flash_attention_lse"] = lv * val_batches
            return launches, evals

        lines = {"a_dp2_ep2": "mesh: data 2 x context 1 x model 2",
                 "b_fsdp2_ep2": "mesh: data 2 x context 1 x model 2, fsdp",
                 "c_cp2_ep2": "mesh: data 1 x context 2 x model 2"}
        routes = []
        with _skewed_routers(routes):
            runs, one = _epoch_jobs(
                "moe ep", work, out, common, MOE_EP_JOBS, {"one": []},
                dict.fromkeys(MOE_EP_JOBS, "one"), want, lines, jobs,
                MOE_EP_ELEMENTS, env={"CHIP_SMOKE_MOE_SKEW": "1"})
        while not ring.join():
            pass
        ring_readings = _moe_ring_check([
            json.load(open(os.path.join(ring_dir, f"rank{r}.json")))
            for r in range(MESH_WORLD)])
        chosen, kept, kept_later, later = routes[0]
        log(f"moe ep: one process's first routing keeps {kept} of {chosen} "
            f"choices, {kept_later} of the later half's {later}")
        if kept_later == later:
            raise AssertionError("moe ep: the skewed routers drop no choice "
                                 "in the row's later half")
        aux_one = _epoch_logs(out["one"], (0,))[0]["loss_moe_aux"]
        for name in MOE_EP_JOBS:
            _mesh_compare_losses(
                f"moe ep {name} loss_moe_aux",
                _epoch_logs(out[name], (0,))[0]["loss_moe_aux"], aux_one, 1)
        ring_first = _first_step_error("moe ep c_cp2_ep2", out["c_cp2_ep2"],
                                       out["one"])
        if ring_first > MOE_EP_RING_FIRST_LOSS_TOL:
            raise AssertionError("moe ep (c_cp2_ep2): the first step parts "
                                 "from one process's")

        # (d) int8 evaluation from (a)'s checkpoint: on a DP 4 mesh, B6 on
        # the dense prefix's fc2s; under (a)'s mesh, B6 off. Both at once
        # beside one process's.
        first = "a_dp2_ep2"
        ckpt = os.path.join(out[first], "checkpoint_epoch_0")
        ev = model + ["--packed_val_data", splits["val"], "--only_evaluate",
                      "--quantize", "int8", "--checkpoint", ckpt]
        jobs["int8_dp4"] = _MeshJob("moe_int8_dp4", work, ev + [
            "--output_dir", out["int8_dp4"]])
        jobs["int8_ep"] = _MeshJob("moe_int8_ep", work, ev + MOE_EP_JOBS[
            first] + ["--output_dir", out["int8_ep"]])
        one_ev, wall_ev_one = _one_process_cli(ev + ["--output_dir",
                                                     out["int8_one"]])
        evals = {"int8_dp4": jobs["int8_dp4"].wait(),
                 "int8_ep": jobs["int8_ep"].wait()}
        want_ev = {"int8_dp4": {"flash_attn_fwd": 12 * val_batches,
                                "int8_gemm": MOE_EP_INT8_FC2 * val_batches},
                   "int8_ep": {"flash_attn_fwd": 12 * val_batches}}
        for name, ranks in evals.items():
            for r, res in enumerate(ranks):
                if (res["launches"] != want_ev[name]
                        or res["eval"] != want_ev[name]):
                    raise AssertionError(
                        f"moe ep ({name}): rank {r} launches "
                        f"{res['launches']}; expected {want_ev[name]}")
            # The checkpoint resumes at epoch 1, which names the files.
            _mesh_compare_metrics(f"moe ep --only_evaluate --quantize int8 "
                                  f"({name})", _ap(out[name], 1),
                                  _ap(out["int8_one"], 1),
                                  _mesh_detections(out, (name, 1),
                                                   ("int8_one", 1)))
        if one_ev != want_ev["int8_dp4"]:
            raise AssertionError(f"moe ep (int8 eval): one process launched "
                                 f"{one_ev}; expected {want_ev['int8_dp4']}")

        # (a)'s checkpoint served from one process.
        served_counts = _served_checkpoint("moe ep", ckpt, model,
                                           splits["val"],
                                           {"flash_attn_fwd": 12})

        every = (*runs.items(), *evals.items())
        for kname in ("flash_attn_fwd", "flash_attn_bwd",
                      "flash_attention_lse", "int8_gemm"):
            k = kernels[kname]
            for job, ranks in every:
                per_rank = [res["launches"].get(kname, 0) for res in ranks]
                k["launches"] += sum(per_rank)
                k.setdefault("launches_moe_ep", {})[job] = per_rank
        kernels["flash_attn_fwd"]["launches"] += served_counts[
            "flash_attn_fwd"]
        log("moe ep: " + json.dumps({
            "metric": "wall seconds of each job and host seconds a step "
                      "(rank 0's epoch record) with the ranks sharing one "
                      "card over host-staged gloo collectives: not an "
                      "expert-parallel speed",
            "jobs_at_once": list(MOE_EP_JOBS),
            "wall_s": {n: j.wall for n, j in jobs.items()},
            "s_per_step": {n: MESH_BATCH / _epoch_logs(out[n], (0,))[0][
                "images_per_sec"] for n in MOE_EP_JOBS},
            "max_memory_allocated": {
                **{n: [res["max_memory"] for res in ranks]
                   for n, ranks in every},
                "one_process": one["one"]["max_memory_allocated"]},
            "one_process_wall_s": {"train": one["one"]["wall_s"],
                                   "int8_eval": wall_ev_one},
            "one_process_launches": {"train": one["one"]["launches"],
                                     "int8_eval": one_ev},
            "one_process_first_routing": routes[0],
            "c_first_step_error": ring_first,
            "ring_routing": ring_readings,
            "phase_s": time.perf_counter() - t_phase,
            "card": card_line()}))
    finally:
        for job in jobs.values():
            job.kill()
        if ring is not None:
            for p in ring.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        shutil.rmtree(work, ignore_errors=True)


def moe_ring_fault_control(seed: int) -> None:
    """The dropped-prefix control of phase_moe_ep's job (c), on its own
    (`python3 chip_smoke.py --moe-ring-fault`): (c)'s flags with every
    rank's `ring_counts` replaced (`_without_prefix`), beside one
    process's run, both at the skewed routers; its first step must part
    from one process's by more than MOE_EP_RING_FIRST_LOSS_TOL."""
    import os
    import shutil
    import tempfile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="moe_fault_", dir=build)
    t0 = time.perf_counter()
    job = None
    try:
        _, _, common = _moe_ep_flags(seed, work)
        out = {k: os.path.join(work, k) for k in ("fault", "one")}
        job = _MeshJob("moe_fault", work, common + MOE_EP_JOBS["c_cp2_ep2"]
                       + ["--output_dir", out["fault"]],
                       env={"CHIP_SMOKE_MOE_SKEW": "1",
                            "CHIP_SMOKE_MOE_RING_FAULT": "1"})
        with _skewed_routers():
            _one_process_cli(common + ["--output_dir", out["one"]])
        job.wait()
        if _first_step_error("moe ring fault control (c)", out["fault"],
                             out["one"]) <= MOE_EP_RING_FIRST_LOSS_TOL:
            raise AssertionError("moe ring fault control: the dropped "
                                 "prefix passes (c)'s first-step limit")
        log(f"moe ring fault control: fails as it should, "
            f"{time.perf_counter() - t0:.1f} s; {card_line()}")
    finally:
        if job is not None:
            job.kill()
        shutil.rmtree(work, ignore_errors=True)


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
    counts = _launches()
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
    """`dinov2_od_tpu_torch.bench` in-process, train (its default),
    BENCH_MODE=eval and BENCH_FFN=moe (the train step with the MoE FFN):
    the four keys of bench.py's line, a positive value, the card's name
    (and for MoE "moe-E8") in the metric, and the flash kernels launched
    (B1 and B2 in the train step, B1 in the forward), nothing else."""
    import torch

    from dinov2_od_tpu_torch import bench
    from dinov2_od_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    for env, want in (({}, _counts(flash_attn_fwd=1, flash_attn_bwd=1)),
                      ({"BENCH_MODE": "eval"}, _counts(flash_attn_fwd=1)),
                      ({"BENCH_FFN": "moe"}, _counts(flash_attn_fwd=1,
                                                     flash_attn_bwd=1))):
        t0 = time.perf_counter()
        _build.reset_launch_counts()
        rec = bench.run(env)
        torch.cuda.synchronize()
        launched = {k: int(n > 0) for k, n in _launches().items()}
        log("bench: " + json.dumps(rec))
        log(f"bench: {env or 'default'}: {time.perf_counter() - t0:.1f} s, "
            f"launches {_launches()}; {card_line()}")
        problems = []
        if list(rec) != ["metric", "value", "unit", "vs_baseline"]:
            problems.append(f"keys {list(rec)}")
        if not rec["value"] > 0:
            problems.append(f"value {rec['value']}")
        if name not in rec["metric"]:
            problems.append(f"the metric does not name {name}")
        if env.get("BENCH_FFN") and "moe-E8 FFN" not in rec["metric"]:
            problems.append("the metric does not name the MoE FFN")
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


def _serving_problems(rec: dict, counts: dict, want: dict, card: str):
    """What is wrong with a bench_serving result: its keys (the JAX
    tool's seven), p50 <= p95 <= p99, a positive rate, the card named in
    the metric, and the kernels launched against `want`."""
    problems = []
    keys = ["metric", "p50_ms", "p95_ms", "p99_ms", "concurrent_img_per_s",
            "requests", "threads"]
    if list(rec) != keys:
        problems.append(f"keys {list(rec)}")
    elif not 0 < rec["p50_ms"] <= rec["p95_ms"] <= rec["p99_ms"]:
        problems.append("p50 <= p95 <= p99 does not hold")
    elif not rec["concurrent_img_per_s"] > 0:
        problems.append("no positive rate")
    elif card not in rec["metric"]:
        problems.append(f"the metric does not name {card}")
    if counts != want:
        problems.append(f"launches {counts}, expected {want}")
    return problems


def _detections_differ(got, want, tol=DETECT_TOL):
    """Where two detect results differ: per image the same category ids
    in order, scores within tol[0], boxes within tol[1] pixels."""
    if len(got) != len(want):
        return f"{len(got)} images against {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        if [d["category_id"] for d in g] != [d["category_id"] for d in w]:
            return f"image {i}: other categories"
        a = np.array([[d["score"], *d["bbox"]] for d in g]).reshape(-1, 5)
        b = np.array([[d["score"], *d["bbox"]] for d in w]).reshape(-1, 5)
        if not np.isfinite(a).all():
            return f"image {i}: non-finite detections"
        if (np.abs(a[:, 0] - b[:, 0]).max(initial=0) > tol[0]
                or np.abs(a[:, 1:] - b[:, 1:]).max(initial=0) > tol[1]):
            return f"image {i}: scores or boxes differ"
    return None


def _device_busy(fn, tries: int = 4):
    """(fn's result, device busy ms, device span ms) of one call of `fn`
    from torch.profiler: the union of the CUDA kernel and copy intervals,
    and the time from the first device event's start to the last one's
    end; the span less the busy time is the device's idle time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            result = fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            break
    else:
        raise AssertionError("the profiler saw no device events")
    busy, (start, end) = 0.0, spans[0]
    for s0, s1 in spans[1:]:
        if s0 > end:
            busy += end - start
            start, end = s0, s1
        else:
            end = max(end, s1)
    busy += end - start
    span = max(s1 for _, s1 in spans) - spans[0][0]
    return result, busy / 1e3, span / 1e3


class _Waited:
    """A CUDA event whose wait is recorded in `order` as "r" and timed
    into `host_ms["wait"]`."""

    def __init__(self, event, order: list, host_ms: dict):
        self.event, self.order, self.host_ms = event, order, host_ms

    def synchronize(self):
        self.order.append("r")
        t0 = time.perf_counter()
        if self.event is not None:  # None: a CPU run's copy is done
            self.event.synchronize()
        self.host_ms["wait"] += (time.perf_counter() - t0) * 1e3


def _timed_into(host_ms: dict, name: str, fn):
    """fn, its host time added to host_ms[name] at every call."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            host_ms[name] += (time.perf_counter() - t0) * 1e3
    return timed


def _check_detect(predictor, n: int, seed: int, want: dict, tag: str,
                  faster: bool):
    """`predictor.detect` over n random images, double-buffered and
    sequential, two runs each under torch.profiler: the detections equal
    both ways (a shuffled chunk as the control), each run's launches
    `want`, and the order of dispatches ("d") and read-back waits ("r"):
    d d r d r ... r double-buffered, d r d r ... sequential (the control).
    With `faster`, the device's idle time between the first and the last
    device event must be lower double-buffered, best run against best run
    (a stall of the shared host only ever adds idle time). The host's time a chunk
    in each stage (staging and copy in, the forward's launches, the copy
    out, the wait, formatting) is logged. Returns the idle readings and
    the launches of the four runs."""
    from dinov2_od_tpu_torch import inference
    from dinov2_od_tpu_torch.ops import _build

    size = predictor.cfg.backbone.image_size
    chunks = n // predictor.batch_size
    rng = np.random.default_rng(seed + 13)
    images = list(rng.uniform(size=(n, size, size, 3)).astype(np.float32))
    predictor.detect(images[:predictor.batch_size], score_threshold=0.0)
    order: list = []
    stages = ("upload", "forward", "download", "wait", "format")
    host_ms = dict.fromkeys(stages, 0.0)
    forward = _timed_into(host_ms, "forward", predictor._forward_topk)
    download = _timed_into(host_ms, "download", predictor._download)
    format_detections = inference.format_detections

    def dispatch(*args):
        order.append("d")
        return forward(*args)

    def read_back(topk):
        host, done = download(topk)
        return host, _Waited(done, order, host_ms)

    predictor._forward_topk, predictor._download = dispatch, read_back
    predictor._upload = _timed_into(host_ms, "upload", predictor._upload)
    inference.format_detections = _timed_into(host_ms, "format",
                                              format_detections)
    runs, idle, orders, total, host = {}, {}, {}, {}, {}
    try:
        for overlap in (False, True, True, False):
            name = "double" if overlap else "sequential"
            predictor.overlap_chunks = overlap
            predictor.device_batches = 0
            order.clear()
            host_ms.update(dict.fromkeys(stages, 0.0))
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            res, busy, span = _device_busy(
                lambda: predictor.detect(images, score_threshold=0.0))
            wall = (time.perf_counter() - t0) * 1e3
            counts = _launches()
            if counts != want or predictor.device_batches != chunks:
                raise AssertionError(f"detect {tag} {name}: launches "
                                     f"{counts}, expected {want}")
            runs[name], orders[name] = res, "".join(order)
            host.setdefault(name, []).append(
                {k: v / chunks for k, v in host_ms.items()})
            for k, c in counts.items():
                total[k] = total.get(k, 0) + c
            idle.setdefault(name, []).append(
                {"wall_ms": wall, "busy_ms": busy, "span_ms": span,
                 "idle_ms": span - busy, "idle_share": (span - busy) / span})
        predictor.overlap_chunks = True
        shuffled = list(images)
        bs = predictor.batch_size
        shuffled[2 * bs:3 * bs], shuffled[3 * bs:4 * bs] = (
            images[3 * bs:4 * bs], images[2 * bs:3 * bs])
        control = _detections_differ(
            predictor.detect(shuffled, score_threshold=0.0),
            runs["sequential"])
    finally:
        del predictor._forward_topk, predictor._download, predictor._upload
        inference.format_detections = format_detections
    double = "d" + "dr" * (chunks - 1) + "r"
    differ = _detections_differ(runs["double"], runs["sequential"])
    seq_idle = min(r["idle_ms"] for r in idle["sequential"])
    dbl_idle = min(r["idle_ms"] for r in idle["double"])
    log(f"measurement tools: detect {tag} " + json.dumps(idle))
    log(f"measurement tools: detect {tag} host ms a chunk "
        + json.dumps(host))
    problems = []
    if differ or control is None:
        problems.append(f"double vs sequential {differ}; the shuffled "
                        f"control {control}")
    if orders["double"] != double or orders["sequential"] == double:
        problems.append(f"orders {orders}")
    if faster and not dbl_idle < seq_idle:
        launch_ms = min(h["forward"] for h in host["sequential"])
        busy_ms = min(r["busy_ms"] for r in idle["sequential"]) / chunks
        problems.append(f"idle {dbl_idle} ms double-buffered against "
                        f"{seq_idle} ms sequential (a chunk: {launch_ms:.3f}"
                        f" ms of the host's launches, {busy_ms:.3f} ms of "
                        f"device time)")
    if problems:
        raise AssertionError(f"detect {tag}: " + "; ".join(problems))
    log(f"measurement tools: detect {tag} x {chunks} chunks: double-buffered"
        f" equal to sequential (the shuffled control: {control}); order "
        f"{orders['double']} against {orders['sequential']}; device idle "
        f"{dbl_idle:.3f} ms double-buffered against {seq_idle:.3f} ms "
        f"sequential (the best run each way)")
    return idle, total


def _scaling_problems(recs, batches, variants):
    """What is wrong with bench_attn_scaling's records: one a (batch,
    variant) in order, positive times, and each variant's two kernels
    launched and no other."""
    problems = []
    if [(r["batch"], r["variant"]) for r in recs] != [
            (b, v) for b in batches for v in variants]:
        problems.append("records out of order")
    for r in recs:
        if not (r["fwd_ms"] > 0 and r["fwdbwd_ms"] > 0):
            problems.append(f"{r['batch']}/{r['variant']}: a time is not "
                            f"positive")
        if sorted(r["launches"]) != sorted(SCALING_KERNELS[r["variant"]]):
            problems.append(f"{r['batch']}/{r['variant']}: launched "
                            f"{r['launches']}")
    return problems


def _input_problems(res: dict, resolved: str):
    """What is wrong with bench_input's dict: the resolved backend named,
    a native row only where 'auto' resolved to the native decoder, and a
    positive rate in every phase run."""
    problems = []
    if res.get("decode_backend_auto") != resolved:
        problems.append(f"decode_backend_auto {res.get('decode_backend_auto')}"
                        f" against {resolved}")
    if ("native_uint8" in res["decode"]) != (resolved == "native"):
        problems.append(f"decode rows {sorted(res['decode'])} with 'auto' "
                        f"resolved to {resolved}")
    rates = [*res["decode"].values(), *res["loader"].values()] + [
        res.get(k, 0) for k in ("train_from_disk", "train_device_only",
                                "eval_from_disk", "eval_device_only")]
    if not all(r > 0 for r in rates):
        problems.append("a rate is missing or not positive")
    return problems


def phase_measurement_tools(seed: int, kernels: dict):
    """The measurement and input tools at full width, in-process, each
    with a control that must fail: bench_serving (ViT-B/224 b1, bf16 and
    int8; B1, and B6 in int8, and nothing else); Predictor.detect over
    DETECT_CHUNKS chunks of DETECT_BATCH at ViT-B/224 and of
    DETECT_LARGE_BATCH at ViT-L/560, double-buffered against the
    sequential schedule (equal detections, a shuffled chunk as the
    control; the order of dispatches and read-backs, the sequential order
    as the control; the device's idle time both ways from torch.profiler,
    lower double-buffered at ViT-L/560, where the card sets the pace);
    bench_attn_scaling (each variant's kernels, a forcing that does not
    take as the control); bench_qkv_layout; bench_evaluator at
    EVAL_IMAGES (native and numpy metrics equal; fewer detections as the
    control); bench_input on INPUT_IMAGES 640 px JPEGs with its train and
    eval phases, and the backend 'auto' resolved to."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from dinov2_od_tpu_torch.data import coco
    from dinov2_od_tpu_torch.evaluation.coco_metrics import CocoEvaluator
    from dinov2_od_tpu_torch.inference import Predictor
    from dinov2_od_tpu_torch.models.detector import cast_frozen_weights
    from dinov2_od_tpu_torch.ops import _build
    from dinov2_od_tpu_torch.tools import (bench_attn_scaling,
                                           bench_evaluator, bench_input,
                                           bench_qkv_layout, bench_serving)

    card = torch.cuda.get_device_name(0)
    t_phase = time.perf_counter()
    resolved = coco.resolved_decode_backend()
    log(f"measurement tools: decode_backend 'auto' resolved to {resolved!r}"
        + ("" if resolved == "native" else
           "; the native JPEG decoder did not build here, so it is held "
           "only by the CPU tests"))
    depth = 12

    def add(counts: dict, tag: str):
        for name, n in counts.items():
            if n:
                kernels[name]["launches"] += n
                kernels[name][f"launches_{tag}"] = n

    # bench_serving, bf16 and int8.
    forwards = (2 + 2 * SERVING_REQUESTS
                + SERVING_THREADS * (SERVING_REQUESTS // SERVING_THREADS))
    for quant in (None, "int8"):
        t0 = time.perf_counter()
        argv = ["--requests", str(SERVING_REQUESTS),
                "--threads", str(SERVING_THREADS)]
        if quant:
            argv += ["--quantize", quant]
        out = io.StringIO()
        _build.reset_launch_counts()
        rec = bench_serving.run(bench_serving.parse_args(argv), out=out)
        torch.cuda.synchronize()
        counts = _launches()
        for line in out.getvalue().splitlines():
            log(f"measurement tools: bench_serving {quant or 'bf16'}: {line}")
        launches = {"flash_attn_fwd": depth * forwards}
        if quant:
            launches["int8_gemm"] = depth * forwards
        want = _counts(**launches)
        problems = _serving_problems(rec, counts, want, card)
        wrong = dict(want, flash_attn_bwd=1)
        swapped = dict(rec, p95_ms=rec["p99_ms"] + 1)
        controls = [_serving_problems(rec, counts, wrong, card),
                    _serving_problems(swapped, counts, want, card)]
        if problems or not all(controls):
            raise AssertionError(f"bench_serving {quant or 'bf16'}: "
                                 f"{problems}; controls {controls}")
        add(counts, f"bench_serving_{quant or 'bf16'}")
        log(f"measurement tools: bench_serving {quant or 'bf16'}: "
            f"{time.perf_counter() - t0:.1f} s, launches {counts}; "
            f"{card_line()}")
        torch.cuda.empty_cache()

    # Predictor.detect, double-buffered against sequential: ViT-B/224 at
    # batch 32, then ViT-L/560 at batch 32, where the card, not the host,
    # sets the pace (about 150 ms of device time a chunk against about
    # 35 ms of the host's launches; at batch 8 the two were within a few
    # ms of each other, and a slower host made either schedule idle more).
    for model_name, size, batch, kernel, per_forward in (
            ("facebook/dinov2-base", 224, DETECT_BATCH, "flash_attn_fwd",
             depth),
            ("facebook/dinov2-large", 560, DETECT_LARGE_BATCH,
             "flash_attn_bhsd_fwd", 2 * depth)):
        t0 = time.perf_counter()
        _, cfg16, params = _serving_model(seed, model_name, image_size=size)
        predictor = Predictor(cast_frozen_weights(params, cfg16), cfg16,
                              device="cuda", batch_size=batch)
        del params
        tag = f"ViT-{cfg16.backbone.variant[0].upper()}/{size} b{batch}"
        idle, counts = _check_detect(
            predictor, DETECT_CHUNKS * batch, seed,
            _counts(**{kernel: per_forward * DETECT_CHUNKS}), tag,
            faster=model_name.endswith("large"))
        add(counts, "detect")
        log(f"measurement tools: detect {tag}: "
            f"{time.perf_counter() - t0:.1f} s; {card_line()}")
        del predictor
        torch.cuda.empty_cache()

    # bench_attn_scaling, with a forcing that does not take as the control.
    t0 = time.perf_counter()
    args = bench_attn_scaling.parse_args(
        ["--batches", *map(str, SCALING_BATCHES)])
    out = io.StringIO()
    _build.reset_launch_counts()
    recs = bench_attn_scaling.run(args, out=out, target_seconds=0.2)
    torch.cuda.synchronize()
    add(_launches(), "bench_attn_scaling")
    for line in out.getvalue().splitlines():
        log(f"measurement tools: bench_attn_scaling: {line}")
    problems = _scaling_problems(recs, SCALING_BATCHES, args.variants)
    forced = bench_attn_scaling.forced
    bench_attn_scaling.forced = lambda variant: contextlib.nullcontext()
    try:
        ctl = bench_attn_scaling.run(
            bench_attn_scaling.parse_args(["--batches", "32", "--variants",
                                           "bhsd"]),
            out=io.StringIO(), target_seconds=0.05, repeats=1)
    finally:
        bench_attn_scaling.forced = forced
    control = _scaling_problems(ctl, (32,), ("bhsd",))
    if problems or not control:
        raise AssertionError(f"bench_attn_scaling: {problems}; control "
                             f"{control}")
    log(f"measurement tools: bench_attn_scaling: {time.perf_counter() - t0:.1f}"
        f" s; the unforced control {control}; {card_line()}")

    # bench_qkv_layout: cuBLAS GEMMs, none of the port's kernels.
    t0 = time.perf_counter()
    out = io.StringIO()
    _build.reset_launch_counts()
    rec = bench_qkv_layout.run(bench_qkv_layout.parse_args([]), out=out)
    log(f"measurement tools: bench_qkv_layout: {out.getvalue().strip()}")
    keys = ["metric", "prefused_ms", "per_step_concat_ms", "delta_ms_per_fwd"]
    if (list(rec) != keys or not rec["prefused_ms"] > 0
            or not rec["per_step_concat_ms"] > 0 or card not in rec["metric"]
            or any(_launches().values())):
        raise AssertionError(f"bench_qkv_layout: {rec}, launches "
                             f"{_launches()}")
    log(f"measurement tools: bench_qkv_layout: "
        f"{time.perf_counter() - t0:.1f} s; {card_line()}")

    # bench_evaluator: the C++ and numpy matchers agree; fewer detections
    # through the C++ matcher as the control.
    t0 = time.perf_counter()
    out = io.StringIO()
    rec = bench_evaluator.run(bench_evaluator.parse_args(
        ["--images", str(EVAL_IMAGES)]), out=out)
    log("measurement tools: bench_evaluator: " + json.dumps(
        {k: rec[k] for k in ("images", "gt", "detections", "init_s",
                             "evaluate_s", "metrics_equal")}))
    gt, dets = bench_evaluator.synth(n_img=EVAL_IMAGES)
    with tempfile.NamedTemporaryFile("w", suffix=".json") as f:
        json.dump(gt, f)
        f.flush()
        fewer = CocoEvaluator(f.name, use_native=True).evaluate(dets[1::2])
    if (not rec["metrics_equal"] or set(rec["metrics"]) != {"native", "numpy"}
            or fewer == rec["metrics"]["numpy"]
            or not 0 < rec["metrics"]["native"]["AP"] < 1):
        raise AssertionError(f"bench_evaluator: {rec['metrics']}; control "
                             f"{fewer}")
    log(f"measurement tools: bench_evaluator: AP {rec['metrics']['native']['AP']}"
        f" both ways, the control's {fewer['AP']}; "
        f"{time.perf_counter() - t0:.1f} s")

    # bench_input on written 640 px JPEGs, with its train and eval phases.
    t0 = time.perf_counter()
    out = io.StringIO()
    _build.reset_launch_counts()
    try:
        res = bench_input.run(bench_input.parse_args(
            ["--dir", INPUT_DIR, "--gen", str(INPUT_IMAGES), "--train",
             "--eval"]), out=out)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(INPUT_DIR, ignore_errors=True)
    counts = _launches()
    for line in out.getvalue().splitlines():
        log(f"measurement tools: bench_input: {line}")
    launched = sorted(k for k, n in counts.items() if n)
    steps = 12 + INPUT_IMAGES // 32  # measure_steps_per_sec's, the loader's
    problems = _input_problems(res, resolved)
    toggled = dict(res, decode=dict(res["decode"]))
    if "native_uint8" in toggled["decode"]:
        del toggled["decode"]["native_uint8"]
    else:
        toggled["decode"]["native_uint8"] = 1.0
    control = _input_problems(toggled, resolved)
    if (problems or not control
            or launched != ["flash_attn_bwd", "flash_attn_fwd"]
            or counts["flash_attn_bwd"] != 2 * steps):
        raise AssertionError(f"bench_input: {problems}; launches {counts} "
                             f"({steps} steps); control {control}")
    add(counts, "bench_input")
    log(f"measurement tools: bench_input: {time.perf_counter() - t0:.1f} s, "
        f"launches {counts}; control {control}; {card_line()}")
    log(f"measurement tools: {time.perf_counter() - t_phase:.1f} s in all")
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
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--cli-rank"]:
        # One rank of phase_mesh_cli: --cli-rank COUNTS -- CLI_ARGS.
        return _cli_rank(argv[1], argv[3:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also break the serving forward's and the train "
                         "step's device time down by kernel with "
                         "torch.profiler")
    ap.add_argument("--moe-ring-fault", action="store_true",
                    help="run only phase_moe_ep's dropped-prefix control "
                         "(moe_ring_fault_control) and exit 0 when it "
                         "fails as it should")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    log(card_line())  # as nvidia-smi prints it: name, power limit
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_build()
    if args.moe_ring_fault:
        moe_ring_fault_control(args.seed)
        return 0
    kernels = {}
    for entry in (phase_kernels(args.seed), phase_bwd_kernel(args.seed),
                  phase_int8_kernel(args.seed)):
        kernels[entry["name"]] = entry
    kernels.update(phase_bhsd_kernels(args.seed))
    kernels.update(phase_allheads_kernels(args.seed))
    kernels["attn_roofline"] = phase_roofline_kernel(args.seed)
    kernels["flash_attention_lse"] = phase_lse_kernel(args.seed)
    serving_ips = phase_slice(args.seed, kernels, profile=args.profile)
    int8_ips = phase_int8_serving(args.seed, kernels, serving_ips,
                                  profile=args.profile)
    train_ips = phase_train(args.seed, kernels, profile=args.profile)
    loop_ips = phase_train_cli(args.seed, kernels, train_ips)
    phase_import_export(args.seed, kernels)
    phase_moe(args.seed, kernels, serving_ips, int8_ips, train_ips)
    phase_train_recipes(args.seed, kernels, train_ips, loop_ips)
    phase_prefix_int8_train(args.seed, kernels, train_ips,
                            profile=args.profile)
    phase_large_serving(args.seed, kernels, profile=args.profile)
    phase_large_train(args.seed, kernels, profile=args.profile)
    phase_tp(args.seed, kernels)
    phase_cp(args.seed, kernels)
    phase_mesh_cli(args.seed, kernels)
    phase_pp(args.seed, kernels)
    phase_fsdp(args.seed, kernels)
    phase_moe_ep(args.seed, kernels)
    phase_roofline_tool(kernels)
    phase_bench()
    phase_trace()
    phase_measurement_tools(args.seed, kernels)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
