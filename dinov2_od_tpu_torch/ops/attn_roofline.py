"""The attention roofline tool's ablation kernel (T1): the CUDA kernel's
wrapper and its plain version.

Counterpart of the Pallas kernel `kernel` of tools/bench_attn_roofline.py
(:69, its pallas_call at :94). For bf16 q, k, v `[B, H, S, 64]` it
computes, per (batch, head) over all S rows and keys (no mask: padded rows
are data):

- q' = fp32(q) * fp32(scale * log2 e). The tool's scale is a numpy
  float64, which JAX does not treat as a weak scalar, so it promotes the
  bf16 q to fp32: q' is fp32, unlike the production kernels' bf16 q;
- s = q' . k^T, accumulated in fp32;
- p by stage: s (`mxu_only`), s - rowmax(s) (`plus_max`) or
  exp2(s - rowmax(s)) (`plus_exp2`);
- o = bf16(bf16(p) . v), accumulated in fp32; no division by the row sum.

`attn_roofline` launches the kernel (csrc/attn_roofline.cu) for a CUDA
tensor and runs `attn_roofline_plain`, the same math in torch ops, for a
CPU tensor. A CUDA tensor never falls back to the plain version: the
wrapper launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, _tma
from .flash_attention import _bound, _raise_on

_KERNEL = "attn_roofline"
_LOG2E = 1.4426950408889634
HEAD_DIM = 64
STAGES = ("mxu_only", "plus_max", "plus_exp2")
# Longest S the kernel takes: a block keeps 32 rows of fp32 logits, in
# 64-key blocks of 8 KB, beside two 8 KB K/V slots in its 227 KB of shared
# memory (csrc/attn_roofline.cu).
MAX_SEQ = 1664
Q_ROWS = 32  # query rows of the kernel's unit (its q box)
KEY_TILE = 64  # keys of its K and V boxes


def q_multiplier(scale: float) -> float:
    """fp32(scale * log2 e): the TPU kernel's q multiplier, taken in
    float64 and rounded to fp32 where it meets q."""
    return float(np.float32(scale * _LOG2E))


def _check(q, k, v, stage: str) -> None:
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}; got {stage!r}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k and v must be [B, H, S, {HEAD_DIM}] of one shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"head_dim must be {HEAD_DIM}; got {q.shape[-1]}")
    if not q.dtype == k.dtype == v.dtype == torch.bfloat16:
        raise TypeError(f"q, k and v must be bf16; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must lie on one device")


def attn_roofline_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, stage: str) -> torch.Tensor:
    """T1's math in torch ops, fp32 with p and o rounded to bf16 where the
    TPU kernel rounds them, on any device; o `[B, H, S, 64]` bf16."""
    _check(q, k, v, stage)
    s = torch.matmul(q.float() * q_multiplier(scale),
                     k.float().transpose(-1, -2))
    if stage == "mxu_only":
        p = s
    elif stage == "plus_max":
        p = s - s.amax(dim=-1, keepdim=True)
    else:
        p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(torch.bfloat16).float(), v.float())
    return o.to(torch.bfloat16)


def attn_roofline_tma_specs(q, k, v):
    """The tensor-map specs T1's kernel reads its operands through
    (ops/_tma.py), in its order: q `[B, H, S, 64]` in boxes of 32 rows of
    one head (a unit's query rows), k and v in boxes of 64 rows (a key
    tile), through the real strides. Raises ValueError where TMA cannot
    address one of them."""
    order = (3, 2, 1, 0)  # head dim, row, head, batch
    return [_tma.tensor_map_spec(t, order, (HEAD_DIM, rows, 1, 1))
            for t, rows in ((q, Q_ROWS), (k, KEY_TILE), (v, KEY_TILE))]


def _launch(q, k, v, scale: float, stage: str, n_keys: int) -> torch.Tensor:
    """The kernel over the first `n_keys` keys: S for `attn_roofline`;
    fewer only for a control that must disagree with the plain version."""
    b, h, s, dh = q.shape
    if not 1 <= n_keys <= s:
        raise ValueError(f"n_keys must lie in [1, {s}]; got {n_keys}")
    specs = _tma.as_c_array(*attn_roofline_tma_specs(q, k, v))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib, fn = _bound(_KERNEL, [p] * 4 + [i] * 6 + [ctypes.c_float, p, p])
    o = torch.empty((b, h, s, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                STAGES.index(stage), b, h, s, n_keys, dh,
                q_multiplier(scale), ctypes.addressof(specs), stream)
    _raise_on(lib, _KERNEL, rc)
    _build.launch_counts[_KERNEL] += 1
    return o


def attn_roofline(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, stage: str) -> torch.Tensor:
    """o `[B, H, S, 64]` bf16 of one ablation stage, q, k, v bf16
    `[B, H, S, 64]` with S <= MAX_SEQ (views whose last dim is contiguous
    and whose strides TMA can address). A CUDA tensor launches the kernel;
    a CPU tensor takes the plain version."""
    _check(q, k, v, stage)
    if q.shape[2] > MAX_SEQ:
        raise ValueError(f"the attention roofline kernel takes S up to "
                         f"{MAX_SEQ}; got {q.shape[2]}")
    if q.device.type == "cpu":
        return attn_roofline_plain(q, k, v, scale=scale, stage=stage)
    if q.device.type != "cuda":
        raise ValueError(f"no attention roofline kernel for {q.device}")
    return _launch(q, k, v, scale, stage, q.shape[2])


__all__ = ["HEAD_DIM", "MAX_SEQ", "STAGES", "attn_roofline",
           "attn_roofline_plain", "attn_roofline_tma_specs", "q_multiplier"]
