"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of dinov2_od_tpu/ops/flash_attention.py (`flash_attention`,
`flash_attention_lse` and their kernels). The JAX wrapper picks a kernel
by shape, and so does this one, with copies of the JAX rules:

- flat (`_flat_eligible`): self-attention whose whole [S, S] logits fit
  the TPU kernel's VMEM (S <= 1536) with heads that pair into 128-lane
  groups. The TPU kernels `_fwd_kernel_flat` / `_bwd_kernel_flat` become
  B1 / B2 (csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd.cu).
- BHSD, everything else (Sq != Sk; head counts with no 128-lane pairing,
  such as ViT-B's 3 heads a rank under 4-way tensor parallelism; long
  sequences such as ViT-L/14 at 560 px, 1601 tokens), splits in two as
  `_flash_fwd` and `_bhsd_bwd_impl` split it, the forward and the backward
  each by its own rule (`_allheads_fwd`, `_allheads_bwd`):
  - all-heads, where a head's fp32 logits fit the TPU kernel's 8 MiB
    budget (`_head_group`): `_fwd_kernel_allheads` /
    `_bwd_kernel_allheads` become B4f / B4b (csrc/flash_attn_allheads_fwd.cu,
    csrc/flash_attn_allheads_bwd.cu);
  - blocked, where they do not: `_fwd_kernel` / `_dkv_kernel` become
    B5f / B5b (csrc/flash_attn_bhsd_fwd.cu, csrc/flash_attn_bhsd_bwd.cu).
  At S = 700 and one head, for example, the forward takes B4f and the
  backward B5b, as in JAX.

Both families compute one function, the TPU kernels' math:

- q is scaled by `scale * log2(e)` in its own dtype and the softmax is
  taken in base 2;
- keys at positions >= `kv_len` get the logit -1e30 (not -inf, so a row
  stays finite);
- the probabilities are rounded to the input dtype before both the p.v
  product and the row sum, which accumulate in fp32;
- the lse is kept in log2 space (m + log2 l), fp32, `[B, H, Sq]`.

The backward recomputes p = exp2(s - lse) from the saved q, k and lse
and takes delta = rowsum(fp32(dO) * fp32(o)) per head from torch ops
outside the kernel, as the JAX wrapper does; a cotangent of the lse
output folds into delta (`_delta`). With dt the input dtype and scale
exact in it (1/8 at head dim 64):

- dv = p(dt)^T dO and dp = (dO * scale)(dt) v^T, both fp32 sums;
- ds = p * (dp - delta * scale);
- dk = ds(dt)^T q with the unscaled q, dq = ds(dt) k, fp32 sums cast to
  dt at the end;
- keys at or past kv_len have p = 0, so their dk and dv are exactly 0;
  query rows at or past q_len (the BHSD kernel's row mask) have p = 0.

The public layout is `[B, S, H, dh]` in and out for both families; the
kernels read q, k, v (and dO) through their strides, so the three slices
of the backbone's fused qkv GEMM output are read in place and no
transpose is materialised.

`flash_attention_fwd` / `flash_attention_bwd` (flat),
`flash_attention_allheads_fwd` / `flash_attention_allheads_bwd` and
`flash_attention_bhsd_fwd` / `flash_attention_bhsd_bwd` launch the kernels
for a CUDA tensor and run the plain versions, the same math in torch ops,
for a CPU tensor. A CUDA tensor never falls back to a plain version: the
wrapper launches the kernel or raises. `flash_attention` and
`flash_attention_lse` are differentiable through `_FlashAttention`, whose
backward takes the forward's family (flat or BHSD) and, inside BHSD, the
kernel of the backward's own rule.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build, _tma

_KERNEL = "flash_attn_fwd"
_BWD_KERNEL = "flash_attn_bwd"
_BHSD_KERNEL = "flash_attn_bhsd_fwd"
_BHSD_BWD_KERNEL = "flash_attn_bhsd_bwd"
_ALLHEADS_KERNEL = "flash_attn_allheads_fwd"
_ALLHEADS_BWD_KERNEL = "flash_attn_allheads_bwd"
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
NEG_INF = -1e30
HEAD_DIM = 64  # the only head width the kernels are built for
_DTYPES = (torch.bfloat16, torch.float32)

# The JAX package's family choice (dinov2_od_tpu/ops/flash_attention.py
# `_LANE`, `_SUBLANE`, `_round_up`, `_flat_group`, `_flat_eligible`),
# copied so the port routes every shape to the same family.
_LANE = 128
_SUBLANE = 16
_FLAT_LOGITS_LIMIT = 18 * 2**20  # 2 fp32 [S_pad, S_pad] logits tiles


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _flat_group(dh: int) -> int:
    """Heads per flat lane block: smallest g with (g * dh) % 128 == 0."""
    return _LANE // math.gcd(dh, _LANE)


def _flat_eligible(q, k) -> bool:
    """Self-attention whose heads pair into 128-lane groups and whose two
    fp32 [S_pad, S_pad] logits tiles fit 18 MiB (S <= 1536): the flat
    family (B1/B2); anything else takes the BHSD family (B4f/B4b or
    B5f/B5b)."""
    _, sq, h, dh = q.shape
    if sq != k.shape[1] or h % _flat_group(dh):
        return False
    s_pad = _round_up(sq, _SUBLANE)
    return 2 * s_pad * s_pad * 4 <= _FLAT_LOGITS_LIMIT


# The JAX package's split inside the BHSD family (`_LOGITS_VMEM_BUDGET`,
# `_auto_block`, `_head_group` and the conditions of `_flash_fwd` and
# `_bhsd_bwd_impl`), copied so each shape takes the counterpart of the TPU
# kernel JAX runs there.
_LOGITS_VMEM_BUDGET = 8 * 2**20


def _auto_block(s: int, other_pad: int, n_buffers: int = 2) -> int:
    """The TPU kernels' block over `s`: single-block when n_buffers fp32
    [block, other_pad] tiles fit 13 MiB, else the fewest equal blocks."""
    cap = 13 * 2**20 // (4 * other_pad * n_buffers)
    cap = max(_SUBLANE, (cap // _SUBLANE) * _SUBLANE)
    s_pad = _round_up(s, _SUBLANE)
    if s_pad <= cap:
        return s_pad
    n_blocks = -(-s_pad // cap)
    return _round_up(-(-s_pad // n_blocks), _SUBLANE)


def _head_group(h: int, sq_pad: int, sk_pad: int, n_buffers: int) -> int:
    """Largest divisor of h whose n_buffers x [g, Sq, Sk] fp32 logits fit
    the 8 MiB budget; 0 when one head does not fit."""
    per_head = sq_pad * sk_pad * 4 * n_buffers
    if per_head > _LOGITS_VMEM_BUDGET:
        return 0
    g = min(h, _LOGITS_VMEM_BUDGET // per_head)
    while h % g:
        g -= 1
    return g


def _allheads_fwd(q, k) -> bool:
    """The BHSD forward takes the all-heads kernel (B4f), as `_flash_fwd`
    does with no block_q, else the blocked one (B5f)."""
    _, sq, h, _ = q.shape
    sk_pad = _round_up(k.shape[1], _SUBLANE)
    sq_pad = _round_up(sq, _auto_block(sq, sk_pad))
    g = _head_group(h, sq_pad, sk_pad, n_buffers=2)
    return g > 1 or (g == 1 and sq_pad == _round_up(sq, _SUBLANE))


def _allheads_bwd(q, k) -> bool:
    """The BHSD backward takes the all-heads kernel (B4b), as
    `_bhsd_bwd_impl` does with no block_q, else the blocked one (B5b)."""
    _, sq, h, _ = q.shape
    sq_pad = _round_up(sq, _SUBLANE)
    sk_pad = _round_up(k.shape[1], _auto_block(k.shape[1], sq_pad,
                                               n_buffers=4))
    return _head_group(h, sq_pad, sk_pad, n_buffers=5) >= 1


def _rounded(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype`, as JAX rounds a Python scalar that multiplies
    an array to the array's own type."""
    return torch.tensor(x, dtype=torch.float32).to(dtype).item()


def _qscale(scale: float, dtype: torch.dtype) -> float:
    """`scale * log2(e)` in q's dtype: the TPU kernel's q multiplier."""
    return _rounded(scale * _LOG2E, dtype)


def _check(q, k, v, kv_len: Optional[int], self_attention: bool) -> int:
    """Shapes, dtypes and devices both families take; returns kv_len.
    q is [B, Sq, H, dh], k and v [B, Sk, H, dh] (Sq == Sk for the flat
    family)."""
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]
            or (self_attention and q.shape != k.shape)):
        kind = ("self-attention q, k, v of one shape" if self_attention
                else "q [B, Sq, H, dh] and k, v [B, Sk, H, dh]")
        raise ValueError(
            f"flash attention takes {kind}; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"flash attention takes bf16 or fp32 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    sk = k.shape[1]
    kv_len = sk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= sk:
        raise ValueError(f"kv_len must lie in [1, {sk}]; got {kv_len}")
    return kv_len


def _fwd_math(q, k, v, scale: float, kv_len: int):
    """The forward kernels' math in torch ops: o `[B, Sq, H, dh]` in q's
    dtype and the log2 lse `[B, H, Sq]` in fp32."""
    dt = q.dtype
    qs = (q.float() * _qscale(scale, dt)).to(dt)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if kv_len < k.shape[1]:
        s[..., kv_len:] = NEG_INF
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m).to(dt).float()
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o / l.permute(0, 2, 1, 3)
    lse2 = (m + torch.log2(l)).squeeze(-1)
    return o.to(dt), lse2


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1's math in torch ops, on any device: self-attention o
    `[B, S, H, dh]` in q's dtype and the log2 lse `[B, H, S]` in fp32."""
    kv_len = _check(q, k, v, kv_len, self_attention=True)
    return _fwd_math(q, k, v, scale, kv_len)


def flash_attention_bhsd_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5f's math in torch ops, on any device: q `[B, Sq, H, dh]`, k and v
    `[B, Sk, H, dh]`; o `[B, Sq, H, dh]` in q's dtype and the log2 lse
    `[B, H, Sq]` in fp32. The same rules as the flat forward: the TPU
    kernel `_fwd_kernel` computes the flat kernel's function over a
    q block."""
    kv_len = _check(q, k, v, kv_len, self_attention=False)
    return _fwd_math(q, k, v, scale, kv_len)


def flash_attention_allheads_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4f's math in torch ops, on any device: q `[B, Sq, H, dh]`, k and v
    `[B, Sk, H, dh]`; o `[B, Sq, H, dh]` and the log2 lse `[B, H, Sq]`. The
    TPU kernel `_fwd_kernel_allheads` computes B5f's function over a group
    of heads, p against the exact row max, which is how the plain version
    takes it."""
    kv_len = _check(q, k, v, kv_len, self_attention=False)
    return _fwd_math(q, k, v, scale, kv_len)


def _check_launch(**tensors) -> None:
    """What every flash kernel needs of its [B, S, H, 64] operands."""
    b, _, h, dh = next(iter(tensors.values())).shape
    if dh != HEAD_DIM:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM}; got {dh}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch and heads must be < 65536; got {b}, {h}")
    for name, t in tensors.items():
        align = 16 // t.element_size()  # elements per 16-byte vector load
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        if any(st % align for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name}'s data pointer and batch, row and head strides "
                f"must be 16-byte aligned; got strides {t.stride()}"
            )


def _bound(name: str, argtypes):
    """The loaded library of kernel `name` and its entry point `name`,
    with the C signature set once."""
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib, fn


def _raise_on(lib, name: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


_P, _I, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)


def _launch(q, k, v, scale: float, kv_len: int):
    b, s, h, dh = q.shape
    _check_launch(q=q, k=k, v=v)
    lib, fn = _bound(_KERNEL,
                     [_P] * 5 + [_I] * 6 + [_F] + [_LL] * 9 + [_P] * 2)
    o = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    specs = (_tma.as_c_array(*flat_fwd_tma_specs(q, k, v))
             if q.dtype == torch.bfloat16 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), b, s, h, dh,
            kv_len, _qscale(scale, q.dtype),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            None if specs is None else ctypes.addressof(specs), stream,
        )
    _raise_on(lib, _KERNEL, rc)
    _build.launch_counts[_KERNEL] += 1
    return o, lse


def _head_specs(rows: int, *tensors):
    """Tensor-map specs (ops/_tma.py) of [B, S, H, 64] operands in boxes of
    `rows` rows of one head, through their real strides."""
    order = (3, 2, 1, 0)  # head dim, head, row, batch
    return [_tma.tensor_map_spec(t, order, (HEAD_DIM, 1, rows, 1))
            for t in tensors]


def flat_fwd_tma_specs(q, k, v):
    """The tensor-map specs B1's bf16 kernel reads its operands through, in
    its order: q `[B, S, H, 64]` in boxes of 64 rows of one head (a unit's
    query rows), k and v in boxes of 128 rows (a key tile), through the
    real strides, so the fused qkv slices are read in place. B1 runs B4f's
    body (csrc/flash_fwd_units.cuh), so these are B4f's boxes. Raises
    ValueError where TMA cannot address one of them."""
    return [*_head_specs(64, q), *_head_specs(128, k, v)]


def bhsd_fwd_tma_specs(q, k, v):
    """The tensor-map specs B5f's bf16 kernel reads its operands through, in
    its order: q `[B, Sq, H, 64]` and k, v `[B, Sk, H, 64]`, each in boxes
    of 128 rows of one head (a query tile, a key tile), through the real
    strides, so the fused qkv slices are read in place. Raises ValueError
    where TMA cannot address one of them."""
    return _head_specs(128, q, k, v)


def _launch_bhsd(q, k, v, scale: float, kv_len: int):
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    _check_launch(q=q, k=k, v=v)
    lib, fn = _bound(_BHSD_KERNEL,
                     [_P] * 5 + [_I] * 7 + [_F] + [_LL] * 9 + [_P] * 2)
    o = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    specs = (_tma.as_c_array(*bhsd_fwd_tma_specs(q, k, v))
             if q.dtype == torch.bfloat16 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), b, sq, sk, h,
            dh, kv_len, _qscale(scale, q.dtype),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            None if specs is None else ctypes.addressof(specs), stream,
        )
    _raise_on(lib, _BHSD_KERNEL, rc)
    _build.launch_counts[_BHSD_KERNEL] += 1
    return o, lse


def allheads_fwd_tma_specs(q, k, v):
    """The tensor-map specs B4f's bf16 kernel reads its operands through, in
    its order: q `[B, Sq, H, 64]` in boxes of 64 rows of one head (a unit's
    query rows), k and v `[B, Sk, H, 64]` in boxes of 128 rows (a key
    tile), through the real strides, so a rank's fused qkv slices are read
    in place. Raises ValueError where TMA cannot address one of them."""
    return flat_fwd_tma_specs(q, k, v)


def _launch_allheads(q, k, v, scale: float, kv_len: int):
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    _check_launch(q=q, k=k, v=v)
    lib, fn = _bound(_ALLHEADS_KERNEL,
                     [_P] * 5 + [_I] * 7 + [_F] + [_LL] * 9 + [_P] * 2)
    o = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    specs = (_tma.as_c_array(*allheads_fwd_tma_specs(q, k, v))
             if q.dtype == torch.bfloat16 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), b, sq, sk, h,
            dh, kv_len, _qscale(scale, q.dtype),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            None if specs is None else ctypes.addressof(specs), stream,
        )
    _raise_on(lib, _ALLHEADS_KERNEL, rc)
    _build.launch_counts[_ALLHEADS_KERNEL] += 1
    return o, lse


def _device_or_raise(q) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """o `[B, S, H, dh]` and the log2 lse `[B, H, S]` of self-attention,
    flat family (B1).

    q, k, v may be strided views (e.g. the three slices of one fused qkv
    GEMM output) as long as their last dim is contiguous. A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version."""
    kv_len = _check(q, k, v, kv_len, self_attention=True)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale=scale, kv_len=kv_len)
    _device_or_raise(q)
    return _launch(q, k, v, scale, kv_len)


def flash_attention_bhsd_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """o `[B, Sq, H, dh]` and the log2 lse `[B, H, Sq]`, BHSD family (B5f):
    q `[B, Sq, H, dh]`, k and v `[B, Sk, H, dh]`, any Sq and Sk, strided
    views with a contiguous last dim. A CUDA tensor launches the kernel; a
    CPU tensor takes the plain version."""
    kv_len = _check(q, k, v, kv_len, self_attention=False)
    if q.device.type == "cpu":
        return flash_attention_bhsd_fwd_plain(q, k, v, scale=scale,
                                              kv_len=kv_len)
    _device_or_raise(q)
    return _launch_bhsd(q, k, v, scale, kv_len)


def flash_attention_allheads_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """o `[B, Sq, H, dh]` and the log2 lse `[B, H, Sq]` against the exact
    row max (B4f): q `[B, Sq, H, dh]`, k and v `[B, Sk, H, dh]`, strided
    views with a contiguous last dim. A CUDA tensor launches the kernel; a
    CPU tensor takes the plain version."""
    kv_len = _check(q, k, v, kv_len, self_attention=False)
    if q.device.type == "cpu":
        return flash_attention_allheads_fwd_plain(q, k, v, scale=scale,
                                                  kv_len=kv_len)
    _device_or_raise(q)
    return _launch_allheads(q, k, v, scale, kv_len)


def _delta(do: torch.Tensor, o: torch.Tensor,
           glse2: Optional[torch.Tensor]) -> torch.Tensor:
    """delta [B, H, Sq] fp32 = rowsum(fp32(dO) * fp32(o)) per head, less
    the cotangent glse2 [B, H, Sq] of the log2 lse, folded in as JAX does
    (dinov2_od_tpu/ops/flash_attention.py:527-533, :745-753): d lse2 / d s
    is p * scale * log2(e), so delta - glse2 * log2(e) adds exactly the
    lse's share to ds, and dv does not depend on the lse."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if glse2 is not None:
        delta = delta - glse2.float() * _LOG2E
    return delta.contiguous()


def _bwd_math(q, k, v, do, lse, delta, scale: float, kv_len: int,
              q_len: int):
    """The backward kernels' math in torch ops: dq `[B, Sq, H, dh]`, dk and
    dv `[B, Sk, H, dh]`, in q's dtype."""
    dt = q.dtype
    qs = (q.float() * _qscale(scale, dt)).to(dt)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    p = torch.exp2(s - lse[..., None])
    if kv_len < k.shape[1]:
        p[..., kv_len:] = 0.0
    if q_len < q.shape[1]:
        p[:, :, q_len:] = 0.0
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    dos = (do.float() * _rounded(scale, dt)).to(dt)
    dp = torch.einsum("bqhd,bkhd->bhqk", dos.float(), v.float())
    ds = p * (dp - delta[..., None] * scale)
    ds_dt = ds.to(dt).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_dt, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_dt, k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B2's math in torch ops, on any device.

    Args:
      q, k, v, do: [B, S, H, dh] in one dtype.
      lse: the forward's log2 lse [B, H, S] fp32.
      delta: [B, H, S] fp32 (`_delta`).

    Returns dq, dk, dv [B, S, H, dh] in q's dtype."""
    kv_len = _check(q, k, v, kv_len, self_attention=True)
    return _bwd_math(q, k, v, do, lse, delta, scale, kv_len, q.shape[1])


def flash_attention_bhsd_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None, q_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B5b's math (the TPU kernel `_dkv_kernel`'s) in torch ops, on any
    device.

    Args:
      q, do: [B, Sq, H, dh]; k, v: [B, Sk, H, dh]; one dtype.
      lse: the forward's log2 lse [B, H, Sq] fp32.
      delta: [B, H, Sq] fp32 (`_delta`).
      kv_len: keys at or past it get p = 0 (exactly zero dk, dv).
      q_len: query rows at or past it get p = 0 (exactly zero dq, and
        nothing of theirs reaches dk, dv).

    Returns dq [B, Sq, H, dh], dk, dv [B, Sk, H, dh] in q's dtype."""
    kv_len, q_len = _check_bhsd_bwd(q, k, v, kv_len, q_len)
    return _bwd_math(q, k, v, do, lse, delta, scale, kv_len, q_len)


def flash_attention_allheads_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None, q_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B4b's math (the TPU kernel `_bwd_kernel_allheads`'s, which is
    `_dkv_kernel`'s function over a group of heads) in torch ops, on any
    device. Arguments and results as `flash_attention_bhsd_bwd_plain`."""
    kv_len, q_len = _check_bhsd_bwd(q, k, v, kv_len, q_len)
    return _bwd_math(q, k, v, do, lse, delta, scale, kv_len, q_len)


def _check_bhsd_bwd(q, k, v, kv_len, q_len) -> Tuple[int, int]:
    kv_len = _check(q, k, v, kv_len, self_attention=False)
    sq = q.shape[1]
    q_len = sq if q_len is None else int(q_len)
    if not 1 <= q_len <= sq:
        raise ValueError(f"q_len must lie in [1, {sq}]; got {q_len}")
    return kv_len, q_len


def _check_rows(b: int, h: int, sq: int, **tensors) -> None:
    for name, t in tensors.items():
        if (t.shape != (b, h, sq) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 [B, H, Sq]")


def flat_bwd_tma_specs(q, k, v, do):
    """The tensor-map specs B2's bf16 kernel reads its operands through, in
    its order: q, k, v and dO `[B, S, H, 64]`, each in boxes of 64 rows of
    one head (a unit's own tile or a streamed one), through the real
    strides, so the fused qkv slices are read in place. Raises ValueError
    where TMA cannot address one of them."""
    return _head_specs(64, q, k, v, do)


def _launch_bwd(q, k, v, do, lse, delta, scale: float, kv_len: int):
    """B2: dq, dk and dv written whole by one launch (bf16; fp32 takes two
    CUDA-core passes), deterministic."""
    b, s, h, dh = q.shape
    _check_launch(q=q, k=k, v=v, do=do)
    _check_rows(b, h, s, lse=lse, delta=delta)
    lib, fn = _bound(_BWD_KERNEL,
                     [_P] * 9 + [_I] * 6 + [_F] * 3 + [_LL] * 12 + [_P] * 2)
    dq = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    specs = (_tma.as_c_array(*flat_bwd_tma_specs(q, k, v, do))
             if q.dtype == torch.bfloat16 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), int(q.dtype == torch.bfloat16), b, s, h, dh,
            kv_len, _qscale(scale, q.dtype),
            _rounded(scale, q.dtype), float(scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3],
            None if specs is None else ctypes.addressof(specs), stream,
        )
    _raise_on(lib, _BWD_KERNEL, rc)
    _build.launch_counts[_BWD_KERNEL] += 1
    return dq, dk, dv


def bhsd_bwd_tma_specs(q, k, v, do, dq_acc):
    """The tensor-map specs B5b's bf16 kernel reads its operands through
    (ops/_tma.py), in its order: q and dO `[B, Sq, H, 64]` in 64-row
    boxes, k and v `[B, Sk, H, 64]` in 128-row boxes (one key tile), each
    one head wide, and the fp32 dq scratch `[B, Sq, H, 64]` in boxes of 16
    rows (one warp's) by 32 head dims (128 bytes, the swizzle's width); the
    real strides, so the fused qkv slices are read in place. Raises
    ValueError where TMA cannot address one of them."""
    order = (3, 2, 1, 0)  # head dim, head, row, batch
    return [*_head_specs(64, q), *_head_specs(128, k, v),
            *_head_specs(64, do),
            _tma.tensor_map_spec(dq_acc, order, (HEAD_DIM // 2, 1, 16, 1))]


def allheads_bwd_tma_specs(q, k, v, do):
    """The tensor-map specs B4b's bf16 kernel reads its operands through, in
    its order: q and dO `[B, Sq, H, 64]`, k and v `[B, Sk, H, 64]`, each in
    boxes of 64 rows of one head (a unit's own tile or a streamed one),
    through the real strides, so a rank's fused qkv slices are read in
    place. Raises ValueError where TMA cannot address one of them."""
    return _head_specs(64, q, k, v, do)


def _launch_bhsd_bwd(q, k, v, do, lse, delta, scale: float, kv_len: int,
                     q_len: int):
    """B5b. dq is summed over key tiles by fp32 bulk reduce-adds into a
    zeroed fp32 scratch, so its low bits may differ from run to run; the
    scratch is cast to q's dtype once here (for fp32 it is dq itself)."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    _check_launch(q=q, k=k, v=v, do=do)
    _check_rows(b, h, sq, lse=lse, delta=delta)
    lib, fn = _bound(_BHSD_BWD_KERNEL,
                     [_P] * 9 + [_I] * 8 + [_F] * 3 + [_LL] * 12 + [_P] * 2)
    dq_acc = torch.zeros((b, sq, h, dh), dtype=torch.float32,
                         device=q.device)
    dk = torch.empty((b, sk, h, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    specs = (_tma.as_c_array(*bhsd_bwd_tma_specs(q, k, v, do, dq_acc))
             if q.dtype == torch.bfloat16 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), int(q.dtype == torch.bfloat16),
            b, sq, sk, h, dh, kv_len, q_len, _qscale(scale, q.dtype),
            _rounded(scale, q.dtype), float(scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3],
            None if specs is None else ctypes.addressof(specs), stream,
        )
    _raise_on(lib, _BHSD_BWD_KERNEL, rc)
    _build.launch_counts[_BHSD_BWD_KERNEL] += 1
    return dq_acc.to(q.dtype), dk, dv


def _launch_allheads_bwd(q, k, v, do, lse, delta, scale: float, kv_len: int,
                         q_len: int):
    """B4b: dq, dk and dv written whole by one launch, deterministic."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    _check_launch(q=q, k=k, v=v, do=do)
    _check_rows(b, h, sq, lse=lse, delta=delta)
    lib, fn = _bound(_ALLHEADS_BWD_KERNEL,
                     [_P] * 9 + [_I] * 8 + [_F] * 3 + [_LL] * 12 + [_P] * 2)
    dq = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    specs = (_tma.as_c_array(*allheads_bwd_tma_specs(q, k, v, do))
             if q.dtype == torch.bfloat16 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), int(q.dtype == torch.bfloat16),
            b, sq, sk, h, dh, kv_len, q_len, _qscale(scale, q.dtype),
            _rounded(scale, q.dtype), float(scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3],
            None if specs is None else ctypes.addressof(specs), stream,
        )
    _raise_on(lib, _ALLHEADS_BWD_KERNEL, rc)
    _build.launch_counts[_ALLHEADS_BWD_KERNEL] += 1
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None, glse2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of self-attention, flat family (B2), from the forward's
    q, k, v, o and log2 lse `[B, H, S]`, the output cotangent dO and,
    optionally, the cotangent `glse2` `[B, H, S]` of the log2 lse. A CUDA
    tensor launches the kernel; a CPU tensor takes the plain version."""
    kv_len = _check(q, k, v, kv_len, self_attention=True)
    delta = _delta(do, o, glse2)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                         scale=scale, kv_len=kv_len)
    _device_or_raise(q)
    if do.stride(3) != 1:
        do = do.contiguous()
    return _launch_bwd(q, k, v, do, lse, delta, scale, kv_len)


def flash_attention_bhsd_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None, glse2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq `[B, Sq, H, dh]`, dk, dv `[B, Sk, H, dh]`, BHSD family (B5b),
    from the forward's q, k, v, o and log2 lse `[B, H, Sq]`, dO and,
    optionally, the lse cotangent `glse2` `[B, H, Sq]`. A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version."""
    kv_len = _check(q, k, v, kv_len, self_attention=False)
    delta = _delta(do, o, glse2)
    if q.device.type == "cpu":
        return flash_attention_bhsd_bwd_plain(q, k, v, do, lse, delta,
                                              scale=scale, kv_len=kv_len)
    _device_or_raise(q)
    if do.stride(3) != 1:
        do = do.contiguous()
    return _launch_bhsd_bwd(q, k, v, do, lse, delta, scale, kv_len,
                            q.shape[1])


def flash_attention_allheads_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None, glse2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq `[B, Sq, H, dh]`, dk, dv `[B, Sk, H, dh]` (B4b), from the
    forward's q, k, v, o and log2 lse `[B, H, Sq]`, dO and, optionally, the
    lse cotangent `glse2` `[B, H, Sq]`. A CUDA tensor launches the kernel;
    a CPU tensor takes the plain version."""
    kv_len = _check(q, k, v, kv_len, self_attention=False)
    delta = _delta(do, o, glse2)
    if q.device.type == "cpu":
        return flash_attention_allheads_bwd_plain(q, k, v, do, lse, delta,
                                                  scale=scale, kv_len=kv_len)
    _device_or_raise(q)
    if do.stride(3) != 1:
        do = do.contiguous()
    return _launch_allheads_bwd(q, k, v, do, lse, delta, scale, kv_len,
                                q.shape[1])


def _forward_fn(q, k, flat: bool):
    if flat:
        return flash_attention_fwd
    return (flash_attention_allheads_fwd if _allheads_fwd(q, k)
            else flash_attention_bhsd_fwd)


def _backward_fn(q, k, flat: bool):
    if flat:
        return flash_attention_bwd
    return (flash_attention_allheads_bwd if _allheads_bwd(q, k)
            else flash_attention_bhsd_bwd)


class _FlashAttention(torch.autograd.Function):
    """o and the log2 lse from the flat, all-heads or blocked forward;
    the backward takes the flat kernel after a flat forward and, after a
    BHSD one, the all-heads or blocked kernel by the backward's own rule;
    each function looked up at call time."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_len, flat):
        o, lse2 = _forward_fn(q, k, flat)(q, k, v, scale=scale,
                                          kv_len=kv_len)
        ctx.save_for_backward(q, k, v, o, lse2)
        ctx.scale, ctx.kv_len, ctx.flat = scale, kv_len, flat
        ctx.set_materialize_grads(False)
        return o, lse2

    @staticmethod
    def backward(ctx, do, glse2):
        q, k, v, o, lse2 = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        bwd = _backward_fn(q, k, ctx.flat)
        dq, dk, dv = bwd(q, k, v, o, lse2, do, scale=ctx.scale,
                         kv_len=ctx.kv_len, glse2=glse2)
        return dq, dk, dv, None, None, None


def _family(q, k, v, kv_len, flat: Optional[bool]):
    """(kv_len, flat): the JAX wrapper's choice when `flat` is None."""
    kv_len = _check(q, k, v, kv_len, self_attention=False)
    if flat is None:
        flat = _flat_eligible(q, k)
    elif flat:
        _check(q, k, v, kv_len, self_attention=True)
    return kv_len, bool(flat)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None, flat: Optional[bool] = None,
) -> torch.Tensor:
    """Fused attention, `[B, Sq, H, dh]` q and `[B, Sk, H, dh]` k, v in,
    `[B, Sq, H, dh]` out; differentiable. `flat` forces (True) or forbids
    (False) the flat family; None chooses as the JAX package does."""
    kv_len, flat = _family(q, k, v, kv_len, flat)
    return _FlashAttention.apply(q, k, v, scale, kv_len, flat)[0]


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None, flat: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention plus its natural-log lse `[B, Sq, H]` (fp32), as the JAX
    `flash_attention_lse` returns them; differentiable in both (autograd
    turns the natural-log cotangent into the log2 one the kernels
    take)."""
    kv_len, flat = _family(q, k, v, kv_len, flat)
    o, lse2 = _FlashAttention.apply(q, k, v, scale, kv_len, flat)
    return o, lse2.transpose(1, 2) * _LN2


__all__ = [
    "HEAD_DIM", "NEG_INF", "allheads_bwd_tma_specs", "allheads_fwd_tma_specs",
    "bhsd_bwd_tma_specs", "bhsd_fwd_tma_specs", "flash_attention",
    "flash_attention_allheads_bwd", "flash_attention_allheads_bwd_plain",
    "flash_attention_allheads_fwd", "flash_attention_allheads_fwd_plain",
    "flash_attention_bhsd_bwd",
    "flash_attention_bhsd_bwd_plain", "flash_attention_bhsd_fwd",
    "flash_attention_bhsd_fwd_plain", "flash_attention_bwd",
    "flash_attention_bwd_plain", "flash_attention_fwd",
    "flash_attention_fwd_plain", "flash_attention_lse", "flat_bwd_tma_specs",
    "flat_fwd_tma_specs",
]
