"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of dinov2_od_tpu/ops/flash_attention.py (`flash_attention`,
`flash_attention_lse`, the flat forward kernel `_fwd_kernel_flat` and the
flat backward kernel `_bwd_kernel_flat`). The forward's math is the TPU
kernel's:

- q is scaled by `scale * log2(e)` in its own dtype and the softmax is
  taken in base 2;
- keys at positions >= `kv_len` get the logit -1e30 (not -inf, so a row
  stays finite);
- the probabilities are rounded to the input dtype before both the p.v
  product and the row sum, which accumulate in fp32;
- the lse is kept in log2 space (m + log2 l), fp32, `[B, H, S]`.

The backward recomputes p = exp2(s - lse) from the saved q, k and lse
and takes delta = rowsum(fp32(dO) * fp32(o)) per head from torch ops
outside the kernel, as the JAX wrapper does; a cotangent of the lse
output folds into delta (`_delta`). With dt the input dtype and scale
exact in it (1/8 at head dim 64):

- dv = p(dt)^T dO and dp = (dO * scale)(dt) v^T, both fp32 sums;
- ds = p * (dp - delta * scale);
- dk = ds(dt)^T q with the unscaled q, dq = ds(dt) k, fp32 sums cast to
  dt at the end;
- keys at or past kv_len have p = 0, so their dk and dv are exactly 0.

`flash_attention_fwd` and `flash_attention_bwd` launch the kernels
(csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd.cu) for a CUDA tensor and
run `flash_attention_fwd_plain` / `flash_attention_bwd_plain`, the same
math in torch ops, for a CPU tensor. A CUDA tensor never falls back to a
plain version: the wrapper launches the kernel or raises.
`flash_attention` and `flash_attention_lse` are differentiable through
`_FlashAttention`, whose backward is `flash_attention_bwd`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_KERNEL = "flash_attn_fwd"
_BWD_KERNEL = "flash_attn_bwd"
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
NEG_INF = -1e30
HEAD_DIM = 64  # the only head width the kernel is built for
_DTYPES = (torch.bfloat16, torch.float32)


def _rounded(x: float, dtype: torch.dtype) -> float:
    """x rounded to `dtype`, as JAX rounds a Python scalar that multiplies
    an array to the array's own type."""
    return torch.tensor(x, dtype=torch.float32).to(dtype).item()


def _qscale(scale: float, dtype: torch.dtype) -> float:
    """`scale * log2(e)` in q's dtype: the TPU kernel's q multiplier."""
    return _rounded(scale * _LOG2E, dtype)


def _check(q, k, v, kv_len: Optional[int]) -> int:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "flash attention takes self-attention q, k, v of one shape "
            f"[B, S, H, dh]; got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"flash attention takes bf16 or fp32 q, k, v of one dtype; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    s = q.shape[1]
    kv_len = s if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len must lie in [1, {s}]; got {kv_len}")
    return kv_len


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's math in torch ops, on any device.

    Returns o `[B, S, H, dh]` in q's dtype and the log2-space lse
    `[B, H, S]` in fp32."""
    kv_len = _check(q, k, v, kv_len)
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


def _check_launch(**tensors) -> None:
    """What both kernels need of their [B, S, H, 64] operands."""
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


def _launch(q, k, v, scale: float, kv_len: int):
    b, s, h, dh = q.shape
    _check_launch(q=q, k=k, v=v)
    lib = _build.load(_KERNEL)
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.flash_attn_fwd_error_string.argtypes = [i]
        lib.flash_attn_fwd_error_string.restype = ctypes.c_char_p
    o = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), b, s, h, dh,
            kv_len, _qscale(scale, q.dtype),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream,
        )
    if rc != 0:
        msg = lib.flash_attn_fwd_error_string(rc).decode()
        raise RuntimeError(f"flash_attn_fwd launch failed: {msg} ({rc})")
    _build.launch_counts[_KERNEL] += 1
    return o, lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """o `[B, S, H, dh]` and the log2 lse `[B, H, S]` of self-attention.

    q, k, v may be strided views (e.g. the three slices of one fused qkv
    GEMM output) as long as their last dim is contiguous. A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version."""
    kv_len = _check(q, k, v, kv_len)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale=scale, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    return _launch(q, k, v, scale, kv_len)


def _delta(do: torch.Tensor, o: torch.Tensor,
           glse2: Optional[torch.Tensor]) -> torch.Tensor:
    """delta [B, H, S] fp32 = rowsum(fp32(dO) * fp32(o)) per head, less
    the cotangent glse2 [B, H, S] of the log2 lse, folded in as JAX does
    (dinov2_od_tpu/ops/flash_attention.py:527-533): d lse2 / d s is
    p * scale * log2(e), so delta - glse2 * log2(e) adds exactly the
    lse's share to ds, and dv does not depend on the lse."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if glse2 is not None:
        delta = delta - glse2.float() * _LOG2E
    return delta.contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's math in torch ops, on any device.

    Args:
      q, k, v, do: [B, S, H, dh] in one dtype.
      lse: the forward's log2 lse [B, H, S] fp32.
      delta: [B, H, S] fp32 (`_delta`).

    Returns dq, dk, dv [B, S, H, dh] in q's dtype."""
    kv_len = _check(q, k, v, kv_len)
    dt = q.dtype
    qs = (q.float() * _qscale(scale, dt)).to(dt)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    p = torch.exp2(s - lse[..., None])
    if kv_len < k.shape[1]:
        p[..., kv_len:] = 0.0
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    dos = (do.float() * _rounded(scale, dt)).to(dt)
    dp = torch.einsum("bqhd,bkhd->bhqk", dos.float(), v.float())
    ds = p * (dp - delta[..., None] * scale)
    ds_dt = ds.to(dt).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_dt, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_dt, k.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _launch_bwd(q, k, v, do, lse, delta, scale: float, kv_len: int):
    b, s, h, dh = q.shape
    _check_launch(q=q, k=k, v=v, do=do)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, s) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous fp32 [B, H, S]")
    lib = _build.load(_BWD_KERNEL)
    fn = lib.flash_attn_bwd
    if fn.argtypes is None:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        fn.argtypes = ([p] * 9 + [i] * 6 + [f, f, f] + [ll] * 12 + [p])
        fn.restype = ctypes.c_int
        lib.flash_attn_bwd_error_string.argtypes = [i]
        lib.flash_attn_bwd_error_string.restype = ctypes.c_char_p
    dq = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), int(q.dtype == torch.bfloat16), b, s, h, dh,
            kv_len, _qscale(scale, q.dtype),
            _rounded(scale, q.dtype), float(scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], stream,
        )
    if rc != 0:
        msg = lib.flash_attn_bwd_error_string(rc).decode()
        raise RuntimeError(f"flash_attn_bwd launch failed: {msg} ({rc})")
    _build.launch_counts[_BWD_KERNEL] += 1
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None, glse2: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of self-attention from the forward's q, k, v, o and log2
    lse `[B, H, S]`, the output cotangent dO and, optionally, the
    cotangent `glse2` `[B, H, S]` of the log2 lse. A CUDA tensor launches
    the kernel; a CPU tensor takes the plain version."""
    kv_len = _check(q, k, v, kv_len)
    delta = _delta(do, o, glse2)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                         scale=scale, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    if do.stride(3) != 1:
        do = do.contiguous()
    return _launch_bwd(q, k, v, do, lse, delta, scale, kv_len)


class _FlashAttention(torch.autograd.Function):
    """o and the log2 lse from `flash_attention_fwd`; the backward is
    `flash_attention_bwd`, looked up at call time."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_len):
        o, lse2 = flash_attention_fwd(q, k, v, scale=scale, kv_len=kv_len)
        ctx.save_for_backward(q, k, v, o, lse2)
        ctx.scale, ctx.kv_len = scale, kv_len
        ctx.set_materialize_grads(False)
        return o, lse2

    @staticmethod
    def backward(ctx, do, glse2):
        q, k, v, o, lse2 = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse2, do,
                                         scale=ctx.scale, kv_len=ctx.kv_len,
                                         glse2=glse2)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Fused self-attention, `[B, S, H, dh]` in and out; differentiable."""
    kv_len = _check(q, k, v, kv_len)
    return _FlashAttention.apply(q, k, v, scale, kv_len)[0]


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    kv_len: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention plus its natural-log lse `[B, S, H]` (fp32), as the JAX
    `flash_attention_lse` returns them; differentiable in both (autograd
    turns the natural-log cotangent into the log2 one the kernel
    takes)."""
    kv_len = _check(q, k, v, kv_len)
    o, lse2 = _FlashAttention.apply(q, k, v, scale, kv_len)
    return o, lse2.transpose(1, 2) * _LN2


__all__ = [
    "HEAD_DIM", "NEG_INF", "flash_attention", "flash_attention_bwd",
    "flash_attention_bwd_plain", "flash_attention_fwd",
    "flash_attention_fwd_plain", "flash_attention_lse",
]
