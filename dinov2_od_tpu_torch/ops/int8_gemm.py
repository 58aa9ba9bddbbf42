"""Fused dynamic quantization + int8 GEMM: the CUDA kernel's wrapper and
its plain version.

Counterpart of dinov2_od_tpu/ops/int8_gemm.py (`fused_int8_linear`, the
Pallas kernel `_kernel`). For x `[..., K]` and an int8 linear
`{"kernel_q": int8 [K, N], "w_scale": [N], "bias": [N]}`:

- each row (token) of x gets the scale s = max(absmax * fp32(1/127), 1e-8)
  and the codes clip(round(x / s), -127, 127), rounded half to even;
- the codes multiply the int8 kernel exactly into int32;
- out = fma(float(acc), s * w_scale, bias) in fp32, cast to x's dtype.

The scale multiplies by the fp32 reciprocal of 127 where the JAX source
divides by 127: the JAX package runs activation quantization under `jit`,
where XLA rewrites that division into the multiply (x / s stays a true
division), and XLA on the CPU contracts the epilogue into one fma. With
both, the plain version here matches jitted JAX bit for bit.

`fused_int8_linear` launches the kernel (csrc/int8_gemm.cu) for a CUDA
tensor and runs `fused_int8_linear_plain`, the same math in torch ops, for
a CPU tensor. A CUDA tensor never falls back to the plain version: the
wrapper launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from . import _build

_KERNEL = "int8_gemm"
EPS = 1e-8
_QMAX = 127.0
INV_QMAX = float(np.float32(1.0) / np.float32(_QMAX))  # fp32(1/127)
_DTYPES = (torch.bfloat16, torch.float32)

# Off under tensor parallelism in the JAX package (a K-sharded fc2 would
# need its operands gathered); kept so callers can flip it the same way.
_FUSED_ENABLED = True


def set_fused_enabled(enabled: bool) -> None:
    global _FUSED_ENABLED
    _FUSED_ENABLED = bool(enabled)


def int8_gemm_eligible(m: int, k: int, n: int) -> bool:
    """The shapes the fused kernel takes, the JAX package's conditions:
    K and N multiples of 128 and K at most 4096 (the kernel keeps a
    32 x K int8 slab of x in shared memory). Any M."""
    if not _FUSED_ENABLED or m < 1:
        return False
    return k % 128 == 0 and n % 128 == 0 and 0 < k <= 4096 and n > 0


def quantize_acts(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric dynamic quantization over the last dim: int8
    codes of x's shape and fp32 scales `[..., 1]`."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().amax(-1, keepdim=True) * INV_QMAX,
                            EPS)
    codes = torch.clamp(torch.round(x32 / scale), -_QMAX, _QMAX)
    return codes.to(torch.int8), scale


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N], exact. b is taken in the
    layout it has: on the card cuBLASLt runs a K-major b (a transposed view
    of an [N, K] tensor) far faster than an N-contiguous one. cuBLASLt
    wants M > 16: fewer rows are padded with zeros there."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros((17 - m, a.shape[1]))])
    return torch._int_mm(a.contiguous(), b)[:m]


def dequant_epilogue(acc: torch.Tensor, x_scale: torch.Tensor,
                     w_scale: torch.Tensor, bias: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """fma(float(acc), x_scale * w_scale, bias) in fp32, cast to dtype
    (the int32 acc converts as it is read)."""
    return torch.addcmul(bias.float(), acc,
                         x_scale * w_scale.float()).to(dtype)


def _split(x: torch.Tensor, p: Dict[str, torch.Tensor]):
    kq = p["kernel_q"]
    if x.dtype not in _DTYPES:
        raise TypeError(f"the int8 GEMM takes bf16 or fp32 x; got {x.dtype}")
    if kq.dtype != torch.int8 or kq.dim() != 2 or kq.shape[0] != x.shape[-1]:
        raise ValueError(
            f"kernel_q must be int8 [K, N] with K = {x.shape[-1]}; got "
            f"{kq.dtype} {tuple(kq.shape)}")
    return x.reshape(-1, x.shape[-1]), kq


def fused_int8_linear_plain(x: torch.Tensor,
                            p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernel's math in torch ops, on any device: `[..., K]` ->
    `[..., N]` in x's dtype."""
    x2d, kq = _split(x, p)
    codes, scale = quantize_acts(x2d)
    out = dequant_epilogue(int_mm(codes, kq), scale, p["w_scale"],
                           p["bias"], x.dtype)
    return out.reshape(*x.shape[:-1], kq.shape[1])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with a 16-byte aligned data pointer (copied if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x2d: torch.Tensor, kq: torch.Tensor, w_scale: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    m, k = x2d.shape
    n = kq.shape[1]
    if not int8_gemm_eligible(m, k, n):
        raise ValueError(
            f"the int8 GEMM kernel does not take (M, K, N) = {(m, k, n)}: "
            f"K and N must be multiples of 128, K at most 4096 "
            f"(int8_gemm_eligible)")
    x2d, kq = _aligned(x2d), _aligned(kq)
    w_scale = _aligned(w_scale.to(torch.float32))
    bias = _aligned(bias.to(torch.float32))
    for name, t in (("kernel_q", kq), ("w_scale", w_scale), ("bias", bias)):
        if t.device != x2d.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2d.device}")
    if w_scale.shape != (n,) or bias.shape != (n,):
        raise ValueError(f"w_scale and bias must be [N] = [{n}]")
    lib = _build.load(_KERNEL)
    fn = lib.int8_gemm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.int8_gemm_error_string.argtypes = [i]
        lib.int8_gemm_error_string.restype = ctypes.c_char_p
    out = torch.empty((m, n), dtype=x2d.dtype, device=x2d.device)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = fn(x2d.data_ptr(), kq.data_ptr(), w_scale.data_ptr(),
                bias.data_ptr(), out.data_ptr(),
                int(x2d.dtype == torch.bfloat16), m, k, n, stream)
    if rc != 0:
        msg = lib.int8_gemm_error_string(rc).decode()
        raise RuntimeError(f"int8_gemm launch failed: {msg} ({rc})")
    _build.launch_counts[_KERNEL] += 1
    return out


def fused_int8_linear(x: torch.Tensor,
                      p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """y = dequant(quant(x) @ kernel_q) + bias, `[..., K]` -> `[..., N]` in
    x's dtype. A CUDA tensor launches the kernel (or raises on a shape it
    does not take); a CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return fused_int8_linear_plain(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 GEMM kernel for {x.device}")
    x2d, kq = _split(x, p)
    out = _launch(x2d, kq, p["w_scale"], p["bias"])
    return out.reshape(*x.shape[:-1], kq.shape[1])


__all__ = [
    "EPS", "INV_QMAX", "dequant_epilogue", "fused_int8_linear",
    "fused_int8_linear_plain", "int8_gemm_eligible", "int_mm",
    "quantize_acts", "set_fused_enabled",
]
