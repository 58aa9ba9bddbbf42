"""The arguments of a TMA tensor map, computed from a tensor.

The Hopper kernels (csrc/int8_gemm.cu, csrc/flash_attn_bhsd_bwd.cu) load
their tiles with TMA. A tensor map describes the global tensor to the
hardware: its dims innermost first, the byte strides of all dims but the
innermost (which must be contiguous), and the box, the tile one copy
moves. TMA needs a 16-byte aligned base address and 16-byte multiples for
every stride, and at most 256 elements a box dim. The kernels' C entry
points encode the map (`cuTensorMapEncodeTiled`) from the flat spec that
`tensor_map_spec` returns (csrc/hopper.cuh reads the same layout), so the
shapes, strides and boxes are fixed here, where the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

SPEC_LEN = 16  # rank, 5 dims, 4 byte strides, 5 box dims, 1 unused
_MAX_RANK = 5


def _pad(xs: Sequence[int], n: int) -> List[int]:
    return list(xs) + [0] * (n - len(xs))


def tensor_map_spec(t: torch.Tensor, order: Sequence[int],
                    box: Sequence[int]) -> List[int]:
    """The spec of a tensor map over `t`: `order` lists t's dims innermost
    first (the first one must have stride 1), `box` the box's extent along
    each of them. Raises ValueError where TMA cannot address `t`."""
    rank = len(order)
    if not 1 <= rank <= _MAX_RANK or len(box) != rank:
        raise ValueError(f"a tensor map has 1 to {_MAX_RANK} dims and a box "
                         f"dim each; got order {order}, box {box}")
    if sorted(order) != list(range(t.dim())):
        raise ValueError(f"order {order} must list each of t's {t.dim()} "
                         f"dims once")
    item = t.element_size()
    dims = [int(t.shape[d]) for d in order]
    strides = [int(t.stride(d)) * item for d in order]
    if strides[0] != item:
        raise ValueError(f"the innermost dim ({order[0]}) must be "
                         f"contiguous; its stride is {t.stride(order[0])}")
    if t.data_ptr() % 16:
        raise ValueError("TMA needs a 16-byte aligned data pointer")
    for d, s in zip(order[1:], strides[1:]):
        if s % 16 or not 0 < s < 2 ** 40:
            raise ValueError(
                f"TMA needs byte strides that are positive multiples of 16; "
                f"dim {d} has {s} bytes (strides {t.stride()})")
    if any(not 0 < d < 2 ** 32 for d in dims):
        raise ValueError(f"dims {dims} out of TMA's range")
    if any(not 1 <= b <= 256 for b in box) or (box[0] * item) % 16:
        raise ValueError(f"box {box}: each dim 1..256, the innermost a "
                         f"multiple of 16 bytes")
    return [rank, *_pad(dims, 5), *_pad(strides[1:], 4), *_pad(box, 5), 0]


def as_c_array(*specs: Sequence[int]):
    """The specs, concatenated, as a C array of int64 for a kernel's entry
    point."""
    flat = [v for spec in specs for v in spec]
    return (ctypes.c_longlong * len(flat))(*flat)


__all__ = ["SPEC_LEN", "as_c_array", "tensor_map_spec"]
