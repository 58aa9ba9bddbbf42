"""Device memory introspection for `--memory_monitor` (counterpart of
dinov2_od_tpu/utils/memory.py): usage by CUDA device from
`torch.cuda.memory_stats`, and the largest live CUDA tensors."""

from __future__ import annotations

import gc
from typing import Dict, List, Tuple

import torch

_MB = 1024 * 1024


def memory_stats() -> Dict[str, Dict[str, float]]:
    """Per CUDA device, MB allocated now, at peak, reserved by the caching
    allocator, and the card's total; {} without CUDA."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use_mb": s.get("allocated_bytes.all.current", 0) / _MB,
            "peak_bytes_in_use_mb": s.get("allocated_bytes.all.peak", 0) / _MB,
            "reserved_mb": s.get("reserved_bytes.all.current", 0) / _MB,
            "bytes_limit_mb":
                torch.cuda.get_device_properties(i).total_memory / _MB,
        }
    return stats


def format_memory_stats() -> str:
    lines = [
        f"{dev}: in_use {s['bytes_in_use_mb']:.1f}MB  "
        f"peak {s['peak_bytes_in_use_mb']:.1f}MB  "
        f"reserved {s['reserved_mb']:.1f}MB  "
        f"limit {s['bytes_limit_mb']:.1f}MB"
        for dev, s in memory_stats().items()
    ]
    return "\n".join(lines) or "no device memory stats available"


def live_arrays_by_size(top: int = 20) -> List[Tuple[str, float]]:
    """The largest live CUDA tensors as ('dtype[shape]', MB), from a walk
    of the objects the garbage collector tracks."""
    out = []
    for obj in gc.get_objects():
        try:
            if torch.is_tensor(obj) and obj.is_cuda:
                out.append((f"{obj.dtype}{list(obj.shape)}",
                            obj.numel() * obj.element_size() / 1e6))
        except ReferenceError:  # a dead weak proxy
            continue
    out.sort(key=lambda kv: -kv[1])
    return out[:top]

