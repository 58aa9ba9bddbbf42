"""Profiling and tracing (counterpart of dinov2_od_tpu/utils/profiling.py).

- `trace(logdir)`: a torch.profiler context over the host's ops and the
  card's kernels that writes a Chrome trace, `<logdir>/trace.json`
  (chrome://tracing or Perfetto; `tools/trace_step.py` summarises it).
- `annotate(name)`: a named region in that trace.
- `StepTimer`: rolling wall-clock stats for train loops.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profile the body (CPU ops and CUDA kernels) and write its Chrome
    trace to `<logdir>/trace.json` on exit. The caller synchronises the
    card inside the body, so that every kernel it launched is recorded."""
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """Named trace region: `with annotate('matcher'): ...`."""
    return record_function(name)


class StepTimer:
    """Rolling throughput stats for a training loop."""

    def __init__(self, window: int = 50):
        self.times = deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
        self._last = now
        return dt

    @property
    def mean_sec(self) -> float:
        if not self.times:
            return float("nan")
        return sum(self.times) / len(self.times)

    def images_per_sec(self, batch_size: int) -> float:
        m = self.mean_sec
        return batch_size / m if m == m and m > 0 else float("nan")


__all__ = ["StepTimer", "TRACE_FILE", "annotate", "trace"]
