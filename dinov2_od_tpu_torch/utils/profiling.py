"""Profiling and tracing (counterpart of dinov2_od_tpu/utils/profiling.py).

- `trace(logdir)`: a torch.profiler context over the host's ops and the
  card's kernels that writes a Chrome trace, `<logdir>/trace.json`
  (chrome://tracing or Perfetto; `tools/trace_step.py` summarises it).
- `annotate(name)`: a named region in that trace, on the profiler's own
  clock beside the card's kernels, copies and sets; one flag check when
  no profiler runs.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
# What `annotate` returns while no profiler runs: reusable and reentrant.
_NO_SPAN = contextlib.nullcontext()


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
    """Named trace region: `with annotate('step.match'): ...`. A
    `record_function` span only while a profiler is active; otherwise a
    shared no-op context, so the span costs the program one flag check
    (a `record_function` costs its ops even with no profiler to see it)."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN


__all__ = ["TRACE_FILE", "annotate", "trace"]
