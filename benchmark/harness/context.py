"""What a traffic kind is handed and what it hands back.

`Program` is the system under test: the port's entry points that a
cell drives, gathered in one place so that a test can put a broken one
in their stead. `RunContext` is one run's settings; `Outcome` is what
the run measured, and `Readings` what the per-layer readers read.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from .common import Cell, Check


@dataclasses.dataclass
class Program:
    make_train_step: Callable
    create_train_state: Callable
    solver_stats: Dict[str, int]
    launch_counts: Dict[str, int]    # launches of each hand-written kernel


def port() -> Program:
    """The port's own entry points and counters."""
    from dinov2_od_tpu_torch.ops._build import launch_counts
    from dinov2_od_tpu_torch.ops.matching import solver_stats
    from dinov2_od_tpu_torch.train.state import create_train_state
    from dinov2_od_tpu_torch.train.step import make_train_step

    return Program(make_train_step=make_train_step,
                   create_train_state=create_train_state,
                   solver_stats=solver_stats, launch_counts=launch_counts)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


@dataclasses.dataclass
class RunContext:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any                  # a torch.device
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    program: Optional[Program] = None
    # A control run: None (the program as the configuration states it),
    # "int8" (the program with its own int8 path on) or "reference" (the
    # plain reference one precision below the configuration's,
    # `reference.model.LOWER`, in the program's place).
    control: Optional[str] = None
    log: Callable[..., None] = log

    def __post_init__(self):
        if self.program is None:
            self.program = port()

    def mark(self, phase: str) -> None:
        """Logs the seconds since the process started, at the end of a
        phase of set-up."""
        self.log(f"setup {phase}: {time.perf_counter() - self.t_start:.3f} s")

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            import torch
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read. `window_s`, `window_units` and the
    counters are of the untraced window; `trace` is the profiled
    sub-window's summary, with the attention work's least seconds and its
    units of work. A unit is a train step."""

    kind: str                            # "train"
    window_s: float
    model_flops: float
    counters: Dict[str, float]
    trace: Any = None                    # harness.trace.TraceSummary
    trace_attention_bound_s: float = 0.0
    trace_steps: int = 0
    window_units: int = 0


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]
    units: Dict[str, str]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Check]
    readings: Readings
