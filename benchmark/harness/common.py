"""What every cell shares: its files, the card, the guard against JAX and
the result line.

A cell is `benchmark/workloads/<name>.json`. It names its configuration
(`benchmark/configs/<config>.json`) and its traffic kind, whose generator
and runner is `benchmark/traffic/<kind>.py`. Which metrics a cell reports
comes from `BENCHMARK.json` at the root of the checkout: its end-to-end
metrics in an untraced run, its per-layer metrics in a traced one, each
read by `benchmark/metrics/<metric>.py`. Nothing here names a cell, a
configuration or a metric, so a new one is a new file.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
# Caches and traces of a run, at fixed paths inside the checkout (the
# root .gitignore lists build/).
CACHE_DIR = ROOT / "build" / "bench_cache"
TRACE_DIR = ROOT / "build" / "bench_trace"

# Modules that must not be loaded in a run, compared by top-level name:
# the JAX package's name is a prefix of the port's, so a prefix test would
# flag the port itself.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "dinov2_od_tpu")


class CellError(RuntimeError):
    """A cell's files disagree with each other or with BENCHMARK.json."""


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One workload with its configuration and its metrics' names."""

    name: str
    workload: dict
    config: dict
    end_to_end: List[str]
    per_layer: List[str]

    @property
    def kind(self) -> str:
        return self.workload["traffic"]["kind"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def metrics_of(entries: List[dict], cell: str,
               reported: Optional[List[str]] = None) -> List[str]:
    """The names of the metrics in `entries` that `cell` reports: those
    that list it under `workloads`, or, without that key, those that move
    an end-to-end metric the cell reports (`reported`; every entry when
    None)."""
    out = []
    for m in entries:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m["name"])
        elif reported is None or m.get("moves") in reported:
            out.append(m["name"])
    return out


def load_cell(name: str, bench_dir: Path = BENCH_DIR,
              spec: Optional[dict] = None) -> Cell:
    """The cell `name` from its workload file, its configuration file and
    BENCHMARK.json (`spec`, read from the checkout's root by default)."""
    path = bench_dir / "workloads" / f"{name}.json"
    if not path.is_file():
        raise CellError(f"no workload file {path}")
    workload = read_json(path)
    config = read_json(bench_dir / "configs" / f"{workload['config']}.json")
    spec = benchmark_spec() if spec is None else spec
    e2e = metrics_of(spec["end_to_end"], name)
    return Cell(name=name, workload=workload, config=config,
                end_to_end=e2e,
                per_layer=metrics_of(spec["per_layer"], name, e2e))


def load_kind(kind: str, bench_dir: Path = BENCH_DIR):
    """The traffic module `benchmark/traffic/<kind>.py`."""
    if not (bench_dir / "traffic" / f"{kind}.py").is_file():
        raise CellError(f"no traffic kind {kind!r}")
    return importlib.import_module(f"benchmark.traffic.{kind}")


def load_reader(metric: str,
                bench_dir: Path = BENCH_DIR) -> Callable[[Any], Optional[float]]:
    """`read` of `benchmark/metrics/<metric>.py` (a metric's name may hold
    dots, so the file is loaded by path)."""
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise CellError(f"no reader for metric {metric!r}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in list(modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def card_info(count: int) -> Dict[str, Any]:
    """The card's name, the cards used and the first card's power limit."""
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        info["power_limit_w"] = float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


@dataclasses.dataclass
class Check:
    """One number compared against its limit: correct while value <= limit
    (a NaN or an infinity never is)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def finite(x) -> Optional[float]:
    """x as a float, or None where it is not a finite number (JSON has no
    infinity)."""
    x = float(x)
    return x if math.isfinite(x) else None


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, tuple], device: dict,
                checks: List[Check], breakdown: Optional[dict] = None) -> str:
    """The run's last line of standard output. `metrics` maps a name to
    (value, unit). The checks come last, each with its value and limit."""
    out: Dict[str, Any] = {
        "correct": bool(correct), "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": finite(v), "unit": u}
                    for k, (v, u) in metrics.items()},
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": finite(c.value), "limit": c.limit}
                     for c in checks}
    return json.dumps(out)
