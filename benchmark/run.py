"""Runs one cell of the benchmark of dinov2_od_tpu_torch once, on the
card(s) of the machine it starts on, and prints one JSON result line.

    python3 benchmark/run.py --workload vitb224-train-coco100 \\
        --seed 1234 --seconds 20 --trace 0

The cell's files (`benchmark/workloads/<name>.json`, its configuration
and traffic kind) say what runs; `BENCHMARK.json` says which metrics the
line carries: with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a profiled sub-window after
the measured one. Every run checks what the timed path produced against
the plain reference in `benchmark/reference/` and prints each number
compared beside its limit, last on standard error and last in the line.

Exits non-zero, with no result line, without a CUDA card (or with fewer
than the cell asks for), when a cell's files are missing or disagree,
when a traced run finds nothing to read for a per-layer metric that
BENCHMARK.json lists for the cell (say, no attention kernel's time:
`benchmark/kernels/attention/` names them), and when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import common  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; no
    library may load JAX on its own behalf."""
    common.CACHE_DIR.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(common.CACHE_DIR / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(common.CACHE_DIR /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None, program=None, device=None) -> int:
    """`program` and `device` replace the port and the card (tests)."""
    args = parse_args(argv)
    cache_env()
    try:
        cell = common.load_cell(args.workload)
    except (common.CellError, OSError, KeyError) as e:
        print(f"run: {e}", file=sys.stderr)
        return 2
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"run: the cell needs {cell.chips} CUDA card(s); "
                  f"{torch.cuda.device_count()} available", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)

    from benchmark.harness.context import RunContext
    from benchmark.harness.trace import breakdown

    ctx = RunContext(cell=cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=device, t_start=_T_START,
                     program=program)
    outcome = common.load_kind(cell.kind).run(ctx)

    if args.trace:
        metrics = {}
        units = {m["name"]: m["unit"]
                 for m in common.benchmark_spec()["per_layer"]}
        for name in cell.per_layer:
            value = common.load_reader(name)(outcome.readings)
            if value is not None:
                metrics[name] = (value, units[name])
        missing = [n for n in cell.per_layer if n not in metrics]
        if missing:
            print(f"run: the traced run found nothing to read for {missing}",
                  file=sys.stderr)
            return 5
    else:
        metrics = {name: (outcome.end_to_end[name], outcome.units[name])
                   for name in cell.end_to_end}

    found = common.forbidden_loaded()
    if found:
        print(f"run: modules that must not load were loaded: {found}",
              file=sys.stderr)
        return 4

    device_info = (common.card_info(cell.chips) if device.type == "cuda"
                   else {"platform": device.type, "kind": "cpu",
                         "count": 1})
    device_info["memory_peak_bytes"] = outcome.memory_peak_bytes
    bd = None
    tr = outcome.readings.trace
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        bd = breakdown(tr)
        print("device s by family: " + ", ".join(
            f"{k} {v!r}" for k, v in sorted(tr.groups_s.items(),
                                          key=lambda kv: -kv[1])),
              file=sys.stderr)
    correct = all(c.ok for c in outcome.checks)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(common.result_line(correct, outcome.attempted, outcome.failed,
                             metrics, device_info, outcome.checks, bd),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
