"""Reads a cell's compared numbers on many seeds in one process: the
program as the configuration states it (`--mode program`: the lower
readings of each limit) or a control (the upper readings): `--mode int8`,
the program with the port's own int8 path on (the W8A8 backbone prefix,
B6) in place of the configuration's bf16 backbone; `--mode reference`,
the plain reference one precision below the configuration's (fp8
backbone products, bf16 decoder products) in the program's place.

    python3 benchmark/control.py --workload vitb224-train-coco100 \\
        --seeds 11 12 13 --mode int8 [--seconds 20]

The compared numbers come from the first steps and need no window
(`--seconds 0`, the default); a window reads the cell's end-to-end
metrics too. Prints one JSON line a seed and then the largest and
smallest reading of each number. The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", choices=("program", "int8", "reference"),
                    default="reference")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness.context import RunContext

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    cell = common.load_cell(args.workload)
    kind = common.load_kind(cell.kind)
    rows = []
    for seed in args.seeds:
        ctx = RunContext(cell=cell, seed=seed, seconds=args.seconds,
                         trace=False, device=torch.device("cuda", 0),
                         control=None if args.mode == "program" else args.mode)
        out = kind.run(ctx)
        row = {"seed": seed, "mode": args.mode,
               "checks": {c.name: c.value for c in out.checks},
               "correct": all(c.ok for c in out.checks),
               "end_to_end": out.end_to_end,
               "memory_peak_bytes": out.memory_peak_bytes}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    names = rows[0]["checks"]
    print(json.dumps({"workload": args.workload, "mode": args.mode,
                      "seeds": len(rows),
                      "max": {n: max(r["checks"][n] for r in rows)
                              for n in names},
                      "min": {n: min(r["checks"][n] for r in rows)
                              for n in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
