"""The numbers that decide `correct`: how far what the timed path produced
lies from the plain reference.

Training (per cell): the widest relative gap of the first steps' losses;
by the worst leaf, the gap between the program's and the reference's
norm of the first gradient as Adam received it, and of each leaf's change
over the first steps, each against the larger of the reference's norm of
that leaf and of the median leaf. Leaves whose raw first gradient in the
reference is under a thousandth of the median leaf's (a key bias under
softmax) move by round-off alone and are left out of both.

Precision: the launches of the program's own lower-precision kernels
(int8 and below, by name) over the checked steps, the window and the
traced steps, plus the parameter leaves that the program holds in
another dtype than the configuration states. A lower-precision path can
read as close to the reference as the stated one (the port's int8 prefix
does), so it is caught by what it runs, with the limit 0.
"""

from __future__ import annotations

import re
import statistics
from typing import Dict, List, Sequence

SMALL_GRAD = 1e-3
# Kernels that compute below bfloat16, by their name in the program's
# launch counters.
LOWER_PRECISION = re.compile(r"int8|int4|fp8|fp4|e4m3|e5m2", re.I)


def kept_leaves(ref_raw: Dict[tuple, float]) -> List[tuple]:
    med = statistics.median(ref_raw.values())
    return [p for p, v in ref_raw.items() if v >= SMALL_GRAD * med]


def leaf_gap(prog: Dict[tuple, float], ref: Dict[tuple, float],
             leaves: Sequence[tuple]) -> float:
    med = statistics.median(ref[p] for p in leaves)
    return max(abs(prog[p] - ref[p]) / max(ref[p], med) for p in leaves)


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """prog and ref: {"losses": [...], "grad1": {path: norm}, "change":
    {path: norm}}, ref also "grad1_raw"."""
    leaves = kept_leaves(ref["grad1_raw"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    return {"loss_gap": loss,
            "grad1_gap": leaf_gap(prog["grad1"], ref["grad1"], leaves),
            "change_gap": leaf_gap(prog["change"], ref["change"], leaves)}


def lower_precision_launches(counts: Dict[str, int]) -> int:
    """The launches in a snapshot of the program's launch counters made by
    kernels that compute below bfloat16."""
    return sum(n for k, n in counts.items() if LOWER_PRECISION.search(k))


def dtype_departures(held: Dict[tuple, "object"],
                     stated: Dict[tuple, "object"]) -> int:
    """The leaves of `stated` (path -> dtype) that `held` (path -> tensor)
    lacks or holds in another dtype."""
    return sum(1 for p, dt in stated.items()
               if p not in held or held[p].dtype != dt)
