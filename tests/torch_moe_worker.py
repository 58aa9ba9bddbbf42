"""One rank of the MoE mesh tests (tests/test_torch_mesh_moe.py).

    python tests/torch_moe_worker.py RANK WORLD PORT JOBS OUT_DIR

The ranks join a gloo group and run the pickled jobs in order, each on
its own mesh, as tests/torch_fsdp_worker.py runs its own (whose jobs,
"step", "guard", "int8" and "cli", these are); then each writes its
results to OUT_DIR/rank{r}.pt. One job more:

- "control": the loss terms and the gathered gradients (`train_grads`)
  with the aux term's path counted once a model rank instead of once in
  the model group's sum (`ops.moe.aux_once_over_model` the identity), the
  fault that the 1 / M scale keeps out.

It imports torch, numpy and the port only (no JAX).
"""

from __future__ import annotations

import sys
from pathlib import Path

from dinov2_od_tpu_torch.ops import moe
from dinov2_od_tpu_torch.params import params_from_numpy
from dinov2_od_tpu_torch.parallel import gather_params
from dinov2_od_tpu_torch.train.state import create_train_state
from dinov2_od_tpu_torch.train.step import train_grads

import torch_fsdp_worker as fsdp


def run_control(job, mesh):
    cfg = fsdp._config(job)
    state = create_train_state(
        params_from_numpy(job["tree"], device="cpu", mesh=mesh), cfg.optim,
        cfg.detector)
    sound = moe.aux_once_over_model
    moe.aux_once_over_model = lambda aux, mesh: aux
    try:
        losses, grads = train_grads(cfg, state, fsdp._batch(job, mesh),
                                    mesh=mesh)
    finally:
        moe.aux_once_over_model = sound
    return {"losses": losses, "grads": gather_params(grads, mesh)}


fsdp.JOBS["control"] = run_control


def start(jobs, world: int, tmp: Path, timeout: float = 300):
    """`world` ranks started on `jobs` (tests/torch_ranks.py);
    `results(ranks)` waits for them."""
    import pickle

    from torch_ranks import Ranks

    tmp.mkdir(parents=True, exist_ok=True)
    jobs_path = tmp / "jobs.pkl"
    with open(jobs_path, "wb") as f:
        pickle.dump(jobs, f)
    return Ranks(lambda r, port: [__file__, r, world, port, jobs_path, tmp],
                 world, tmp, timeout=timeout)


results = fsdp.results


if __name__ == "__main__":
    r, w, port = (int(a) for a in sys.argv[1:4])
    fsdp.run(r, w, port, *sys.argv[4:6])
