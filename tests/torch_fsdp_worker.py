"""One rank of the FSDP tests (tests/test_torch_mesh_fsdp.py).

    python tests/torch_fsdp_worker.py RANK WORLD PORT JOBS OUT_DIR

The ranks join a gloo group over tcp://127.0.0.1:PORT (tests/
torch_pp_worker.py's start-up) and run the pickled jobs in order, each on
its own mesh (`create_mesh` from the job's MeshConfig fields), with
`parallel.sharding.FSDP_MIN_ELEMS` set to the job's `min_elems` where it
has one; then each writes its results to OUT_DIR/rank{r}.pt. It imports
torch, numpy and the port only (no JAX). Jobs:

- "step" (the TrainConfig with the job's `train` fields, such as
  use_remat): the eval forward and top-k on this data rank's images,
  `train_grads` (gathered), one `make_train_step` (its metrics, the
  trainable params after it gathered, whether every frozen shard kept
  its values), this rank's element counts of params and Adam moments and
  the mesh's FSDP layout; with `ckpt`, a second state with an EMA takes
  the step and is saved under the job's directory (rank 0 writes), then
  restored from the file and cut again on every rank;
- "guard": the step under skip_nonfinite with an EMA, after a NaN is
  written into one element of one leaf's gradient shard on one rank, as
  `reduce_gradients` leaves it;
- "int8": the eval forward of an int8 tree (quantized whole, then cut);
- "cli": `train.cli.main` on the job's flags in the started world, the
  model tests/torch_mesh_cli_worker.py's tiny one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pickle
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.params import params_from_numpy
from dinov2_od_tpu_torch.parallel import (
    batch_sharding,
    create_mesh,
    gather_params,
    sharding,
)
from dinov2_od_tpu_torch.train import checkpoint as ckpt
from dinov2_od_tpu_torch.train import step as step_mod
from dinov2_od_tpu_torch.train.state import (
    create_train_state,
    tree_leaves,
    tree_map,
)
from dinov2_od_tpu_torch.train.step import (
    make_eval_step,
    make_eval_topk_step,
    make_train_step,
    train_grads,
)

import torch_cp_worker
import torch_mesh_cli_worker


@contextlib.contextmanager
def min_elems(job):
    saved = sharding.FSDP_MIN_ELEMS
    sharding.FSDP_MIN_ELEMS = job.get("min_elems", saved)
    try:
        yield
    finally:
        sharding.FSDP_MIN_ELEMS = saved


def _config(job, **optim):
    """The job's TrainConfig (with its `train` fields, such as use_remat),
    the optimizer's fields replaced by `optim`."""
    cfg = torch_cp_worker.train_config(job["backbone"], job["decoder"],
                                       job["mesh"])
    return dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, **optim),
        **job.get("train", {}))


def _batch(job, mesh):
    return batch_sharding(
        {k: torch.from_numpy(v) for k, v in job["batch"].items()}, mesh)


def _trainable(tree, state):
    """The leaves that have Adam moments, detached copies."""
    return tree_map(lambda m, p: p.detach().clone(), state.opt_state.mu,
                    tree)


def _numel(tree) -> int:
    return sum(t.numel() for t in tree_leaves(tree))


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def _snapshot(state):
    clone = lambda t: None if t is None else tree_map(  # noqa: E731
        lambda x: x.detach().clone(), t)
    return {"params": clone(state.params), "mu": clone(state.opt_state.mu),
            "nu": clone(state.opt_state.nu), "ema": clone(state.ema)}


def run_step(job, mesh):
    cfg = _config(job)
    params = params_from_numpy(job["tree"], device="cpu", mesh=mesh)
    batch = _batch(job, mesh)
    out = {"layout": dict(mesh.fsdp_layout)}
    fwd = make_eval_step(cfg, mesh)(params, batch["images"])
    out["forward"] = {k: fwd[k] for k in ("pred_logits", "pred_boxes")}
    sizes = torch.full((batch["images"].shape[0], 2), 56.0)
    out["topk"] = make_eval_topk_step(cfg, mesh, max_detections=10)(
        params, batch["images"], sizes)["topk"]
    before = tree_map(lambda t: t.clone(), params)
    state = create_train_state(params, cfg.optim, cfg.detector)
    out["elements"] = {"params": _numel(params),
                       "moments": _numel(state.opt_state.mu)}
    out["losses"], grads = train_grads(cfg, state, batch, mesh=mesh)
    out["grads"] = gather_params(grads, mesh)
    state, out["metrics"] = make_train_step(cfg, mesh)(state, batch)
    out["stepped"] = gather_params(_trainable(state.params, state), mesh)
    out["frozen_kept"] = all(
        torch.equal(a, b) for a, b in zip(tree_leaves(before),
                                          tree_leaves(state.params))
        if not b.requires_grad)
    if "ckpt" in job:
        out["ckpt"] = _checkpoint(job, mesh, batch)
    return out


def _checkpoint(job, mesh, batch):
    """An FSDP state with an EMA after one step, saved (rank 0 writes the
    logical tree), restored from the file and cut again: whether every
    shard comes back bit for bit, and the rank's shards."""
    cfg = _config(job, ema_decay=0.5)
    state = create_train_state(
        params_from_numpy(job["tree"], device="cpu", mesh=mesh), cfg.optim,
        cfg.detector)
    state, _ = make_train_step(cfg, mesh)(state, batch)
    path = ckpt.save_checkpoint(job["ckpt"], 0, state.params,
                                state.opt_state, 1.0, step=state.step,
                                ema=state.ema, mesh=mesh)
    logical = params_from_numpy(job["tree"], device="cpu")
    template = create_train_state(logical, cfg.optim, cfg.detector)
    restored = ckpt.restore_checkpoint(path, logical, template.opt_state,
                                       template.ema)
    opt, ema = ckpt.shard_train_trees(restored.opt_state, restored.ema,
                                      mesh)
    again = {"params": sharding.shard_params(restored.params, mesh),
             "mu": opt.mu, "nu": opt.nu, "ema": ema}
    mine = _snapshot(state)
    return {"path": path, "step": restored.step, "count": opt.count,
            "same": {k: _equal(mine[k], again[k]) for k in mine},
            "elements": {k: _numel(v) for k, v in mine.items()}}


def run_guard(job, mesh):
    cfg = _config(job, skip_nonfinite=True, ema_decay=0.5)
    state = create_train_state(
        params_from_numpy(job["tree"], device="cpu", mesh=mesh), cfg.optim,
        cfg.detector)
    # The EMA away from the params, so a skipped EMA update shows.
    tree_map(lambda e: e.mul_(0.5) if e.dim() else e, state.ema)
    before = _snapshot(state)
    sound = step_mod.reduce_gradients
    path = tuple(job["poison"])

    def poisoned(grads, paths, m):
        sound(grads, paths, m)
        if dist.get_rank() == job["poison_rank"]:
            grads[paths.index(path)].view(-1)[0] = float("nan")

    step_mod.reduce_gradients = poisoned
    try:
        state, metrics = make_train_step(cfg, mesh)(state, _batch(job, mesh))
    finally:
        step_mod.reduce_gradients = sound
    after = _snapshot(state)
    return {"skip": float(metrics["nonfinite_skip"]),
            "kept": {k: _equal(before[k], after[k]) for k in before},
            "layout": dict(mesh.fsdp_layout)}


def run_int8(job, mesh):
    cfg = _config(job)
    images = batch_sharding({"images": torch.from_numpy(job["images"])},
                            mesh)["images"]
    out = {}
    for name in ("float", "int8"):
        params = params_from_numpy(job[name], device="cpu", mesh=mesh)
        out[name] = make_eval_step(cfg, mesh)(params, images)
    out["layout"] = dict(mesh.fsdp_layout)
    return out


def run_cli(job, mesh):
    del mesh  # the CLI builds its own over the started world
    with torch_mesh_cli_worker.tiny_cli(job["spec"]) as cli:
        return {"rc": cli.main(job["args"])}


JOBS = {"step": run_step, "guard": run_guard, "int8": run_int8,
        "cli": run_cli}


def run(rank: int, world: int, port: int, jobs_path: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        with open(jobs_path, "rb") as f:
            jobs = pickle.load(f)
        results = {}
        for job in jobs:
            with min_elems(job):
                mcfg = pcfg.MeshConfig(**job["mesh"])
                mesh = create_mesh(mcfg.model_parallel_size, mcfg)
                res = JOBS[job["kind"]](job, mesh)
            results[job["name"]] = {"data_index": mesh.data_index,
                                    "model_index": mesh.model_index, **res}
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def start(jobs, world: int, tmp: Path, timeout: float = 300):
    """`world` ranks started on `jobs` (tests/torch_ranks.py);
    `results(ranks)` waits for them."""
    from torch_ranks import Ranks

    tmp.mkdir(parents=True, exist_ok=True)
    jobs_path = tmp / "jobs.pkl"
    with open(jobs_path, "wb") as f:
        pickle.dump(jobs, f)
    return Ranks(lambda r, port: [__file__, r, world, port, jobs_path, tmp],
                 world, tmp, timeout=timeout)


def results(ranks) -> list:
    """Each rank's results, once every rank has exited 0."""
    ranks.wait()
    return [torch.load(ranks.log_dir / f"rank{r}.pt", weights_only=False)
            for r in range(ranks.world)]


if __name__ == "__main__":
    r, w, port = (int(a) for a in sys.argv[1:4])
    run(r, w, port, *sys.argv[4:6])
