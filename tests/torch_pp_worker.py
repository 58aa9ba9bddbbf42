"""One rank of the pipeline-parallel tests (tests/test_torch_pipeline.py,
tests/test_torch_mesh_pp.py).

    python tests/torch_pp_worker.py RANK WORLD PORT JOBS OUT_DIR

The ranks join a gloo group over tcp://127.0.0.1:PORT and run the
pickled jobs in order, each on its own mesh (`create_mesh` from the job's
MeshConfig fields; every rank builds every mesh in the jobs' order), then
write their results to OUT_DIR/rank{r}.pt. It imports torch, numpy and
the port only (no JAX); the test process computes the references while
the ranks run. Jobs:

- "blocks": `pipeline_blocks` on affine tanh blocks (x @ w_i + b_i, then
  tanh) over the job's stages, for each of its bubble settings: this
  rank's output rows, and the gradients of sum(out ** 2) over the global
  batch: of w and b summed over the stage and data groups, of x this
  rank's rows summed over the stage group;
- "forward": the detector's eval forward and top-k step on this data
  rank's images;
- "train": tests/torch_cp_worker.py's train job (the eval forward and
  top-k, `train_grads`, `make_train_step`), its results gathered over
  the model group.
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.params import params_from_numpy
from dinov2_od_tpu_torch.parallel import batch_sharding, create_mesh
from dinov2_od_tpu_torch.parallel.collectives import all_reduce
from dinov2_od_tpu_torch.parallel.pipeline import pipeline_blocks
from dinov2_od_tpu_torch.train.step import make_eval_step, make_eval_topk_step

import torch_cp_worker


def _tanh_block(h, p):
    return torch.tanh(h @ p["w"] + p["b"])


def run_blocks(job, mesh, calls):
    del calls
    w, b = (torch.from_numpy(job[k]) for k in ("w", "b"))
    x = torch.from_numpy(job["x"])
    rows = x.shape[0] // mesh.data_size
    mine = slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)
    out = {"data_index": mesh.data_index, "stage_index": mesh.stage_index}
    for skip in job["skip"]:
        params = {"w": w.clone().requires_grad_(),
                  "b": b.clone().requires_grad_()}
        xl = x[mine].clone().requires_grad_(job["x_grad"])
        y = pipeline_blocks(xl, params, _tanh_block, mesh,
                            job["microbatches"], skip_bubbles=skip,
                            num_chunks=job["chunks"],
                            frozen_blocks=job.get("frozen", 0))
        (y ** 2).sum().backward()
        grads = {}
        for k, t in params.items():
            g = all_reduce(t.grad, mesh.stage_group, mesh.backend) \
                if mesh.stage_size > 1 else t.grad
            grads[k] = (all_reduce(g, mesh.data_group, mesh.backend)
                        if mesh.data_size > 1 else g)
        if job["x_grad"]:
            grads["x"] = (all_reduce(xl.grad, mesh.stage_group, mesh.backend)
                          if mesh.stage_size > 1 else xl.grad)
        out[skip] = {"out": y.detach(), "grads": grads,
                     "own_rows": {k: (t.grad.abs().sum(tuple(range(
                         1, t.grad.dim()))) > 0).tolist()
                         for k, t in params.items()}}
    return out


def run_forward(job, mesh, calls):
    del calls
    cfg = torch_cp_worker.train_config(job["backbone"], job["decoder"],
                                       job["mesh"])
    params = params_from_numpy(job["tree"], device="cpu", mesh=mesh)
    images = batch_sharding({"images": torch.from_numpy(job["images"])},
                            mesh)["images"]
    fwd = make_eval_step(cfg, mesh)(params, images)
    sizes = torch.full((images.shape[0], 2), 56.0)
    return {"forward": {k: fwd[k] for k in ("pred_logits", "pred_boxes")},
            "topk": make_eval_topk_step(cfg, mesh, max_detections=10)(
                params, images, sizes)["topk"]}


JOBS = {"blocks": run_blocks, "forward": run_forward,
        "train": torch_cp_worker.run_train}


def run(rank: int, world: int, port: int, jobs_path: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        with open(jobs_path, "rb") as f:
            jobs = pickle.load(f)
        calls = torch_cp_worker._count_plain_calls()
        results = {}
        for job in jobs:
            mcfg = pcfg.MeshConfig(**job["mesh"])
            mesh = create_mesh(mcfg.model_parallel_size, mcfg)
            res = JOBS[job["kind"]](job, mesh, calls)
            results[job["name"]] = {
                "data_index": mesh.data_index,
                "model_index": mesh.model_index,
                "stage_index": mesh.stage_index, **res}
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def start(jobs, world: int, tmp: Path, timeout: float = 300):
    """`world` ranks started on `jobs` (tests/torch_ranks.py: a free port,
    peers killed on a failure or at `timeout`); `results(ranks)` waits for
    them."""
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
