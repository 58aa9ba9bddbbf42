"""One rank of the context- and tensor-parallel tests
(tests/test_torch_ring_attention.py, tests/test_torch_context_parallel.py).

Started on the CPU, one process a rank (`python tests/torch_cp_worker.py
RANK WORLD STORE INPUTS OUT_DIR`), the ranks joined in a gloo process
group over a FileStore. It imports torch, numpy and the port only (no
JAX): the test process computes the references, hands the jobs over as a
pickle and reads each rank's results back from `OUT_DIR/rank{r}.pt`.

Every job builds its own mesh (`create_mesh` from its MeshConfig fields;
each rank builds every mesh, in the jobs' order) and runs one of:

- "ring": `ring_attention` on this rank's shard (its ring's rows, its
  model index's heads) of global q, k, v, then the gradient of the sum of
  squares of the output's real rows; the calls of each flash plain
  version, forward and backward apart;
- "collectives": `ring_shift` both ways, `shard_tokens` and
  `gather_tokens` with their gradients, on tensors that name their rank;
- "train": the eval forward and top-k step, one train step's loss terms
  and gathered gradients (`train_grads`), `make_train_step`'s metrics
  and gathered params, and the loss with decoder dropout from a
  generator seeded as every other rank's; with `ring_impl`, the ring's
  inner loop forced; with `remat`, the gradients under use_remat;
- "swiglu": the eval forward and `train_grads` of a SwiGLU backbone under
  TP, and the forward with fc1 sharded as one contiguous slice of 2M (a
  faulty layout the test holds to fail);
- "int8": the eval forward of an int8 tree under TP, and a lone
  row-parallel int8 linear with the model group's absmax and, as a
  faulty control, with this rank's.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.models import quantize
from dinov2_od_tpu_torch.ops import attention as attn
from dinov2_od_tpu_torch.ops import flash_attention as fa
from dinov2_od_tpu_torch.ops.ring_attention import ring_attention
from dinov2_od_tpu_torch.params import params_from_numpy
from dinov2_od_tpu_torch.parallel import (
    batch_sharding,
    create_mesh,
    gather_params,
    gather_tokens,
    ring_shift,
    shard_tokens,
)
from dinov2_od_tpu_torch.parallel.sharding import local_slice
from dinov2_od_tpu_torch.train.state import create_train_state
from dinov2_od_tpu_torch.train.step import (
    make_eval_step,
    make_eval_topk_step,
    make_train_step,
    train_grads,
)

PLAIN = ("flash_attention_fwd_plain", "flash_attention_bwd_plain",
         "flash_attention_allheads_fwd_plain",
         "flash_attention_allheads_bwd_plain",
         "flash_attention_bhsd_fwd_plain", "flash_attention_bhsd_bwd_plain")


def train_config(backbone: dict, decoder: dict, mesh: dict, batch: int = 4,
                 max_boxes: int = 6, lr: float = 3e-4) -> pcfg.TrainConfig:
    det = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**backbone),
                              decoder=pcfg.DecoderConfig(**decoder))
    return pcfg.TrainConfig(
        detector=det,
        data=pcfg.DataConfig(batch_size=batch, max_boxes=max_boxes),
        optim=pcfg.OptimConfig(learning_rate=lr),
        mesh=pcfg.MeshConfig(**mesh))


def _count_plain_calls():
    """Counts the calls of each flash plain version (the wrappers look them
    up by name at call time)."""
    calls = dict.fromkeys(PLAIN, 0)
    for name in PLAIN:
        fn = getattr(fa, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        setattr(fa, name, counted)
    return calls


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return None if tree is None else tree.detach().clone()


def _place(mesh) -> dict:
    return {"data_index": mesh.data_index, "model_index": mesh.model_index,
            "context_index": mesh.context_index}


def _shard(x: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    w = x.shape[dim] // n
    return x.narrow(dim, index * w, w).contiguous()


def run_ring(job, mesh, calls):
    q, k, v = (torch.from_numpy(job[n]) for n in ("q", "k", "v"))
    s, valid = q.shape[1], job["valid_len"]

    def local(x):
        x = _shard(x, 1, mesh.context_index, mesh.context_size)
        return _shard(x, 2, mesh.model_index, mesh.model_size)

    loc = [local(x).requires_grad_() for x in (q, k, v)]
    for name in calls:
        calls[name] = 0
    out = ring_attention(*loc, scale=job["scale"], mesh=mesh,
                         valid_len=valid, impl=job["impl"],
                         block_size=job.get("block_size"))
    fwd_calls = dict(calls)
    w = s // mesh.context_size
    rows = torch.arange(mesh.context_index * w, (mesh.context_index + 1) * w)
    real = rows < (s if valid is None else valid)
    (out[:, real] ** 2).sum().backward()
    return {"out": out.detach(), "grads": [t.grad for t in loc],
            "fwd_calls": fwd_calls,
            "bwd_calls": {n: calls[n] - fwd_calls[n] for n in calls}}


def run_collectives(job, mesh, calls):
    del job, calls
    me = torch.full((2, 3), float(dist.get_rank()))
    x = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    x.requires_grad_()
    part = shard_tokens(x, mesh)
    whole = gather_tokens(part * (mesh.context_index + 1.0), mesh)
    (whole * torch.arange(8.0)[None, :, None]).sum().backward()
    return {"next": ring_shift(me, mesh), "prev": ring_shift(me, mesh, -1),
            "bf16": ring_shift(me.bfloat16(), mesh), "part": part.detach(),
            "whole": whole.detach(), "x_grad": x.grad}


def _force_ring_impl(impl):
    """The ring's inner loop forced to `impl` (the backbone's ring takes
    'auto', the blockwise loop on a CPU tensor)."""
    def forced(*a, **kw):
        return ring_attention(*a, **{**kw, "impl": impl})

    attn.ring_attention = forced if impl else ring_attention


def run_train(job, mesh, calls):
    cfg = train_config(job["backbone"], job["decoder"], job["mesh"])
    _force_ring_impl(job.get("ring_impl"))
    params = params_from_numpy(job["tree"], device="cpu", mesh=mesh)
    batch = batch_sharding(
        {k: torch.from_numpy(v) for k, v in job["batch"].items()}, mesh)
    out = {}
    for name in calls:
        calls[name] = 0
    fwd = make_eval_step(cfg, mesh)(params, batch["images"])
    out["forward"] = {k: fwd[k] for k in ("pred_logits", "pred_boxes")}
    out["forward_calls"] = dict(calls)
    sizes = torch.full((batch["images"].shape[0], 2), 56.0)
    out["topk"] = make_eval_topk_step(cfg, mesh, max_detections=10)(
        params, batch["images"], sizes)["topk"]
    state = create_train_state(params, cfg.optim, cfg.detector)
    for name in calls:
        calls[name] = 0
    losses, grads = train_grads(cfg, state, batch, mesh=mesh)
    out["grad_calls"] = dict(calls)
    out["losses"] = losses
    out["grads"] = gather_params(grads, mesh)
    if job.get("remat"):
        remat = dataclasses.replace(cfg, use_remat=True)
        out["remat_grads"] = gather_params(train_grads(
            remat, create_train_state(params, cfg.optim, cfg.detector),
            batch, mesh=mesh)[1], mesh)
    state, metrics = make_train_step(cfg, mesh)(state, batch)
    out["metrics"] = metrics
    out["stepped"] = gather_params(_detached(state.params), mesh)
    if "dropout_seed" in job:
        drop = train_config(job["backbone"], {**job["decoder"],
                                              "dropout": 0.1}, job["mesh"])
        gen = torch.Generator().manual_seed(job["dropout_seed"])
        out["dropout_losses"], _ = train_grads(
            drop, create_train_state(
                params_from_numpy(job["tree"], device="cpu", mesh=mesh),
                drop.optim, drop.detector),
            batch, gen, mesh=mesh)
    _force_ring_impl(None)
    return out


def run_swiglu(job, mesh, calls):
    del calls
    cfg = train_config(job["backbone"], job["decoder"], job["mesh"])
    params = params_from_numpy(job["tree"], device="cpu", mesh=mesh)
    batch = batch_sharding(
        {k: torch.from_numpy(v) for k, v in job["batch"].items()}, mesh)
    out = {"forward": make_eval_step(cfg, mesh)(params, batch["images"])}
    state = create_train_state(params, cfg.optim, cfg.detector)
    out["losses"], grads = train_grads(cfg, state, batch, mesh=mesh)
    out["grads"] = gather_params(grads, mesh)
    whole = params_from_numpy(job["tree"], device="cpu")
    fc1 = {n: (t[..., local_slice(t.shape[-1], mesh)].contiguous()
               if n in ("kernel", "bias", "lora_B") else t)
           for n, t in whole["backbone"]["blocks"]["fc1"].items()}
    blocks = {**params["backbone"]["blocks"], "fc1": fc1}
    faulty = {**params, "backbone": {**params["backbone"], "blocks": blocks}}
    out["contiguous_forward"] = make_eval_step(cfg, mesh)(
        faulty, batch["images"])
    return out


def run_int8(job, mesh, calls):
    del calls
    cfg = train_config(job["backbone"], job["decoder"], job["mesh"])
    params = params_from_numpy(job["tree"], device="cpu", mesh=mesh)
    images = batch_sharding({"images": torch.from_numpy(job["images"])},
                            mesh)["images"]
    out = {"forward": make_eval_step(cfg, mesh)(params, images)}
    lin = params_from_numpy(job["linear"], device="cpu")
    x = torch.from_numpy(job["x"])
    rows = local_slice(x.shape[-1], mesh)
    p = {"kernel_q": quantize.k_major(lin["kernel_q"][rows]),
         "w_scale": lin["w_scale"], "bias": lin["bias"]}
    with torch.no_grad():
        out["row_parallel"] = quantize.int8_row_parallel(x[:, rows], p, mesh)
        sound = quantize._model_max
        quantize._model_max = lambda t, mesh: t
        try:
            out["row_parallel_local_max"] = quantize.int8_row_parallel(
                x[:, rows], p, mesh)
        finally:
            quantize._model_max = sound
    return out


JOBS = {"ring": run_ring, "collectives": run_collectives, "train": run_train,
        "swiglu": run_swiglu, "int8": run_int8}


def run(rank: int, world: int, store_path: str, inputs_path: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        with open(inputs_path, "rb") as f:
            jobs = pickle.load(f)
        calls = _count_plain_calls()
        results = {}
        for job in jobs:
            mcfg = pcfg.MeshConfig(**job["mesh"])
            mesh = create_mesh(mcfg.model_parallel_size, mcfg)
            res = JOBS[job["kind"]](job, mesh, calls)
            results[job["name"]] = {**_place(mesh), **res}
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def start_ranks(jobs, world: int, tmp: Path):
    """`world` worker processes started on `jobs`, each writing its output
    to tmp/rank{r}.log; for the test process, which computes its
    references while they run."""
    inp = tmp / "jobs.pkl"
    with open(inp, "wb") as f:
        pickle.dump(jobs, f)
    repo = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(repo), "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(world):
        with open(tmp / f"rank{r}.log", "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(r), str(world),
                 str(tmp / "store"), str(inp), str(tmp)],
                cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def rank_results(procs, tmp: Path):
    """Each rank's results, once its process has ended."""
    for r, p in enumerate(procs):
        p.wait(timeout=300)
        log = (tmp / f"rank{r}.log").read_text()
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} failed:\n{log[-3000:]}")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


if __name__ == "__main__":
    r, w = int(sys.argv[1]), int(sys.argv[2])
    run(r, w, *sys.argv[3:6])
