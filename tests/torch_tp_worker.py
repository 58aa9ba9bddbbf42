"""One rank of the tensor-parallel tests (tests/test_torch_tensor_parallel.py).

Started on the CPU, one process a rank (`python tests/torch_tp_worker.py
RANK WORLD TP STORE INPUTS OUT_DIR`), the ranks joined in a gloo process
group over a FileStore. It imports torch, numpy and the port only (no
JAX): the test process computes the references, hands the inputs over as
a pickle and reads each rank's results back from `OUT_DIR/rank{r}.pt`.

What a rank runs, on a ('data', 'model') mesh of `tp` model ranks:
- its shard of the numpy param tree (`params_from_numpy(..., mesh=)`), and
  `gather_params` of it;
- the eval forward with attn_impl="flash" (on the CPU the flash kernels'
  plain versions, whose calls it counts);
- one train step's loss terms and gathered gradients (`train_grads`), the
  global norm of the gradient shards, and `make_train_step`'s updated
  params, gathered;
- the loss of a step with decoder dropout on, from a generator seeded as
  every other rank's, which the test holds to one process's.
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.models.detector import detector_apply
from dinov2_od_tpu_torch.ops import flash_attention as fa
from dinov2_od_tpu_torch.params import params_from_numpy
from dinov2_od_tpu_torch.parallel import (
    batch_sharding,
    create_mesh,
    gather_params,
)
from dinov2_od_tpu_torch.train.state import create_train_state, global_norm
from dinov2_od_tpu_torch.train.step import (
    make_train_step,
    prep_images,
    train_grads,
)

PLAIN = ("flash_attention_fwd_plain", "flash_attention_bwd_plain",
         "flash_attention_allheads_fwd_plain",
         "flash_attention_allheads_bwd_plain",
         "flash_attention_bhsd_fwd_plain", "flash_attention_bhsd_bwd_plain")


def train_config(backbone: dict, decoder: dict, batch: int, max_boxes: int,
                 lr: float, tp: int) -> pcfg.TrainConfig:
    det = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**backbone),
                              decoder=pcfg.DecoderConfig(**decoder))
    return pcfg.TrainConfig(
        detector=det,
        data=pcfg.DataConfig(batch_size=batch, max_boxes=max_boxes),
        optim=pcfg.OptimConfig(learning_rate=lr),
        mesh=pcfg.MeshConfig(model_parallel_size=tp))


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


def run(rank: int, world: int, tp: int, store_path: str, inputs_path: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        with open(inputs_path, "rb") as f:
            inp = pickle.load(f)
        cfg = train_config(inp["backbone"], inp["decoder"], inp["batch_size"],
                           inp["max_boxes"], inp["lr"], tp)
        mesh = create_mesh(tp, cfg.mesh)
        out = {"data_index": mesh.data_index, "model_index": mesh.model_index}
        params = params_from_numpy(inp["tree"], device="cpu", mesh=mesh)
        out["shards"] = _detached(params)
        out["gathered"] = _detached(gather_params(params, mesh))
        batch = batch_sharding(
            {k: torch.from_numpy(v) for k, v in inp["batch"].items()}, mesh)
        calls = _count_plain_calls()

        with torch.no_grad():
            fwd = detector_apply(params, cfg.detector,
                                 prep_images(batch["images"], True),
                                 attn_impl="flash", mesh=mesh)
        out["forward"] = {k: fwd[k] for k in ("pred_logits", "pred_boxes")}
        out["forward_calls"] = dict(calls)

        state = create_train_state(params, cfg.optim, cfg.detector)
        calls.update(dict.fromkeys(PLAIN, 0))
        losses, grads = train_grads(cfg, state, batch, attn_impl="flash",
                                    mesh=mesh)
        out["grad_calls"] = dict(calls)
        out["losses"] = losses
        out["grad_norm"] = global_norm(grads, mesh)
        out["grads"] = gather_params(grads, mesh)

        state, metrics = make_train_step(cfg, mesh)(state, batch)
        out["metrics"] = metrics
        out["stepped"] = gather_params(_detached(state.params), mesh)

        drop_cfg = dataclasses.replace(cfg, detector=dataclasses.replace(
            cfg.detector, decoder=dataclasses.replace(cfg.detector.decoder,
                                                      dropout=0.1)))
        gen = torch.Generator().manual_seed(inp["dropout_seed"])
        out["dropout_losses"], _ = train_grads(
            drop_cfg, create_train_state(
                params_from_numpy(inp["tree"], device="cpu", mesh=mesh),
                cfg.optim, cfg.detector),
            batch, gen, mesh=mesh)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, t = (int(a) for a in sys.argv[1:4])
    run(r, w, t, *sys.argv[4:7])
