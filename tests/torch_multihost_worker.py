"""One rank of tests/test_torch_multihost.py.

Started on the CPU, one process a rank, with the launcher's environment
that `torchrun` sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
LOCAL_RANK), and joined through `initialize_multihost(auto=True)`:

    python tests/torch_multihost_worker.py INPUTS OUT_DIR

It imports torch, numpy and the port only (no JAX). The test process
hands the inputs over as a pickle and reads each rank's results back from
`OUT_DIR/rank{r}.pt`. What a rank runs:
- `auto_mesh` at each of the inputs' layouts: its place in the mesh;
- on the 2 x 2 mesh (data 2, model 2) and on data 2 x context 2: the
  training set uploaded in both cache layouts and each global index of
  the inputs gathered both ways (`sharded_batch_gather`,
  `replicated_batch_gather`);
- on the 2 x 2 mesh: its shards of the inputs' params, Adam moments and
  EMA (logical trees of CPU tensors) saved with `save_checkpoint(mesh=)`
  (rank 0 writes), then the file restored onto zero templates and cut
  into shards again (`shard_params`, `shard_train_trees`).
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path

import torch

from dinov2_od_tpu_torch import config as C
from dinov2_od_tpu_torch.parallel import initialize_multihost
from dinov2_od_tpu_torch.parallel.sharding import auto_mesh, shard_params
from dinov2_od_tpu_torch.train import checkpoint as ckpt
from dinov2_od_tpu_torch.train import device_cache as dc
from dinov2_od_tpu_torch.train.state import AdamState


class ArrayDataset:
    """A dataset over in-memory arrays (what the cache uploads)."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays["images"])

    def get_example(self, i):
        return {k: v[i] for k, v in self.arrays.items()}

    def get_batch(self, idx):
        return {k: v[idx] for k, v in self.arrays.items()}


def main(inputs: str, out_dir: str) -> None:
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    initialize_multihost(auto=True, device="cpu")
    rank = torch.distributed.get_rank()
    out = {"places": {}, "gathers": {}}
    for name, (batch, mp, cp, legacy) in inp["layouts"].items():
        cfg = C.MeshConfig(model_parallel_size=mp, context_parallel_size=cp,
                           context_parallel=legacy)
        mesh = auto_mesh(batch, mp, cfg)
        out["places"][name] = (mesh.data_size, mesh.context_size,
                               mesh.model_size, mesh.data_index,
                               mesh.context_index, mesh.model_index)

    data = ArrayDataset(inp["arrays"])
    for name in ("dp2 x tp2", "dp2 x cp2"):
        batch, mp, cp, legacy = inp["layouts"][name]
        mesh = auto_mesh(batch, mp, C.MeshConfig(
            model_parallel_size=mp, context_parallel_size=cp))
        sharded = dc.upload_train_cache(data, "cpu", "sharded", mesh)
        replicated = dc.upload_train_cache(data, "cpu", "replicated", mesh)
        out["gathers"][name] = {
            "rows": len(sharded["images"]),
            "sharded": [dc.sharded_batch_gather(sharded, torch.as_tensor(i),
                                                mesh)
                        for i in inp["indices"]],
            "replicated": [dc.replicated_batch_gather(
                replicated, torch.as_tensor(i), mesh)
                for i in inp["indices"]]}

    mesh = auto_mesh(4, 2, C.MeshConfig(model_parallel_size=2))
    trees = inp["trees"]
    params, mu, nu, ema = (shard_params(trees[k], mesh)
                           for k in ("params", "mu", "nu", "ema"))
    opt = AdamState(count=3, mu=mu, nu=nu)
    path = ckpt.save_checkpoint(inp["ckpt_dir"], 0, params, opt, 1.5,
                                {"epochs": [0]}, step=7, ema=ema, mesh=mesh)
    zeros = inp["zeros"]
    restored = ckpt.restore_checkpoint(
        path, trees["params"], AdamState(count=0, mu=zeros["mu"],
                                         nu=zeros["nu"]), zeros["ema"])
    opt2, ema2 = ckpt.shard_train_trees(restored.opt_state, restored.ema,
                                        mesh)
    out["shards"] = {"params": params, "mu": mu, "nu": nu, "ema": ema}
    out["restored"] = {"params": shard_params(restored.params, mesh),
                       "mu": opt2.mu, "nu": opt2.nu, "ema": ema2,
                       "count": opt2.count, "step": restored.step}
    out["place"] = (mesh.data_index, mesh.model_index)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
