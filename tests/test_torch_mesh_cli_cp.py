"""The port's training CLI under context parallelism, and its
`--only_evaluate --quantize int8` under tensor parallelism, each as a
world of 4 processes on the CPU (gloo), held against the port's
one-process CLI run on the same flags (tests/torch_mesh_cli_worker.py's
tiny fp32 config and flags: 8 synthetic images at 56 px, global batch 2,
two epochs with validation and a checkpoint each):

- DP 2 x CP 2 (`--context_parallel_size 2`: the backbone's 17 tokens
  padded to 18 and split over a ring of 2, ring attention);
- the legacy ring over the model axis (`--context_parallel
  --model_parallel 2`: DP 2 x ring 2, the params replicated on it);
- `--only_evaluate --quantize int8 --model_parallel 2` (DP 2 x TP 2)
  against one process's unfused int8 path: the fused quantize + GEMM is
  off under TP, as in the JAX CLI.

Each: per-step losses, metrics and detections within ONE_PROCESS_TOL
(relative); the runs wrote only rank 0's files.
"""

import json
import os

import numpy as np
import pytest
import torch

from dinov2_od_tpu_torch.data.synthetic import write_coco_dataset
from dinov2_od_tpu_torch.ops import int8_gemm

from torch_mesh_cli_worker import (SPEC, cli_args, detections, epoch_losses,
                                   eval_args, mesh_ranks, read_json,
                                   init_checkpoint, tiny_cli)

# The same fp32 math with its sums split over the ring, the model group
# and the data group (the ranks' runs read within 2e-7 of one process).
ONE_PROCESS_TOL = 1e-5
MESHES = {"dp2 x cp2": ["--context_parallel_size", "2"],
          "legacy ring": ["--context_parallel", "--model_parallel", "2"]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the ranks and the in-process runs share the
    suite's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli_cp")
    data = write_coco_dataset(str(tmp / "data"), num_images=8,
                              image_size=56, seed=7, max_objects=2)
    init = init_checkpoint(str(tmp))
    spec_file = tmp / "spec.json"
    spec_file.write_text(json.dumps(SPEC))
    out = {k: str(tmp / k.replace(" ", "_"))
           for k in (*MESHES, "one", "tp int8", "one int8")}
    worlds = {name: mesh_ranks(tmp, name.replace(" ", "_"), spec_file,
                               cli_args(data, init, out[name], *flags))
              for name, flags in MESHES.items()}
    worlds["tp int8"] = mesh_ranks(
        tmp, "tp_int8", spec_file,
        eval_args(data, init, out["tp int8"], "--quantize", "int8",
                  "--model_parallel", "2"))
    with tiny_cli(SPEC) as cli:
        assert cli.main(cli_args(data, init, out["one"])) == 0
        int8_gemm.set_fused_enabled(False)
        try:
            assert cli.main(eval_args(data, init, out["one int8"],
                                      "--quantize", "int8")) == 0
        finally:
            int8_gemm.set_fused_enabled(True)
    logs = {name: world.wait() for name, world in worlds.items()}
    return {"out": out, "logs": logs}


def _close(got, want):
    return abs(got - want) <= ONE_PROCESS_TOL * max(abs(want), 1.0)


def _same_validation(mesh_out, one_out, epoch):
    got = read_json(mesh_out, f"metrics_epoch_{epoch}.json")
    want = read_json(one_out, f"metrics_epoch_{epoch}.json")
    assert got.keys() == want.keys()
    assert all(_close(got[k], want[k]) for k in want), (got, want)
    got, want = (detections(o, f"predictions_epoch_{epoch}.json")
                 for o in (mesh_out, one_out))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        assert np.allclose(g[2:], w[2:], rtol=ONE_PROCESS_TOL,
                           atol=ONE_PROCESS_TOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_context_parallel_run_matches_one_process(runs, name):
    mesh_out, one_out = runs["out"][name], runs["out"]["one"]
    got, want = epoch_losses(mesh_out), epoch_losses(one_out)
    assert len(got) == len(want) == 8
    assert all(_close(g, w) for g, w in zip(got, want)), (got, want)
    for epoch in (0, 1):
        _same_validation(mesh_out, one_out, epoch)
    for r, log in enumerate(runs["logs"][name]):
        assert (f"mesh: data 2 x context 2 x model 1 (rank at {r // 2}, "
                f"{r % 2}, 0), backend gloo") in log


@pytest.mark.parametrize("name", list(MESHES))
def test_context_parallel_run_wrote_one_set_of_files(runs, name):
    def files(out):
        names = os.listdir(out)
        logs = [n for n in names if n.endswith("_train.log")]
        return set(names) - set(logs), len(logs)

    assert files(runs["out"][name]) == files(runs["out"]["one"])


def test_only_evaluate_int8_under_tp_matches_one_process(runs):
    _same_validation(runs["out"]["tp int8"], runs["out"]["one int8"], 0)
    for r, log in enumerate(runs["logs"]["tp int8"]):
        assert "int8-quantized backbone" in log
    names = {n for n in os.listdir(runs["out"]["tp int8"])
             if not n.endswith("_train.log")}
    assert names == {"metrics_epoch_0.json", "predictions_epoch_0.json"}
