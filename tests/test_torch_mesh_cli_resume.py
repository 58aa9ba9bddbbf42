"""The port's training CLI from the device cache under DP 2 x CP 2, and a
preempted mesh run resumed, as worlds of 4 processes on the CPU (gloo;
tests/torch_mesh_cli_worker.py's tiny fp32 config and flags: 8 synthetic
images at 56 px, global batch 2, two epochs with validation and a
checkpoint each, `--device_cache --steps_per_dispatch 1`):

- `--device_cache_layout sharded` (each data rank holds 4 of the 8 rows)
  trains to the replicated layout's params bit for bit, with the same
  losses and detections, and within ONE_PROCESS_TOL of one process's
  cached run;
- SIGTERM to rank 1 alone, as the loop logs epoch 1's second step: every
  rank agrees on the flag at the next check and checkpoints at the same
  step (epoch 1, batch 3), none writes a final model, and the run resumed
  from that checkpoint ends on the uninterrupted run's params bit for
  bit, repeating its last step's loss.
"""

import json
import os
import re

import pytest
import torch

from dinov2_od_tpu_torch.data.synthetic import write_coco_dataset

from torch_mesh_cli_worker import (SPEC, cli_args, detections, epoch_losses,
                                   final_params, init_checkpoint,
                                   mesh_ranks, read_json, tiny_cli)

ONE_PROCESS_TOL = 1e-5
CACHED = ["--device_cache", "--steps_per_dispatch", "1"]
DP_CP = ["--context_parallel_size", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the ranks and the in-process run share the
    suite's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli_resume")
    data = write_coco_dataset(str(tmp / "data"), num_images=8,
                              image_size=56, seed=7, max_objects=2)
    init = init_checkpoint(str(tmp))
    spec_file = tmp / "spec.json"
    spec_file.write_text(json.dumps(SPEC))
    out = {k: str(tmp / k) for k in ("sharded", "replicated", "preempted",
                                     "one")}

    def world(name, *flags, env=None, checkpoint=init):
        return mesh_ranks(tmp, name, spec_file,
                          cli_args(data, checkpoint, out[name], *CACHED,
                                   *DP_CP, *flags), env=env)

    worlds = {
        "sharded": world("sharded", "--device_cache_layout", "sharded"),
        "replicated": world("replicated", "--device_cache_layout",
                            "replicated"),
        "preempted": world("preempted", env=lambda r: (
            {"MESH_CLI_SIGTERM_AT": "epoch 1 batch 1/"} if r == 1 else {}))}
    with tiny_cli(SPEC) as cli:
        assert cli.main(cli_args(data, init, out["one"], *CACHED)) == 0
    logs = {name: w.wait() for name, w in worlds.items()}
    resume = os.path.join(out["preempted"], "checkpoint_epoch_0")
    preempt_files = sorted(os.listdir(out["preempted"]))
    logs["resumed"] = world("preempted", checkpoint=resume).wait()
    return {"out": out, "logs": logs, "preempt_files": preempt_files,
            "resume": resume}


def test_sharded_cache_trains_as_the_replicated_one(runs):
    sharded, replicated = runs["out"]["sharded"], runs["out"]["replicated"]
    assert epoch_losses(sharded) == epoch_losses(replicated)
    a, b = final_params(sharded), final_params(replicated)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert detections(sharded, "predictions_epoch_1.json") == detections(
        replicated, "predictions_epoch_1.json")
    for r, log in enumerate(runs["logs"]["sharded"]):
        assert "(sharded, 4 of 8 rows)" in log, r
    for r, log in enumerate(runs["logs"]["replicated"]):
        assert "(replicated, 8 of 8 rows)" in log, r


def test_sharded_cache_run_matches_one_process(runs):
    got = epoch_losses(runs["out"]["sharded"])
    want = epoch_losses(runs["out"]["one"])
    assert len(got) == len(want) == 8
    assert all(abs(g - w) <= ONE_PROCESS_TOL * abs(w)
               for g, w in zip(got, want)), (got, want)
    got, want = (read_json(runs["out"][k], "metrics_epoch_1.json")
                 for k in ("sharded", "one"))
    assert all(abs(got[k] - want[k]) <= ONE_PROCESS_TOL for k in want)


def test_sigterm_to_one_rank_stops_every_rank_at_one_step(runs):
    logs = runs["logs"]["preempted"]
    assert "received signal" in logs[1]
    assert all("received signal" not in logs[r] for r in (0, 2, 3))
    saved = [re.findall(r"preemption checkpoint saved: .*continue epoch "
                        r"(\d+) at batch (\d+)", log) for log in logs]
    assert saved == [[("1", "3")]] * 4
    assert "final_model" not in runs["preempt_files"]
    history = read_json(runs["resume"], "metrics_history.json")
    assert history["_preempt_batch_index"] == 3


def test_resumed_mesh_run_repeats_the_uninterrupted_one(runs):
    a, b = final_params(runs["out"]["preempted"]), final_params(
        runs["out"]["sharded"])
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    resumed = read_json(runs["out"]["preempted"], "train_epoch_1.json")
    whole = read_json(runs["out"]["sharded"], "train_epoch_1.json")
    assert resumed["steps"] == [7]
    assert resumed["losses"] == whole["losses"][3:]
    for r, log in enumerate(runs["logs"]["resumed"]):
        assert "at epoch 1 batch 3" in log, r
