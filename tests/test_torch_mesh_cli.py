"""The port's training CLI on a mesh of processes, one process a rank, on
the CPU: DP 2 x TP 2 (`--model_parallel 2 --batch_size 2` on a world of
4, joined through `--coordinator_address/--num_processes/--process_id`,
gloo), at test_torch_train_loop.py's tiny fp32 config (3 ViT blocks of
width 128, a 2-layer deformable decoder of width 64, dropout 0, 6 GT
slots: the exact matcher) on 8 synthetic images at 56 px, two epochs with
validation and a checkpoint each, from one numpy param tree.

- Against the JAX package's `run_training` with `model_parallel=2` at
  batch 2, which on the suite's 8 CPU devices builds the same 2 x 2 mesh
  (`auto_mesh`): per-step losses within LOSS_TOL, the last validation's AP
  within AP_TOL and the same number of detections.
- Against the port's own one-process CLI run on the same flags: losses,
  metrics and detections within 1e-5 relative.
- The run wrote one set of files, rank 0's; the other ranks log to the
  console only.
- Its checkpoint serves from one process (`Predictor.from_checkpoint`).

The ranks are processes of tests/torch_mesh_cli_worker.py (the CLI with
the tiny config; no JAX). DP x CP, the legacy ring and `--only_evaluate
--quantize int8` under TP are tests/test_torch_mesh_cli_cp.py; the
sharded device cache and a preempted mesh run
tests/test_torch_mesh_cli_resume.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.data.coco import CocoDetectionDataset as JaxCoco
from dinov2_od_tpu.models.detector import init_detector_params as jax_init
from dinov2_od_tpu.train.loop import run_training as jax_run_training

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.synthetic import write_coco_dataset
from dinov2_od_tpu_torch.inference import Predictor
from dinov2_od_tpu_torch.params import params_from_numpy
from dinov2_od_tpu_torch.train.checkpoint import save_final_params

from torch_mesh_cli_worker import (BACKBONE, DECODER, SPEC, cli_args,
                                   detections, epoch_losses, mesh_ranks,
                                   read_json, tiny_cli)

MAX_BOXES = SPEC["max_boxes"]
# test_torch_train_loop.py's tolerances: per-step loss against JAX,
# relative (the frameworks sum in other orders); validation AP, absolute.
LOSS_TOL = 1e-5
AP_TOL = 0.01
# The mesh run against one process: the same fp32 math, its sums split
# over the model group and the data group (measured within 2e-7).
ONE_PROCESS_TOL = 1e-5
EPOCHS = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the ranks and the in-process runs share the
    suite's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    jdet = jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**BACKBONE),
                               decoder=jcfg.DecoderConfig(**DECODER))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  jax_init(jax.random.key(0), jdet))
    rng = np.random.default_rng(0)
    for lin in tree["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = rng.normal(0, 0.05, lin["lora_B"].shape).astype(
                np.float32)
    return jdet, tree


class ScalarLog:
    """A SummaryWriter stand-in that records add_scalar calls."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, {})[step] = float(value)

    def add_images(self, *a, **k):
        pass

    def close(self):
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli")
    data = write_coco_dataset(str(tmp / "data"), num_images=8,
                              image_size=56, seed=7, max_objects=2)
    jdet, tree = _tree()
    init = save_final_params(str(tmp), params_from_numpy(tree, device="cpu"),
                             name="init")
    spec = SPEC
    spec_file = tmp / "spec.json"
    spec_file.write_text(json.dumps(spec))
    out = {k: str(tmp / k) for k in ("tp", "one", "jax")}
    tp = mesh_ranks(tmp, "tp", spec_file, cli_args(
        data, init, out["tp"], "--model_parallel", "2"))

    # JAX's loop on the 2 x 2 mesh while the ranks run.
    jc = jcfg.TrainConfig(
        detector=jdet,
        data=jcfg.DataConfig(batch_size=2, max_boxes=MAX_BOXES,
                             num_workers=2),
        optim=jcfg.OptimConfig(learning_rate=2e-3),
        mesh=jcfg.MeshConfig(model_parallel_size=2))
    jds = JaxCoco(data[0], data[1], 56, max_boxes=MAX_BOXES)
    log = ScalarLog()
    jax_run_training(jc, jax.tree_util.tree_map(jnp.asarray, tree), jds,
                     jds, out["jax"], writer=log, num_epochs=EPOCHS,
                     val_frequency=1, log_frequency=1, checkpoint_every=100,
                     model_parallel=2)

    with tiny_cli(spec) as cli:
        assert cli.main(cli_args(data, init, out["one"])) == 0
    return {"out": out, "jax_losses": log.scalars["train/loss"],
            "tp_logs": tp.wait(), "data": data, "spec": spec}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_dp_tp_losses_match_jax(runs):
    got = epoch_losses(runs["out"]["tp"])
    want = [runs["jax_losses"][s] for s in sorted(runs["jax_losses"])]
    assert len(got) == len(want) == 4 * EPOCHS
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) < LOSS_TOL, errs


def test_dp_tp_validation_matches_jax(runs):
    last = f"epoch_{EPOCHS - 1}.json"
    got = read_json(runs["out"]["tp"], "metrics_" + last)
    want = read_json(runs["out"]["jax"], "metrics_" + last)
    assert abs(got["AP"] - want["AP"]) < AP_TOL
    assert len(read_json(runs["out"]["tp"], "predictions_" + last)) == len(
        read_json(runs["out"]["jax"], "predictions_" + last))


def test_dp_tp_matches_one_process(runs):
    tp, one = runs["out"]["tp"], runs["out"]["one"]
    errs = [_rel(g, w) for g, w in zip(epoch_losses(tp), epoch_losses(one))]
    assert len(errs) == 4 * EPOCHS and max(errs) < ONE_PROCESS_TOL, errs
    for e in range(EPOCHS):
        got, want = (read_json(o, f"metrics_epoch_{e}.json")
                     for o in (tp, one))
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= ONE_PROCESS_TOL, k
        got, want = (detections(o, f"predictions_epoch_{e}.json")
                     for o in (tp, one))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[:2] == w[:2]
            assert np.allclose(g[2:], w[2:], rtol=ONE_PROCESS_TOL,
                               atol=ONE_PROCESS_TOL)


def test_only_rank_0_wrote_files(runs):
    """The run's files are one process's: the records, the predictions and
    metrics, a checkpoint each epoch and the final model, one log file;
    the other ranks log to the console, each line marked with its rank."""
    names = sorted(os.listdir(runs["out"]["tp"]))
    logs = [n for n in names if n.endswith("_train.log")]
    assert len(logs) == 1
    plots = {"loss_plot.png", "ap_plot.png"} & set(names)
    want = {f"{kind}_epoch_{e}.json" for e in range(EPOCHS)
            for kind in ("train", "metrics", "predictions")}
    want |= {f"checkpoint_epoch_{e}" for e in range(EPOCHS)}
    assert set(names) == want | {"final_model"} | set(logs) | plots
    for r, log in enumerate(runs["tp_logs"]):
        assert (f"mesh: data 2 x context 1 x model 2 (rank at {r // 2}, 0, "
                f"{r % 2}), backend gloo") in log
        if r:
            assert f"[rank {r}]" in log and "console only" in log


def test_tp_checkpoint_serves_from_one_process(runs):
    """`Predictor.from_checkpoint` loads the TP run's final model in one
    process and gives, on the validation images, the detections that the
    mesh's last validation gave."""
    spec = runs["spec"]
    det = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**spec["backbone"]),
                              decoder=pcfg.DecoderConfig(**spec["decoder"]))
    final = os.path.join(runs["out"]["tp"], "final_model")
    predictor = Predictor.from_checkpoint(final, detector_cfg=det,
                                          device="cpu")
    images_dir, ann = runs["data"]
    with open(ann) as f:
        files = {im["id"]: im["file_name"] for im in json.load(f)["images"]}
    ids = sorted(files)
    got = predictor.detect([os.path.join(images_dir, files[i]) for i in ids],
                           score_threshold=0.05)
    want = read_json(runs["out"]["tp"],
                     f"predictions_epoch_{EPOCHS - 1}.json")
    assert sum(map(len, got)) == len(want) > 0
    for i, dets in zip(ids, got):
        scores = sorted(d["score"] for d in want if d["image_id"] == i)
        assert np.allclose(sorted(d["score"] for d in dets), scores,
                           atol=1e-5)
