"""The port's training CLI under pipeline parallelism, one process a rank,
on the CPU (gloo; tests/torch_mesh_cli_worker.py's ranks and flags: 8
synthetic images at 56 px, two epochs with validation and a checkpoint
each), at a tiny fp32 config of 4 ViT blocks (width 128, 2 heads, LoRA
on the last 2; a 2-layer deformable decoder of width 64, dropout 0, 6 GT
slots), from one numpy param tree:

- (a) legacy GPipe, `--model_parallel 2 --pipeline_parallel
  --pipeline_microbatches 1` at global batch 2: data 2 x stage 2, as
  JAX's `run_training` lays out the same flags on the suite's 8 CPU
  devices (`auto_mesh`: a data axis of 2);
- (b) interleaved PP x TP, `--pipeline_parallel_size 2 --model_parallel 2
  --pipeline_chunks 2 --pipeline_microbatches 2` at global batch 4:
  stage 2 x model 2 (JAX's `auto_mesh` adds a data axis of 2 on its 8
  devices; the math is the same).

Each against JAX's `run_training` on its flags (per-step loss within
LOSS_TOL, the last validation's AP within AP_TOL) and the port's one
process (losses, metrics and detections within ONE_PROCESS_TOL). Then,
from (a)'s files: only rank 0 wrote; its final model serves from one
process (`Predictor.from_checkpoint`) with the detections of its last
validation; `--only_evaluate --quantize int8` under (a)'s mesh gives one
process's int8 evaluation (B6's path on the stages: the model axis holds
no shards); and a run resumed from its first checkpoint ends on its
final params bit for bit.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

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

from torch_mesh_cli_worker import (cli_args, detections, epoch_losses,
                                   eval_args, final_params, mesh_ranks,
                                   read_json, tiny_cli)

BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=4, lora_r=2,
                lora_last_n_blocks=2, target_dim=64)
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=6, dropout=0.0)
SPEC = {"backbone": BACKBONE, "decoder": DECODER, "max_boxes": 6}
# name: (the CLI's mesh flags, global batch, JAX's MeshConfig fields)
MESHES = {
    "legacy": (["--model_parallel", "2", "--pipeline_parallel",
                "--pipeline_microbatches", "1"], 2,
               dict(model_parallel_size=2, pipeline_parallel=True,
                    pipeline_microbatches=1)),
    "pp_tp": (["--pipeline_parallel_size", "2", "--model_parallel", "2",
               "--pipeline_chunks", "2", "--pipeline_microbatches", "2"], 4,
              dict(model_parallel_size=2, pipeline_parallel_size=2,
                   pipeline_chunks=2, pipeline_microbatches=2)),
}
# tests/test_torch_mesh_cli.py's tolerances.
LOSS_TOL = 1e-5
AP_TOL = 0.01
ONE_PROCESS_TOL = 1e-5
EPOCHS = 2
INT8 = ["--quantize", "int8"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the ranks and the in-process runs share the
    suite's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    """JAX's init with lora_B nonzero in the adapted blocks' rows (the
    rest zero, as training keeps them)."""
    jdet = jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**BACKBONE),
                               decoder=jcfg.DecoderConfig(**DECODER))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  jax_init(jax.random.key(0), jdet))
    rng = np.random.default_rng(0)
    first = BACKBONE["depth_override"] - BACKBONE["lora_last_n_blocks"]
    for lin in tree["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            b = rng.normal(0, 0.05, lin["lora_B"].shape).astype(np.float32)
            b[:first] = 0.0
            lin["lora_B"] = b
    return jdet, tree


class _Scalars:
    """A SummaryWriter stand-in that records add_scalar calls."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, {})[step] = float(value)

    def add_images(self, *a, **k):
        pass

    def close(self):
        pass


def _jax_losses(jdet, tree, data, out, batch, mesh):
    jc = jcfg.TrainConfig(
        detector=jdet,
        data=jcfg.DataConfig(batch_size=batch, max_boxes=SPEC["max_boxes"],
                             num_workers=2),
        optim=jcfg.OptimConfig(learning_rate=2e-3),
        mesh=jcfg.MeshConfig(**mesh), save_on_preemption=False)
    jds = JaxCoco(data[0], data[1], 56, max_boxes=SPEC["max_boxes"])
    log = _Scalars()
    jax_run_training(jc, jax.tree_util.tree_map(jnp.asarray, tree), jds, jds,
                     out, writer=log, num_epochs=EPOCHS, val_frequency=1,
                     log_frequency=1, checkpoint_every=100,
                     model_parallel=mesh["model_parallel_size"])
    scalars = log.scalars["train/loss"]
    return [scalars[s] for s in sorted(scalars)]


def _batch(args, batch):
    i = args.index("--batch_size")
    return args[:i + 1] + [str(batch)] + args[i + 2:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli_pp")
    data = write_coco_dataset(str(tmp / "data"), num_images=8,
                              image_size=56, seed=7, max_objects=2)
    jdet, tree = _tree()
    init = save_final_params(str(tmp), params_from_numpy(tree, device="cpu"),
                             name="init")
    spec_file = tmp / "spec.json"
    spec_file.write_text(json.dumps(SPEC))
    out = {k: str(tmp / k) for k in (
        *MESHES, *(f"{m} one" for m in MESHES), *(f"{m} jax" for m in MESHES),
        "resumed", "int8", "int8 one")}
    args = {m: _batch(cli_args(data, init, out[m]), b)
            for m, (_, b, _) in MESHES.items()}
    worlds = {m: mesh_ranks(tmp, m, spec_file, args[m] + flags)
              for m, (flags, _, _) in MESHES.items()}
    with ThreadPoolExecutor(len(MESHES)) as pool:
        jax_runs = {m: pool.submit(_jax_losses, jdet, tree, data,
                                   out[f"{m} jax"], b, mesh)
                    for m, (_, b, mesh) in MESHES.items()}
        with tiny_cli(SPEC) as cli:
            for m, (_, b, _) in MESHES.items():
                assert cli.main(_batch(cli_args(data, init, out[f"{m} one"]),
                                       b)) == 0
        jax_losses = {m: f.result() for m, f in jax_runs.items()}
    logs = {m: w.wait() for m, w in worlds.items()}

    # From (a)'s files: a resume from its first checkpoint and the int8
    # evaluation of its final model under the same mesh.
    legacy = MESHES["legacy"][0]
    final = os.path.join(out["legacy"], "final_model")
    later = {
        "resumed": mesh_ranks(tmp, "resumed", spec_file, cli_args(
            data, os.path.join(out["legacy"], "checkpoint_epoch_0"),
            out["resumed"], *legacy)),
        "int8": mesh_ranks(tmp, "int8", spec_file, eval_args(
            data, final, out["int8"], *INT8, *legacy))}
    with tiny_cli(SPEC) as cli:
        assert cli.main(eval_args(data, final, out["int8 one"], *INT8)) == 0
    logs.update({k: w.wait() for k, w in later.items()})
    return {"out": out, "logs": logs, "jax_losses": jax_losses,
            "data": data}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pp_losses_and_validation_match_jax(runs, mesh):
    got = epoch_losses(runs["out"][mesh])
    want = runs["jax_losses"][mesh]
    steps = 8 // MESHES[mesh][1]
    assert len(got) == len(want) == steps * EPOCHS
    errs = [_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) < LOSS_TOL, errs
    last = f"epoch_{EPOCHS - 1}.json"
    mine = read_json(runs["out"][mesh], "metrics_" + last)
    theirs = read_json(runs["out"][f"{mesh} jax"], "metrics_" + last)
    assert abs(mine["AP"] - theirs["AP"]) < AP_TOL
    assert len(read_json(runs["out"][mesh], "predictions_" + last)) == len(
        read_json(runs["out"][f"{mesh} jax"], "predictions_" + last))


def _same_validation(got_dir, want_dir, epoch):
    got, want = (read_json(o, f"metrics_epoch_{epoch}.json")
                 for o in (got_dir, want_dir))
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= ONE_PROCESS_TOL, k
    got, want = (detections(o, f"predictions_epoch_{epoch}.json")
                 for o in (got_dir, want_dir))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        assert np.allclose(g[2:], w[2:], rtol=ONE_PROCESS_TOL,
                           atol=ONE_PROCESS_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pp_matches_one_process(runs, mesh):
    pp, one = runs["out"][mesh], runs["out"][f"{mesh} one"]
    errs = [_rel(g, w) for g, w in zip(epoch_losses(pp), epoch_losses(one))]
    assert len(errs) == 8 // MESHES[mesh][1] * EPOCHS
    assert max(errs) < ONE_PROCESS_TOL, errs
    for e in range(EPOCHS):
        _same_validation(pp, one, e)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pp_only_rank_0_wrote_files(runs, mesh):
    """One set of files, rank 0's; each rank logged its place on the
    mesh: (data, stage, model) = (r // 2, r % 2, 0) on (a), (0, r // 2,
    r % 2) on (b)."""
    names = sorted(os.listdir(runs["out"][mesh]))
    logs = [n for n in names if n.endswith("_train.log")]
    assert len(logs) == 1
    plots = {"loss_plot.png", "ap_plot.png"} & set(names)
    want = {f"{kind}_epoch_{e}.json" for e in range(EPOCHS)
            for kind in ("train", "metrics", "predictions")}
    want |= {f"checkpoint_epoch_{e}" for e in range(EPOCHS)}
    assert set(names) == want | {"final_model"} | set(logs) | plots
    for r, log in enumerate(runs["logs"][mesh]):
        place = ((r // 2, r % 2, 0) if mesh == "legacy"
                 else (0, r // 2, r % 2))
        shape = "data 2 x stage 2 x model 1" if mesh == "legacy" else \
            "data 1 x stage 2 x model 2"
        assert (f"mesh: {shape} (rank at {place[0]}, {place[1]}, "
                f"{place[2]}), backend gloo") in log
        if r:
            assert f"[rank {r}]" in log and "console only" in log


def test_pp_checkpoint_serves_from_one_process(runs):
    """`Predictor.from_checkpoint` loads (a)'s final model in one process
    and gives, on the validation images, the detections its last
    validation gave."""
    det = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**BACKBONE),
                              decoder=pcfg.DecoderConfig(**DECODER))
    final = os.path.join(runs["out"]["legacy"], "final_model")
    predictor = Predictor.from_checkpoint(final, detector_cfg=det,
                                          device="cpu")
    images_dir, ann = runs["data"]
    with open(ann) as f:
        files = {im["id"]: im["file_name"] for im in json.load(f)["images"]}
    ids = sorted(files)
    got = predictor.detect([os.path.join(images_dir, files[i]) for i in ids],
                           score_threshold=0.05)
    want = read_json(runs["out"]["legacy"],
                     f"predictions_epoch_{EPOCHS - 1}.json")
    assert sum(map(len, got)) == len(want) > 0
    for i, dets in zip(ids, got):
        scores = sorted(d["score"] for d in want if d["image_id"] == i)
        assert np.allclose(sorted(d["score"] for d in dets), scores,
                           atol=1e-5)


def test_only_evaluate_int8_under_pp_matches_one_process(runs):
    """`--only_evaluate --quantize int8` under (a)'s stages: the int8
    model (LoRA folded, W8A8, B6's path) pipelined gives one process's
    int8 evaluation; rank 0 alone writes it."""
    _same_validation(runs["out"]["int8"], runs["out"]["int8 one"], 0)
    for log in runs["logs"]["int8"]:
        assert "int8-quantized backbone" in log
    names = {n for n in os.listdir(runs["out"]["int8"])
             if not n.endswith("_train.log")}
    assert names == {"metrics_epoch_0.json", "predictions_epoch_0.json"}


def test_pp_resume_ends_on_the_uninterrupted_params(runs):
    """(a) resumed from its epoch-0 checkpoint under the same mesh runs
    epoch 1 again: the same losses, and the final params bit for bit."""
    resumed, whole = runs["out"]["resumed"], runs["out"]["legacy"]
    assert (read_json(resumed, "train_epoch_1.json")["losses"]
            == read_json(whole, "train_epoch_1.json")["losses"])
    got, want = final_params(resumed), final_params(whole)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
