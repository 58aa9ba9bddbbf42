"""The port's training loop (dinov2_od_tpu_torch/train/loop.py) on the CPU.

- `run_training` against the JAX package's on one synthetic PNG dataset
  (8 images at 56 px, batch 4, 4 epochs, validation each epoch), tiny
  config (3 ViT blocks of width 128, 2-layer deformable decoder of width
  64), fp32, dropout 0, 6 GT slots (the exact matcher in both). Per-step
  losses, read from both loops' scalar logs, within LOSS_TOL; the last
  validation's AP within AP_TOL and the same number of detections.
- A run preempted mid-epoch and resumed repeats the uninterrupted run bit
  for bit (dropout on: its masks are a function of (seed, step)).

The CLI and `serve.main` are tests/test_torch_train_cli.py.
"""

import json
import logging
import os
import signal

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.data.coco import CocoDetectionDataset as JaxCoco
from dinov2_od_tpu.models.detector import init_detector_params as jax_init
from dinov2_od_tpu.train.loop import run_training as jax_run_training

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.coco import CocoDetectionDataset
from dinov2_od_tpu_torch.data.synthetic import write_coco_dataset
from dinov2_od_tpu_torch.params import params_from_numpy
from dinov2_od_tpu_torch.train import cli
from dinov2_od_tpu_torch.train.checkpoint import latest_checkpoint
from dinov2_od_tpu_torch.train.loop import run_training

BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=3, lora_r=2,
                lora_last_n_blocks=2, target_dim=64)
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=6, dropout=0.0)
# Per-step loss against JAX, relative to the reference: the frameworks
# sum in other orders (1e-5 for one step in test_torch_train_step.py);
# over these 8 steps the two loops stayed within 1e-6 of each other.
LOSS_TOL = 1e-5
# Val AP (COCO AP in [0, 1]): scores that agree to ~1e-6 give the same
# ranking unless two detections tie that closely, which would move AP of
# 8 images by a fraction of one detection's share.
AP_TOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small eager ops, and
    under the suite's parallel workers torch's default of a thread a
    core oversubscribes the machine (a test ~30x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    return write_coco_dataset(str(root), num_images=8, image_size=56, seed=7,
                              max_objects=2)


def _cfgs():
    jdet = jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**BACKBONE),
                               decoder=jcfg.DecoderConfig(**DECODER))
    pdet = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**BACKBONE),
                               decoder=pcfg.DecoderConfig(**DECODER))
    data = dict(batch_size=4, max_boxes=6, num_workers=2)
    optim = dict(learning_rate=2e-3)
    return (jcfg.TrainConfig(detector=jdet, data=jcfg.DataConfig(**data),
                             optim=jcfg.OptimConfig(**optim)),
            pcfg.TrainConfig(detector=pdet, data=pcfg.DataConfig(**data),
                             optim=pcfg.OptimConfig(**optim)))


def _tree(jc):
    tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  jax_init(jax.random.key(0), jc.detector))
    rng = np.random.default_rng(0)
    for lin in tree["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = rng.normal(0, 0.05, lin["lora_B"].shape).astype(
                np.float32)
    return tree


def _run(run, cfg, params, ds, out):
    log = ScalarLog()
    run(cfg, params, ds, ds, out, writer=log, num_epochs=4, val_frequency=1,
        log_frequency=1, checkpoint_every=100)
    with open(os.path.join(out, "metrics_epoch_3.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(out, "predictions_epoch_3.json")) as f:
        metrics["detections"] = len(json.load(f))
    return log.scalars["train/loss"], metrics


@pytest.fixture(scope="module")
def loop_runs(synth, tmp_path_factory):
    images_dir, ann = synth
    jc, pc = _cfgs()
    tree = _tree(jc)
    kw = dict(image_size=56, max_boxes=6, output_dtype="uint8",
              decode_backend="pil")
    jax_out = str(tmp_path_factory.mktemp("jax_loop"))
    ref = _run(jax_run_training, jc,
               jax.tree_util.tree_map(jnp.asarray, tree),
               JaxCoco(images_dir, ann, **kw), jax_out)
    port_out = str(tmp_path_factory.mktemp("port_loop"))
    got = _run(run_training, pc, params_from_numpy(tree, device="cpu"),
               CocoDetectionDataset(images_dir, ann, **kw), port_out)
    return ref, got, port_out


def test_run_training_matches_jax(loop_runs):
    (ref_losses, ref_metrics), (losses, metrics), out = loop_runs
    assert sorted(losses) == sorted(ref_losses) == list(range(1, 9))
    for step, want in ref_losses.items():
        assert abs(losses[step] - want) <= LOSS_TOL * abs(want), (
            step, losses[step], want)
    for k in ("AP", "AP50", "AP75"):
        assert abs(metrics[k] - ref_metrics[k]) <= AP_TOL, (k, metrics,
                                                            ref_metrics)
    assert metrics["AP50"] > 0  # trained enough that AP says something
    assert metrics["detections"] == ref_metrics["detections"]
    with open(os.path.join(out, "train_epoch_1.json")) as f:
        epoch = json.load(f)
    assert epoch["steps"] == [2, 3] and epoch["nonfinite_skips"] == 0
    np.testing.assert_allclose(epoch["losses"], [losses[3], losses[4]],
                               rtol=1e-6)
    assert epoch["images_per_sec"] > 0
    for name in ("final_model", "checkpoint_epoch_3",
                 "predictions_epoch_0.json", "metrics_epoch_0.json"):
        assert os.path.exists(os.path.join(out, name)), name


class _SignalOnSecondBatchLog(logging.Handler):
    """SIGTERM while the loop logs its first step, as a cluster's eviction
    would arrive."""

    def __init__(self):
        super().__init__()
        self.fired = False

    def emit(self, record):
        if not self.fired and "batch 0/" in record.getMessage():
            self.fired = True
            signal.raise_signal(signal.SIGTERM)


def _lightweight_args(images_dir, ann, out, *extra):
    return ["--train_images", images_dir, "--train_annotations", ann,
            "--lightweight", "--image_size", "56", "--batch_size", "4",
            "--num_epochs", "2", "--output_dir", out, "--device", "cpu",
            "--checkpoint_frequency", "100", "--val_frequency", "100",
            "--log_frequency", "1", *extra]


def _final(out):
    state = torch.load(os.path.join(out, "final_model", "state.pt"),
                       weights_only=True)
    return state["params"]


def _leaves(t):
    return ([x for v in t.values() for x in _leaves(v)]
            if isinstance(t, dict) else [t])


def test_preempted_resume_is_bit_identical(tmp_path):
    images_dir, ann = write_coco_dataset(str(tmp_path / "d"), num_images=16,
                                         image_size=56, seed=1)
    out_a, out_b = str(tmp_path / "a"), str(tmp_path / "b")
    assert cli.main(_lightweight_args(images_dir, ann, out_a)) == 0

    trigger = _SignalOnSecondBatchLog()
    logging.getLogger().addHandler(trigger)
    try:
        assert cli.main(_lightweight_args(images_dir, ann, out_b)) == 0
    finally:
        logging.getLogger().removeHandler(trigger)
    assert trigger.fired
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    ckpt = latest_checkpoint(out_b)
    assert ckpt.endswith("checkpoint_epoch_0")
    assert not os.path.isdir(os.path.join(out_b, "final_model"))
    with open(os.path.join(ckpt, "metrics_history.json")) as f:
        assert json.load(f)["_preempt_batch_index"] == 2  # 4 batches/epoch
    assert cli.main(_lightweight_args(images_dir, ann, out_b, "--checkpoint",
                                      ckpt)) == 0
    la, lb = _leaves(_final(out_a)), _leaves(_final(out_b))
    assert len(la) == len(lb) > 50
    for a, b in zip(la, lb):
        assert torch.equal(a, b)
    with open(os.path.join(out_a, "train_epoch_0.json")) as f:
        full = json.load(f)["losses"]
    with open(os.path.join(out_b, "train_epoch_0.json")) as f:
        resumed = json.load(f)
    assert resumed["steps"] == [2, 3] and resumed["losses"] == full[2:]
