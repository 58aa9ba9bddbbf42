"""The port's training set on the card and K steps a dispatch
(dinov2_od_tpu_torch/train/device_cache.py, the cache branch of
train/loop.py and the CLI's --device_cache) on the CPU:

- `epoch_index_groups` against the JAX package's arrays, resume skips
  included;
- a multi-step dispatch against the same steps one at a time (bit for
  bit, with dropout and augmentation drawn from (seed, step));
- `evaluate_cached` against `evaluate_dataset` (the same detections;
  the predictions file streamed from flat arrays reads back as the
  dicts' file);
- the cache's bytes, the memory check and the layouts;
- the CLI with --device_cache, augmentation and accumulation: the same
  params to the bit as the host loader's run, a mid-epoch preemption
  resumed exactly, cached validation's AP equal to the loader's, and
  `sharded` refused.
"""

import json
import logging
import os
import signal

import numpy as np
import pytest
import torch

from dinov2_od_tpu.train import device_cache as jdc

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.coco import CocoDetectionDataset
from dinov2_od_tpu_torch.data.synthetic import (NUM_SYNTHETIC_CLASSES,
                                                make_batch,
                                                write_coco_dataset)
from dinov2_od_tpu_torch.models.detector import init_detector_params
from dinov2_od_tpu_torch.train import cli
from dinov2_od_tpu_torch.train import device_cache as dc
from dinov2_od_tpu_torch.train.checkpoint import latest_checkpoint
from dinov2_od_tpu_torch.train.loop import evaluate_dataset
from dinov2_od_tpu_torch.train.state import create_train_state
from dinov2_od_tpu_torch.train.step import (make_eval_topk_step,
                                            make_train_step, step_seed)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: many small eager ops, run beside the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg(**train):
    det = pcfg.DetectorConfig(
        backbone=pcfg.BackboneConfig(variant="small", image_size=56,
                                     hidden_dim_override=128,
                                     num_heads_override=2, depth_override=3,
                                     lora_r=1, target_dim=32),
        decoder=pcfg.DecoderConfig(hidden_dim=32, num_queries=8,
                                   num_layers=2, num_heads=4,
                                   dim_feedforward=64,
                                   num_classes=NUM_SYNTHETIC_CLASSES,
                                   dropout=0.1))
    return pcfg.TrainConfig(detector=det, data=pcfg.DataConfig(batch_size=4),
                            optim=pcfg.OptimConfig(learning_rate=3e-4),
                            **train)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("dc")
    images_dir, ann = write_coco_dataset(str(root), num_images=10, seed=2,
                                         image_size=56)
    return CocoDetectionDataset(images_dir, ann, image_size=56, max_boxes=6,
                                output_dtype="uint8")


@pytest.mark.parametrize("n,b,k,epoch,skip", [
    (37, 4, 3, 2, 0), (37, 4, 3, 2, 2), (64, 8, 16, 0, 0), (64, 8, 16, 5, 7),
    (5000, 16, 16, 59, 300), (10, 4, 1, 1, 1)])
def test_epoch_index_groups_match_jax(n, b, k, epoch, skip):
    got = dc.epoch_index_groups(n, b, k, seed=42, epoch=epoch, skip=skip)
    want = jdc.epoch_index_groups(n, b, k, seed=42, epoch=epoch, skip=skip)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.array_equal(g, w)


def _cache(n=12, seed=0):
    raw = make_batch(np.random.default_rng(seed), n, image_size=56,
                     max_boxes=6)
    raw["images"] = (np.clip(raw["images"], 0, 1) * 255).astype(np.uint8)
    return {k: torch.from_numpy(v) for k, v in raw.items()}


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
def test_multi_step_equals_single_steps(augment):
    """Three steps in one dispatch against three single steps, each
    single step's generator seeded by (seed, step) as the loop seeds it:
    the same losses and params to the bit (dropout 0.1; with augmentation
    flip, zoom and colour drawn from the same generator)."""
    aug = (pcfg.AugmentConfig(hflip_prob=0.5, scale_jitter=0.2,
                              color_jitter=0.2) if augment
           else pcfg.AugmentConfig())
    cfg = _tiny_cfg(augment=aug)
    cache = _cache()
    idxs = np.array([[3, 1, 4, 0], [5, 9, 2, 6], [11, 8, 7, 10]])
    runs = []
    for multi in (True, False):
        params = init_detector_params(torch.Generator().manual_seed(0),
                                      cfg.detector, device="cpu")
        state = create_train_state(params, cfg.optim, cfg.detector)
        state.step = 7  # a resumed run's step count
        step = make_train_step(cfg)
        gen = torch.Generator()
        if multi:
            state, metrics = dc.make_multi_train_step(cfg, step)(
                state, cache, torch.from_numpy(idxs), gen)
            losses = metrics["loss"]
        else:
            losses = []
            for row in idxs:
                gen.manual_seed(step_seed(cfg.seed, state.step))
                state, m = step(state, {k: v[torch.from_numpy(row)]
                                        for k, v in cache.items()}, gen)
                losses.append(m["loss"])
            losses = torch.stack(losses)
        runs.append((losses, state))
    (la, sa), (lb, sb) = runs
    assert la.shape == (3,) and torch.equal(la, lb)
    assert sa.step == sb.step == 10
    pa = [p for p in sa.params["decoder"]["class_embed"].values()]
    pb = [p for p in sb.params["decoder"]["class_embed"].values()]
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert torch.equal(sa.params["backbone"]["blocks"]["q"]["lora_A"],
                       sb.params["backbone"]["blocks"]["q"]["lora_A"])


@pytest.mark.parametrize("batch_size", [4, 5], ids=["padded", "exact"])
def test_evaluate_cached_equals_evaluate_dataset(synth, batch_size,
                                                 tmp_path):
    """The cached evaluation (10 images: two full batches of 4 and a
    padded one, or two of 5) gives evaluate_dataset's detections, and its
    streamed predictions file parses to the dicts' file."""
    cfg = _tiny_cfg()
    params = init_detector_params(torch.Generator().manual_seed(0),
                                  cfg.detector, device="cpu")
    want_file = str(tmp_path / "want.json")
    want = evaluate_dataset(make_eval_topk_step(cfg), params, synth,
                            batch_size, synth.label_to_cat_id,
                            output_file=want_file, score_threshold=0.0)
    cache, ids, n = dc.upload_eval_cache(synth, batch_size, "cpu")
    assert n == 10 and cache["images"].shape[:2] == (-(-10 // batch_size),
                                                    batch_size)
    eval_all = dc.make_cached_eval(cfg)
    got = dc.evaluate_cached(eval_all, params, cache, ids, n,
                             synth.label_to_cat_id, score_threshold=0.0)
    assert got == want and len(got) == 10 * 8 * NUM_SYNTHETIC_CLASSES
    got_file = str(tmp_path / "got.json")
    arrays = dc.evaluate_cached(eval_all, params, cache, ids, n,
                                synth.label_to_cat_id, score_threshold=0.0,
                                output_file=got_file, return_arrays=True)
    assert len(arrays[0]) == len(want)
    with open(got_file) as f, open(want_file) as g:
        assert json.load(f) == json.load(g)


def test_train_cache_bytes_layouts_and_memory_check(synth, monkeypatch):
    cache = dc.upload_train_cache(synth, "cpu")
    assert set(cache) == set(dc.TRAIN_KEYS)
    assert cache["images"].shape == (10, 56, 56, 3)
    assert cache["images"].dtype == torch.uint8
    assert dc.cache_nbytes(synth) == sum(
        t.numel() * t.element_size() for t in cache.values())
    ex = synth.get_example(3)
    for k in dc.TRAIN_KEYS:
        assert np.array_equal(cache[k][3].numpy(), ex[k]), k
    assert dc.resolve_layout("auto") == dc.resolve_layout(
        "replicated") == "replicated"
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        dc.upload_train_cache(synth, "cpu", "sharded")
    with pytest.raises(ValueError):
        dc.resolve_layout("striped")
    # A card with less free memory than the cache: a clear error, no
    # quiet fallback to the host loader.
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1000, 80 * 10 ** 9))
    with pytest.raises(MemoryError, match="--device_cache"):
        dc.check_fits(dc.cache_nbytes(synth), "cuda", "training-set cache")
    dc.check_fits(999, "cuda", "training-set cache")


class _SignalOnLog(logging.Handler):
    """SIGTERM when the loop logs `needle`, as an eviction would arrive."""

    def __init__(self, needle):
        super().__init__()
        self.needle, self.fired = needle, False

    def emit(self, record):
        if not self.fired and self.needle in record.getMessage():
            self.fired = True
            signal.raise_signal(signal.SIGTERM)


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_dc")
    return write_coco_dataset(str(root), num_images=32, image_size=56,
                              seed=1, max_objects=3)


def _args(data, out, *extra):
    images_dir, ann = data
    return ["--train_images", images_dir, "--train_annotations", ann,
            "--val_images", images_dir, "--val_annotations", ann,
            "--lightweight", "--image_size", "56", "--batch_size", "4",
            "--num_epochs", "2", "--output_dir", out, "--device", "cpu",
            "--checkpoint_frequency", "100", "--val_frequency", "2",
            "--log_frequency", "1", "--hflip_prob", "0.5",
            "--scale_jitter", "0.1", *extra]


def _final(out):
    state = torch.load(os.path.join(out, "final_model", "state.pt"),
                       weights_only=True)

    def leaves(t):
        return ([x for v in t.values() for x in leaves(v)]
                if isinstance(t, dict) else [t])

    return leaves(state["params"])


def _json(out, name):
    with open(os.path.join(out, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("accumulate", [2, 3])
def test_cli_device_cache_trains_and_resumes_exactly(cli_data, tmp_path,
                                                     accumulate):
    """Two epochs of 8 steps from the cache, 2 steps a dispatch, with
    augmentation and accumulation: the host loader's run to the bit (same
    order, same draws), its AP; then a run preempted after its first
    dispatch is read (4 steps: between two mini-steps at k=3) and resumed
    from the preemption checkpoint, ending on the same params."""
    cache = ["--device_cache", "--steps_per_dispatch", "2",
             "--gradient_accumulation_steps", str(accumulate)]
    out_c, out_l, out_p = (str(tmp_path / n) for n in ("cache", "loader",
                                                       "preempted"))
    assert cli.main(_args(cli_data, out_c, *cache)) == 0
    assert cli.main(_args(cli_data, out_l, *cache[3:])) == 0
    for a, b in zip(_final(out_c), _final(out_l)):
        assert torch.equal(a, b)
    for name in ("train_epoch_0.json", "train_epoch_1.json"):
        c, l_ = _json(out_c, name), _json(out_l, name)
        assert c["steps"] == l_["steps"] and c["losses"] == l_["losses"]
    assert _json(out_c, "metrics_epoch_1.json") == _json(
        out_l, "metrics_epoch_1.json")
    preds = _json(out_c, "predictions_epoch_1.json")
    assert preds == _json(out_l, "predictions_epoch_1.json") and preds

    trigger = _SignalOnLog("epoch 1 batch 1/")
    logging.getLogger().addHandler(trigger)
    try:
        assert cli.main(_args(cli_data, out_p, *cache)) == 0
    finally:
        logging.getLogger().removeHandler(trigger)
    assert trigger.fired
    ckpt = latest_checkpoint(out_p)
    assert ckpt.endswith("checkpoint_epoch_0")
    assert _json(ckpt, "metrics_history.json")["_preempt_batch_index"] == 4
    assert not os.path.isdir(os.path.join(out_p, "final_model"))
    assert cli.main(_args(cli_data, out_p, *cache,
                          "--checkpoint", ckpt)) == 0
    for a, b in zip(_final(out_c), _final(out_p)):
        assert torch.equal(a, b)
    resumed = _json(out_p, "train_epoch_1.json")
    assert resumed["steps"] == list(range(12, 16))
    assert resumed["losses"] == _json(out_c, "train_epoch_1.json")[
        "losses"][4:]


def test_cli_refuses_the_sharded_layout(cli_data, tmp_path):
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        cli.main(_args(cli_data, str(tmp_path), "--device_cache",
                       "--device_cache_layout", "sharded"))


def test_pack_dataset_tool_writes_what_the_loader_reads(synth, tmp_path):
    """tools/pack_dataset.py: the packed set reads back as the decoded
    COCO set, example by example."""
    from dinov2_od_tpu_torch.data.packed import PackedDataset
    from dinov2_od_tpu_torch.tools import pack_dataset

    out = str(tmp_path / "packed")
    assert pack_dataset.main(["--images", synth.images_dir,
                              "--annotations", synth.coco_path, "--out", out,
                              "--image_size", "56", "--max_boxes", "6",
                              "--num_workers", "2"]) == 0
    packed = PackedDataset(out)
    assert len(packed) == len(synth) == 10
    for i in (0, 9):
        a, b = packed.get_example(i), synth.get_example(i)
        for k in ("images", "boxes", "labels", "valid", "image_id"):
            assert np.array_equal(a[k], b[k]), k
