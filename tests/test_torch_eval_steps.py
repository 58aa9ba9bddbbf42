"""The port's eval steps and `postprocess_detections`
(dinov2_od_tpu_torch/train/step.py, evaluation/postprocess.py) against the
JAX package's on the same params (carried across with
`params_from_numpy`) and batch, on the CPU at a tiny size (3 ViT blocks
of width 128, 2 heads of 64; a 2-layer deformable decoder of width 64),
fp32.

Also the overfit gate of tests/test_end_to_end_learning.py on the port,
with its threshold.

Tolerances, relative to max(1, the reference's magnitude): outputs and
loss terms 1e-4 (the frameworks' GEMMs and reductions sum in other orders
through 3 blocks and the decoder). Top-k is compared as score sets (ties
may order differently): the sorted scores within 1e-5, the boxes of
matching (score, label) pairs within 1e-3 pixels of a 56 px image.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.evaluation.postprocess import (
    postprocess_detections as jax_postprocess,
)
from dinov2_od_tpu.models.detector import init_detector_params as jax_init
from dinov2_od_tpu.train import step as jstep

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.coco import CocoDetectionDataset
from dinov2_od_tpu_torch.data.loader import DataLoader
from dinov2_od_tpu_torch.data.synthetic import (
    NUM_SYNTHETIC_CLASSES,
    make_batch,
    write_coco_dataset,
)
from dinov2_od_tpu_torch.evaluation.coco_metrics import compute_coco_metrics
from dinov2_od_tpu_torch.evaluation.postprocess import postprocess_detections
from dinov2_od_tpu_torch.models.detector import init_detector_params
from dinov2_od_tpu_torch.params import params_from_numpy
from dinov2_od_tpu_torch.train import step as pstep
from dinov2_od_tpu_torch.train.state import create_train_state

BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=3, lora_r=2,
                lora_last_n_blocks=2, target_dim=64)
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=NUM_SYNTHETIC_CLASSES)
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small eager ops, and
    under the suite's parallel workers torch's default of a thread a
    core oversubscribes the machine (a test ~30x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**data):
    d = dict(batch_size=4, max_boxes=6, **data)
    jdet = jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**BACKBONE),
                               decoder=jcfg.DecoderConfig(**DECODER))
    pdet = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**BACKBONE),
                               decoder=pcfg.DecoderConfig(**DECODER))
    return (jcfg.TrainConfig(detector=jdet, data=jcfg.DataConfig(**d)),
            pcfg.TrainConfig(detector=pdet, data=pcfg.DataConfig(**d)))


@pytest.fixture(scope="module")
def setup():
    jc, pc = _cfgs()
    tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  jax_init(jax.random.key(0), jc.detector))
    batch = make_batch(np.random.default_rng(0), 4, image_size=56,
                       max_boxes=6)
    # Raw uint8 feed: both steps normalise on the device.
    batch["images"] = (batch["images"] * 255).astype(np.uint8)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jc, pc, tree, jparams, batch


def _rel(ref, out):
    ref = np.asarray(ref, np.float32)
    out = out.detach().float().numpy() if torch.is_tensor(out) else out
    return float(np.abs(ref - out).max() / max(1.0, np.abs(ref).max()))


def test_eval_step_matches_jax(setup):
    jc, pc, tree, jparams, batch = setup
    ref = jstep.make_eval_step(jc)(jparams, jnp.asarray(batch["images"]))
    out = pstep.make_eval_step(pc)(params_from_numpy(tree, device="cpu"),
                                   torch.from_numpy(batch["images"]))
    for k in ("pred_logits", "pred_boxes"):
        assert _rel(ref[k], out[k]) <= TOL, k
    assert not out["pred_logits"].requires_grad


def _topk_sets(topk):
    """Per image: sorted scores and {(label, rounded score): box}."""
    return [(np.sort(t[:, 0]),
             {(int(r[1]), round(float(r[0]), 5)): r[2:] for r in t})
            for t in np.asarray(topk, np.float32)]


@pytest.mark.parametrize("parity_mode", [False, True])
def test_eval_topk_step_matches_jax(setup, parity_mode):
    jc, pc, tree, jparams, batch = setup
    sizes = np.array([[56, 56], [480, 640], [100, 50], [56, 56]], np.int32)
    ref = jstep.make_eval_topk_step(jc, max_detections=20,
                                    parity_mode=parity_mode)(
        jparams, jnp.asarray(batch["images"]), jnp.asarray(sizes))["topk"]
    out = pstep.make_eval_topk_step(pc, max_detections=20,
                                    parity_mode=parity_mode)(
        params_from_numpy(tree, device="cpu"),
        torch.from_numpy(batch["images"]), torch.from_numpy(sizes))["topk"]
    assert out.shape == (4, 20, 6) and out.dtype == torch.float32
    for (rs, rmap), (os_, omap) in zip(_topk_sets(ref),
                                       _topk_sets(out.numpy())):
        np.testing.assert_allclose(os_, rs, atol=1e-5)
        common = rmap.keys() & omap.keys()
        assert len(common) >= len(rmap) - 2  # a tie may cross the cut
        for key in common:
            np.testing.assert_allclose(omap[key], rmap[key], atol=1e-3)


def test_loss_eval_step_matches_jax(setup):
    jc, pc, tree, jparams, batch = setup
    ref = jstep.make_loss_eval_step(jc)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    out = pstep.make_loss_eval_step(pc)(
        params_from_numpy(tree, device="cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(ref) == set(out)
    for k in ref:
        assert _rel(ref[k], out[k]) <= TOL, (k, ref[k], out[k])


def test_postprocess_detections_matches_jax(setup):
    """One-shot post-processing of raw outputs: the same COCO dicts, up to
    the order of tied scores."""
    jc, pc, tree, jparams, batch = setup
    out = jstep.make_eval_step(jc)(jparams, jnp.asarray(batch["images"]))
    logits = np.array(out["pred_logits"])
    boxes = np.array(out["pred_boxes"])
    ids = np.array([5, 6, 7, 9])
    sizes = np.array([[56, 56], [480, 640], [100, 50], [56, 56]], np.int32)
    lut = {i: 10 * (i + 1) for i in range(NUM_SYNTHETIC_CLASSES)}
    for parity in (False, True):
        kw = dict(score_threshold=0.3, max_detections=10, parity_mode=parity)
        ref = jax_postprocess(logits, boxes, ids, sizes, lut, **kw)
        got = postprocess_detections(torch.from_numpy(logits), boxes, ids,
                                     sizes, lut, **kw)
        key = lambda d: (d["image_id"], -round(d["score"], 5),
                         d["category_id"])
        ref, got = sorted(ref, key=key), sorted(got, key=key)
        assert len(ref) == len(got) > 0
        for r, g in zip(ref, got):
            assert (r["image_id"], r["category_id"]) == (g["image_id"],
                                                         g["category_id"])
            assert abs(r["score"] - g["score"]) <= 1e-6
            np.testing.assert_allclose(g["bbox"], r["bbox"], atol=1e-3)


def test_overfit_reaches_nontrivial_ap(tmp_path):
    """tests/test_end_to_end_learning.py on the port: 8 synthetic images
    through files, dataset, loader, 401 train steps, the device top-k and
    COCOeval; AP50 above 0.3, the JAX test's gate."""
    images_dir, ann_file = write_coco_dataset(str(tmp_path), num_images=8,
                                              image_size=56, seed=7,
                                              max_objects=2)
    ds = CocoDetectionDataset(images_dir, ann_file, image_size=56,
                              max_boxes=6)
    det = pcfg.DetectorConfig(
        backbone=pcfg.BackboneConfig(
            variant="small", image_size=56, patch_size=14, lora_r=2,
            target_dim=48, hidden_dim_override=96, depth_override=3,
            num_heads_override=4, mlp_ratio_override=2.0),
        decoder=pcfg.DecoderConfig(
            hidden_dim=48, num_queries=8, num_layers=2, num_heads=4,
            dim_feedforward=96, num_classes=ds.num_classes,
            use_deformable=True, dropout=0.0),
    )
    cfg = pcfg.TrainConfig(detector=det,
                           optim=pcfg.OptimConfig(learning_rate=2e-3))
    params = init_detector_params(torch.Generator().manual_seed(0), det,
                                  device="cpu")
    state = create_train_state(params, cfg.optim, det)
    step = pstep.make_train_step(cfg)
    batch_np = next(iter(DataLoader(ds, batch_size=8, shuffle=False)))
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()
             if k in ("images", "boxes", "labels", "valid")}
    state, first = step(state, batch)
    for _ in range(399):
        state, _ = step(state, batch)
    state, last = step(state, batch)
    assert float(last["loss"]) < 0.3 * float(first["loss"])
    out = pstep.make_eval_step(cfg)(state.params, batch["images"])
    results = postprocess_detections(
        out["pred_logits"], out["pred_boxes"], batch_np["image_id"],
        batch_np["orig_size"], ds.label_to_cat_id)
    assert results, "no detections above threshold after overfitting"
    metrics = compute_coco_metrics(results, ann_file)
    assert metrics["AP50"] > 0.3, metrics
