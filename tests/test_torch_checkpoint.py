"""The port's checkpoints (dinov2_od_tpu_torch/train/checkpoint.py) and
`Predictor.from_checkpoint`, on the CPU: exact round trips, the JAX
package's restore semantics (merge counts, optimizer fallback, latest
checkpoint), and a JAX param tree served from a port checkpoint with the
JAX Predictor's detections (fp32: scores within 1e-5, pixel boxes within
1e-3, as tests/test_torch_inference.py holds the Predictor).
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.inference import Predictor as JaxPredictor
from dinov2_od_tpu.models import init_detector_params as jax_init
from dinov2_od_tpu.train.checkpoint import merge_compatible as jax_merge

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.inference import Predictor
from dinov2_od_tpu_torch.models.detector import (
    cast_frozen_weights,
    init_detector_params,
)
from dinov2_od_tpu_torch.params import params_from_numpy
from dinov2_od_tpu_torch.train import checkpoint as ckpt
from dinov2_od_tpu_torch.train.state import (
    create_train_state,
    tree_leaves,
    tree_map,
)

BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=2, lora_r=2,
                lora_last_n_blocks=1, target_dim=32)
DECODER = dict(hidden_dim=32, num_queries=5, num_layers=1, num_heads=4,
               dim_feedforward=64, num_classes=6)


def _cfgs(**decoder):
    dk = {**DECODER, **decoder}
    return (jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**BACKBONE),
                                decoder=jcfg.DecoderConfig(**dk)),
            pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**BACKBONE),
                                decoder=pcfg.DecoderConfig(**dk)))


def _state(seed=0, ema_decay=0.0, **decoder):
    _, pc = _cfgs(**decoder)
    params = cast_frozen_weights(
        init_detector_params(torch.Generator().manual_seed(seed), pc,
                             device="cpu"), pc)
    state = create_train_state(params, pcfg.OptimConfig(ema_decay=ema_decay),
                               pc)
    # Non-trivial moments and EMA, as after some steps.
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for t in (tree_leaves(state.opt_state.mu)
                  + tree_leaves(state.opt_state.nu)
                  + tree_leaves(state.ema or {})):
            t.copy_(torch.rand(t.shape, generator=gen).to(t.dtype))
    state.opt_state = state.opt_state._replace(count=7)
    state.step = 7
    return pc, state


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_is_bit_exact(tmp_path, async_save):
    pc, state = _state(ema_decay=0.99)
    hist = {"epochs": [0, 1, 2], "train_loss": [2.5, 1.5, 1.25],
            "val_AP": [0.125]}
    path = ckpt.save_checkpoint(str(tmp_path), 3, state.params,
                                state.opt_state, 1.25, hist,
                                async_save=async_save, step=state.step,
                                ema=state.ema)
    assert path.endswith("checkpoint_epoch_3")
    _, fresh = _state(seed=5, ema_decay=0.99)
    r = ckpt.restore_checkpoint(path, fresh.params, fresh.opt_state,
                                fresh.ema)
    assert (r.start_epoch, r.step, r.metrics_history) == (4, 7, hist)
    _assert_trees_equal(r.params, state.params)
    assert r.opt_state.count == 7
    _assert_trees_equal(r.opt_state.mu, state.opt_state.mu)
    _assert_trees_equal(r.opt_state.nu, state.opt_state.nu)
    _assert_trees_equal(r.ema, state.ema)
    # Frozen leaves keep their stored bf16 dtype; None stays at their
    # moments.
    assert r.params["backbone"]["cls_token"].dtype == torch.bfloat16
    assert r.opt_state.mu["backbone"]["cls_token"] is None
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_epoch_3"]
    assert sorted(os.listdir(path)) == [ckpt.HISTORY_FILE, ckpt.STATE_FILE]


def test_save_replaces_in_place_and_latest(tmp_path):
    _, state = _state()
    for epoch in (9, 19, 19, 4):
        ckpt.save_checkpoint(str(tmp_path), epoch, state.params,
                             state.opt_state, 1.0, async_save=True)
    ckpt.wait_for_saves()
    final = ckpt.save_final_params(str(tmp_path), state.params)
    os.makedirs(tmp_path / "checkpoint_epoch_x")
    assert sorted(os.listdir(tmp_path)) == [
        "checkpoint_epoch_19", "checkpoint_epoch_4", "checkpoint_epoch_9",
        "checkpoint_epoch_x", "final_model"]
    latest = ckpt.latest_checkpoint(str(tmp_path))
    assert latest.endswith("checkpoint_epoch_19")
    assert ckpt.restore_checkpoint(latest, state.params).start_epoch == 20
    assert ckpt.latest_checkpoint(str(tmp_path / "absent")) is None
    r = ckpt.restore_checkpoint(final, state.params, state.opt_state)
    _assert_trees_equal(r.params, state.params)
    assert r.opt_state is state.opt_state  # a bare-params save
    assert (r.start_epoch, r.metrics_history) == (0, {})


def test_merge_compatible_counts_equal_to_jax():
    t = {"a": np.zeros((2, 2), np.float32), "b": np.zeros((3,), np.float32),
         "c": {"d": np.zeros((4, 1), np.float32),
               "e": np.zeros((5,), np.float32)}}
    r = {"a": np.ones((2, 2), np.float32), "b": np.ones((4,), np.float32),
         "c": {"d": np.ones((4, 1), np.float32)}, "z": np.ones(2, np.float32)}
    j_merged, j_loaded, j_skipped = jax_merge(
        jax.tree_util.tree_map(jnp.asarray, t),
        jax.tree_util.tree_map(jnp.asarray, r))
    to_t = lambda tree: tree_map(torch.from_numpy, tree)
    merged, loaded, skipped = ckpt.merge_compatible(to_t(t), to_t(r))
    assert (loaded, skipped) == (j_loaded, j_skipped) == (2, 2)
    for path in ("a", "b", "c/d", "c/e"):
        keys = path.split("/")
        want = j_merged
        got = merged
        for k in keys:
            want, got = want[k], got[k]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shape_change_restores_what_fits_and_a_fresh_optimizer(tmp_path):
    """A 5-query checkpoint into an 8-query model: same-shape leaves load,
    query_embed keeps its init, and the optimizer starts fresh (reference
    train.py:711-739, :1013-1025)."""
    _, s5 = _state(seed=0)
    path = ckpt.save_checkpoint(str(tmp_path), 0, s5.params, s5.opt_state,
                                1.0, step=3)
    _, s8 = _state(seed=1, num_queries=8)
    init_query = s8.params["decoder"]["query_embed"].clone()
    r = ckpt.restore_checkpoint(path, s8.params, s8.opt_state)
    assert torch.equal(r.params["backbone"]["cls_token"],
                       s5.params["backbone"]["cls_token"])
    assert torch.equal(r.params["decoder"]["query_embed"], init_query)
    assert r.opt_state is s8.opt_state
    assert r.ema is None and r.step == 3


@pytest.fixture(scope="module")
def jax_tree():
    jc, _ = _cfgs()
    tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  jax_init(jax.random.key(0), jc))
    rng = np.random.default_rng(3)
    for lin in tree["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = rng.normal(0, 0.1, lin["lora_B"].shape).astype(
                np.float32)
    return tree


def test_jax_tree_saved_and_served_from_checkpoint(tmp_path, jax_tree):
    jc, pc = _cfgs()
    path = ckpt.save_final_params(str(tmp_path),
                                  params_from_numpy(jax_tree, device="cpu"))
    labels = {i: 10 + i for i in range(6)}
    pred = Predictor.from_checkpoint(path, detector_cfg=pc, device="cpu",
                                     label_to_cat_id=labels, batch_size=2)
    rng = np.random.default_rng(4)
    images = [rng.uniform(size=(56, 56, 3)).astype(np.float32)
              for _ in range(3)]
    ref = JaxPredictor(jax.tree_util.tree_map(jnp.asarray, jax_tree), jc,
                       label_to_cat_id=labels, batch_size=2).detect(
        images, score_threshold=0.0, max_detections=8)
    out = pred.detect(images, score_threshold=0.0, max_detections=8)
    assert len(out) == len(ref) == 3
    for got, want in zip(out, ref):
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g["category_id"] == w["category_id"]
            assert abs(g["score"] - w["score"]) <= 1e-5
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-3)
    with pytest.raises(RuntimeError, match="CUDA"):
        import unittest.mock as mock

        with mock.patch.object(torch.cuda, "is_available", lambda: False):
            Predictor.from_checkpoint(path, detector_cfg=pc)
    # A config whose decoder differs keeps the template there.
    other = dataclasses.replace(pc, decoder=dataclasses.replace(
        pc.decoder, num_queries=7))
    assert Predictor.from_checkpoint(path, detector_cfg=other,
                                     device="cpu").cfg is other
