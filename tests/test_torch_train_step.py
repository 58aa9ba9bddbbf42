"""The port's train step (dinov2_od_tpu_torch/train/) against the JAX
package's `make_train_step` and optax chain, on the CPU at a tiny size
(3 ViT blocks of width 128 with 2 heads of 64, the last 2 LoRA-adapted;
a 2-layer deformable decoder of width 64), fp32, decoder dropout 0.

The JAX init is carried across with `params_from_numpy` after setting
every lora_B to small nonzero values, so every LoRA leaf has a gradient.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.data.synthetic import make_batch as jax_make_batch
from dinov2_od_tpu.models.detector import (
    detector_apply as jax_detector_apply,
    init_detector_params as jax_init,
    lora_block_multiplier as jax_lora_mult,
    trainable_mask as jax_trainable_mask,
)
from dinov2_od_tpu.ops.losses import set_criterion as jax_set_criterion
from dinov2_od_tpu.train import state as jstate
from dinov2_od_tpu.train.step import (
    make_train_step as jax_make_train_step,
    prep_images as jax_prep_images,
)

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.synthetic import NUM_SYNTHETIC_CLASSES, make_batch
from dinov2_od_tpu_torch.models import layers as players
from dinov2_od_tpu_torch.models.detector import (
    lora_block_multiplier,
    trainable_mask,
)
from dinov2_od_tpu_torch.ops.attention import multi_head_attention
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy
from dinov2_od_tpu_torch.train import state as pstate
from dinov2_od_tpu_torch.train.step import (
    make_train_step,
    prep_images,
    train_loss,
)

BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=3, lora_r=2,
                lora_last_n_blocks=2, target_dim=64)
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=NUM_SYNTHETIC_CLASSES,
               dropout=0.0)
LR = 3e-4
# fp32 against JAX, each relative to max(1, the reference's magnitude):
# losses and grad_norm 1e-5 (the two frameworks' GEMMs and reductions
# sum in other orders through 3 blocks and the decoder); gradients 1e-4
# of each leaf's largest gradient; updated params 2e-7 absolute where
# the gradient is clearly above noise: over 1e-2 of its leaf's largest
# and over 1e-6 (a first Adam step moves each such element by about
# lr * sign(g), so only the rounding of p + u differs; an element near 0,
# such as every one of the self-attention key bias, whose gradient is 0
# up to rounding, moves by +-lr on either side).
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 2e-7
GRAD_FLOOR = 1e-2
GRAD_ABS_FLOOR = 1e-6


def _cfgs(decoder=None, optim=None, **train):
    dk = {**DECODER, **(decoder or {})}
    ok = {"learning_rate": LR, **(optim or {})}
    jdet = jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**BACKBONE),
                               decoder=jcfg.DecoderConfig(**dk))
    pdet = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**BACKBONE),
                               decoder=pcfg.DecoderConfig(**dk))
    data = dict(batch_size=4, max_boxes=6)
    return (jcfg.TrainConfig(detector=jdet, data=jcfg.DataConfig(**data),
                             optim=jcfg.OptimConfig(**ok), **train),
            pcfg.TrainConfig(detector=pdet, data=pcfg.DataConfig(**data),
                             optim=pcfg.OptimConfig(**ok), **train))


@pytest.fixture(scope="module")
def tree():
    jc, _ = _cfgs()
    t = jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        jax_init(jax.random.key(0), jc.detector))
    rng = np.random.default_rng(0)
    for lin in t["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = rng.normal(0, 0.05, lin["lora_B"].shape).astype(
                np.float32)
    return t


@pytest.fixture(scope="module")
def batch_np():
    return make_batch(np.random.default_rng(0), 4, image_size=56,
                      max_boxes=6)


def _port_state(tree, pc):
    params = params_from_numpy(tree, device="cpu")
    return pstate.create_train_state(params, pc.optim, pc.detector)


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _jax_tree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        elif v is not None:
            out[prefix + k] = v
    return out


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(ref, out):
    ref, out = _np(ref), _np(out)
    return float(np.abs(ref - out).max() / max(1.0, np.abs(ref).max()))


def _jax_loss_fn(jc, batch, rng):
    """The JAX train step's loss (dinov2_od_tpu/train/step.py:178-229)."""
    det = jc.detector
    images = jax_prep_images(batch["images"], jc.data.normalize)

    def loss_fn(params):
        params = jstate.stop_gradient_frozen(params, det)
        out = jax_detector_apply(params, det, images, rng=rng,
                                 deterministic=False)
        kw = dict(matcher_cfg=jc.matcher, loss_cfg=jc.loss,
                  num_classes=det.decoder.num_classes)
        gt = (batch["labels"], batch["boxes"], batch["valid"])
        losses, match = jax_set_criterion(out["pred_logits"],
                                          out["pred_boxes"], *gt,
                                          return_match=True, **kw)
        total = losses["loss"]
        for i, aux in enumerate(out.get("aux_outputs", [])):
            aux_l = jax_set_criterion(
                aux["pred_logits"], aux["pred_boxes"], *gt,
                match=match if jc.share_aux_match else None, **kw)
            total = total + aux_l["loss"]
            losses[f"loss_aux_{i}"] = aux_l["loss"]
        losses["loss"] = total
        return total, losses

    return loss_fn


def _port_grads(pc, state, batch, attn_impl="auto"):
    total, losses = train_loss(pc, state.params, batch, attn_impl=attn_impl)
    leaves = pstate.tree_leaves(pstate.tree_map(
        lambda m, p: p, state.opt_state.mu, state.params))
    it = iter(torch.autograd.grad(total, leaves))
    grads = pstate.tree_map(lambda m: next(it), state.opt_state.mu)
    return losses, pstate.mask_gradients(grads, state.params, pc.detector)


@pytest.fixture(scope="module")
def jax_step_result(tree, batch_np):
    """One JAX make_train_step from the shared tree, plus the JAX loss's
    masked gradients."""
    jc, _ = _cfgs()
    params = _jax_tree(tree)
    jb = _jax_tree(batch_np)
    rng = jax.random.key(1)
    (_, losses), grads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(jc, jb, rng), has_aux=True))(params)
    grads = jstate.mask_gradients(grads, params, jc.detector)
    tx = jstate.make_optimizer(jc.optim, jc.detector, params)
    state = jstate.create_train_state(_jax_tree(tree), jc.optim, jc.detector)
    new_state, metrics = jax_make_train_step(jc, tx)(state, jb, rng)
    return {
        "losses": jax.tree_util.tree_map(np.asarray, losses),
        "grads": jax.tree_util.tree_map(np.asarray, grads),
        "metrics": jax.tree_util.tree_map(np.asarray, metrics),
        "params": jax.tree_util.tree_map(np.asarray, new_state.params),
    }


# ---- one step against JAX --------------------------------------------------


def test_one_step_matches_jax_make_train_step(tree, batch_np,
                                              jax_step_result):
    _, pc = _cfgs()
    state = _port_state(tree, pc)
    state, metrics = make_train_step(pc)(state, _torch_batch(batch_np))
    ref = jax_step_result["metrics"]
    assert state.step == 1 and state.opt_state.count == 1
    for key in ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm",
                "num_boxes"):
        assert _rel(ref[key], metrics[key]) <= LOSS_TOL, key
    grads = _flat(jax_step_result["grads"])
    new = _flat(params_to_numpy(state.params))
    want = _flat(jax_step_result["params"])
    mask = _flat(jax.tree_util.tree_map(
        bool, jax_trainable_mask(_jax_tree(tree), jcfg.DetectorConfig(
            backbone=jcfg.BackboneConfig(**BACKBONE),
            decoder=jcfg.DecoderConfig(**DECODER)))))
    moved = 0
    for k, v in want.items():
        if not mask[k]:
            assert np.array_equal(new[k], _flat(tree)[k]), k  # frozen
            continue
        g = np.abs(grads[k])
        clear = (g > GRAD_FLOOR * g.max()) & (g > GRAD_ABS_FLOOR)
        moved += int(clear.sum())
        assert np.abs(new[k] - v)[clear].max(initial=0.0) <= PARAM_TOL, k
    assert moved > 10_000


@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_gradients_match_jax(tree, batch_np, jax_step_result, attn_impl):
    """Every trainable leaf's masked gradient; 'flash' runs the backbone
    through the flash autograd Function (plain forward and backward on
    the CPU)."""
    _, pc = _cfgs()
    losses, grads = _port_grads(pc, _port_state(tree, pc),
                                _torch_batch(batch_np), attn_impl)
    for key, v in jax_step_result["losses"].items():
        assert _rel(v, losses[key]) <= LOSS_TOL, key
    ref = _flat(jax_step_result["grads"])
    got = _flat(grads)
    assert set(got) <= set(ref) and len(got) > 40
    for k, g in got.items():
        assert _rel(ref[k], g) <= GRAD_TOL, (k, _rel(ref[k], g))
        if k.endswith(("lora_A", "lora_B")):
            assert not g[0].any() and g[1:].abs().sum() > 0, k


# ---- the optimizer on shared gradients -------------------------------------


OPTIM_CASES = {
    "clip_active": dict(),
    "clip_inactive": dict(gradient_clip_val=1e6),
    "weight_decay": dict(weight_decay=0.05),
    "cosine": dict(lr_schedule="cosine", warmup_steps=2, total_steps=5,
                   min_lr_ratio=0.1),
    "linear": dict(lr_schedule="linear", warmup_steps=1, total_steps=4),
    "constant_warmup": dict(warmup_steps=3),
}


@pytest.mark.parametrize("case", list(OPTIM_CASES))
def test_optimizer_matches_optax(tree, case):
    """Four updates from the same numpy gradients (scaled so the clip
    binds or not) against the optax chain of make_optimizer, with the
    train step's masking before and after. Each update within 3e-5 of
    max(|update|, lr): both take 1 - b2**count in fp32, where one ulp of
    b2**count (6e-8) is 2e-5 of 1 - b2**count at count 3 and the two
    frameworks' pow may round apart (measured 1.1e-5)."""
    jc, pc = _cfgs(optim=OPTIM_CASES[case])
    det = jc.detector
    jparams = _jax_tree(tree)
    tx = jstate.make_optimizer(jc.optim, det, jparams)
    jopt = tx.init(jparams)
    state = _port_state(tree, pc)
    mask = jax_trainable_mask(jparams, det)
    rng = np.random.default_rng(list(OPTIM_CASES).index(case))
    scale = 1e-4 if case == "clip_active" else 1.0
    for _ in range(4):
        g_np = jax.tree_util.tree_map(
            lambda p, m: (rng.normal(0, scale, p.shape).astype(np.float32)
                          if m else np.zeros(p.shape, np.float32)),
            tree, mask)
        if case == "clip_active":
            g_np = jax.tree_util.tree_map(lambda g: g * 1e4, g_np)
        jg = jstate.mask_gradients(_jax_tree(g_np), jparams, det)
        jupd, jopt = tx.update(jg, jopt, jparams)
        jupd = jstate.mask_gradients(jupd, jparams, det)
        jparams = optax.apply_updates(jparams, jupd)
        pg = pstate.tree_map(lambda m, g: torch.from_numpy(g),
                             state.opt_state.mu, g_np)
        pg = pstate.mask_gradients(pg, state.params, pc.detector)
        pupd, state.opt_state = pstate.optimizer_update(
            pg, state.opt_state, state.params, pc.optim)
        pupd = pstate.mask_gradients(pupd, state.params, pc.detector)
        with torch.no_grad():
            pstate.tree_map(lambda u, p: p.add_(u), pupd, state.params)
        want = _flat(jax.tree_util.tree_map(np.asarray, jupd))
        for k, u in _flat(pupd).items():
            d = np.abs(want[k] - u.numpy()) / np.maximum(np.abs(want[k]), LR)
            assert d.max() <= 3e-5, k
    for k, v in _flat(params_to_numpy(state.params)).items():
        assert np.abs(_flat(jax.tree_util.tree_map(np.asarray, jparams))[k]
                      - v).max() <= 1e-6, k


def test_lr_schedules_match_optax():
    for kw in OPTIM_CASES.values():
        oc = jcfg.OptimConfig(**{k: v for k, v in kw.items()
                                 if k != "gradient_clip_val"})
        js = jstate.lr_schedule_fn(oc, LR)
        ps = pstate.lr_schedule_fn(pcfg.OptimConfig(**{
            k: v for k, v in kw.items() if k != "gradient_clip_val"}), LR)
        assert (js is None) == (ps is None)
        for count in range(8):
            if js is not None:
                assert abs(float(js(count)) - ps(count)) <= 1e-7 * LR


def test_trainable_mask_and_block_multiplier_match_jax(tree):
    jc, pc = _cfgs()
    params = params_from_numpy(tree, device="cpu")
    jm = _flat(jax.tree_util.tree_map(
        bool, jax_trainable_mask(_jax_tree(tree), jc.detector)))
    assert _flat(trainable_mask(params, pc.detector)) == jm
    jmult = _flat(jax.tree_util.tree_map(
        np.asarray, jax_lora_mult(_jax_tree(tree), jc.detector)))
    for k, m in _flat(lora_block_multiplier(params, pc.detector)).items():
        shape = _flat(tree)[k].shape
        m = m.numpy() if torch.is_tensor(m) else np.float32(m)
        assert np.array_equal(np.broadcast_to(jmult[k], shape),
                              np.broadcast_to(m, shape)), k


# ---- the port's step on its own --------------------------------------------


def test_frozen_leaves_and_non_adapted_lora_rows_stay(tree, batch_np):
    _, pc = _cfgs()
    state = _port_state(tree, pc)
    step = make_train_step(pc)
    for _ in range(3):
        state, _ = step(state, _torch_batch(batch_np))
    mask = _flat(trainable_mask(state.params, pc.detector))
    before = _flat(tree)
    after = _flat(params_to_numpy(state.params))
    # The deformable point weights get an exactly-zero gradient, in JAX
    # too: offsets start at zero, so every point of a head samples the
    # same place, gets the same gradient and the same update, and the
    # softmax over identical samples has no gradient.
    symmetric = ("decoder.layers.deform.weights_kernel",
                 "decoder.layers.deform.weights_bias")
    for k, v in after.items():
        if not mask[k] or k in symmetric:
            assert np.array_equal(v, before[k]), k
        elif k.endswith(("lora_A", "lora_B")):
            assert np.array_equal(v[0], before[k][0]), k  # not adapted
            assert not np.array_equal(v[1:], before[k][1:]), k
        else:
            assert not np.array_equal(v, before[k]), k
    assert not any(p.requires_grad for k, p in
                   _flat(state.params).items() if not mask[k])


def test_skip_nonfinite_and_ema(tree, batch_np):
    """A NaN image: the step is skipped whole (params, Adam moments, EMA
    and the update count stay) and reported; a finite batch then moves
    params and the EMA follows decay * ema + (1 - decay) * params."""
    _, pc = _cfgs(optim=dict(skip_nonfinite=True, ema_decay=0.9))
    state = _port_state(tree, pc)
    step = make_train_step(pc)
    bad = _torch_batch(batch_np)
    bad["images"][1, 3, 5, 0] = float("nan")
    snap = _flat(params_to_numpy(state.params))
    state, m = step(state, bad)
    assert float(m["nonfinite_skip"]) == 1.0 and state.step == 1
    assert state.opt_state.count == 0
    assert not any(t.any() for t in _flat(state.opt_state.mu).values())
    for k, v in _flat(params_to_numpy(state.params)).items():
        assert np.array_equal(v, snap[k]), k
    ema0 = _flat(params_to_numpy(state.ema))
    state, m = step(state, _torch_batch(batch_np))
    assert float(m["nonfinite_skip"]) == 0.0 and state.opt_state.count == 1
    mask = _flat(trainable_mask(state.params, pc.detector))
    new = _flat(params_to_numpy(state.params))
    ema = _flat(params_to_numpy(state.ema))
    for k, m_ in mask.items():
        if m_:
            np.testing.assert_allclose(ema[k], 0.9 * ema0[k] + 0.1 * new[k],
                                       rtol=1e-6, atol=1e-7)
        else:
            assert ema[k].shape == ()  # a placeholder, no copy
    merged = pstate.merge_ema(state.params, state.ema, pc.detector)
    assert merged["decoder"]["class_embed"]["kernel"] is \
        state.ema["decoder"]["class_embed"]["kernel"]


@pytest.mark.parametrize("share", [False, True], ids=["own", "shared"])
def test_aux_losses_match_jax(tree, batch_np, share):
    jc, pc = _cfgs(decoder=dict(aux_loss=True), share_aux_match=share)
    jb = _jax_tree(batch_np)
    _, ref = jax.jit(_jax_loss_fn(jc, jb, jax.random.key(1)))(
        _jax_tree(tree))
    state = _port_state(tree, pc)
    state, metrics = make_train_step(pc)(state, _torch_batch(batch_np))
    assert set(ref) <= set(metrics) and "loss_aux_0" in metrics
    for key, v in ref.items():
        assert _rel(v, metrics[key]) <= LOSS_TOL, key


def test_dropout_keep_rate_and_scaling():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = players.dropout(x, 0.1, gen, deterministic=False)
    kept = y != 0
    # Binomial(200000, 0.9): 4 sigma is 0.27% of the keep rate.
    assert abs(kept.float().mean().item() - 0.9) < 0.0027
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert players.dropout(x, 0.1, gen, deterministic=True) is x
    assert players.dropout(x, 0.1, None, deterministic=False) is x
    # Attention-probability dropout: dropped after the softmax, kept
    # probabilities scaled by 1/keep, rows not renormalised.
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 50, 4, 8)).astype(
        np.float32)) for _ in range(3))
    v = torch.ones_like(v)  # output = the row sum of the kept weights
    out = multi_head_attention(q, k, v, impl="auto", dropout_rate=0.5,
                               generator=torch.Generator().manual_seed(2))
    sums = out[..., 0]
    assert (sums - 1.0).abs().max() > 0.1  # not renormalised
    assert abs(sums.mean().item() - 1.0) < 0.05  # unbiased


def test_same_generator_seed_gives_the_same_step(tree, batch_np):
    _, pc = _cfgs(decoder=dict(dropout=0.1))
    runs = []
    for seed in (5, 5, 6):
        state = _port_state(tree, pc)
        state, m = make_train_step(pc)(state, _torch_batch(batch_np),
                                       torch.Generator().manual_seed(seed))
        runs.append((float(m["loss"]), _flat(params_to_numpy(state.params))))
    assert runs[0][0] == runs[1][0]
    assert all(np.array_equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    assert runs[0][0] != runs[2][0]


def test_loss_drops_on_a_fixed_batch(tree, batch_np):
    _, pc = _cfgs(decoder=dict(dropout=0.1))
    state = _port_state(tree, pc)
    step = make_train_step(pc)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(30):
        state, m = step(state, _torch_batch(batch_np), gen)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.7 * losses[0], losses


def test_make_batch_and_prep_images_match_jax():
    for seed in (0, 3):
        a = make_batch(np.random.default_rng(seed), 3, image_size=28,
                       max_boxes=5, max_objects=6)
        b = jax_make_batch(np.random.default_rng(seed), 3, image_size=28,
                           max_boxes=5, max_objects=6)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    raw = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3)).astype(
        np.uint8)
    for normalize in (True, False):
        ref = jax_prep_images(jnp.asarray(raw), normalize)
        out = prep_images(torch.from_numpy(raw), normalize)
        assert out.dtype == torch.float32
        assert np.abs(np.asarray(ref) - out.numpy()).max() <= 1e-6
    x = torch.rand(2, 8, 8, 3)
    assert prep_images(x, True) is x


def test_train_state_lives_on_the_params_device(tree):
    _, pc = _cfgs()
    state = _port_state(tree, pc)
    assert all(t.device.type == "cpu"
               for t in _flat(state.opt_state.mu).values())
    assert dataclasses.is_dataclass(state) and state.ema is None
