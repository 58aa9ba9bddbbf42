"""The port at the long-sequence configuration's shape, ViT-*/14 at 560 px
(1601 tokens), against the JAX package on the CPU: a narrow backbone (2
blocks of width 128, 2 heads of 64, LoRA on the last block) and a small
deformable decoder over the 40 x 40 feature grid, fp32, decoder dropout 0.

At 1601 tokens the JAX dispatch refuses the flat kernels (s_pad 1616:
2 * 1616^2 * 4 B > 18 MiB), so 'flash' takes the BHSD family: on the CPU
the port runs B5f's and B5b's plain versions, which the tests count.
The JAX side runs its XLA attention (its Pallas path needs a TPU; the
kernels themselves are held against the JAX kernels in interpret mode by
tests/test_torch_flash_attention_bhsd.py).

The JAX init is carried across with `params_from_numpy` after setting
every lora_B to small nonzero values, so every LoRA leaf has a gradient.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.models.detector import (
    detector_apply as jax_detector_apply,
    init_detector_params as jax_init,
)
from dinov2_od_tpu.ops import deformable as jdef
from dinov2_od_tpu.ops import flash_attention as jfa
from dinov2_od_tpu.ops.losses import set_criterion as jax_set_criterion
from dinov2_od_tpu.train import state as jstate
from dinov2_od_tpu.train.step import prep_images as jax_prep_images

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.synthetic import NUM_SYNTHETIC_CLASSES, make_batch
from dinov2_od_tpu_torch.models.detector import (
    detector_apply,
    init_detector_params,
)
from dinov2_od_tpu_torch.ops import _build
from dinov2_od_tpu_torch.ops import deformable as pdef
from dinov2_od_tpu_torch.ops import flash_attention as fa
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy
from dinov2_od_tpu_torch.train import state as pstate
from dinov2_od_tpu_torch.train.step import make_train_step, train_loss

IMAGE = 560
TOKENS = (IMAGE // 14) ** 2 + 1  # 1601
BACKBONE = dict(variant="small", image_size=IMAGE, hidden_dim_override=128,
                num_heads_override=2, depth_override=2, lora_r=2,
                lora_last_n_blocks=1, target_dim=64)
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=NUM_SYNTHETIC_CLASSES,
               dropout=0.0)
BATCH, MAX_BOXES = 2, 5
# fp32 against JAX: outputs 1e-4 max abs error (two frameworks' GEMMs and
# reductions sum in other orders through 2 blocks of 1601-key softmaxes
# and the decoder); losses and grad_norm 1e-5 relative; gradients 1e-4 of
# each leaf's largest gradient (relative to max(1, it)).
MODEL_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _cfgs():
    jdet = jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**BACKBONE),
                               decoder=jcfg.DecoderConfig(**DECODER))
    pdet = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**BACKBONE),
                               decoder=pcfg.DecoderConfig(**DECODER))
    data = dict(batch_size=BATCH, max_boxes=MAX_BOXES)
    return (jcfg.TrainConfig(detector=jdet, data=jcfg.DataConfig(**data),
                             optim=jcfg.OptimConfig()),
            pcfg.TrainConfig(detector=pdet, data=pcfg.DataConfig(**data),
                             optim=pcfg.OptimConfig()))


@pytest.fixture(scope="module")
def tree():
    jc, _ = _cfgs()
    t = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                               jax_init(jax.random.key(0), jc.detector))
    rng = np.random.default_rng(0)
    for lin in t["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = rng.normal(0, 0.05, lin["lora_B"].shape).astype(
                np.float32)
    return t


@pytest.fixture(scope="module")
def batch_np():
    return make_batch(np.random.default_rng(0), BATCH, image_size=IMAGE,
                      max_boxes=MAX_BOXES)


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


@contextlib.contextmanager
def _counting_plain_versions():
    """Counts the calls of each flash plain version through the wrappers
    (which look them up by name at call time)."""
    names = ("flash_attention_fwd_plain", "flash_attention_bwd_plain",
             "flash_attention_bhsd_fwd_plain",
             "flash_attention_bhsd_bwd_plain")
    calls = dict.fromkeys(names, 0)
    sound = {n: getattr(fa, n) for n in names}

    def counted(name):
        def fn(*a, **kw):
            calls[name] += 1
            return sound[name](*a, **kw)
        return fn

    for n in names:
        setattr(fa, n, counted(n))
    try:
        yield calls
    finally:
        for n, fn in sound.items():
            setattr(fa, n, fn)


def test_shapes_at_560_px(tree):
    """1601 tokens; pos_embed [1, 1601, D]; the 1600 patch tokens factor
    into a 40 x 40 grid in both frameworks; the JAX tree carries across
    leaf for leaf; both dispatches refuse the flat kernels at 1601 tokens
    (here and at ViT-L/560's 16 heads)."""
    _, pc = _cfgs()
    assert pc.detector.backbone.seq_len == TOKENS == 1601
    assert tree["backbone"]["pos_embed"].shape == (1, TOKENS, 128)
    assert pdef.factor_spatial_shape(TOKENS - 1) == (40, 40)
    assert jdef.factor_spatial_shape(TOKENS - 1) == (40, 40)
    port = init_detector_params(torch.Generator().manual_seed(0),
                                pc.detector, device="cpu")
    assert port["backbone"]["pos_embed"].shape == (1, TOKENS, 128)
    bridged = _flat(params_to_numpy(params_from_numpy(tree, device="cpu")))
    want = _flat(tree)
    assert bridged.keys() == want.keys()
    assert set(_flat(params_to_numpy(port))) == set(want)
    for k, v in want.items():
        assert bridged[k].shape == v.shape and np.array_equal(bridged[k], v), k
    for h in (2, 16):
        x = np.zeros((1, TOKENS, h, 64), np.float32)
        assert not fa._flat_eligible(x, x) and not jfa._flat_eligible(x, x)


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_detector_apply_matches_jax(tree, attn_impl):
    """The port's detector_apply at 560 px against JAX's; 'flash' runs
    every block's attention through B5f's plain version (2 calls, no flat
    ones), 'xla' through none."""
    jc, pc = _cfgs()
    x = np.random.default_rng(1).normal(
        size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    ref = jax_detector_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                             jc.detector, jnp.asarray(x))
    _build.reset_launch_counts()
    with _counting_plain_versions() as calls, torch.no_grad():
        out = detector_apply(params_from_numpy(tree, device="cpu"),
                             pc.detector, torch.from_numpy(x),
                             attn_impl=attn_impl)
    depth = pc.detector.backbone.depth
    want = depth if attn_impl == "flash" else 0
    assert calls == {"flash_attention_fwd_plain": 0,
                     "flash_attention_bwd_plain": 0,
                     "flash_attention_bhsd_fwd_plain": want,
                     "flash_attention_bhsd_bwd_plain": 0}
    assert _build.launch_counts == {n: 0 for n in _build.SOURCES}
    for key in ("pred_logits", "pred_boxes"):
        assert out[key].shape == ref[key].shape
        err = float(np.abs(np.asarray(ref[key]) - out[key].numpy()).max())
        assert err <= MODEL_TOL, (key, err)


@pytest.fixture(scope="module")
def jax_grads(tree, batch_np):
    """The JAX train step's loss terms and masked gradients at the shared
    tree (dinov2_od_tpu/train/step.py's loss, decoder dropout 0)."""
    jc, _ = _cfgs()
    det = jc.detector
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    batch = jax.tree_util.tree_map(jnp.asarray, batch_np)
    images = jax_prep_images(batch["images"], jc.data.normalize)
    rng = jax.random.key(1)

    def loss_fn(p):
        p = jstate.stop_gradient_frozen(p, det)
        out = jax_detector_apply(p, det, images, rng=rng,
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

    (_, losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    grads = jstate.mask_gradients(grads, params, det)
    grads = jax.tree_util.tree_map(np.asarray, grads)
    norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                       for g in _flat(grads).values()))
    return {"losses": jax.tree_util.tree_map(np.asarray, losses),
            "grads": grads, "grad_norm": norm}


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def test_train_gradients_through_bhsd_match_jax(tree, batch_np, jax_grads):
    """The train loss and every trainable gradient with attn_impl='flash':
    the adapted block's backward runs B5b's plain version once, the
    no-grad prefix none."""
    _, pc = _cfgs()
    state = pstate.create_train_state(params_from_numpy(tree, device="cpu"),
                                      pc.optim, pc.detector)
    with _counting_plain_versions() as calls:
        total, losses = train_loss(pc, state.params, _torch_batch(batch_np),
                                   attn_impl="flash")
        leaves = pstate.tree_leaves(pstate.tree_map(
            lambda m, p: p, state.opt_state.mu, state.params))
        it = iter(torch.autograd.grad(total, leaves))
    grads = pstate.mask_gradients(
        pstate.tree_map(lambda m: next(it), state.opt_state.mu),
        state.params, pc.detector)
    depth = pc.detector.backbone.depth
    assert calls == {"flash_attention_fwd_plain": 0,
                     "flash_attention_bwd_plain": 0,
                     "flash_attention_bhsd_fwd_plain": depth,
                     "flash_attention_bhsd_bwd_plain": 1}
    for key, v in jax_grads["losses"].items():
        assert _rel(v, losses[key]) <= LOSS_TOL, key
    ref = _flat(jax_grads["grads"])
    got = _flat(grads)
    assert set(got) <= set(ref) and len(got) > 30
    for k, g in got.items():
        assert _rel(ref[k], g) <= GRAD_TOL, (k, _rel(ref[k], g))
        if k.endswith(("lora_A", "lora_B")):
            assert not g[0].any() and g[1].abs().sum() > 0, k


def test_one_train_step_matches_jax(tree, batch_np, jax_grads):
    """make_train_step's first step at 560 px: its loss terms and the norm
    of its masked gradients against JAX's, and the frozen leaves
    untouched."""
    _, pc = _cfgs()
    state = pstate.create_train_state(params_from_numpy(tree, device="cpu"),
                                      pc.optim, pc.detector)
    state, metrics = make_train_step(pc)(state, _torch_batch(batch_np))
    for key, v in jax_grads["losses"].items():
        assert _rel(v, metrics[key]) <= LOSS_TOL, key
    assert _rel(jax_grads["grad_norm"], metrics["grad_norm"]) <= LOSS_TOL
    after = _flat(params_to_numpy(state.params))
    before = _flat(tree)
    assert np.array_equal(after["backbone.pos_embed"],
                          before["backbone.pos_embed"])
    assert not np.array_equal(after["decoder.class_embed.kernel"],
                              before["decoder.class_embed.kernel"])
