"""The port's device-side augmentation (dinov2_od_tpu_torch/data/augment.py)
against the JAX package's (dinov2_od_tpu/data/augment.py) on the CPU.

The random streams of the two frameworks cannot match, so every op is
fed the JAX package's own draws: the test splits the JAX key as
`augment_batch` does, draws with `jax.random`, and gives those factors to
the port's `apply_*` functions. Tolerances, fp32 on [0, 1] pixels and
normalised boxes: pixels within 2e-6 (the bilinear resample sums two
neighbours through two matmuls whose reduction order differs between
XLA and torch), boxes within 1e-6, valid bits and flips exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.data import augment as jaug

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data import augment as paug

PIX_TOL = 2e-6
BOX_TOL = 1e-6
B, H, W, G = 4, 20, 24, 6  # non-square, so the two axes cannot swap


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    cxcy = rng.uniform(0.1, 0.9, (B, G, 2))
    wh = rng.uniform(0.02, 0.4, (B, G, 2))
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    valid = rng.uniform(size=(B, G)) < 0.8
    return images, boxes, valid


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_scale_draws(key, strength):
    """The (s, tx, ty) of jaug._scale_jitter for `key`."""
    ks, kx, ky = jax.random.split(key, 3)
    s = jax.random.uniform(ks, (B,), minval=1.0 - strength,
                           maxval=1.0 + strength)
    tx = W * (1.0 - s) * jax.random.uniform(kx, (B,))
    ty = H * (1.0 - s) * jax.random.uniform(ky, (B,))
    return s, tx, ty


def _jax_color_draws(key, strength):
    kb, kc, ks = jax.random.split(key, 3)
    lo, hi = 1.0 - strength, 1.0 + strength
    return [jax.random.uniform(k, (B, 1, 1, 1), minval=lo,
                               maxval=hi).reshape(B)
            for k in (kb, kc, ks)]


def _close(got, want, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert np.abs(got - np.asarray(want)).max() <= tol


@pytest.mark.parametrize("scale,translate", [(1.0, 0.0), (0.8, 3.5),
                                             (1.25, -4.0)])
def test_resample_matrix_matches_jax(scale, translate):
    want = jaug._resample_matrix(W, jnp.float32(scale), jnp.float32(translate))
    got = paug.resample_matrix(W, torch.tensor([scale]),
                               torch.tensor([translate]))[0]
    _close(got, want, 1e-6)
    if scale == 1.0 and translate == 0.0:
        assert torch.equal(got, torch.eye(W))  # the identity resample


def test_hflip_matches_jax(inputs):
    images, boxes, _ = inputs
    key = jax.random.key(3)
    flip = np.asarray(jax.random.bernoulli(key, 0.5, (B,)))
    assert 0 < flip.sum() < B  # both branches run
    want_i, want_b = jaug._hflip(key, 0.5, jnp.asarray(images),
                                 jnp.asarray(boxes))
    got_i, got_b = paug.apply_hflip(_t(images), _t(boxes), _t(flip))
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    _close(got_b, want_b, 0.0)


@pytest.mark.parametrize("strength", [0.1, 0.25, 0.5])
def test_scale_jitter_matches_jax(inputs, strength):
    images, boxes, valid = inputs
    key = jax.random.key(5)
    s, tx, ty = _jax_scale_draws(key, strength)
    want = jaug._scale_jitter(key, strength, 1e-3, jnp.asarray(images),
                              jnp.asarray(boxes), jnp.asarray(valid))
    got = paug.apply_scale_translate(_t(images), _t(boxes), _t(valid),
                                     _t(s), _t(tx), _t(ty), 1e-3)
    _close(got[0], want[0], PIX_TOL)
    _close(got[1], want[1], BOX_TOL)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


def test_scale_jitter_drops_boxes_pushed_out(inputs):
    """A 2x zoom with the crop window at the far corner pushes the boxes
    near the origin out of frame: their valid bits clear, as in JAX."""
    images, _, _ = inputs
    boxes = np.zeros((B, G, 4), np.float32)
    boxes[..., :2], boxes[..., 2:] = 0.1, 0.05
    boxes[:, 0] = (0.9, 0.9, 0.1, 0.1)  # stays in frame
    valid = np.ones((B, G), bool)
    s = np.full(B, 2.0, np.float32)
    tx, ty = W * (1 - s), H * (1 - s)
    want = jaug.apply_scale_translate(
        jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
        jnp.asarray(s), jnp.asarray(tx), jnp.asarray(ty), 1e-3)
    got = paug.apply_scale_translate(_t(images), _t(boxes), _t(valid),
                                     _t(s), _t(tx), _t(ty), 1e-3)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2][:, 0].all() and not got[2][:, 1:].any()
    _close(got[1], want[1], BOX_TOL)


@pytest.mark.parametrize("strength", [0.2, 0.4])
def test_color_jitter_matches_jax(inputs, strength):
    images, _, _ = inputs
    key = jax.random.key(7)
    b, c, g = _jax_color_draws(key, strength)
    want = jaug._color_jitter(key, strength, jnp.asarray(images))
    got = paug.apply_color_jitter(_t(images), _t(b), _t(c), _t(g))
    _close(got, want, PIX_TOL)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("kw", [
    dict(hflip_prob=0.5),
    dict(scale_jitter=0.25),
    dict(color_jitter=0.3),
    dict(hflip_prob=0.5, scale_jitter=0.25, color_jitter=0.3),
], ids=["flip", "scale", "color", "all"])
def test_augment_batch_matches_jax_with_its_draws(inputs, kw):
    """The whole pipeline in JAX's order (flip, zoom, colour) with the
    draws `augment_batch` makes from one key."""
    images, boxes, valid = inputs
    rng = jax.random.key(11)
    k_flip, k_scale, k_color = jax.random.split(rng, 3)
    jc = jcfg.AugmentConfig(**kw)
    draws = {}
    if jc.hflip_prob > 0:
        draws["flip"] = jax.random.bernoulli(k_flip, jc.hflip_prob, (B,))
    if jc.scale_jitter > 0:
        draws["scale"], draws["tx"], draws["ty"] = _jax_scale_draws(
            k_scale, jc.scale_jitter)
    if jc.color_jitter > 0:
        draws["bright"], draws["contrast"], draws["sat"] = _jax_color_draws(
            k_color, jc.color_jitter)
    want = jaug.augment_batch(rng, jnp.asarray(images), jnp.asarray(boxes),
                              jnp.asarray(valid), jc)
    got = paug.apply_augment(_t(images), _t(boxes), _t(valid),
                             {k: _t(v) for k, v in draws.items()},
                             pcfg.AugmentConfig(**kw))
    _close(got[0], want[0], PIX_TOL)
    _close(got[1], want[1], BOX_TOL)
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


def test_draws_are_seeded_ranged_and_only_for_enabled_ops():
    cfg = pcfg.AugmentConfig(hflip_prob=0.5, scale_jitter=0.25,
                             color_jitter=0.3)

    def draw(seed, c=cfg):
        g = torch.Generator().manual_seed(seed)
        return paug.draw_augment(g, c, 64, H, W, "cpu")

    a, b, c = draw(1), draw(1), draw(2)
    assert set(a) == {"flip", "scale", "tx", "ty", "bright", "contrast",
                      "sat"}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["scale"], c["scale"])
    s = a["scale"]
    assert ((s >= 0.75) & (s <= 1.25)).all()
    for t, size in ((a["tx"], W), (a["ty"], H)):
        lo = torch.minimum(torch.zeros(()), size * (1 - s))
        hi = torch.maximum(torch.zeros(()), size * (1 - s))
        assert ((t >= lo - 1e-5) & (t <= hi + 1e-5)).all()
    for k in ("bright", "contrast", "sat"):
        assert ((a[k] >= 0.7) & (a[k] <= 1.3)).all()
    assert 0 < int(a["flip"].sum()) < 64
    always = draw(0, pcfg.AugmentConfig(hflip_prob=1.0))
    assert set(always) == {"flip"} and always["flip"].all()
    assert draw(0, pcfg.AugmentConfig()) == {}
    assert not pcfg.AugmentConfig().enabled


def test_augment_batch_leaves_the_inputs_alone(inputs):
    images, boxes, valid = inputs
    x, bx, v = _t(images.copy()), _t(boxes.copy()), _t(valid.copy())
    cfg = pcfg.AugmentConfig(hflip_prob=1.0, scale_jitter=0.3,
                             color_jitter=0.3)
    out = paug.augment_batch(torch.Generator().manual_seed(0), x, bx, v, cfg)
    assert np.array_equal(x.numpy(), images)
    assert np.array_equal(bx.numpy(), boxes)
    assert np.array_equal(v.numpy(), valid)
    assert out[0].shape == x.shape and out[1].shape == bx.shape
    assert out[2].dtype == torch.bool
