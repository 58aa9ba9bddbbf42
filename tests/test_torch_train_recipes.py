"""The recorded training recipes' step options in the port's train step
(dinov2_od_tpu_torch/train/step.py, state.py, checkpoint.py) against the
JAX package's `make_train_step` and optax chain, on the CPU at a tiny
size (3 ViT blocks of width 128 with 2 heads of 64, the last 2
LoRA-adapted; a 2-layer deformable decoder of width 64), fp32, decoder
dropout 0:

- device-side augmentation at hflip_prob=1 (deterministic in both);
- rematerialisation of the adapted blocks (bit-equal to the step
  without it on the CPU);
- lora_mode="fold" in training;
- gradient accumulation over two mini-batches against optax.MultiSteps,
  and a resume between the two mini-steps;
- the branchless non-finite guard, equal to the unguarded step on
  finite batches and skipping a poisoned mini-step.

Tolerances, relative to max(1, the reference's magnitude): losses and
grad_norm 1e-5, updated params 2e-7 absolute where the gradient is
clearly above noise (as tests/test_torch_train_step.py states them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.models.detector import (
    init_detector_params as jax_init,
    trainable_mask as jax_trainable_mask,
)
from dinov2_od_tpu.train import state as jstate
from dinov2_od_tpu.train.step import make_train_step as jax_make_train_step

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.synthetic import NUM_SYNTHETIC_CLASSES, make_batch
from dinov2_od_tpu_torch.ops import _build
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy
from dinov2_od_tpu_torch.train import checkpoint as ckpt
from dinov2_od_tpu_torch.train import state as pstate
from dinov2_od_tpu_torch.train.step import make_train_step, train_grads

BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=3, lora_r=2,
                lora_last_n_blocks=2, target_dim=64)
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=NUM_SYNTHETIC_CLASSES,
               dropout=0.0)
LR = 3e-4
LOSS_TOL = 1e-5
PARAM_TOL = 2e-7
GRAD_FLOOR = 1e-2
GRAD_ABS_FLOOR = 1e-6
METRICS = ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: many small eager ops, run beside the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(backbone=None, optim=None, **train):
    bk = {**BACKBONE, **(backbone or {})}
    ok = {"learning_rate": LR, **(optim or {})}
    jdet = jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**bk),
                               decoder=jcfg.DecoderConfig(**DECODER))
    pdet = pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**bk),
                               decoder=pcfg.DecoderConfig(**DECODER))
    data = dict(batch_size=4, max_boxes=6)
    jtrain = dict(train)
    ptrain = dict(train)
    if "augment" in train:
        jtrain["augment"] = jcfg.AugmentConfig(**train["augment"])
        ptrain["augment"] = pcfg.AugmentConfig(**train["augment"])
    return (jcfg.TrainConfig(detector=jdet, data=jcfg.DataConfig(**data),
                             optim=jcfg.OptimConfig(**ok), **jtrain),
            pcfg.TrainConfig(detector=pdet, data=pcfg.DataConfig(**data),
                             optim=pcfg.OptimConfig(**ok), **ptrain))


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
def batches():
    return [make_batch(np.random.default_rng(s), 4, image_size=56,
                       max_boxes=6) for s in (0, 1)]


def _state(tree, pc):
    return pstate.create_train_state(params_from_numpy(tree, device="cpu"),
                                     pc.optim, pc.detector)


def _tb(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _jt(t):
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
    return (x.detach().float().numpy() if torch.is_tensor(x)
            else np.asarray(x, np.float32))


def _rel(ref, out):
    ref, out = _np(ref), _np(out)
    return float(np.abs(ref - out).max() / max(1.0, np.abs(ref).max()))


def _jax_steps(jc, tree, batches):
    """JAX make_train_step over `batches` from `tree`: (metrics, params)
    after each call, as numpy."""
    params = _jt(tree)
    tx = jstate.make_optimizer(jc.optim, jc.detector, params)
    state = jstate.create_train_state(params, jc.optim, jc.detector)
    step = jax_make_train_step(jc, tx)
    out = []
    for b in batches:
        state, m = step(state, _jt(b), jax.random.key(1))
        out.append((jax.tree_util.tree_map(np.asarray, m),
                    jax.tree_util.tree_map(np.asarray, state.params),
                    None if state.ema is None else
                    jax.tree_util.tree_map(np.asarray, state.ema)))
    return out


def _mean_grads(pc, tree, batches):
    """The mean of the port's masked gradients over `batches` at `tree`."""
    state = _state(tree, pc)
    gs = [_flat(pstate.tree_map(lambda g: g.numpy(),
                                train_grads(pc, state, _tb(b))[1]))
          for b in batches]
    return {k: np.mean([g[k] for g in gs], axis=0) for k in gs[0]}


def _check_params(new, want, grads, tree, det):
    """Updated params against JAX where the gradient is clear of noise;
    frozen leaves bit-equal to the start."""
    mask = _flat(jax.tree_util.tree_map(
        bool, jax_trainable_mask(_jt(tree), det)))
    new, want, start = _flat(new), _flat(want), _flat(tree)
    moved = 0
    for k, v in want.items():
        if not mask[k]:
            assert np.array_equal(new[k], start[k]), k
            continue
        g = np.abs(grads[k])
        clear = (g > GRAD_FLOOR * g.max()) & (g > GRAD_ABS_FLOOR)
        moved += int(clear.sum())
        assert np.abs(new[k] - v)[clear].max(initial=0.0) <= PARAM_TOL, k
    assert moved > 10_000


# ---- augmentation ----------------------------------------------------------


def test_hflip_step_matches_jax(tree, batches):
    """hflip_prob=1 flips every image and box in both frameworks: one step
    against JAX's, and unlike the step without augmentation."""
    jc, pc = _cfgs(augment=dict(hflip_prob=1.0))
    (ref, want, _), = _jax_steps(jc, tree, batches[:1])
    state = _state(tree, pc)
    state, m = make_train_step(pc)(state, _tb(batches[0]),
                                   torch.Generator().manual_seed(0))
    for key in METRICS:
        assert _rel(ref[key], m[key]) <= LOSS_TOL, key
    flipped = {k: v[:, :, ::-1] if k == "images" else v
               for k, v in batches[0].items()}
    flipped["boxes"] = flipped["boxes"].copy()
    flipped["boxes"][..., 0] = 1.0 - flipped["boxes"][..., 0]
    _, plain = _cfgs()
    _, m_plain = make_train_step(plain)(_state(tree, plain), _tb(flipped))
    _, m_unflipped = make_train_step(plain)(_state(tree, plain),
                                            _tb(batches[0]))
    assert _rel(m_plain["loss"], m["loss"]) <= LOSS_TOL
    assert float(m_unflipped["loss"]) != float(m["loss"])
    grads = _mean_grads(plain, tree, [flipped])
    _check_params(params_to_numpy(state.params), want, grads, tree,
                  jc.detector)


def test_augmentation_off_leaves_the_step_alone(tree, batches):
    """A disabled augmentation draws nothing: the step with a generator is
    the step without one, bit for bit."""
    _, pc = _cfgs()
    a, ma = make_train_step(pc)(_state(tree, pc), _tb(batches[0]))
    b, mb = make_train_step(pc)(_state(tree, pc), _tb(batches[0]),
                                torch.Generator().manual_seed(9))
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(np.array_equal(v, _flat(params_to_numpy(b.params))[k])
               for k, v in _flat(params_to_numpy(a.params)).items())


# ---- remat and fold --------------------------------------------------------


def test_remat_is_bit_equal_to_the_step_without_it(tree, batches):
    """Recomputing the two adapted blocks in the backward gives the same
    loss, gradients and update to the bit, and runs their attention
    forward twice (counted through `_build.launch_counts` on the card:
    see chip_smoke.py's train recipes phase)."""
    runs = {}
    for remat in (False, True):
        _, pc = _cfgs(use_remat=remat)
        state = _state(tree, pc)
        metrics, grads = train_grads(pc, state, _tb(batches[0]))
        state, m = make_train_step(pc)(state, _tb(batches[0]))
        runs[remat] = (m, _flat(pstate.tree_map(lambda g: g.numpy(), grads)),
                       _flat(params_to_numpy(state.params)))
    (m0, g0, p0), (m1, g1, p1) = runs[False], runs[True]
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(np.array_equal(g0[k], g1[k]) for k in g0)
    assert all(np.array_equal(p0[k], p1[k]) for k in p0)
    assert _build.launch_counts["flash_attn_fwd"] == 0  # CPU: plain


def test_remat_recomputes_the_adapted_blocks(tree, batches, monkeypatch):
    """Forward calls of the attention under the step: 3 without remat,
    3 + 2 with it (the adapted blocks' recompute), none extra in the
    no-grad prefix."""
    from dinov2_od_tpu_torch.models import vit

    calls = []
    real = vit.multi_head_attention
    monkeypatch.setattr(vit, "multi_head_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for remat, want in ((False, 3), (True, 5)):
        calls.clear()
        _, pc = _cfgs(use_remat=remat)
        make_train_step(pc)(_state(tree, pc), _tb(batches[0]))
        assert len(calls) == want, remat


def test_fold_mode_step_matches_jax(tree, batches):
    """lora_mode='fold' trains through W + alpha * A @ B: one step
    against JAX's fold-mode step, and the same gradients as the factored
    step up to rounding."""
    jc, pc = _cfgs(backbone=dict(lora_mode="fold"))
    (ref, want, _), = _jax_steps(jc, tree, batches[:1])
    state = _state(tree, pc)
    state, m = make_train_step(pc)(state, _tb(batches[0]))
    for key in METRICS:
        assert _rel(ref[key], m[key]) <= LOSS_TOL, key
    fold = _mean_grads(pc, tree, batches[:1])
    _, factored_cfg = _cfgs()
    factored = _mean_grads(factored_cfg, tree, batches[:1])
    for k, g in factored.items():
        assert np.abs(fold[k] - g).max() <= 1e-4 * max(1.0, np.abs(g).max())
    _check_params(params_to_numpy(state.params), want, fold, tree,
                  jc.detector)


def test_fold_mode_bf16_step_matches_jax_bf16(tree, batches):
    """With a bf16 backbone the fold runs in bf16 (W_eff cast to the
    activation dtype) in both frameworks: the losses within bf16's
    roundings of each other (3e-2 relative, as the bf16 forward checks of
    tests/test_torch_models.py)."""
    jc, pc = _cfgs(backbone=dict(lora_mode="fold", dtype="bfloat16"))
    (ref, _, _), = _jax_steps(jc, tree, batches[:1])
    _, m = make_train_step(pc)(_state(tree, pc), _tb(batches[0]))
    for key in ("loss", "loss_ce", "loss_bbox", "loss_giou"):
        assert _rel(ref[key], m[key]) <= 3e-2, key
    assert np.isfinite(float(m["grad_norm"]))


# ---- gradient accumulation -------------------------------------------------


@pytest.fixture(scope="module")
def multisteps(tree, batches):
    """optax.MultiSteps (k=2, EMA 0.9) over the two batches."""
    jc, _ = _cfgs(optim=dict(gradient_accumulation_steps=2, ema_decay=0.9))
    return _jax_steps(jc, tree, batches)


def test_accumulation_matches_optax_multisteps(tree, batches, multisteps):
    """k=2: the first call leaves params and moments as they were (the
    EMA moves toward the unchanged params, as JAX's does); the second
    applies the chain to the mean of the two gradients."""
    jc, pc = _cfgs(optim=dict(gradient_accumulation_steps=2, ema_decay=0.9))
    state = _state(tree, pc)
    step = make_train_step(pc)
    start = _flat(params_to_numpy(state.params))
    state, m1 = step(state, _tb(batches[0]))
    for key in METRICS:
        assert _rel(multisteps[0][0][key], m1[key]) <= LOSS_TOL, key
    assert state.opt_state.count == 0 and state.opt_state.mini_step == 1
    assert all(np.array_equal(v, start[k]) for k, v in
               _flat(params_to_numpy(state.params)).items())
    assert not any(t.any() for t in _flat(state.opt_state.mu).values())
    state, m2 = step(state, _tb(batches[1]))
    for key in METRICS:
        assert _rel(multisteps[1][0][key], m2[key]) <= LOSS_TOL, key
    assert state.opt_state.count == 1 and state.opt_state.mini_step == 0
    assert not any(t.any() for t in _flat(state.opt_state.acc).values())
    grads = _mean_grads(pc, tree, batches)
    _check_params(params_to_numpy(state.params), multisteps[1][1], grads,
                  tree, jc.detector)
    # EMA: 0.9 * (0.9 * p0 + 0.1 * p0) + 0.1 * p1 on the trainable leaves.
    ema, want = _flat(params_to_numpy(state.ema)), _flat(multisteps[1][2])
    for k, v in ema.items():
        if v.shape:
            assert np.abs(v - want[k]).max() <= 1e-6, k


def test_accumulation_is_not_a_bigger_batch(tree, batches):
    """The mean of two mini-steps' gradients, each normalised by its own
    GT count, is not the gradient of the two batches as one."""
    _, pc = _cfgs()
    both = {k: np.concatenate([batches[0][k], batches[1][k]])
            for k in batches[0]}
    mean = _mean_grads(pc, tree, batches)
    big = _mean_grads(pc, tree, [both])
    assert max(np.abs(mean[k] - big[k]).max() for k in mean) > 1e-6


def test_resume_between_mini_steps_is_exact(tree, batches, tmp_path):
    """A checkpoint after the first mini-step holds the accumulator and
    the mini-step: the restored run's second call equals the
    uninterrupted run's to the bit."""
    _, pc = _cfgs(optim=dict(gradient_accumulation_steps=2))
    step = make_train_step(pc)
    state, _ = step(_state(tree, pc), _tb(batches[0]))
    path = ckpt.save_checkpoint(str(tmp_path), 0, state.params,
                                state.opt_state, 0.0, step=state.step)
    cont, m_cont = step(state, _tb(batches[1]))

    fresh = _state(tree, pc)
    restored = ckpt.restore_checkpoint(path, fresh.params, fresh.opt_state)
    assert restored.opt_state.mini_step == 1 and restored.step == 1
    again = pstate.create_train_state(restored.params, pc.optim,
                                      pc.detector)
    again.opt_state, again.step = restored.opt_state, restored.step
    again, m_again = make_train_step(pc)(again, _tb(batches[1]))
    assert all(torch.equal(m_cont[k], m_again[k]) for k in m_cont)
    for tree_a, tree_b in ((cont.params, again.params),
                           (cont.opt_state.mu, again.opt_state.mu),
                           (cont.opt_state.nu, again.opt_state.nu)):
        a, b = _flat(tree_a), _flat(tree_b)
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert again.opt_state.count == 1 and again.step == 2


# ---- the non-finite guard --------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
def test_guard_is_the_plain_step_on_finite_batches(tree, batches, k):
    """skip_nonfinite's branchless update (device counts, the host's
    bias corrections and rates by table) equals the unguarded step to the
    bit over three finite calls."""
    runs = []
    for guard in (False, True):
        _, pc = _cfgs(optim=dict(gradient_accumulation_steps=k,
                                 skip_nonfinite=guard, ema_decay=0.9,
                                 lr_schedule="cosine", warmup_steps=1,
                                 total_steps=4))
        state = _state(tree, pc)
        step = make_train_step(pc)
        for b in (batches[0], batches[1], batches[0]):
            state, m = step(state, _tb(b))
        runs.append((_flat(params_to_numpy(state.params)),
                     _flat(params_to_numpy(state.ema)),
                     int(state.opt_state.count),
                     int(state.opt_state.mini_step)))
    (p0, e0, c0, s0), (p1, e1, c1, s1) = runs
    assert all(np.array_equal(p0[key], p1[key]) for key in p0)
    assert all(np.array_equal(e0[key], e1[key]) for key in e0)
    assert (c0, s0) == (c1, s1) == ((3, 0) if k == 1 else (1, 1))


def test_guard_skips_a_poisoned_mini_step(tree, batches):
    """k=2: a NaN mini-step between two finite ones is skipped whole (the
    accumulator and the mini-step keep their values), so the update
    comes from the two finite batches, as the run without it gives."""
    _, pc = _cfgs(optim=dict(gradient_accumulation_steps=2,
                             skip_nonfinite=True))
    bad = _tb(batches[1])
    bad["images"][0, 1, 2, 0] = float("nan")
    step = make_train_step(pc)
    state = _state(tree, pc)
    skips = []
    for b in (_tb(batches[0]), bad, _tb(batches[1])):
        state, m = step(state, b)
        skips.append(float(m["nonfinite_skip"]))
    assert skips == [0.0, 1.0, 0.0] and state.step == 3
    ref = _state(tree, pc)
    for b in batches:
        ref, _ = make_train_step(pc)(ref, _tb(b))
    assert int(state.opt_state.count) == int(ref.opt_state.count) == 1
    a, b = _flat(state.params), _flat(ref.params)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_adam_table_gives_the_host_scalars():
    oc = pcfg.OptimConfig(learning_rate=LR, lr_schedule="cosine",
                          warmup_steps=2, total_steps=10)
    table = pstate.AdamTable(oc, "cpu")
    for c in (0, 1, 5, 9, 70):
        got = [float(x) for x in table(torch.tensor(c), c)]
        want = [float(np.float32(x)) for x in pstate.adam_scalars(oc, c)]
        assert got == want, c
    assert dataclasses.is_dataclass(oc)


# ---- the dense-GT bench ----------------------------------------------------


@pytest.mark.parametrize("aux,share,calls", [(False, False, 1),
                                             (True, False, 3),
                                             (True, True, 1)],
                         ids=["final", "aux", "shared"])
def test_bench_dense_runs_the_auction_at_93_gt(aux, share, calls):
    """tools/bench_dense.py on the CPU with ViT-S: 93 valid GT of 100 slots
    go to the auction, once a step per matched decoder layer (3 with
    aux_loss, 1 when the aux layers share the final match)."""
    from dinov2_od_tpu_torch.tools import bench_dense

    batch = bench_dense.dense_batch(2, 93, device="cpu")
    assert batch["valid"].sum(1).tolist() == [93, 93]
    assert batch["valid"].shape == (2, bench_dense.MAX_BOXES)
    out = bench_dense.run(2, 93, aux, share, device="cpu", iters=1,
                          model="facebook/dinov2-small")
    assert out["sec_per_step"] > 0 and out["value"] > 0
    assert out["matcher_per_step"]["auction"] == calls
    assert out["matcher_per_step"]["jv"] == 0
    assert f"aux_loss={aux}" in out["metric"] and "cpu" in out["metric"]
