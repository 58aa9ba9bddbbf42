"""The port's MoE backbone FFN (dinov2_od_tpu_torch/ops/moe.py and its
sparse-upcycling layout in models/) against the JAX package on the CPU,
at a tiny size: 3 ViT blocks of width 128 with 2 heads of 64, the last 2
(adapted) blocks MoE with 4 experts, top-2, capacity factor 1.25 (11
slots an expert for 17 tokens, so tokens are dropped); a 2-layer
deformable decoder of width 64, dropout 0.

Params come from the JAX `init_detector_params` with every lora_B set to
small nonzero values, carried across with `params_from_numpy`. Inputs are
numpy draws from fixed seeds. Each check states its tolerance."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.models import quantize as jq
from dinov2_od_tpu.models.detector import (
    cast_frozen_weights as jax_cast,
    detector_apply as jax_detector_apply,
    fold_detector_lora as jax_fold,
    init_detector_params as jax_init,
    lora_block_multiplier as jax_lora_mult,
    trainable_mask as jax_trainable_mask,
)
from dinov2_od_tpu.models.vit import backbone_apply as jax_backbone_apply
from dinov2_od_tpu.ops import moe as jmoe
from dinov2_od_tpu.train import state as jstate
from dinov2_od_tpu.train.step import make_train_step as jax_make_train_step

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.synthetic import NUM_SYNTHETIC_CLASSES, make_batch
from dinov2_od_tpu_torch.models.detector import (
    cast_frozen_weights,
    detector_apply,
    fold_detector_lora,
    init_detector_params,
    lora_block_multiplier,
    trainable_mask,
)
from dinov2_od_tpu_torch.models.quantize import quantize_detector_int8
from dinov2_od_tpu_torch.models.vit import backbone_apply
from dinov2_od_tpu_torch.ops import moe as pmoe
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy
from dinov2_od_tpu_torch.parallel.sharding import Mesh
from dinov2_od_tpu_torch.train import state as pstate
from dinov2_od_tpu_torch.train.step import make_train_step

BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=3, lora_r=2,
                lora_last_n_blocks=2, target_dim=64,
                ffn_type_override="moe", moe_num_experts=4)
DECODER = dict(hidden_dim=64, num_queries=8, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=NUM_SYNTHETIC_CLASSES,
               dropout=0.0)
# fp32 against JAX (max abs error): the gate math and one FFN 1e-5; the
# backbone and detector 1e-4 (the two frameworks' GEMMs and reductions
# sum in other orders through every block, as in test_torch_models.py).
OP_TOL = 1e-5
MODEL_TOL = 1e-4
# The train step, as test_torch_train_step.py holds the dense one: losses
# 1e-5 and gradients 1e-4, each relative to max(1, the reference's
# magnitude); updated params 2e-7 absolute where the gradient is clearly
# above noise.
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 2e-7


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: many small eager ops, run beside the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**backbone):
    bk = {**BACKBONE, **backbone}
    return (jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**bk),
                                decoder=jcfg.DecoderConfig(**DECODER)),
            pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**bk),
                                decoder=pcfg.DecoderConfig(**DECODER)))


_TREES = {}


def _tree(**backbone):
    """The JAX init for the layout (numpy), every lora_B nonzero."""
    key = tuple(sorted(backbone.items()))
    if key not in _TREES:
        jc, _ = _cfgs(**backbone)
        t = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                   jax_init(jax.random.key(0), jc))
        rng = np.random.default_rng(0)
        for stack in ("blocks", "moe_blocks"):
            for lin in t["backbone"].get(stack, {}).values():
                if isinstance(lin, dict) and "lora_B" in lin:
                    lin["lora_B"] = rng.normal(
                        0, 0.05, lin["lora_B"].shape).astype(np.float32)
        _TREES[key] = t
    return _TREES[key]


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
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _rel(ref, out):
    ref, out = _np(ref), _np(out)
    return float(np.abs(ref - out).max() / max(1.0, np.abs(ref).max()))


def _images(n=2, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, 56, 56, 3)).astype(np.float32)


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def _expert_params(rng, d, m, e, scale=0.3):
    return {"router_kernel": rng.normal(0, scale, (d, e)),
            "fc1_kernel": rng.normal(0, scale, (e, d, m)),
            "fc1_bias": rng.normal(0, scale, (e, m)),
            "fc2_kernel": rng.normal(0, scale, (e, m, d)),
            "fc2_bias": rng.normal(0, scale, (e, d))}


def _as(tree, dtype=np.float32):
    return ({k: torch.from_numpy(np.asarray(v, dtype)) for k, v in tree.items()},
            {k: jnp.asarray(v, dtype) for k, v in tree.items()})


# ---- routing ---------------------------------------------------------------


CAPACITY_GRID = [(257, 8, 2, 1.25), (257, 8, 1, 1.0), (17, 4, 2, 1.25),
                 (6, 2, 1, 2 * 2 / 6), (16, 4, 2, 1.0), (10, 4, 2, 1.1),
                 (1, 8, 1, 1.0), (1, 1, 1, 0.01), (1601, 8, 2, 1.25),
                 (3, 3, 3, 1 / 3), (100, 7, 2, 0.7), (50, 16, 4, 2.0)]


@pytest.mark.parametrize("n,e,k,cf", CAPACITY_GRID)
def test_capacity_matches_jax(n, e, k, cf):
    """Exact: the same expression in the same order of operations, so the
    ceiling lands alike where k * n / e * cf is (or rounds to) an
    integer."""
    assert pmoe.moe_capacity(n, e, k, cf) == jmoe.moe_capacity(n, e, k, cf)
    assert pmoe.moe_capacity(257, 8, 2, 1.25) == 81


def _logits(b, n, e, seed):
    return np.random.default_rng(seed).normal(0, 1.0, (b, n, e)).astype(
        np.float32)


def _tied_rows(e=8):
    """[0.9, then e - 1 equal], all equal, and one of each tie further
    down: ties the top-k must break to the lower index."""
    tail = np.log(0.1 / (e - 1))
    rows = np.array([[np.log(0.9)] + [tail] * (e - 1),
                     [0.0] * e,
                     [1.0, 2.0, 2.0, 0.5, 2.0, 0.0, 1.0, 1.0][:e]],
                    np.float32)
    return rows


@pytest.mark.parametrize("top_k,capacity", [(2, 81), (2, 3), (1, 2), (3, 5)])
def test_routing_matches_jax(top_k, capacity):
    """combine's support (every token's experts and slots) exactly, its
    values and the aux loss within 1e-6 (the two softmaxes round apart in
    the last bit), on random rows and on tied ones. Small capacities drop
    tokens in every round."""
    logits = _logits(3, 40, 8, seed=top_k * 10 + capacity)
    logits[0, :3] = _tied_rows()
    logits[1, 5:8] = _tied_rows()
    pc, paux = pmoe.moe_routing(torch.from_numpy(logits), top_k, capacity)
    jc, jaux = jmoe.moe_routing(jnp.asarray(logits), top_k, capacity)
    jc = np.asarray(jc)
    np.testing.assert_array_equal(pc.numpy() > 0, jc > 0)
    assert np.abs(pc.numpy() - jc).max() <= 1e-6
    assert abs(float(paux) - float(jaux)) <= 1e-6
    if capacity >= 40 * top_k:  # nothing dropped: gates sum to 1
        np.testing.assert_allclose(pc.sum(dim=(2, 3)).numpy(), 1.0,
                                   atol=1e-6)


def test_tied_rows_choose_the_lower_index():
    """jax.lax.top_k's order at ties: [0.9, seven equal] picks experts
    (0, 1) and all-equal picks (0, 1); `torch.topk` gives another pair
    there, the port's choice does not."""
    logits = torch.from_numpy(_tied_rows()[None])
    combine, _ = pmoe.moe_routing(logits, 2, 8)
    jc, _ = jmoe.moe_routing(jnp.asarray(logits.numpy()), 2, 8)
    chosen = (combine.sum(-1) > 0)[0]
    assert torch.nonzero(chosen[0]).ravel().tolist() == [0, 1]
    assert torch.nonzero(chosen[1]).ravel().tolist() == [0, 1]
    assert torch.nonzero(chosen[2]).ravel().tolist() == [1, 2]
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(jc)[0].sum(-1) > 0)


def test_forced_router_drops_tokens_past_capacity():
    """Every token forced onto expert 0 with 2 slots (JAX's own test):
    tokens 0 and 1 get the FFN, the others exactly 0, in both frameworks;
    the outputs agree within 1e-5."""
    d, m, e, n = 4, 8, 2, 6
    mp = _expert_params(np.random.default_rng(4), d, m, e)
    mp["router_kernel"] = np.zeros((d, e))
    mp["router_kernel"][:, 0] = 100.0
    x = (np.ones((1, n, d)) + np.arange(n)[None, :, None] * 0.1).astype(
        np.float32)
    cf = 2 * e / n
    assert pmoe.moe_capacity(n, e, 1, cf) == 2
    pp, jp = _as(mp)
    out, _ = pmoe.moe_ffn(torch.from_numpy(x), pp, top_k=1,
                          capacity_factor=cf, activation=_gelu)
    ref, _ = jmoe.moe_ffn(jnp.asarray(x), jp, top_k=1, capacity_factor=cf,
                          activation=lambda h: jax.nn.gelu(h,
                                                           approximate=True))
    assert out[0, :2].abs().sum() > 0
    assert not out[0, 2:].any()
    assert _err(out, ref) <= OP_TOL


def test_aux_loss_balanced_and_collapsed():
    """A uniform router gives 1 and a collapsed one E (to 1e-6 and 1e-4,
    as JAX's test holds them), in both frameworks."""
    b, n, e = 2, 16, 4
    uniform = np.zeros((b, n, e), np.float32)
    collapsed = np.full((b, n, e), -50.0, np.float32)
    collapsed[..., 0] = 50.0
    for logits, want, tol in ((uniform, 1.0, 1e-6), (collapsed, e, 1e-4)):
        _, paux = pmoe.moe_routing(torch.from_numpy(logits), 1, n)
        _, jaux = jmoe.moe_routing(jnp.asarray(logits), 1, n)
        assert abs(float(paux) - want) <= tol
        assert abs(float(paux) - float(jaux)) <= 1e-6


# ---- the FFN -----------------------------------------------------------------


@pytest.mark.parametrize("cf", [1.25, 0.5, 4.0])
def test_moe_ffn_fp32_matches_jax_and_the_plain_oracle(cf):
    """fp32 against JAX and against the per-token oracle: output 1e-5,
    aux 1e-6. cf 0.5 drops tokens, 4.0 none."""
    d, m, e, k = 16, 32, 4, 2
    mp = _expert_params(np.random.default_rng(1), d, m, e)
    x = np.random.default_rng(2).normal(size=(2, 17, d)).astype(np.float32)
    pp, jp = _as(mp)
    kw = dict(top_k=k, capacity_factor=cf)
    out, aux = pmoe.moe_ffn(torch.from_numpy(x), pp, activation=_gelu, **kw)
    ref, jaux = jmoe.moe_ffn(jnp.asarray(x), jp, activation=lambda h:
                             jax.nn.gelu(h, approximate=True), **kw)
    plain, paux = pmoe.moe_ffn_plain(torch.from_numpy(x), pp,
                                     activation=_gelu, **kw)
    assert _err(out, ref) <= OP_TOL
    assert _err(out, plain) <= OP_TOL
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert abs(float(aux) - float(paux)) <= 1e-6


def test_moe_ffn_bf16_matches_jax_bf16():
    """bf16 activations and fp32 weights: the router product in bf16 (so
    both frameworks route on the same bf16 logits: the support of the
    routing is compared exactly through the output's zero rows under a
    tight capacity), the expert GEMMs in bf16. Output within 2 bf16 ulps
    of its scale (2^-6 relative to its largest value); aux within 1e-6."""
    d, m, e, k = 32, 64, 4, 2
    mp = _expert_params(np.random.default_rng(3), d, m, e, scale=0.2)
    x = np.random.default_rng(5).normal(size=(2, 17, d)).astype(np.float32)
    pp, jp = _as(mp)
    xb = torch.from_numpy(x).bfloat16()
    xj = jnp.asarray(x, jnp.bfloat16)
    kw = dict(top_k=k, capacity_factor=0.75)
    out, aux = pmoe.moe_ffn(xb, pp, activation=_gelu, **kw)
    ref, jaux = jax.jit(lambda a, p: jmoe.moe_ffn(
        a, p, activation=lambda h: jax.nn.gelu(h, approximate=True),
        **kw))(xj, jp)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    np.testing.assert_array_equal(_np(out) == 0, ref == 0)
    assert _err(out, ref) <= 2 ** -6 * np.abs(ref).max()
    assert abs(float(aux) - float(jaux)) <= 1e-6
    # Routing in fp32 throughout would not be the JAX function.
    out32, _ = pmoe.moe_ffn(xb.float(), pp, activation=_gelu, **kw)
    assert _err(out32, ref) > 0


# ---- the backbone and the detector -----------------------------------------


@pytest.mark.parametrize("layout", ["split", "full_depth"])
def test_backbone_forward_and_aux_match_jax(layout):
    """The split layout (1 dense prefix block + 2 MoE blocks) and
    full-depth MoE (no "blocks"): features within 1e-4, moe_aux within
    1e-5; for the split layout the detector's outputs too."""
    extra = {"lora_last_n_blocks": 3} if layout == "full_depth" else {}
    jc, pc = _cfgs(**extra)
    tree = _tree(**extra)
    assert ("blocks" in tree["backbone"]) == (layout == "split")
    assert tree["backbone"]["moe_blocks"]["moe"]["fc1_kernel"].shape[:2] == (
        2 if layout == "split" else 3, 4)
    x = _images()
    jf, jaux = jax.jit(lambda p, im: jax_backbone_apply(p, jc.backbone, im))(
        _jt(tree["backbone"]), jnp.asarray(x))
    params = params_from_numpy(tree, device="cpu")
    with torch.no_grad():
        pf, paux = backbone_apply(params["backbone"], pc.backbone,
                                  torch.from_numpy(x))
    assert _err(pf, jf) <= MODEL_TOL
    assert abs(float(paux) - float(jaux)) <= 1e-5
    assert paux.dtype == torch.float32
    if layout == "full_depth":
        return
    with torch.no_grad():
        out = detector_apply(params, pc, torch.from_numpy(x))
    ref = jax.jit(lambda p, im: jax_detector_apply(p, jc, im))(
        _jt(tree), jnp.asarray(x))
    for key in ("pred_logits", "pred_boxes"):
        assert _err(out[key], ref[key]) <= MODEL_TOL, key
    assert abs(float(out["moe_aux"]) - float(ref["moe_aux"])) <= 1e-5


def test_port_init_has_the_jax_tree():
    """The port's own init draws the JAX tree's keys and shapes, in both
    layouts."""
    for extra in ({}, {"lora_last_n_blocks": 3}):
        jc, pc = _cfgs(**extra)
        want = {k: v.shape for k, v in _flat(_tree(**extra)).items()}
        got = init_detector_params(torch.Generator().manual_seed(0), pc,
                                   device="cpu")
        assert {k: tuple(v.shape) for k, v in _flat(got).items()} == want


def test_masks_fold_and_cast_match_jax():
    """trainable_mask and lora_block_multiplier leaf for leaf (the
    multiplier broadcast to its leaf); fold_detector_lora's tree within
    1e-6; cast_frozen_weights' dtypes exactly and its values within a
    bf16 rounding of 0 (the same cast)."""
    jc, pc = _cfgs()
    tree = _tree()
    params = params_from_numpy(tree, device="cpu")
    jm = _flat(jax.tree_util.tree_map(bool, jax_trainable_mask(_jt(tree),
                                                               jc)))
    pm = _flat(trainable_mask(params, pc))
    assert pm == jm
    assert all(pm[k] for k in pm if ".moe." in k)
    jmult = _flat(jax.tree_util.tree_map(np.asarray,
                                         jax_lora_mult(_jt(tree), jc)))
    pmult = _flat(lora_block_multiplier(params, pc))
    flat = _flat(tree)
    for k, leaf in flat.items():
        np.testing.assert_array_equal(
            np.broadcast_to(_np(torch.as_tensor(pmult[k])), leaf.shape),
            np.broadcast_to(jmult[k], leaf.shape), err_msg=k)
    jf = _flat(jax.tree_util.tree_map(np.asarray, jax_fold(_jt(tree), jc)))
    pf = _flat(params_to_numpy(fold_detector_lora(params, pc)))
    assert set(pf) == set(jf)
    for k in jf:
        assert np.abs(pf[k] - jf[k]).max() <= 1e-6, k
    assert not pf["backbone.blocks.q.lora_B"].any()
    jcast = _flat(jax_cast(_jt(tree), jc))
    pcast = _flat(cast_frozen_weights(params, pc))
    for k, v in jcast.items():
        assert str(pcast[k].dtype).split(".")[-1] == v.dtype.name, k
        np.testing.assert_array_equal(_np(pcast[k]), np.asarray(v, np.float32))
    assert pcast["backbone.moe_blocks.q.kernel"].dtype == torch.bfloat16
    assert pcast["backbone.moe_blocks.moe.fc1_kernel"].dtype == torch.float32


def test_quantize_detector_int8_matches_jax(monkeypatch):
    """The folded MoE tree quantized, against JAX's quantize_detector_int8
    with its per-linear quantizer jitted (the formula the port computes,
    test_torch_quantize.py): every leaf's dtype and value exactly. The
    dense prefix gets its six linears in int8, the MoE blocks q, k, v and
    proj; experts and routers stay fp32. An unfolded tree raises."""
    jc, pc = _cfgs()
    tree = _tree()
    jfold = jax_fold(_jt(tree), jc)
    monkeypatch.setattr(jq, "quantize_linear", jax.jit(jq.quantize_linear))
    jqt = _flat(jax.tree_util.tree_map(
        np.asarray, jq.quantize_detector_int8(jfold, jc)))
    params = params_from_numpy(tree, device="cpu")
    q = quantize_detector_int8(fold_detector_lora(params, pc), pc)
    pqt = _flat(q)
    assert set(pqt) == set(jqt)
    for k, v in jqt.items():
        assert str(pqt[k].dtype).split(".")[-1] == v.dtype.name, k
        np.testing.assert_array_equal(pqt[k].numpy(), v, err_msg=k)
    moe_blocks = q["backbone"]["moe_blocks"]
    assert all("kernel_q" in moe_blocks[n] for n in ("q", "k", "v", "proj"))
    assert moe_blocks["moe"]["fc1_kernel"].dtype == torch.float32
    assert "kernel_q" in q["backbone"]["blocks"]["fc2"]
    with pytest.raises(ValueError, match="unfolded LoRA"):
        quantize_detector_int8(params, pc)
    x = _images()
    with torch.no_grad():
        out = detector_apply(q, pc, torch.from_numpy(x))
    assert torch.isfinite(out["pred_logits"]).all()
    assert torch.isfinite(out["moe_aux"])


def test_prefix_int8_composes_with_moe():
    """prefix_int8 quantizes the dense prefix inside the forward, as JAX
    does: the detector within test_torch_quantize.py's int8 limits of the
    jitted JAX forward (2e-3 logits, 5e-4 boxes: a code in the prefix can
    round to the other integer in the two frameworks), moe_aux within
    1e-4, and off the float forward."""
    jc, pc = _cfgs(prefix_int8=True)
    _, pc_float = _cfgs()
    tree = _tree()
    x = _images(seed=8)
    ref = jax.jit(lambda p, im: jax_detector_apply(p, jc, im))(
        _jt(tree), jnp.asarray(x))
    params = params_from_numpy(tree, device="cpu")
    with torch.no_grad():
        out = detector_apply(params, pc, torch.from_numpy(x))
        plain = detector_apply(params, pc_float, torch.from_numpy(x))
    for key, tol in (("pred_logits", 2e-3), ("pred_boxes", 5e-4)):
        assert _err(out[key], ref[key]) <= tol, key
    assert abs(float(out["moe_aux"]) - float(ref["moe_aux"])) <= 1e-4
    assert _err(out["pred_logits"], plain["pred_logits"]) > 1e-4


# ---- the train step ----------------------------------------------------------


TRAIN_DATA = dict(batch_size=2, max_boxes=6)
LR = 3e-4


def _train_cfgs(**train):
    jc, pc = _cfgs()
    return (jcfg.TrainConfig(detector=jc, data=jcfg.DataConfig(**TRAIN_DATA),
                             optim=jcfg.OptimConfig(learning_rate=LR)),
            pcfg.TrainConfig(detector=pc, data=pcfg.DataConfig(**TRAIN_DATA),
                             optim=pcfg.OptimConfig(learning_rate=LR),
                             **train))


@pytest.fixture(scope="module")
def jax_step():
    """One JAX make_train_step from the shared tree and batch, and the
    masked gradients of its loss (the criterion plus moe_aux_weight times
    the aux; dropout is 0, so train mode is the eval forward)."""
    from dinov2_od_tpu.ops.losses import set_criterion as jax_criterion

    jt, _ = _train_cfgs()
    jc = jt.detector
    tree = _tree()
    batch = make_batch(np.random.default_rng(0), 2, image_size=56,
                       max_boxes=6)
    jb = _jt(batch)

    def jloss(p):
        p = jstate.stop_gradient_frozen(p, jc)
        out = jax_detector_apply(p, jc, jb["images"])
        losses = jax_criterion(
            out["pred_logits"], out["pred_boxes"], jb["labels"], jb["boxes"],
            jb["valid"], matcher_cfg=jt.matcher, loss_cfg=jt.loss,
            num_classes=jc.decoder.num_classes)
        return losses["loss"] + jc.backbone.moe_aux_weight * out["moe_aux"]

    jparams = _jt(tree)
    grads = jstate.mask_gradients(jax.jit(jax.grad(jloss))(jparams),
                                  jparams, jc)
    tx = jstate.make_optimizer(jt.optim, jc, jparams)
    new, metrics = jax_make_train_step(jt, tx)(
        jstate.create_train_state(jparams, jt.optim, jc), jb,
        jax.random.key(1))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"batch": batch, "grads": _flat(to_np(grads)),
            "metrics": to_np(metrics), "params": _flat(to_np(new.params))}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_one_train_step_matches_jax(jax_step):
    """One make_train_step each from the same params and batch: the loss
    terms, loss_moe_aux and grad_norm within 1e-5; every router and expert
    leaf (and every other trainable leaf) updated to within 2e-7 of JAX
    where its gradient is clearly above noise (over 1e-2 of its leaf's
    largest and over 1e-6), so the clip and masked Adam cover them; frozen
    leaves and the dense prefix's LoRA factors unchanged in both."""
    _, pt = _train_cfgs()
    tree = _tree()
    state = pstate.create_train_state(params_from_numpy(tree, device="cpu"),
                                      pt.optim, pt.detector)
    state, metrics = make_train_step(pt)(state,
                                         _torch_batch(jax_step["batch"]))
    ref = jax_step["metrics"]
    for key in ("loss", "loss_ce", "loss_bbox", "loss_giou",
                "loss_moe_aux", "grad_norm"):
        assert _rel(ref[key], metrics[key]) <= LOSS_TOL, key
    new = _flat(params_to_numpy(state.params))
    before = _flat(tree)
    grads = jax_step["grads"]
    moved = {}
    for k, v in jax_step["params"].items():
        g = np.abs(grads[k])
        if not g.any():  # frozen, or the prefix's LoRA rows
            assert np.array_equal(new[k], before[k]), k
            assert np.array_equal(v, before[k]), k
            continue
        clear = (g > 1e-2 * g.max()) & (g > 1e-6)
        moved[k] = int(clear.sum())
        assert np.abs(new[k] - v)[clear].max(initial=0.0) <= PARAM_TOL, k
    moe = {k: n for k, n in moved.items() if ".moe." in k}
    assert len(moe) == 5 and all(moe.values()), moe
    assert "backbone.blocks.q.lora_B" not in moved


@pytest.mark.parametrize("remat", [False, True])
def test_router_and_expert_gradients_match_jax(jax_step, remat):
    """The train loss's masked gradients of the MoE blocks' leaves (router,
    experts and their LoRA factors), each within 1e-4 of its leaf's
    largest JAX gradient; under remat the port's equal its own without
    remat bit for bit."""
    _, pt = _train_cfgs(use_remat=remat)
    from dinov2_od_tpu_torch.train.step import train_grads

    def port_grads(cfg):
        state = pstate.create_train_state(
            params_from_numpy(_tree(), device="cpu"), cfg.optim,
            cfg.detector)
        _, grads = train_grads(cfg, state, _torch_batch(jax_step["batch"]))
        return {k: v for k, v in _flat(grads).items()
                if k.startswith("backbone.moe_blocks.")}

    got = port_grads(pt)
    assert len(got) == 5 + 4 * 2  # router, 4 expert leaves; q/k/v/proj LoRA
    ref = jax_step["grads"]
    for k, g in got.items():
        assert _rel(ref[k], g) <= GRAD_TOL, (k, _rel(ref[k], g))
        assert g.abs().sum() > 0, k
    if remat:
        plain = port_grads(dataclasses.replace(pt, use_remat=False))
        for k, g in got.items():
            assert torch.equal(g, plain[k]), k


# ---- what is left for expert parallelism -----------------------------------


def test_moe_under_a_mesh_or_the_ring_raises():
    """Expert parallelism is ROADMAP.md Queue A item 7: MoE under a mesh
    (the backbone, the train step) or ring attention raises and names
    it."""
    _, pc = _cfgs()
    params = init_detector_params(torch.Generator().manual_seed(0), pc,
                                  device="cpu")
    mesh = Mesh(data_size=1, model_size=2, data_index=0, model_index=0,
                data_group=None, model_group=None, backend="gloo")
    x = torch.from_numpy(_images())
    with pytest.raises(NotImplementedError, match="item 7"):
        backbone_apply(params["backbone"], pc.backbone, x, mesh=mesh)
    with pytest.raises(NotImplementedError, match="item 7"):
        detector_apply(params, pc, x, attn_impl="ring", seq_axis="model")
    cfg = pcfg.TrainConfig(detector=pc,
                           mesh=pcfg.MeshConfig(model_parallel_size=2))
    with pytest.raises(NotImplementedError, match="item 7"):
        make_train_step(cfg, mesh)
    with pytest.raises(ValueError, match="lora_last_n_blocks > 0"):
        init_detector_params(torch.Generator(), dataclasses.replace(
            pc, backbone=dataclasses.replace(pc.backbone,
                                             lora_last_n_blocks=0)),
            device="cpu")


def test_recipe_moe_arm_builds_the_recorded_runs_config():
    """`tools/synthetic_recipes.py --arms moe` passes the CLI the flags
    whose detector config is the one the JAX run logged
    (runs/synthetic5k_moe60, line 3 of its log: moe_num_experts=8, the
    CLI's default), field for field where both packages have the field."""
    import glob
    import re

    from dinov2_od_tpu_torch.tools import synthetic_recipes as recipes
    from dinov2_od_tpu_torch.train import cli

    assert recipes.REFERENCE["moe"] == "runs/synthetic5k_moe60"
    log = glob.glob(str(recipes.REPO / recipes.REFERENCE["moe"] / "*.log"))
    with open(log[0]) as f:
        line = f.read().splitlines()[2]
    logged = eval(re.search(r"detector config: (DetectorConfig\(.*\))$",
                            line).group(1), vars(jcfg))
    ours = cli.build_detector_config(cli.build_arg_parser().parse_args(
        recipes.RECIPE + recipes.ARMS["moe"]))
    for part in ("backbone", "decoder"):
        mine, theirs = getattr(ours, part), getattr(logged, part)
        shared = [f.name for f in dataclasses.fields(mine)
                  if hasattr(theirs, f.name)]
        assert len(shared) > 10
        for name in shared:
            assert getattr(mine, name) == getattr(theirs, name), name
    assert ours.backbone.moe_num_experts == 8
