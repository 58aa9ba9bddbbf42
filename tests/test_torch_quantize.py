"""The port's int8 W8A8 path (dinov2_od_tpu_torch/models/quantize.py and
ops/int8_gemm.py) against the JAX package, on the CPU at a tiny size.

The JAX package runs activation quantization (and the frozen prefix's
weight quantization) inside `jit`, where XLA turns the division by 127
into a multiply by fp32(1/127) and contracts the epilogue into an fma;
the port computes exactly that, so each function is compared with JAX
run the way the JAX package runs it: jitted, or eagerly where the JAX
package quantizes eagerly (the serving weights in `Predictor.__init__`).
The fused kernel's plain version is compared with the Pallas kernel in
interpret mode. The `gpu`-marked test holds the CUDA kernel against its
plain version on the card and skips without one."""

import dataclasses

import numpy as np
import pytest
import torch

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.models import quantize as pq
from dinov2_od_tpu_torch.models.detector import detector_apply
from dinov2_od_tpu_torch.ops import _build
from dinov2_od_tpu_torch.ops import int8_gemm as pg
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy

BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=3, lora_r=2,
                lora_last_n_blocks=1, target_dim=64)
DECODER = dict(hidden_dim=64, num_queries=5, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=6, n_points=2, dropout=0.0)
# The fused kernel's shapes in the JAX package's own test
# (tests/test_quantize.py): wide K, a ragged M, the K = 4096 branch.
FUSED_SHAPES = [(64, 2048, 256), (61, 2048, 256), (64, 4096, 1536)]
# The whole detector with the same int8 tree, port against jitted JAX,
# max abs error. The int8 GEMMs are exact, but their inputs come out of
# two frameworks' LayerNorms, attention and GELUs, which sum in other
# orders: a token's code then rounds to the neighbouring integer now and
# then, one step of that token's scale (1/127 of its largest activation).
# fp32: those flips move logits by ~1e-5 of their scale; bf16: the bf16
# activations themselves drift by bf16 ulps through 3 blocks.
DET_TOL = {"float32": {"pred_logits": 2e-3, "pred_boxes": 5e-4},
           "bfloat16": {"pred_logits": 0.1, "pred_boxes": 0.02}}


@pytest.fixture(scope="module")
def jax_mods():
    """JAX and the JAX package, imported by the tests that compare with
    them only, so the card-only test runs where JAX is not installed
    (`pytest --noconftest ... -m gpu`)."""
    import jax
    import jax.numpy as jnp

    from dinov2_od_tpu import config as jcfg
    from dinov2_od_tpu.models import quantize as jq
    from dinov2_od_tpu.models.detector import (
        detector_apply as jax_detector_apply,
        fold_detector_lora as jax_fold,
        init_detector_params as jax_init,
    )

    return dict(jax=jax, jnp=jnp, jcfg=jcfg, jq=jq,
                detector_apply=jax_detector_apply, fold=jax_fold,
                init=jax_init)


def _cfgs(jm, dtype="float32", **backbone):
    bk = {**BACKBONE, "dtype": dtype, **backbone}
    jcfg = jm["jcfg"]
    return (
        jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**bk),
                            decoder=jcfg.DecoderConfig(**DECODER)),
        pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**bk),
                            decoder=pcfg.DecoderConfig(**DECODER)),
    )


@pytest.fixture(scope="module")
def tree(jax_mods):
    """The JAX init as numpy, with nonzero LoRA B (folding is then not a
    no-op, and every LoRA leaf of the adapted block has a gradient)."""
    jax = jax_mods["jax"]
    jc, _ = _cfgs(jax_mods)
    t = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                               jax_mods["init"](jax.random.key(0), jc))
    rng = np.random.default_rng(0)
    for lin in t["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = rng.normal(0, 0.05, lin["lora_B"].shape).astype(
                np.float32)
    return t


@pytest.fixture(scope="module")
def jax_int8_tree(jax_mods, tree):
    """Folded, then quantized eagerly, as the JAX Predictor does."""
    jm = jax_mods
    jc, _ = _cfgs(jm)
    params = jm["jax"].tree_util.tree_map(jm["jnp"].asarray, tree)
    q = jm["jq"].quantize_detector_int8(jm["fold"](params, jc), jc)
    return jm["jax"].tree_util.tree_map(np.asarray, q)


def _images(n=2, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, 56, 56, 3)).astype(np.float32)


def _f32(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _max_err(a, b):
    return float(np.abs(_f32(a) - _f32(b)).max())


# ---- quantization ----------------------------------------------------------


def test_quantize_linear_matches_jax_on_stacked_leaves(jax_mods):
    """Stacked [depth, in, out] kernels. Against jitted JAX (the prefix of
    a train step): codes and scales bit-identical. Against eager JAX (the
    serving weights): XLA divides there, so a scale may differ by one
    fp32 ulp (a few channels in a hundred), and a code by one where it
    falls on a rounding tie of the other scale."""
    jm = jax_mods
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 96, 160)).astype(np.float32)
    b = rng.normal(size=(3, 160)).astype(np.float32)
    got = pq.quantize_linear({"kernel": torch.from_numpy(w),
                              "bias": torch.from_numpy(b)})
    assert got["kernel_q"].dtype == torch.int8
    assert got["w_scale"].dtype == torch.float32
    assert got["w_scale"].shape == (3, 160)
    assert set(got) == {"kernel_q", "w_scale", "bias"}
    jp = {"kernel": jm["jnp"].asarray(w), "bias": jm["jnp"].asarray(b)}
    jit = jm["jax"].jit(jm["jq"].quantize_linear)(jp)
    np.testing.assert_array_equal(got["kernel_q"].numpy(),
                                  np.asarray(jit["kernel_q"]))
    np.testing.assert_array_equal(got["w_scale"].numpy(),
                                  np.asarray(jit["w_scale"]))
    eager = jm["jq"].quantize_linear(jp)
    ws, ws_e = got["w_scale"].numpy(), np.asarray(eager["w_scale"])
    assert np.all(np.abs(ws - ws_e) <= np.spacing(ws_e))
    dq = np.abs(got["kernel_q"].numpy().astype(np.int32)
                - np.asarray(eager["kernel_q"], np.int32))
    assert dq.max() <= 1
    assert not dq[np.broadcast_to((ws == ws_e)[:, None, :], dq.shape)].any()


def test_int8_kernels_are_stored_for_the_gemm_that_reads_them():
    """Every kernel_q is stored K-major: below K = 2048 for cuBLASLt's s8
    GEMM, from K = 2048 for the fused kernel's wgmma, which reads s8
    operands K-major only. The same values and shapes as the JAX tree."""
    rng = np.random.default_rng(10)
    for k in (768, 2048):
        w = torch.from_numpy(rng.normal(size=(2, k, 256)).astype(np.float32))
        q = pq.quantize_linear({"kernel": w, "bias": torch.zeros(2, 256)})
        kq = q["kernel_q"]
        assert kq.shape == (2, k, 256)
        assert kq.stride()[-2:] == (1, k)
        assert kq[1].stride() == (1, k)
        codes = torch.clamp(torch.round(w / q["w_scale"][:, None, :]), -127,
                            127)
        assert torch.equal(kq.float(), codes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_acts_matches_jitted_jax(jax_mods, dtype):
    jm = jax_mods
    x = np.random.default_rng(2).normal(size=(2, 37, 96)).astype(np.float32)
    x[0, 3] = 0.0  # an all-zero token takes the eps scale
    codes, scale = pg.quantize_acts(torch.from_numpy(x).to(
        getattr(torch, dtype)))
    jc, js = jm["jax"].jit(jm["jq"]._quantize_acts)(
        jm["jnp"].asarray(x, dtype))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    assert scale[0, 3].item() == np.float32(1e-8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FUSED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_fused_matches_jax_kernel(jax_mods, dtype, shape):
    """The plain B6 against the Pallas kernel in interpret mode:
    bit-identical."""
    from dinov2_od_tpu.ops.int8_gemm import (
        fused_int8_linear as jax_fused, int8_gemm_eligible as jax_eligible)

    jm = jax_mods
    m, k, n = shape
    assert pg.int8_gemm_eligible(m, k, n) and jax_eligible(m, k, n)
    rng = np.random.default_rng(3)
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    qp = jm["jax"].jit(jm["jq"].quantize_linear)(
        {"kernel": jm["jnp"].asarray(w), "bias": jm["jnp"].asarray(b)})
    ref = jax_fused(jm["jnp"].asarray(x, dtype), qp, interpret=True)
    tp = {key: torch.from_numpy(np.array(v)) for key, v in qp.items()}
    out = pg.fused_int8_linear(torch.from_numpy(x).to(getattr(torch, dtype)),
                               tp)
    assert out.dtype == getattr(torch, dtype) and out.shape == (m, n)
    np.testing.assert_array_equal(_f32(out), _f32(ref))


def test_eligibility_matches_jax():
    from dinov2_od_tpu.ops.int8_gemm import int8_gemm_eligible as jax_eligible

    for m in (1, 61, 8224):
        for k in (768, 1000, 2048, 3072, 4096, 4224):
            for n in (256, 768, 1000, 2304):
                assert pg.int8_gemm_eligible(m, k, n) == jax_eligible(m, k, n)
    pg.set_fused_enabled(False)
    try:
        assert not pg.int8_gemm_eligible(64, 2048, 256)
    finally:
        pg.set_fused_enabled(True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [96, 2048])
def test_int8_linear_matches_jitted_jax(jax_mods, dtype, k):
    """The unfused path (and, at K = 2048 on the CPU, the same one: the
    fused kernel is for the card) with leading dims: bit-identical."""
    jm = jax_mods
    rng = np.random.default_rng(4)
    n = 160
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    x = rng.normal(size=(2, 19, k)).astype(np.float32)
    qp = jm["jax"].jit(jm["jq"].quantize_linear)(
        {"kernel": jm["jnp"].asarray(w), "bias": jm["jnp"].asarray(b)})
    ref = jm["jax"].jit(jm["jq"].int8_linear)(jm["jnp"].asarray(x, dtype), qp)
    tp = {key: torch.from_numpy(np.array(v)) for key, v in qp.items()}
    _build.reset_launch_counts()
    out = pq.int8_linear(torch.from_numpy(x).to(getattr(torch, dtype)), tp)
    assert not any(_build.launch_counts.values())
    assert out.dtype == getattr(torch, dtype) and out.shape == (2, 19, n)
    np.testing.assert_array_equal(_f32(out), _f32(ref))


def test_straight_through_gradients_match_jax(jax_mods):
    """dx through the dequantized weight in fp32 and the exact db, against
    jax.grad of the JAX custom_vjp; no gradient reaches kernel_q or
    w_scale."""
    jm = jax_mods
    jax, jnp = jm["jax"], jm["jnp"]
    rng = np.random.default_rng(5)
    w = rng.normal(size=(32, 48)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    x = rng.normal(size=(3, 8, 32)).astype(np.float32)
    dy = rng.normal(size=(3, 8, 48)).astype(np.float32)
    qp = jm["jq"].quantize_linear({"kernel": jnp.asarray(w),
                                   "bias": jnp.asarray(b)})

    def jloss(xx, bb):
        y = jm["jq"].int8_linear(xx, {**qp, "bias": bb})
        return jnp.sum(y * jnp.asarray(dy))

    jdx, jdb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), qp["bias"])
    tp = {key: torch.from_numpy(np.array(v)) for key, v in qp.items()}
    tp["bias"] = tp["bias"].clone().requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    (pq.int8_linear(tx, tp) * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp["bias"].grad.numpy(), np.asarray(jdb),
                               rtol=1e-6, atol=1e-5)
    assert np.abs(tx.grad.numpy()).max() > 0
    assert tp["kernel_q"].grad is None and tp["w_scale"].grad is None


def test_int8_qkv_matches_jax_and_unfolded_lora_raises(jax_mods, tree):
    jm = jax_mods
    jc, pc = _cfgs(jm)
    jparams = jm["jax"].tree_util.tree_map(jm["jnp"].asarray, tree)
    with pytest.raises(ValueError, match="fold_detector_lora"):
        jm["jq"].quantize_detector_int8(jparams, jc)
    with pytest.raises(ValueError, match="call fold_detector_lora before "
                                         "quantizing"):
        pq.quantize_detector_int8(params_from_numpy(tree, device="cpu"), pc)
    bp = {name: {key: v[1] for key, v in lin.items()}
          for name, lin in tree["backbone"]["blocks"].items()
          if name in ("q", "k", "v")}
    jbp = {name: jm["jq"].quantize_linear(
        {"kernel": jm["jnp"].asarray(p["kernel"]),
         "bias": jm["jnp"].asarray(p["bias"])}) for name, p in bp.items()}
    x = np.random.default_rng(6).normal(size=(2, 17, 128)).astype(np.float32)
    ref = jm["jax"].jit(jm["jq"].int8_qkv)(jm["jnp"].asarray(x), jbp)
    tbp = {name: {key: torch.from_numpy(np.array(v)) for key, v in p.items()}
           for name, p in jbp.items()}
    out = pq.int8_qkv(torch.from_numpy(x), tbp)
    assert out.shape == (2, 17, 3 * 128)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def test_int8_tree_bridges_leaf_by_leaf(jax_int8_tree):
    """A JAX-quantized tree crosses with every leaf's dtype and value kept,
    and comes back unchanged; the port's quantizer gives the same tree
    shape from the same folded params."""
    flat = _flat(jax_int8_tree)
    params = params_from_numpy(jax_int8_tree, device="cpu")
    pflat = _flat(params)
    assert set(pflat) == set(flat)
    for key, arr in flat.items():
        t = pflat[key]
        assert str(t.dtype).split(".")[-1] == arr.dtype.name, key
        np.testing.assert_array_equal(t.numpy(), arr)
    back = _flat(params_to_numpy(params))
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype
        np.testing.assert_array_equal(back[key], arr)
    blocks = params["backbone"]["blocks"]
    for name in ("q", "k", "v", "proj", "fc1", "fc2"):
        assert blocks[name]["kernel_q"].dtype == torch.int8
        assert "lora_A" not in blocks[name]
    assert "kernel" in params["backbone"]["patch_embed"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_detector_apply_int8_matches_jax(jax_mods, jax_int8_tree, dtype):
    """detector_apply on one JAX-quantized tree, port against jitted JAX
    (DET_TOL says why not bit for bit)."""
    jm = jax_mods
    jax = jm["jax"]
    jc, pc = _cfgs(jm, dtype)
    x = _images()
    ref = jax.jit(lambda p, im: jm["detector_apply"](
        p, jc, im, deterministic=True))(
        jax.tree_util.tree_map(jm["jnp"].asarray, jax_int8_tree),
        jm["jnp"].asarray(x))
    with torch.inference_mode():
        out = detector_apply(params_from_numpy(jax_int8_tree, device="cpu"),
                             pc, torch.from_numpy(x))
    for key, tol in DET_TOL[dtype].items():
        assert out[key].dtype == torch.float32
        err = _max_err(out[key], ref[key])
        assert err <= tol, (key, err)


def test_predictor_int8_matches_jax(jax_mods, tree):
    """Predictor(quantize="int8") folds and quantizes itself (the port by
    the jitted formula, the JAX Predictor eagerly): the same top-k score
    sets to 2e-3 (a channel's scale one ulp apart and the code flips of
    DET_TOL), boxes to 0.1 px of a 56 px image. Also the first batch of
    the fp32 Predictor differs from the int8 one by the quantization."""
    from dinov2_od_tpu.inference import Predictor as JaxPredictor

    from dinov2_od_tpu_torch.inference import Predictor

    jm = jax_mods
    jc, pc = _cfgs(jm)
    rng = np.random.default_rng(7)
    images = [rng.uniform(size=(56, 56, 3)).astype(np.float32)
              for _ in range(3)]
    ref = JaxPredictor(jm["jax"].tree_util.tree_map(jm["jnp"].asarray, tree),
                       jc, batch_size=2, quantize="int8").detect(
        images, score_threshold=0.0, max_detections=8)
    pred = Predictor(params_from_numpy(tree, device="cpu"), pc, batch_size=2,
                     quantize="int8", device="cpu")
    assert pred.params["backbone"]["blocks"]["fc2"]["kernel_q"].dtype == \
        torch.int8
    out = pred.detect(images, score_threshold=0.0, max_detections=8)
    assert len(out) == len(ref) == 3
    for got, want in zip(out, ref):
        np.testing.assert_allclose(sorted(d["score"] for d in got),
                                   sorted(d["score"] for d in want),
                                   atol=2e-3)
        for g in got:  # the same (query, class) pair sits near each box
            near = [w for w in want if w["category_id"] == g["category_id"]
                    and abs(w["score"] - g["score"]) <= 2e-3]
            assert any(np.abs(np.subtract(w["bbox"], g["bbox"])).max() <= 0.1
                       for w in near)
    fp = Predictor(params_from_numpy(tree, device="cpu"), pc, batch_size=2,
                   device="cpu").detect(images, score_threshold=0.0,
                                        max_detections=8)
    assert [d["score"] for d in fp[0]] != [d["score"] for d in out[0]]


# ---- the int8 frozen prefix of training ------------------------------------


def _loss_terms(out):
    return (out["pred_logits"] ** 2).sum() + out["pred_boxes"].sum()


@pytest.fixture(scope="module")
def prefix_runs(jax_mods, tree):
    """Forward outputs, the loss and its gradients with prefix_int8, JAX
    (jax.grad of a detector-level loss, jitted) and the port (autograd),
    and the port's forward without prefix_int8."""
    jm = jax_mods
    jax, jnp = jm["jax"], jm["jnp"]
    jc, pc = _cfgs(jm, prefix_int8=True)
    x = _images(seed=8)
    xj = jnp.asarray(x)

    def jloss(p):
        out = jm["detector_apply"](p, jc, xj, deterministic=True)
        return _loss_terms(out), out

    (jl, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    params = params_from_numpy(tree, device="cpu")

    def mark(t, path):
        for key, v in t.items():
            if isinstance(v, dict):
                mark(v, path + (key,))
            elif path[0] == "decoder" or "projection" in path or key in (
                    "lora_A", "lora_B"):
                v.requires_grad_(True)

    mark(params, ())
    out = detector_apply(params, pc, torch.from_numpy(x))
    loss = _loss_terms(out)
    loss.backward()
    _, pc_plain = _cfgs(jm)
    with torch.no_grad():
        plain = detector_apply(params, pc_plain, torch.from_numpy(x))
    return dict(jl=float(jl), jout=jout, jgrad=jgrad, loss=loss.item(),
                out=out, params=params, plain=plain,
                k=pc.backbone.depth - pc.backbone.lora_last_n_blocks)


def test_prefix_int8_forward_and_loss_match_jax(prefix_runs):
    r = prefix_runs
    for key, tol in DET_TOL["float32"].items():
        err = _max_err(r["out"][key], r["jout"][key])
        assert err <= tol, (key, err)
    assert abs(r["loss"] - r["jl"]) <= 1e-4 * max(1.0, abs(r["jl"]))
    # The prefix really ran in int8: the forward moved off the float one.
    assert _max_err(r["out"]["pred_logits"], r["plain"]["pred_logits"]) > 1e-4


def test_prefix_int8_trainable_gradients_match_jax(prefix_runs):
    """Gradients of the adapted block's LoRA rows (each leaf within 5e-3
    of its largest JAX gradient), and of the decoder and the projection
    (each group's relative error in norm within 5e-3); the prefix's LoRA
    rows get none in either framework. Looser than a float train step's
    1e-4: at this seed one activation code of the int8 prefix rounds to
    the other integer in the two frameworks (DET_TOL), which moves every
    token of that image through the next attention; the gradients then
    differ by 2.7e-3 at most (measured)."""
    r = prefix_runs
    k = r["k"]
    blocks = r["params"]["backbone"]["blocks"]
    jblocks = r["jgrad"]["backbone"]["blocks"]
    for name in ("q", "k", "v", "proj", "fc1", "fc2"):
        for f in ("lora_A", "lora_B"):
            g = blocks[name][f].grad.numpy()
            jg = np.asarray(jblocks[name][f])
            assert not g[:k].any() and not jg[:k].any()
            scale = np.abs(jg[k:]).max()
            assert scale > 0
            assert np.abs(g[k:] - jg[k:]).max() <= 5e-3 * scale, (name, f)
    for path in (("decoder",), ("backbone", "projection")):
        t, jt = r["params"], r["jgrad"]
        for p in path:
            t, jt = t[p], jt[p]
        ft, fj = _flat(t), _flat(jt)
        assert len(ft) == len(fj) > 1
        g = np.concatenate([ft[key].grad.numpy().ravel() for key in ft])
        jg = np.concatenate([np.asarray(fj[key]).ravel() for key in ft])
        err = np.linalg.norm(g - jg) / np.linalg.norm(jg)
        assert err <= 5e-3, (path, err)


# ---- dispatch and the kernel on the card ----------------------------------


def test_cpu_takes_plain_versions_and_counts_nothing():
    rng = np.random.default_rng(9)
    qp = pq.quantize_linear({
        "kernel": torch.from_numpy(rng.normal(size=(2048, 256)).astype(
            np.float32)),
        "bias": torch.zeros(256)})
    x = torch.from_numpy(rng.normal(size=(3, 7, 2048)).astype(np.float32))
    _build.reset_launch_counts()
    fused = pg.fused_int8_linear(x, qp)
    assert torch.equal(fused, pg.fused_int8_linear_plain(x, qp))
    assert torch.equal(fused, pq.int8_linear(x, qp))
    assert _build.launch_counts == {name: 0 for name in _build.SOURCES}
    with pytest.raises(TypeError):
        pg.fused_int8_linear(x.half(), qp)
    with pytest.raises(ValueError):
        pg.fused_int8_linear(x[..., :1024], qp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(8224, 3072, 768), (8219, 3072, 768),
                                   (61, 2048, 256), (600, 4096, 1024)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_card(dtype, shape):
    """The CUDA kernel against its plain version on the card: codes and
    int32 sums are exact and both epilogues are one fma, so within one
    ulp of the output dtype (chip_smoke.py INT8_TOL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m, k, n = shape
    gen = torch.Generator().manual_seed(0)
    qp = pq.quantize_linear({"kernel": torch.randn((k, n), generator=gen),
                             "bias": torch.randn((n,), generator=gen)})
    qp = {key: v.cuda() for key, v in qp.items()}
    x = torch.randn((m, k), generator=gen).to("cuda", getattr(torch, dtype))
    before = _build.launch_counts["int8_gemm"]
    out = pg.fused_int8_linear(x, qp)
    ref = pg.fused_int8_linear_plain(x, qp)
    torch.cuda.synchronize()
    assert _build.launch_counts["int8_gemm"] == before + 1
    ulp = torch.finfo(out.dtype).eps * ref.float().abs().clamp_min(1.0)
    assert bool(((out.float() - ref.float()).abs() <= ulp).all())
