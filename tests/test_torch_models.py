"""The port's layers, boxes, deformable attention, backbone, decoder and
detector (dinov2_od_tpu_torch) against the JAX package on the same
seeded params and inputs, on the CPU at a tiny size.

Params come from the JAX `init_detector_params`, are perturbed with numpy
(nonzero LoRA B so folding is not a no-op, nonzero deformable offsets
and weights so sampling reaches the clipped border) and are carried
across with `params_from_numpy`."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.models import layers as jlayers
from dinov2_od_tpu.models.decoder import decoder_apply as jax_decoder_apply
from dinov2_od_tpu.models.detector import (
    cast_frozen_weights as jax_cast,
    count_params as jax_count_params,
    detector_apply as jax_detector_apply,
    fold_detector_lora as jax_fold,
    init_detector_params as jax_init,
)
from dinov2_od_tpu.models.vit import backbone_apply as jax_backbone_apply
from dinov2_od_tpu.ops import boxes as jboxes
from dinov2_od_tpu.ops import deformable as jdef

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.models import layers as players
from dinov2_od_tpu_torch.models.decoder import decoder_apply
from dinov2_od_tpu_torch.models.detector import (
    cast_frozen_weights,
    count_params,
    detector_apply,
    fold_detector_lora,
    init_detector_params,
)
from dinov2_od_tpu_torch.models.vit import backbone_apply
from dinov2_od_tpu_torch.ops import boxes as pboxes
from dinov2_od_tpu_torch.ops import deformable as pdef
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy

# fp32 tolerances (max abs error): single ops 1e-5; the whole backbone,
# decoder and detector 1e-4 (two frameworks' GEMMs and reductions sum in
# different orders through every layer).
OP_TOL = 1e-5
MODEL_TOL = 1e-4

BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=2, lora_r=2,
                lora_last_n_blocks=1, target_dim=64)
DECODER = dict(hidden_dim=64, num_queries=5, num_layers=2, num_heads=4,
               dim_feedforward=96, num_classes=6, n_points=2)


def _cfgs(backbone=None, decoder=None):
    bk = {**BACKBONE, **(backbone or {})}
    dk = {**DECODER, **(decoder or {})}
    return (
        jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**bk),
                            decoder=jcfg.DecoderConfig(**dk)),
        pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**bk),
                            decoder=pcfg.DecoderConfig(**dk)),
    )


def _perturb(tree, seed=0):
    """Nonzero LoRA B on every block linear; nonzero deformable offset
    and weight projections, large enough that clip(ref + offset, 0, 1)
    clips often."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)
    for lin in tree["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = rng.normal(0, 0.1, lin["lora_B"].shape).astype(
                np.float32)
    for layers in (tree["decoder"]["layers"],):
        if "deform" in layers:
            dfm = layers["deform"]
            d = dfm["offsets_kernel"].shape[1]
            for key, std in (("offsets_kernel", 0.8 / np.sqrt(d)),
                             ("offsets_bias", 0.3),
                             ("weights_kernel", 1.0 / np.sqrt(d)),
                             ("weights_bias", 0.5)):
                dfm[key] = rng.normal(0, std, dfm[key].shape).astype(
                    np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _init_tree(backbone_items, decoder_items):
    jc, _ = _cfgs(dict(backbone_items), dict(decoder_items))
    tree = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.key(0), jc))
    return _perturb(tree)


_SHAPING = ("ffn_type_override", "use_deformable")


def _trees(backbone_items=(), decoder_items=()):
    """(numpy JAX tree, jax cfg, port cfg) for a config variant. The JAX
    init (a compile per config) runs once per param-tree shape: variants
    that differ only in how they apply the params share one tree."""
    jc, pc = _cfgs(dict(backbone_items), dict(decoder_items))
    tree = _init_tree(
        tuple(kv for kv in backbone_items if kv[0] in _SHAPING),
        tuple(kv for kv in decoder_items if kv[0] in _SHAPING),
    )
    return tree, jc, pc


def _images(n=2, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 56, 56, 3)).astype(np.float32)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _max_err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


# ---- param bridge ----------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def test_bridge_round_trip_is_exact():
    tree, _, _ = _trees()
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    a, b = _flat(tree), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_bridge_carries_bf16_leaves():
    tree, jc, _ = _trees()
    cast = jax.tree_util.tree_map(np.asarray, jax_cast(_jax_tree(tree), jc))
    ported = params_from_numpy(cast, device="cpu")
    kern = ported["backbone"]["blocks"]["q"]["kernel"]
    assert kern.dtype == torch.bfloat16
    back = _flat(params_to_numpy(ported))
    for k, v in _flat(cast).items():
        assert np.array_equal(v.astype(np.float32), back[k]), k


def test_port_init_has_the_jax_tree():
    tree, _, pc = _trees()
    own = init_detector_params(torch.Generator().manual_seed(0), pc,
                               device="cpu")
    a = {k: (v.shape, v.dtype.name) for k, v in _flat(tree).items()}
    b = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
         for k, v in _flat(own).items()}
    assert a == b
    assert not own["backbone"]["blocks"]["q"]["lora_B"].any()
    assert not own["decoder"]["layers"]["deform"]["offsets_kernel"].any()
    assert count_params(own) == jax_count_params(tree)


# ---- layers and boxes ------------------------------------------------------


def test_layers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    p = {"kernel": rng.normal(size=(16, 12)).astype(np.float32),
         "bias": rng.normal(size=(12,)).astype(np.float32),
         "lora_A": rng.normal(size=(16, 2)).astype(np.float32),
         "lora_B": rng.normal(size=(2, 12)).astype(np.float32)}
    ln = {"scale": rng.normal(size=(16,)).astype(np.float32),
          "bias": rng.normal(size=(16,)).astype(np.float32)}
    jp, pp = _jax_tree(p), params_from_numpy(p, device="cpu")
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    pairs = [
        (jlayers.linear(jx, jp), players.linear(px, pp)),
        (jlayers.lora_linear(jx, jp, 0.7), players.lora_linear(px, pp, 0.7)),
        (jlayers.layer_norm(jx, jax.tree_util.tree_map(jnp.asarray, ln)),
         players.layer_norm(px, params_from_numpy(ln, device="cpu"))),
        (jlayers.layer_norm(jx, _jax_tree(ln), eps=1e-5),
         players.layer_norm(px, params_from_numpy(ln, device="cpu"),
                            eps=1e-5)),
        (jlayers.fold_lora(jp, 0.7)["kernel"],
         players.fold_lora(pp, 0.7)["kernel"]),
    ]
    for ref, out in pairs:
        assert _max_err(ref, out.numpy()) <= OP_TOL
    # bf16 input: fp32 statistics, result rounded back to bf16.
    xb = players.layer_norm(px.bfloat16(), params_from_numpy(ln, device="cpu"))
    ref = jlayers.layer_norm(jx.astype(jnp.bfloat16), _jax_tree(ln))
    assert xb.dtype == torch.bfloat16
    assert _max_err(ref, xb.float().numpy()) <= 2 ** -7 * 4


def test_boxes_match_jax():
    rng = np.random.default_rng(4)
    b = rng.uniform(size=(5, 9, 4)).astype(np.float32)
    for jf, pf in ((jboxes.box_cxcywh_to_xyxy, pboxes.box_cxcywh_to_xyxy),
                   (jboxes.box_xyxy_to_cxcywh, pboxes.box_xyxy_to_cxcywh)):
        assert _max_err(jf(jnp.asarray(b)), pf(torch.from_numpy(b))) <= 1e-7


# ---- deformable attention --------------------------------------------------


def test_bilinear_gather_matches_jax_off_grid():
    """Locations up to 1.5 px outside the grid: clipped corners, weights
    from the unclipped floor."""
    rng = np.random.default_rng(6)
    h, w = 4, 5
    values = rng.normal(size=(2, h * w, 3, 8)).astype(np.float32)
    lx = rng.uniform(-1.5, w + 0.5, size=(2, 6, 3, 2)).astype(np.float32)
    ly = rng.uniform(-1.5, h + 0.5, size=(2, 6, 3, 2)).astype(np.float32)
    ref = jdef.bilinear_gather(jnp.asarray(values), jnp.asarray(lx),
                               jnp.asarray(ly), (h, w))
    out = pdef.bilinear_gather(torch.from_numpy(values), torch.from_numpy(lx),
                               torch.from_numpy(ly), (h, w))
    assert out.shape == (2, 6, 3, 2, 8)
    assert _max_err(ref, out.numpy()) <= OP_TOL


@pytest.mark.parametrize("hw", [(4, 4), (3, 7)])
def test_deformable_attention_matches_jax(hw):
    rng = np.random.default_rng(8)
    d, nh, npt, q, b = 32, 4, 3, 6, 2
    fields = {
        "offsets_kernel": rng.normal(0, 1.0 / np.sqrt(d), (d, nh * npt * 2)),
        "offsets_bias": rng.normal(0, 0.5, (nh * npt * 2,)),
        "weights_kernel": rng.normal(0, 1.0 / np.sqrt(d), (d, nh * npt)),
        "weights_bias": rng.normal(0, 0.5, (nh * npt,)),
        "value_kernel": rng.normal(0, 1.0 / np.sqrt(d), (d, d)),
        "value_bias": rng.normal(0, 0.1, (d,)),
        "output_kernel": rng.normal(0, 1.0 / np.sqrt(d), (d, d)),
        "output_bias": rng.normal(0, 0.1, (d,)),
    }
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    query = rng.normal(size=(b, q, d)).astype(np.float32)
    ref_pts = rng.uniform(size=(b, q, 2)).astype(np.float32)
    memory = rng.normal(size=(b, hw[0] * hw[1], d)).astype(np.float32)
    # The offsets leave [0, 1] for a good share of the samples.
    offs = (query @ fields["offsets_kernel"] + fields["offsets_bias"])
    loc = ref_pts[:, :, None, :] + offs.reshape(b, q, -1, 2)
    assert ((loc < 0) | (loc > 1)).mean() > 0.1
    ref = jdef.deformable_attention(
        jnp.asarray(query), jnp.asarray(ref_pts), jnp.asarray(memory), hw,
        jdef.DeformableParams(**_jax_tree(fields)), nh, npt)
    out = pdef.deformable_attention(
        torch.from_numpy(query), torch.from_numpy(ref_pts),
        torch.from_numpy(memory), hw,
        pdef.DeformableParams(**params_from_numpy(fields, device="cpu")),
        nh, npt)
    assert _max_err(ref, out.numpy()) <= OP_TOL


def test_factor_spatial_shape_matches_jax():
    for n in range(1, 300):
        assert pdef.factor_spatial_shape(n) == jdef.factor_spatial_shape(n)


# ---- backbone, decoder, detector -------------------------------------------


@pytest.mark.parametrize(
    "variant,impl",
    [
        ((("lora_mode", "factored"),), "xla"),
        ((("lora_mode", "factored"),), "flash"),
        ((("lora_mode", "fold"),), "xla"),
        ((("lora_mode", "fold"),), "flash"),
        ((("ffn_type_override", "swiglu"),), "auto"),
        ((("lora_last_n_blocks", 2), ("gelu_approximate", False)), "flash"),
    ],
    ids=["factored-xla", "factored-flash", "fold-xla", "fold-flash",
         "swiglu", "all-adapted-erf-gelu"],
)
def test_backbone_matches_jax(variant, impl):
    tree, jc, pc = _trees(variant)
    x = _images()
    ref = jax_backbone_apply(_jax_tree(tree["backbone"]), jc.backbone,
                             jnp.asarray(x))
    out = backbone_apply(params_from_numpy(tree["backbone"], device="cpu"),
                         pc.backbone, torch.from_numpy(x), attn_impl=impl)
    assert out.shape == (2, 16, 64)
    assert _max_err(ref, out.numpy()) <= MODEL_TOL


@pytest.mark.parametrize("use_deformable", [True, False])
def test_decoder_matches_jax(use_deformable):
    tree, jc, pc = _trees((), (("use_deformable", use_deformable),))
    memory = np.random.default_rng(2).normal(size=(2, 16, 64)).astype(
        np.float32)
    ref = jax_decoder_apply(_jax_tree(tree["decoder"]), jc.decoder,
                            jnp.asarray(memory))
    out = decoder_apply(params_from_numpy(tree["decoder"], device="cpu"),
                        pc.decoder, torch.from_numpy(memory))
    for key in ("pred_logits", "pred_boxes"):
        assert out[key].dtype == torch.float32
        assert _max_err(ref[key], out[key].numpy()) <= MODEL_TOL


@pytest.mark.parametrize("lora_mode", ["factored", "fold"])
@pytest.mark.parametrize("folded", [False, True])
def test_detector_apply_matches_jax(lora_mode, folded):
    tree, jc, pc = _trees((("lora_mode", lora_mode),))
    jp, pp = _jax_tree(tree), params_from_numpy(tree, device="cpu")
    if folded:
        jp, pp = jax_fold(jp, jc), fold_detector_lora(pp, pc)
    x = _images(3)
    ref = jax_detector_apply(jp, jc, jnp.asarray(x))
    out = detector_apply(pp, pc, torch.from_numpy(x))
    for key in ("pred_logits", "pred_boxes"):
        assert out[key].shape == ref[key].shape
        assert _max_err(ref[key], out[key].numpy()) <= MODEL_TOL


def test_fold_matches_jax_and_changes_the_adapted_kernels():
    tree, jc, pc = _trees()
    pp = params_from_numpy(tree, device="cpu")
    folded = fold_detector_lora(pp, pc)
    ref = _flat(jax.tree_util.tree_map(
        np.asarray, jax_fold(_jax_tree(tree), jc)))
    got = _flat(params_to_numpy(folded))
    for k in ref:
        assert _max_err(ref[k], got[k]) <= 1e-6, k
    before = pp["backbone"]["blocks"]["q"]["kernel"]
    after = folded["backbone"]["blocks"]["q"]["kernel"]
    assert torch.equal(before[0], after[0])  # prefix block: not adapted
    assert not torch.equal(before[1], after[1])
    assert not folded["backbone"]["blocks"]["q"]["lora_B"].any()
    assert pp["backbone"]["blocks"]["q"]["lora_B"].any()  # input untouched


def test_cast_frozen_weights_bf16_matches_jax():
    """bf16 storage of the frozen backbone weights and a bf16 backbone,
    against a JAX bf16 run. Both round every block's activations to bf16
    (2^-8 relative), in different places (GELU, GEMM epilogues). On this
    model and input the JAX bf16 run lies 7.5e-3 (logits) and 7.4e-4
    (boxes) from the JAX fp32 run; the tolerances are 4x that."""
    tree, jc, pc = _trees()
    jc16 = dataclasses.replace(
        jc, backbone=dataclasses.replace(jc.backbone, dtype="bfloat16"))
    pc16 = dataclasses.replace(
        pc, backbone=dataclasses.replace(pc.backbone, dtype="bfloat16"))
    jp = jax_cast(jax_fold(_jax_tree(tree), jc), jc)
    pp = cast_frozen_weights(
        fold_detector_lora(params_from_numpy(tree, device="cpu"), pc), pc)
    dt = {k: str(v.dtype).split(".")[-1] for k, v in _flat(pp).items()}
    jdt = {k: v.dtype.name for k, v in _flat(
        jax.tree_util.tree_map(np.asarray, jp)).items()}
    assert dt == jdt
    assert dt["backbone.blocks.fc1.kernel"] == "bfloat16"
    assert dt["backbone.blocks.ln1.scale"] == "float32"
    assert dt["backbone.blocks.fc1.lora_A"] == "float32"
    assert dt["decoder.class_embed.kernel"] == "float32"
    x = _images(2)
    ref = jax_detector_apply(jp, jc16, jnp.asarray(x))
    for impl in ("xla", "flash"):
        out = detector_apply(pp, pc16, torch.from_numpy(x), attn_impl=impl)
        assert _max_err(ref["pred_boxes"], out["pred_boxes"].numpy()) <= 3e-3
        assert _max_err(ref["pred_logits"],
                        out["pred_logits"].numpy()) <= 3e-2


def test_unported_options_raise(monkeypatch):
    """MoE runs under a mesh (expert parallelism); under a pipeline it
    raises JAX's ValueError, and experts that do not divide the model
    axis raise `check_tp_compatible`'s. Entry points want CUDA unless
    asked for the CPU."""
    from dinov2_od_tpu_torch.parallel.sharding import check_tp_compatible

    _, _, pc = _trees()
    moe = dataclasses.replace(
        pc, backbone=dataclasses.replace(pc.backbone,
                                         ffn_type_override="moe"))
    params = init_detector_params(torch.Generator(), moe, device="cpu")
    with pytest.raises(ValueError, match="not supported under pipeline"):
        detector_apply(params, moe, torch.from_numpy(_images()),
                       pipe_axis="stage")
    check_tp_compatible(moe, 2)  # 8 experts, 4 a rank
    three = dataclasses.replace(
        moe, backbone=dataclasses.replace(moe.backbone, moe_num_experts=3))
    with pytest.raises(ValueError, match="moe_num_experts=3 not divisible"):
        check_tp_compatible(three, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_detector_params(torch.Generator(), pc)
