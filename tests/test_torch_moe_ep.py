"""Expert parallelism's rules and the split routing (dinov2_od_tpu_torch/
parallel/sharding.py's "moe" branch, ops/moe.py's `route` and
`moe_routing_split_plain`) against the JAX package, in one process with
no world of ranks: a rank's cut is `shard_params` on a Mesh that names
its place and holds no process groups.

- Every MoE leaf's model and data entries against JAX's
  `param_shardings` (on an abstract mesh; FSDP's threshold lowered in
  both packages so every MoE leaf is cut), at tests/test_moe.py's
  `_moe_backbone_cfg` widths, its int8 tree included, and each rank's
  element count against each of JAX's devices'.
- The per-rank counts of the chip's MoE mesh jobs (ViT-B/14 with 8
  experts) and `check_tp_compatible`'s message for experts that do not
  divide the model axis, word for word.
- The ring's split routing (each shard's slots from the counts of the
  shards before it) against the whole row's, with a pad row, at 2 and 3
  shards, at a capacity small enough that tokens of the later shards are
  dropped; a control without the earlier shards' counts fails. The
  per-rank aux terms, summed, against the global aux.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.models.detector import init_detector_params as jax_init
from dinov2_od_tpu.models.detector import trainable_mask as jax_trainable_mask
from dinov2_od_tpu.models.quantize import quantize_detector_int8 as jax_int8
from dinov2_od_tpu.ops import moe as jmoe
from dinov2_od_tpu.parallel import sharding as jsh

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.synthetic import NUM_SYNTHETIC_CLASSES
from dinov2_od_tpu_torch.models.quantize import quantize_detector_int8
from dinov2_od_tpu_torch.ops import moe as pmoe
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy
from dinov2_od_tpu_torch.parallel import sharding as psh
from dinov2_od_tpu_torch.train import cli

# tests/test_moe.py's `_moe_backbone_cfg` and its EP tests' decoder.
BACKBONE = dict(variant="small", image_size=56, patch_size=14, lora_r=1,
                target_dim=32, hidden_dim_override=48, depth_override=3,
                num_heads_override=4, mlp_ratio_override=2.0,
                ffn_type_override="moe", moe_num_experts=4, moe_top_k=2,
                lora_last_n_blocks=2)
DECODER = dict(hidden_dim=32, num_queries=8, num_layers=1, num_heads=4,
               dim_feedforward=64, num_classes=NUM_SYNTHETIC_CLASSES,
               dropout=0.0)
MIN_ELEMS = 64  # every MoE leaf of the tiny tree cut under FSDP
MOE = ("router_kernel", "fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias")
# JAX's specs of the MoE leaves on a data 2 x model 2 mesh under FSDP at
# the lowered threshold (entries from the left; [depth, E, d, m] kernels).
PROBE = {"fc1_kernel": (None, "model", None, "data"),
         "fc2_kernel": (None, "model", "data", None),
         "fc1_bias": (None, "model", "data"),
         "fc2_bias": (None, "model", "data"),
         "router_kernel": (None, "data", None)}
# (data, model, fsdp)
MESHES = ((2, 2, True), (2, 1, True), (4, 1, True), (1, 2, False),
          (2, 2, False), (4, 2, True))
# The chip's MoE mesh jobs (chip_smoke.py MOE_EP_JOBS): the CLI's flags,
# the mesh (data, model, fsdp), JAX's per-device param and Adam-moment
# elements. The ring's job (data 1 x context 2 x model 2) holds what
# DP 2 x EP 2's ranks hold: params stay whole over the ring.
CHIP = ["--dino_model", "facebook/dinov2-base", "--image_size", "224",
        "--ffn_type", "moe"]
CHIP_JOBS = {
    "a_dp2_ep2": (CHIP + ["--model_parallel", "2"], (2, 2, False),
                  (84_563_381, 46_061_237)),
    "b_fsdp2_ep2": (CHIP + ["--fsdp", "--model_parallel", "2"],
                    (2, 2, True), (42_510_773, 23_207_477)),
}
# The split routing against the whole row: the combine weights equal to
# the port's whole-row routing bit for bit (the same fp32 gate values at
# the same slots) and within 1e-6 of JAX's; the aux terms' sum within
# 1e-6 of the global aux.
ROUTING_TOL = 1e-6
AUX_TOL = 1e-6


def _paths(tree):
    """{path tuple: leaf} of a tree, paths as the port names them."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name", ""))) for k in p):
            v for p, v in leaves}


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _jdet(**backbone):
    return jcfg.DetectorConfig(
        backbone=jcfg.BackboneConfig(**{**BACKBONE, **backbone}),
        decoder=jcfg.DecoderConfig(**DECODER))


@functools.lru_cache(maxsize=None)
def _tree(int8: bool):
    """JAX's tiny MoE detector (numpy), or its int8 tree (the LoRA
    factors are zero at init, so it quantizes as folded)."""
    params = jax_init(jax.random.key(0), _jdet())
    if int8:
        params = jax_int8(params)
    return jax.tree_util.tree_map(np.asarray, params)


def _mock_mesh(data, model, rank, fsdp):
    return psh.Mesh(
        data_size=data, model_size=model, data_index=rank // model,
        model_index=rank % model, data_group=None, model_group=None,
        backend="gloo", cfg=pcfg.MeshConfig(fsdp=fsdp,
                                            model_parallel_size=model))


def _entry(spec, ndim, axis):
    """The dim (from the right) of a JAX spec's `axis` entry, or None."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return next((d - ndim for d, e in enumerate(entries) if e == axis),
                None)


def _jax_specs(shapes, data, model, fsdp, mask=None):
    """JAX's spec of each leaf on a data x model mesh, and its param (or,
    with a trainable `mask`, moment) elements a device."""
    amesh = AbstractMesh((data, model), ("data", "model"))
    jmc = jcfg.MeshConfig(fsdp=fsdp, model_parallel_size=model)
    sh = _paths(jsh.param_shardings(shapes, amesh, cfg=jmc))
    count = sum(int(np.prod(sh[p].shard_shape(a.shape)))
                for p, a in _paths(shapes).items()
                if mask is None or mask[p])
    return sh, count


def _port_counts(shapes, data, model, fsdp, mask=None):
    """Each rank's element count of its shards (`shard_params` on meta
    tensors of the leaves' shapes)."""
    meta = _nest({p: torch.empty(a.shape, device="meta")
                  for p, a in _paths(shapes).items()})
    counts = []
    for rank in range(data * model):
        shards = _paths(psh.shard_params(
            meta, _mock_mesh(data, model, rank, fsdp)))
        counts.append(sum(t.numel() for p, t in shards.items()
                          if mask is None or mask[p]))
    return counts


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("data, model, fsdp", MESHES)
def test_moe_leaf_specs_and_rank_counts_are_jaxs(data, model, fsdp, int8,
                                                 monkeypatch):
    """Every MoE leaf's model entry (E over the model axis, the router
    replicated) and data entry (FSDP, E taken at model size 1 too) are
    those of JAX's spec, the probe's specs at data 2 x model 2; every
    rank holds each of JAX's devices' element count of the whole tree
    (of the int8 one too: q, k, v and proj int8, the experts in float)."""
    monkeypatch.setattr(jsh, "_FSDP_MIN_ELEMS", MIN_ELEMS)
    monkeypatch.setattr(psh, "FSDP_MIN_ELEMS", MIN_ELEMS)
    tree = _tree(int8)
    sh, want = _jax_specs(tree, data, model, fsdp)
    moe = {p: a for p, a in _paths(tree).items() if p[-2] == "moe"}
    assert sorted(p[-1] for p in moe) == sorted(MOE)
    for path, leaf in moe.items():
        spec = sh[path].spec
        model_dim = _entry(spec, leaf.ndim, "model")
        assert psh.shard_dim(path) == model_dim, path
        data_dim = psh.fsdp_dim(path, leaf.shape, data) if fsdp else None
        assert data_dim == _entry(spec, leaf.ndim, "data"), path
        if (data, model, fsdp) == (2, 2, True):
            full = tuple(spec) + (None,) * (leaf.ndim - len(spec))
            assert full == PROBE[path[-1]], path
    assert _port_counts(tree, data, model, fsdp) == [want] * (data * model)
    if int8:
        assert "kernel_q" in tree["backbone"]["moe_blocks"]["q"]
        assert moe[("backbone", "moe_blocks", "moe", "fc1_kernel")].dtype \
            == np.float32


def test_shard_params_gives_each_model_rank_its_experts():
    """At model 2 each rank's expert leaves are its E / 2 experts, rank 0
    the first half and rank 1 the second (the real values), its router
    the whole one; the port's int8 tree (quantized from the folded float
    tree) is cut alike."""
    tree = _tree(False)
    int8 = params_to_numpy(quantize_detector_int8(params_from_numpy(
        tree, device="cpu")))
    for t in (tree, int8):
        for rank in range(2):
            mesh = _mock_mesh(1, 2, rank, fsdp=False)
            moe = params_from_numpy(t, device="cpu", mesh=mesh)[
                "backbone"]["moe_blocks"]["moe"]
            whole = t["backbone"]["moe_blocks"]["moe"]
            half = slice(2 * rank, 2 * rank + 2)
            for name in ("fc1_kernel", "fc2_kernel", "fc1_bias",
                         "fc2_bias"):
                assert np.array_equal(moe[name].numpy(),
                                      whole[name][:, half]), name
            assert np.array_equal(moe["router_kernel"].numpy(),
                                  whole["router_kernel"])
    path = ("backbone", "moe_blocks", "moe", "router_kernel")
    assert psh.partial_grad(path) and psh.backbone_partial(path)
    assert not any(psh.partial_grad(path[:-1] + (n,)) for n in MOE[1:])


@pytest.mark.parametrize("job", list(CHIP_JOBS))
def test_chip_moe_jobs_per_rank_counts(job):
    """The detector the training CLI builds for each chip MoE job's flags
    (ViT-B/14 at 224 px, 8 experts in the last 2 blocks) is JAX's for the
    same fields but for its dtype (bf16 on the card, which no count
    depends on); every rank holds JAX's per-device count of param
    elements and of Adam moments (4 experts a rank), the pinned
    numbers."""
    flags, (data, model, fsdp), (per_rank, moments) = CHIP_JOBS[job]
    det = cli.build_detector_config(cli.build_arg_parser().parse_args(flags))
    assert det.backbone.moe_num_experts == 8
    jdet = jcfg.DetectorConfig(
        backbone=jcfg.BackboneConfig(**{
            **det.backbone.__dict__, "dtype": "float32"}),
        decoder=jcfg.DecoderConfig(**det.decoder.__dict__))
    shapes = jax.eval_shape(lambda k: jax_init(k, jdet), jax.random.key(0))
    assert _jax_specs(shapes, data, model, fsdp)[1] == per_rank
    assert _port_counts(shapes, data, model, fsdp) == \
        [per_rank] * (data * model)
    mask = _paths(jax_trainable_mask(shapes, jdet))
    assert _jax_specs(shapes, data, model, fsdp, mask)[1] == moments
    assert _port_counts(shapes, data, model, fsdp, mask) == \
        [moments] * (data * model)


@pytest.mark.parametrize("experts, model", [(3, 2), (6, 4), (8, 4), (8, 2),
                                            (4, 8)])
def test_check_tp_compatible_experts_match_jax(experts, model):
    """Experts that do not divide the model axis raise JAX's
    ValueError, word for word; those that do pass in both."""
    det = dict(moe_num_experts=experts, hidden_dim_override=64,
               num_heads_override=8, mlp_ratio_override=2.0)
    jdet = _jdet(**det)
    pdet = pcfg.DetectorConfig(
        backbone=pcfg.BackboneConfig(**{**BACKBONE, **det}),
        decoder=pcfg.DecoderConfig(**{**DECODER, "num_heads": 8,
                                      "hidden_dim": 32}))
    jdet = jcfg.DetectorConfig(
        backbone=jdet.backbone,
        decoder=jcfg.DecoderConfig(**{**DECODER, "num_heads": 8,
                                      "hidden_dim": 32}))
    try:
        jsh.check_tp_compatible(jdet, model)
    except ValueError as want:
        with pytest.raises(ValueError) as got:
            psh.check_tp_compatible(pdet, model)
        assert str(got.value) == str(want)
        assert "moe_num_experts" in str(want)
    else:
        psh.check_tp_compatible(pdet, model)
        assert experts % model == 0


def _logits(seed, b=4, n=17, e=4, pad=1):
    """Router logits [b, n + pad, e]: n real rows and `pad` rows of the
    ring's padding (drawn, so that a pad row would claim slots were it
    not masked)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(b, n + pad, e))
                            .astype(np.float32) * 2.0)


@pytest.mark.parametrize("ring, factor", [(2, 1.25), (3, 1.25), (2, 0.5),
                                          (3, 0.5)])
def test_split_routing_is_the_whole_rows(ring, factor):
    """The ring's routing, each shard from the counts of the shards
    before it (`moe_routing_split_plain`), gives the whole row's slots:
    17 real tokens padded to 18, the pad row claiming none; at capacity
    factor 0.5 (5 slots an expert) tokens of the last shard are dropped,
    so a wrong prefix would show."""
    logits = _logits(ring)
    seq = 17
    capacity = pmoe.moe_capacity(seq, 4, 2, factor)
    split, _ = pmoe.moe_routing_split_plain(logits, 2, capacity, ring,
                                            valid_len=seq)
    whole, _ = pmoe.moe_routing(logits[:, :seq], 2, capacity)
    jwhole, _ = jmoe.moe_routing(jnp.asarray(logits[:, :seq].numpy()), 2,
                                 capacity)
    assert torch.equal(split[:, :seq], whole)
    assert np.abs(split[:, :seq].numpy() - np.asarray(jwhole)).max() \
        <= ROUTING_TOL
    assert not split[:, seq:].any()
    last = (ring - 1) * 18 // ring
    kept = (split[:, last:seq] > 0).sum(dim=(-1, -2))  # choices kept
    if factor < 1:
        assert (kept < 2).any()  # dropped in the last shard


@pytest.mark.parametrize("ring", [2, 3])
def test_split_routing_without_the_prefix_fails(ring):
    """The control: each shard routed with no count of the shards before
    it (every shard starts its experts' slot lists at 0) claims slots
    that earlier shards hold, and its routing parts from the whole
    row's."""
    logits = _logits(ring)
    seq, w = 17, 18 // ring
    capacity = pmoe.moe_capacity(seq, 4, 2, 0.5)
    whole, _ = pmoe.moe_routing(logits[:, :seq], 2, capacity)
    parts = []
    for r in range(ring):
        valid = torch.arange(r * w, (r + 1) * w) < seq
        c, _, _ = pmoe.route(logits[:, r * w:(r + 1) * w], 2, capacity,
                             valid, lambda local: (0 * local, local))
        parts.append(c)
    faulty = torch.cat(parts, dim=1)[:, :seq]
    assert (faulty != whole).any()


@pytest.mark.parametrize("data, ring", [(2, 1), (1, 2), (2, 2), (1, 3),
                                        (4, 3)])
def test_aux_shares_sum_to_the_global_aux(data, ring):
    """Each rank's aux term as `moe_ffn` holds it (the global top-1
    fractions times its data part's probability sum, taken over the ring,
    over the global token count: every rank of a ring holds the same
    term), summed over the data parts, is the aux of the whole batch's
    real rows: the port's one-process `moe_routing` and JAX's within
    AUX_TOL; a pad row enters neither."""
    logits = _logits(10 + data * ring)
    seq = 17
    capacity = pmoe.moe_capacity(seq, 4, 2, 1.25)
    _, shares = pmoe.moe_routing_split_plain(logits, 2, capacity, ring,
                                             data, valid_len=seq)
    assert shares.shape == (data, ring)
    assert torch.equal(shares, shares[:, :1].expand(data, ring))
    _, aux = pmoe.moe_routing(logits[:, :seq], 2, capacity)
    _, jaux = jmoe.moe_routing(jnp.asarray(logits[:, :seq].numpy()), 2,
                               capacity)
    total = float(shares[:, 0].sum())
    assert abs(total - float(aux)) <= AUX_TOL
    assert abs(total - float(jaux)) <= AUX_TOL
    if data > 1:
        assert abs(float(shares[0, 0]) - float(aux)) > 1e-2
