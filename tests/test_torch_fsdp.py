"""FSDP's partition rule and layout (dinov2_od_tpu_torch/parallel/
sharding.py `fsdp_dim`, `shard_params`) against the JAX package's
`param_shardings` and `shard_params`, with no world of ranks: the port's
cut of each rank is `shard_params` on a Mesh that names the rank's place
and holds no process groups (cutting needs none).

- For every leaf of the detector at ViT-S, ViT-B, ViT-L and ViT-g (SwiGLU)
  with the deformable decoder, and of an int8 tree (`kernel_q`,
  `w_scale`), at data 2, 4 and 8 x model 1 and 2: `fsdp_dim` is the
  'data' entry of JAX's spec (on an abstract mesh of that shape), and
  every rank's element count of its shards is each of JAX's devices'.
- The per-rank counts of the chip's two FSDP jobs, from the config the
  training CLI builds for their flags.
- JAX's indivisible 1001 x 96 and 1001 x 97 leaves.
- Each rank's shards at the real values of a tiny tree equal the
  addressable shard of the JAX device at the same place of JAX's
  4-device mesh, with the threshold as it is and lowered.
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
from dinov2_od_tpu.models.quantize import quantize_linear as jax_quantize
from dinov2_od_tpu.parallel import create_mesh as jax_create_mesh
from dinov2_od_tpu.parallel import sharding as jsh

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.data.synthetic import NUM_SYNTHETIC_CLASSES
from dinov2_od_tpu_torch.params import params_from_numpy
from dinov2_od_tpu_torch.parallel import sharding as psh
from dinov2_od_tpu_torch.train import cli

MODELS = {"vit_s": "facebook/dinov2-small", "vit_b": "facebook/dinov2-base",
          "vit_l": "facebook/dinov2-large",
          "vit_g_swiglu": "facebook/dinov2-giant",
          "vit_b_int8": "facebook/dinov2-base"}
# (data, model): JAX's mesh shapes; 8 x 2 is abstract, as every shape here.
MESHES = ((2, 1), (4, 1), (8, 1), (2, 2), (4, 2), (8, 2))
# The chip's two FSDP jobs (chip_smoke.py FSDP_JOBS): the CLI's flags, the
# mesh, JAX's per-device param and Adam-moment elements for them, and the
# detector's param elements.
CHIP_JOBS = {
    "a_fsdp4_vit_l": (["--dino_model", "facebook/dinov2-large",
                       "--image_size", "224", "--fsdp"], (4, 1),
                      (81_153_461, 5_140_661), 320_788_853),
    "b_fsdp2_tp2_vit_b": (["--dino_model", "facebook/dinov2-base",
                           "--image_size", "224", "--fsdp",
                           "--model_parallel", "2"], (2, 2),
                          (25_938_869, 4_271_669), 101_945_717),
}
TINY = dict(variant="small", image_size=56, lora_r=1, target_dim=32)
TINY_DECODER = dict(hidden_dim=32, num_queries=8, num_layers=2, num_heads=4,
                    dim_feedforward=64, num_classes=NUM_SYNTHETIC_CLASSES,
                    use_deformable=True, dropout=0.0)


def _paths(tree):
    """{path tuple: leaf} of a JAX tree, paths as the port names them."""
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


@functools.lru_cache(maxsize=None)
def _shapes(name):
    """JAX's abstract detector tree for a model name at 224 px (its int8
    tree for the *_int8 names)."""
    det = jcfg.detector_config_for_model_name(MODELS[name])

    def init(key):
        params = jax_init(key, det)
        if name.endswith("int8"):
            # JAX's quantize_backbone_int8, but for its check of the LoRA
            # factors' values, which an abstract tree has not.
            blocks = params["backbone"]["blocks"]
            for lin in ("q", "k", "v", "proj", "fc1", "fc2"):
                blocks[lin] = jax_quantize(blocks[lin])
        return params

    return jax.eval_shape(init, jax.random.key(0))


def _mock_mesh(data, model, rank, fsdp=True):
    return psh.Mesh(
        data_size=data, model_size=model, data_index=rank // model,
        model_index=rank % model, data_group=None, model_group=None,
        backend="gloo", cfg=pcfg.MeshConfig(fsdp=fsdp,
                                            model_parallel_size=model))


def _data_dim(spec, ndim):
    entries = list(spec) + [None] * (ndim - len(spec))
    return next((d - ndim for d, e in enumerate(entries) if e == "data"),
                None)


def _jax_per_device(shapes, data, model, mask=None):
    """JAX's spec of each leaf on a data x model mesh, and its param (or,
    with a trainable `mask`, moment) elements a device."""
    amesh = AbstractMesh((data, model), ("data", "model"))
    jmc = jcfg.MeshConfig(fsdp=True, model_parallel_size=model)
    sh = _paths(jsh.param_shardings(shapes, amesh, cfg=jmc))
    leaves = _paths(shapes)
    count = sum(int(np.prod(sh[p].shard_shape(a.shape)))
                for p, a in leaves.items() if mask is None or mask[p])
    return sh, count


def _port_per_rank(shapes, data, model, mask=None):
    """Each rank's element count of its shards (`shard_params` on meta
    tensors of the leaves' shapes)."""
    meta = _nest({p: torch.empty(a.shape, device="meta")
                  for p, a in _paths(shapes).items()})
    counts = []
    for rank in range(data * model):
        shards = _paths(psh.shard_params(meta, _mock_mesh(data, model,
                                                          rank)))
        counts.append(sum(t.numel() for p, t in shards.items()
                          if mask is None or mask[p]))
    return counts


@pytest.mark.parametrize("data, model", MESHES)
@pytest.mark.parametrize("name", list(MODELS))
def test_fsdp_dim_is_jaxs_data_entry_on_every_leaf(name, data, model):
    """`fsdp_dim` on each leaf's path and logical shape is the 'data'
    entry of JAX's `param_shardings` spec for it (the Megatron dim taken
    at model size 1 too, 2-D stacked leaves cut on their depth axis, the
    lower dim on a tie), and every rank holds as many elements as each of
    JAX's devices."""
    shapes = _shapes(name)
    sh, want = _jax_per_device(shapes, data, model)
    cut = 0
    for path, leaf in _paths(shapes).items():
        jax_dim = _data_dim(sh[path].spec, len(leaf.shape))
        assert psh.fsdp_dim(path, leaf.shape, data) == jax_dim, path
        cut += jax_dim is not None
    assert cut > 0
    assert _port_per_rank(shapes, data, model) == [want] * (data * model)


@pytest.mark.parametrize("job", list(CHIP_JOBS))
def test_chip_jobs_per_rank_counts(job):
    """The detector the training CLI builds for each chip job's flags
    (ViT-L/14 under FSDP 4, ViT-B/14 under FSDP 2 x TP 2, both at 224 px)
    is JAX's default one for the model but for its dtype (bf16 on the
    card, which no count depends on); every rank of
    the mesh holds JAX's per-device count of param elements, and of Adam
    moments (the trainable leaves') as many as JAX's device."""
    flags, (data, model), (per_rank, moments), total = CHIP_JOBS[job]
    det = cli.build_detector_config(cli.build_arg_parser().parse_args(flags))
    jdet = jcfg.DetectorConfig(
        backbone=jcfg.BackboneConfig(**{
            **det.backbone.__dict__, "dtype": "float32"}),
        decoder=jcfg.DecoderConfig(**det.decoder.__dict__))
    default = jcfg.detector_config_for_model_name(flags[1])
    assert jdet == default
    shapes = jax.eval_shape(lambda k: jax_init(k, jdet), jax.random.key(0))
    assert sum(int(np.prod(a.shape)) for a in _paths(shapes).values()) \
        == total
    _, want = _jax_per_device(shapes, data, model)
    assert want == per_rank
    assert _port_per_rank(shapes, data, model) == [per_rank] * (data * model)
    mask = _paths(jax_trainable_mask(shapes, jdet))
    assert _jax_per_device(shapes, data, model, mask)[1] == moments
    assert _port_per_rank(shapes, data, model, mask) == \
        [moments] * (data * model)


@pytest.mark.parametrize("cols, want", [(96, -1), (97, None)])
def test_indivisible_dims_skip_as_jax_does(cols, want):
    """JAX's 1001 x 96 and 1001 x 97 leaves at data 8: the indivisible
    1001 falls to the other dim, and with both indivisible the leaf stays
    whole."""
    tree = {"x": {"kernel": jnp.zeros((1001, cols))}}
    mesh = jax_create_mesh(cfg=jcfg.MeshConfig(fsdp=True))
    spec = jsh.param_shardings(tree, mesh,
                               cfg=jcfg.MeshConfig(fsdp=True))["x"]["kernel"]
    assert _data_dim(spec.spec, 2) == want
    assert psh.fsdp_dim(("x", "kernel"), (1001, cols), 8) == want


@pytest.mark.parametrize("data, model, low", [(4, 1, None), (2, 2, None),
                                              (4, 1, 256), (2, 2, 256)])
def test_rank_shards_equal_jax_addressable_shards(data, model, low,
                                                  monkeypatch):
    """Each rank's `shard_params` cut of a tiny tree (tests/test_fsdp.py's
    widths) equals, leaf by leaf and bit for bit, the addressable shard
    of the JAX device at its place on JAX's data x model mesh; with the
    threshold lowered to 256 in both packages too."""
    if low is not None:
        monkeypatch.setattr(jsh, "_FSDP_MIN_ELEMS", low)
        monkeypatch.setattr(psh, "FSDP_MIN_ELEMS", low)
    det = jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**TINY),
                              decoder=jcfg.DecoderConfig(**TINY_DECODER))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.eval_shape(lambda k: jax_init(k, det), jax.random.key(0)))
    jmc = jcfg.MeshConfig(fsdp=True, model_parallel_size=model)
    mesh = jax_create_mesh(model, devices=jax.devices()[:data * model],
                           cfg=jmc)
    placed = _paths(jsh.shard_params(
        jax.tree_util.tree_map(jnp.asarray, tree), mesh, cfg=jmc))
    cut = 0
    for rank in range(data * model):
        pm = _mock_mesh(data, model, rank)
        shards = _paths(params_from_numpy(tree, device="cpu", mesh=pm))
        cut = len(pm.fsdp_layout)
        assert shards.keys() == placed.keys()
        for path, a in placed.items():
            want = next(s.data for s in a.addressable_shards
                        if s.device.id == rank)
            assert np.array_equal(shards[path].numpy(), np.asarray(want)), \
                (rank, path)
    assert cut > (20 if low else 5)
