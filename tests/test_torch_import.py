"""The port's weights-in path against the JAX package on the CPU at tiny
widths: `interpolate_pos_embed` (dinov2_od_tpu_torch/models/vit.py)
against `jax.image.resize`'s bicubic, the HF DINOv2 importer
(models/import_torch.py) fed the same transformers `Dinov2Model` state
dict as the JAX importer (MLP and SwiGLU, across a grid change; the MoE
backbone's sparse upcycling), the
imported backbone's forward against transformers' own, the state-dict
sources (prefixes, an HF directory, a safetensors file, a bf16 file), and
the training CLI's --pretrained_backbone and --import_reference_checkpoint
on the same run's final params."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.models.import_torch import (
    load_dinov2_backbone_params as jax_load_backbone,
)
from dinov2_od_tpu.models.vit import init_backbone_params as jax_init_backbone
from dinov2_od_tpu.models.vit import interpolate_pos_embed as jax_interp

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.models import vit
from dinov2_od_tpu_torch.models.import_torch import (
    _load_state_dict,
    load_dinov2_backbone_params,
)
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy

POS_TOL = 2e-6  # fp32 bicubic: the two resamplers sum in other orders
TREE_TOL = 1e-6
FORWARD_TOL = 1e-4  # the port's backbone against transformers' (fp32)
GRID_CASES = ((37, 16), (37, 40), (16, 37), (4, 7))
HIDDEN, LAYERS, HEADS = 64, 2, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: many small eager ops under the suite's
    parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pos(src, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(1, 1 + src * src, d)).astype(np.float32)


@pytest.mark.parametrize("src,dst", GRID_CASES,
                         ids=[f"{s}to{d}" for s, d in GRID_CASES])
def test_interpolate_pos_embed_matches_jax(src, dst):
    x = _pos(src)
    ref = np.asarray(jax_interp(jnp.asarray(x), src, dst))
    out = vit.interpolate_pos_embed(torch.from_numpy(x), src, dst)
    assert out.shape == ref.shape == (1, 1 + dst * dst, 32)
    np.testing.assert_array_equal(out[:, 0].numpy(), x[:, 0])  # CLS
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=POS_TOL)


def test_interpolate_pos_embed_passes_equal_grids_through():
    x = torch.from_numpy(_pos(16))
    assert vit.interpolate_pos_embed(x, 16, 16) is x
    assert jax_interp(jnp.asarray(x.numpy()), 16, 16).shape == x.shape


@pytest.mark.parametrize("src,dst", GRID_CASES,
                         ids=[f"{s}to{d}" for s, d in GRID_CASES])
def test_interpolate_without_antialias_misses_jax(src, dst, monkeypatch):
    """torch's plain bicubic (a = -0.75) is not JAX's (a = -0.5): the
    tolerance above tells them apart, so `antialias=True` is held in
    place by the test that passes."""
    real = F.interpolate

    def plain(*a, **kw):
        return real(*a, **{**kw, "antialias": False})

    monkeypatch.setattr(vit.F, "interpolate", plain)
    x = _pos(src)
    ref = np.asarray(jax_interp(jnp.asarray(x), src, dst))
    out = vit.interpolate_pos_embed(torch.from_numpy(x), src, dst).numpy()
    assert np.abs(out - ref).max() > 100 * POS_TOL


# ---- the HF importer -------------------------------------------------------


def _backbone_kw(ffn, image_size=56):
    kw = dict(variant="small", image_size=image_size, patch_size=14,
              lora_r=1, drop_cls_token=False, hidden_dim_override=HIDDEN,
              depth_override=LAYERS, num_heads_override=HEADS,
              # Exact erf GELU: transformers' nn.GELU.
              gelu_approximate=False)
    if ffn == "swiglu":
        # HF SwiGLU hidden = round8(64 * 4 * 2/3) = 176.
        kw.update(variant="giant", mlp_ratio_override=176 / 64,
                  ffn_type_override="swiglu")
    else:
        kw.update(mlp_ratio_override=4.0)
    return kw


def _hf_model(ffn, image_size=56, seed=0):
    from transformers import Dinov2Config, Dinov2Model

    torch.manual_seed(seed)
    tcfg = Dinov2Config(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, mlp_ratio=4,
        use_swiglu_ffn=ffn == "swiglu", image_size=image_size,
        patch_size=14, layerscale_value=1.0)
    model = Dinov2Model(tcfg).eval()
    # Random LayerScale and norms, so every leaf carries information.
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "lambda1" in name or "norm" in name:
                p.add_(0.1 * torch.randn_like(p))
    return model


def _port_template(kw, seed=0):
    cfg = pcfg.BackboneConfig(**kw)
    tmpl = vit.init_backbone_params(torch.Generator().manual_seed(seed),
                                    cfg, "cpu")
    return cfg, tmpl


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_close(got, want, tol):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_importer_gives_jax_tree_across_a_grid_change(ffn):
    """A 98 px checkpoint (7 x 7 grid) imported into a 56 px config
    (4 x 4), as a 518 px one is into 224 px: the port's tree equals the
    JAX importer's leaf for leaf, the LoRA factors the template's."""
    sd = _hf_model(ffn, image_size=98).state_dict()
    kw = _backbone_kw(ffn)
    cfg, tmpl = _port_template(kw)
    out = load_dinov2_backbone_params(sd, cfg, tmpl)
    # The JAX importer on the same state dict, over the port's template
    # bridged (its LoRA factors and projection come through unchanged).
    jtmpl = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tmpl))
    ref = jax_load_backbone(sd, jcfg.BackboneConfig(**kw), jtmpl)
    assert out["pos_embed"].shape == (1, 17, HIDDEN)
    _assert_trees_close(params_to_numpy(out), ref, TREE_TOL)
    assert out["blocks"]["q"]["lora_A"] is tmpl["blocks"]["q"]["lora_A"]
    w = sd["encoder.layer.1.attention.attention.query.weight"]
    assert torch.equal(out["blocks"]["q"]["kernel"][1], w.t())
    assert out["blocks"]["q"]["kernel"].is_contiguous()


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_imported_backbone_matches_transformers(ffn, rng):
    model = _hf_model(ffn)
    cfg, tmpl = _port_template(_backbone_kw(ffn))
    params = load_dinov2_backbone_params(model.state_dict(), cfg, tmpl)
    x = rng.normal(size=(2, 56, 56, 3)).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(x.transpose(0, 3, 1, 2))
                    ).last_hidden_state
        out = vit.backbone_apply(params, cfg, torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 17, HIDDEN)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=FORWARD_TOL,
                               atol=FORWARD_TOL)
    # LoRA B is zero after the import: a perturbed A leaves the forward
    # unchanged, a perturbed B moves it.
    moved_a = {**params, "blocks": {**params["blocks"], "q": {
        **params["blocks"]["q"],
        "lora_A": params["blocks"]["q"]["lora_A"] + 100.0}}}
    moved_b = {**params, "blocks": {**params["blocks"], "q": {
        **params["blocks"]["q"],
        "lora_B": params["blocks"]["q"]["lora_B"] + 0.1}}}
    with torch.no_grad():
        same = vit.backbone_apply(moved_a, cfg, torch.from_numpy(x))
        other = vit.backbone_apply(moved_b, cfg, torch.from_numpy(x))
    assert torch.equal(same, out)
    assert (other - out).abs().max() > 1e-4


@pytest.mark.parametrize("prefix", ["dinov2.", "dino.", "backbone.dino."])
def test_wrapped_state_dicts_import_alike(prefix):
    sd = _hf_model("mlp").state_dict()
    cfg, tmpl = _port_template(_backbone_kw("mlp"))
    plain = load_dinov2_backbone_params(sd, cfg, tmpl)
    wrapped = {prefix + k: v for k, v in sd.items()}
    wrapped["decoder.class_embed.weight"] = torch.zeros(3, 3)  # ignored
    _assert_trees_close(
        params_to_numpy(load_dinov2_backbone_params(wrapped, cfg, tmpl)),
        params_to_numpy(plain), 0)


def test_checkpoint_files_and_directories(tmp_path):
    """An HF directory with pytorch_model.bin, one with model.safetensors
    (preferred when both are there), a bare file with a 'state_dict'
    key, and a bf16 checkpoint (cast to fp32 exactly) give one tree."""
    from safetensors.torch import save_file

    sd = _hf_model("mlp").state_dict()
    cfg, tmpl = _port_template(_backbone_kw("mlp"))
    want = params_to_numpy(load_dinov2_backbone_params(sd, cfg, tmpl))

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    torch.save(sd, bin_dir / "pytorch_model.bin")
    st_dir = tmp_path / "st"
    st_dir.mkdir()
    save_file({k: v.contiguous() for k, v in sd.items()},
              str(st_dir / "model.safetensors"))
    torch.save({"state_dict": {k: v * 0 for k, v in sd.items()}},
               st_dir / "pytorch_model.bin")  # not read: safetensors wins
    wrapped = tmp_path / "wrapped.pt"
    torch.save({"state_dict": sd}, wrapped)
    for src in (bin_dir, st_dir, st_dir / "model.safetensors", wrapped):
        got = params_to_numpy(load_dinov2_backbone_params(str(src), cfg,
                                                          tmpl))
        _assert_trees_close(got, want, 0)

    half = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    loaded = _load_state_dict(half)
    assert all(v.dtype == torch.float32 for v in loaded.values())
    assert all(torch.equal(loaded[k], half[k].float()) for k in half)

    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        load_dinov2_backbone_params(str(empty), cfg, tmpl)


@pytest.mark.parametrize("moe_blocks", [1, 2], ids=["split", "full_depth"])
def test_upcycling_import_matches_jax_and_the_dense_block(moe_blocks, rng):
    """Sparse upcycling into the MoE backbone (the last `moe_blocks` of 2
    blocks MoE, 4 experts): the port's tree equals the JAX importer's leaf
    for leaf (every expert the block's dense fc1 / fc2, the routers and
    LoRA factors the template's). With ample capacity (factor E / top_k:
    no token dropped) the upcycled backbone computes the dense import's
    features (within FORWARD_TOL) whatever the router says, and its
    load-balance loss is finite. A SwiGLU checkpoint raises as in JAX."""
    sd = _hf_model("mlp", image_size=98).state_dict()
    kw = {**_backbone_kw("mlp"), "ffn_type_override": "moe",
          "moe_num_experts": 4, "moe_capacity_factor": 2.0,
          "lora_last_n_blocks": moe_blocks}
    cfg, tmpl = _port_template(kw)
    out = load_dinov2_backbone_params(sd, cfg, tmpl)
    jtmpl = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tmpl))
    ref = jax_load_backbone(sd, jcfg.BackboneConfig(**kw), jtmpl)
    _assert_trees_close(params_to_numpy(out), ref, TREE_TOL)
    assert ("blocks" in out) == (moe_blocks == 1)
    moe = out["moe_blocks"]["moe"]
    assert moe["router_kernel"] is tmpl["moe_blocks"]["moe"]["router_kernel"]
    w = sd[f"encoder.layer.{LAYERS - 1}.mlp.fc1.weight"]
    for e in range(4):
        assert torch.equal(moe["fc1_kernel"][-1, e], w.t())

    dense_cfg, dense_tmpl = _port_template(_backbone_kw("mlp"))
    dense = load_dinov2_backbone_params(sd, dense_cfg, dense_tmpl)
    x = torch.from_numpy(rng.normal(size=(2, 56, 56, 3)).astype(np.float32))
    with torch.no_grad():
        feats, aux = vit.backbone_apply(out, cfg, x)
        want = vit.backbone_apply(dense, dense_cfg, x)
    np.testing.assert_allclose(feats.numpy(), want.numpy(), rtol=0,
                               atol=FORWARD_TOL)
    assert torch.isfinite(aux)

    swiglu = _hf_model("swiglu").state_dict()
    for load, c, t in ((load_dinov2_backbone_params, cfg, tmpl),
                       (jax_load_backbone, jcfg.BackboneConfig(**kw), jtmpl)):
        with pytest.raises(ValueError, match="SwiGLU"):
            load(swiglu, c, t)


def test_importer_reads_a_jax_bridged_state_dict():
    """numpy values (the JAX exporter's output type) import as tensors
    do, and the tree lands on the template's device in fp32."""
    sd = _hf_model("mlp").state_dict()
    cfg, tmpl = _port_template(_backbone_kw("mlp"))
    as_np = {k: v.numpy() for k, v in sd.items()}
    a = load_dinov2_backbone_params(as_np, cfg, tmpl)
    b = load_dinov2_backbone_params(sd, cfg, tmpl)
    _assert_trees_close(params_to_numpy(a), params_to_numpy(b), 0)
    assert a["pos_embed"].dtype == torch.float32
    assert a["pos_embed"].device.type == "cpu"


# ---- the training CLI ------------------------------------------------------


def test_cli_pretrained_backbone_then_reference_round_trip(tmp_path):
    """`--pretrained_backbone DIR` trains from the imported backbone; the
    run's final params, saved with save_reference_checkpoint and read back
    by `--import_reference_checkpoint --only_evaluate`, give the run's
    final validation AP exactly."""
    from transformers import Dinov2Config, Dinov2Model

    from dinov2_od_tpu_torch.data.synthetic import write_coco_dataset
    from dinov2_od_tpu_torch.inference import checkpoint_params
    from dinov2_od_tpu_torch.models.export_reference import (
        save_reference_checkpoint,
    )
    from dinov2_od_tpu_torch.train import cli

    images, ann = write_coco_dataset(str(tmp_path / "data"), num_images=4,
                                     image_size=56, seed=3, max_objects=2)
    # The lightweight config's backbone: ViT-S/14, 12 blocks of 6 heads.
    torch.manual_seed(0)
    hf = Dinov2Model(Dinov2Config(
        hidden_size=384, num_hidden_layers=12, num_attention_heads=6,
        image_size=98, patch_size=14))
    hf_dir = tmp_path / "hf"
    hf_dir.mkdir()
    torch.save(hf.state_dict(), hf_dir / "pytorch_model.bin")

    common = ["--val_images", images, "--val_annotations", ann,
              "--lightweight", "--image_size", "56", "--batch_size", "2",
              "--device", "cpu", "--save_on_preemption", "false"]
    out = str(tmp_path / "run")
    assert cli.main(common + [
        "--train_images", images, "--train_annotations", ann,
        "--num_epochs", "1", "--val_frequency", "1",
        "--pretrained_backbone", str(hf_dir), "--output_dir", out]) == 0
    with open(os.path.join(out, "metrics_epoch_0.json")) as f:
        trained_ap = json.load(f)

    det = cli.build_detector_config(cli.build_arg_parser().parse_args(
        common))
    final = checkpoint_params(os.path.join(out, "final_model"), det, "cpu")
    # The frozen backbone is still the imported one.
    w = hf.state_dict()["encoder.layer.3.mlp.fc2.weight"]
    assert torch.equal(final["backbone"]["blocks"]["fc2"]["kernel"][3],
                       w.t())
    ref_file = str(tmp_path / "reference.pt")
    save_reference_checkpoint(ref_file, final, det)
    ev = str(tmp_path / "eval")
    assert cli.main(common + ["--only_evaluate", "--output_dir", ev,
                              "--import_reference_checkpoint",
                              ref_file]) == 0
    with open(os.path.join(ev, "metrics_epoch_0.json")) as f:
        assert json.load(f) == trained_ap
