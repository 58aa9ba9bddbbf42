"""The port's weights-out path against the JAX package on the CPU at tiny
widths: the reference-format state dict (dinov2_od_tpu_torch/models/
export_reference.py) against the JAX exporter's on one bridged tree and
both round trips through the two importers; the serving bundle
(dinov2_od_tpu_torch/export.py) reloaded bit for bit in fp32, bf16 and
int8 (kernel_q K-major again), equal to the in-memory Predictor, chunked
and padded as the JAX loader chunks, and its detections against the JAX
bundle's; tools/export.main and serve.main --bundle answering a request."""

import base64
import io
import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.export import export_serving_bundle as jax_export_bundle
from dinov2_od_tpu.export import load_serving_bundle as jax_load_bundle
from dinov2_od_tpu.models import init_detector_params as jax_init
from dinov2_od_tpu.models.export_reference import (
    export_reference_state_dict as jax_export_reference,
)
from dinov2_od_tpu.models.import_reference import (
    load_reference_detector_params as jax_import_reference,
)

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch import serve
from dinov2_od_tpu_torch.export import (
    _unflatten_params,
    export_serving_bundle,
    load_serving_bundle,
)
from dinov2_od_tpu_torch.inference import Predictor, prepare_images
from dinov2_od_tpu_torch.models.detector import (
    cast_frozen_weights,
    fold_detector_lora,
    init_detector_params,
)
from dinov2_od_tpu_torch.models.export_reference import (
    export_reference_state_dict,
    save_reference_checkpoint,
)
from dinov2_od_tpu_torch.models.import_reference import (
    load_reference_detector_params,
)
from dinov2_od_tpu_torch.models.quantize import quantize_detector_int8
from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy
from dinov2_od_tpu_torch.train.checkpoint import flatten_tree

BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=2, lora_r=2,
                lora_last_n_blocks=1, target_dim=32)
DECODER = dict(hidden_dim=32, num_queries=5, num_layers=2, num_heads=4,
               dim_feedforward=64, num_classes=6)
SCORE_TOL, BBOX_TOL = 1e-5, 1e-3  # test_torch_inference.py's, vs JAX


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: many small eager ops under the suite's
    parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(deformable=True, **backbone):
    dec = dict(DECODER, use_deformable=deformable,
               tie_layer_weights=deformable)  # the reference ties them
    bb = dict(BACKBONE, **backbone)
    return (jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**bb),
                                decoder=jcfg.DecoderConfig(**dec)),
            pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**bb),
                                decoder=pcfg.DecoderConfig(**dec)))


def _tree(jc, seed=0):
    """A JAX param tree as numpy, with nonzero LoRA B on every linear so
    the adapters carry information through the exports."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax_init(jax.random.key(seed), jc))
    rng = np.random.default_rng(seed)
    for lin in tree["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = (0.05 * rng.normal(size=lin["lora_B"].shape)
                             ).astype(np.float32)
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _images(n, seed=0):
    return [np.random.default_rng(seed + i).uniform(size=(56, 56, 3))
            .astype(np.float32) for i in range(n)]


# ---- the reference state dict ---------------------------------------------


@pytest.mark.parametrize("deformable", [True, False],
                         ids=["deformable", "standard"])
def test_reference_export_matches_jax(deformable):
    jc, pc = _cfgs(deformable)
    tree = _tree(jc)
    want = jax_export_reference(tree, jc)
    got = export_reference_state_dict(params_from_numpy(tree, device="cpu"),
                                      pc)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert "backbone.dino.embeddings.mask_token" in got
    assert "backbone.dino.encoder.layer.1.mlp.fc2.linear.weight" in got
    assert "backbone.dino.encoder.layer.0.mlp.fc2.weight" in got


@pytest.mark.parametrize("deformable", [True, False],
                         ids=["deformable", "standard"])
def test_reference_round_trips_across_frameworks(deformable):
    """The port's import of JAX's export and JAX's import of the port's
    export each give the source tree back, but for the LoRA factors of
    the blocks without adapters, which the reference format drops and
    both importers zero."""
    jc, pc = _cfgs(deformable)
    tree = _tree(jc)
    src = params_from_numpy(tree, device="cpu")
    port_back = params_to_numpy(load_reference_detector_params(
        jax_export_reference(tree, jc), pc, src))
    jax_back = jax_import_reference(
        export_reference_state_dict(src, pc), jc,
        jax.tree_util.tree_map(jnp.asarray, tree))
    first = pc.backbone.depth - pc.backbone.lora_last_n_blocks
    want = _flat(tree)
    for back in (_flat(port_back), _flat(jax_back)):
        assert back.keys() == want.keys()
        for k, v in want.items():
            if k.endswith(("lora_A", "lora_B")):
                np.testing.assert_array_equal(back[k][first:], v[first:], k)
                assert not back[k][:first].any(), k
            else:
                np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_reference_checkpoint_of_a_bf16_tree(tmp_path):
    """Frozen leaves stored in bf16 are written as fp32 (exact) and come
    back bit for bit once cast again; the file holds no views of the
    stacked leaves."""
    _, pc = _cfgs(True, dtype="bfloat16")
    params = cast_frozen_weights(
        init_detector_params(torch.Generator().manual_seed(1), pc,
                             device="cpu"), pc)
    path = save_reference_checkpoint(str(tmp_path / "ref.pt"), params, pc)
    sd = torch.load(path, weights_only=True)
    assert all(v.dtype == torch.float32 for v in sd.values())
    q = params["backbone"]["blocks"]["q"]["kernel"]
    assert torch.equal(
        sd["backbone.dino.encoder.layer.0.attention.attention.query.weight"],
        q[0].float().t())
    assert sd["backbone.dino.layernorm.weight"].untyped_storage().nbytes() \
        == 4 * BACKBONE["hidden_dim_override"]
    back = cast_frozen_weights(load_reference_detector_params(
        path, pc, params), pc)
    first = pc.backbone.depth - pc.backbone.lora_last_n_blocks
    got, want = _flat(params_to_numpy(back)), _flat(params_to_numpy(params))
    for k, v in want.items():
        if k.endswith(("lora_A", "lora_B")):
            v, got[k] = v[first:], got[k][first:]
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert back["backbone"]["blocks"]["q"]["kernel"].dtype == torch.bfloat16


# ---- the serving bundle ----------------------------------------------------


def test_param_flatten_round_trip_preserves_dtypes():
    tree = {"a": {"w": torch.ones(2, 3, dtype=torch.bfloat16),
                  "b": torch.arange(4, dtype=torch.int8)},
            "c": torch.full((1,), 2.5)}
    flat = flatten_tree(tree)
    assert set(flat) == {"a/w", "a/b", "c"}
    back = _unflatten_params(flat)
    assert back["a"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["a"]["b"], tree["a"]["b"])


def _leaves_equal(loaded, want):
    a, b = flatten_tree(loaded), flatten_tree(want)
    assert a.keys() == b.keys()
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        # Bit for bit, through an integer view of the same bytes.
        assert torch.equal(a[k].contiguous().view(torch.uint8),
                           b[k].contiguous().view(torch.uint8)), k


MOE = dict(ffn_type_override="moe", moe_num_experts=4, moe_top_k=2,
           moe_capacity_factor=1.5, moe_aux_weight=0.02)


@pytest.mark.parametrize("dtype,quantize,ffn", [
    ("float32", None, {}), ("bfloat16", None, {}), ("bfloat16", "int8", {}),
    ("bfloat16", None, MOE), ("bfloat16", "int8", MOE)],
    ids=["fp32", "bf16", "bf16-int8", "bf16-moe", "bf16-int8-moe"])
def test_bundle_round_trips_and_equals_the_predictor(tmp_path, dtype,
                                                     quantize, ffn):
    """The MoE cases: the manifest's config carries the four moe_* fields
    back, the MoE suffix's experts and routers stay fp32 (int8 takes its
    q, k, v and proj), and the loaded bundle serves as the Predictor."""
    _, pc = _cfgs(True, dtype=dtype, **ffn)
    params = init_detector_params(torch.Generator().manual_seed(0), pc,
                                  device="cpu")
    if dtype == "bfloat16":
        params = cast_frozen_weights(params, pc)
    labels = {i: 10 * (i + 1) for i in range(6)}
    names = {10 * (i + 1): f"color_{i}" for i in range(6)}
    out = export_serving_bundle(
        params, pc, str(tmp_path / "b"), batch_sizes=(2,), max_detections=5,
        quantize=quantize, label_to_cat_id=labels, class_names=names)
    assert sorted(os.listdir(out)) == ["manifest.json", "params.npz"]
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["quantize"] == quantize
    assert manifest["torch_version"] == torch.__version__
    assert manifest["detector_config"]["backbone"]["dtype"] == dtype
    for key, value in ffn.items():
        assert manifest["detector_config"]["backbone"][key] == value

    model = load_serving_bundle(out, device="cpu")
    assert model.cfg == pc and model.device.type == "cpu"
    served = fold_detector_lora(params, pc)
    if quantize:
        served = quantize_detector_int8(served, pc)
    _leaves_equal(model.params, served)
    if quantize:
        kq = model.params["backbone"]["blocks"]["fc2"]["kernel_q"]
        assert kq.dtype == torch.int8 and kq.transpose(-1, -2).is_contiguous()
        assert model.params["backbone"]["blocks"]["q"]["w_scale"].dtype \
            == torch.float32
    if ffn:
        moe_blocks = model.params["backbone"]["moe_blocks"]
        assert moe_blocks["moe"]["fc1_kernel"].dtype == torch.float32
        assert ("kernel_q" in moe_blocks["proj"]) == (quantize == "int8")

    pred = Predictor(params, pc, batch_size=2, quantize=quantize,
                     device="cpu", label_to_cat_id=labels, class_names=names)
    imgs = _images(2)
    pixel, sizes = prepare_images(imgs, 56, True)
    want = pred._forward_topk(torch.from_numpy(pixel), torch.from_numpy(sizes),
                              5).numpy()
    np.testing.assert_array_equal(model.call_packed(pixel, sizes), want)
    assert model.detect(imgs, score_threshold=0.0) == pred.detect(
        imgs, score_threshold=0.0, max_detections=5)
    assert model.label_to_cat_id == labels and model.class_names == names


def test_bundle_chunks_and_pads_over_batch_sizes(tmp_path):
    _, pc = _cfgs(True)
    params = init_detector_params(torch.Generator().manual_seed(1), pc,
                                  device="cpu")
    model = load_serving_bundle(export_serving_bundle(
        params, pc, str(tmp_path / "b"), batch_sizes=(4, 1),
        max_detections=5), device="cpu")
    assert model.batch_sizes == [1, 4]
    assert model._chunks(9) == [(0, 4), (4, 4), (8, 1)]
    assert model._chunks(3) == [(0, 4)]
    assert model._chunks(0) == []

    pixel, sizes = prepare_images(_images(4, seed=9), 56, True)
    full = model.call_packed(pixel, sizes)
    part = model.call_packed(pixel[:3], sizes[:3])  # padded onto 4
    np.testing.assert_array_equal(part, full[:3])
    assert model.device_batches == 2
    assert model.call_packed(pixel[:0], sizes[:0]).shape == (0, 5, 6)

    with pytest.raises(ValueError, match="quantize"):
        export_serving_bundle(params, pc, str(tmp_path / "x"),
                              quantize="int4")
    with pytest.raises(ValueError, match="batch_sizes"):
        export_serving_bundle(params, pc, str(tmp_path / "y"),
                              batch_sizes=(0, 2))
    with pytest.raises(FileNotFoundError):
        load_serving_bundle(str(tmp_path / "missing"), device="cpu")


def test_bundle_detect_matches_jax_bundle(tmp_path):
    """One bridged tree through both exporters and loaders: the same
    detections within the tolerances the Predictor is held to."""
    jc, pc = _cfgs(True)
    tree = _tree(jc, seed=4)
    jax_export_bundle(jax.tree_util.tree_map(jnp.asarray, tree), jc,
                      str(tmp_path / "jax"), batch_sizes=(4,),
                      max_detections=8)
    export_serving_bundle(params_from_numpy(tree, device="cpu"), pc,
                          str(tmp_path / "port"), batch_sizes=(4,),
                          max_detections=8)
    imgs = _images(5, seed=2)  # two chunks, the second padded
    ref = jax_load_bundle(str(tmp_path / "jax")).detect(imgs, 0.0)
    out = load_serving_bundle(str(tmp_path / "port"), device="cpu").detect(
        imgs, 0.0)
    assert len(out) == len(ref) == 5
    for got, want in zip(out, ref):
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g["category_id"] == w["category_id"]
            assert abs(g["score"] - w["score"]) <= SCORE_TOL
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=BBOX_TOL)


def _png_b64(arr_u8):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_tools_export_then_serve_main_bundle(tmp_path):
    """A checkpoint of the training loop through tools/export.main, then
    `serve.main --bundle --device cpu` in a thread: POST /detect answers
    what ServingModel.detect returns on the same images."""
    from dinov2_od_tpu_torch.config import lightweight_detector_config
    from dinov2_od_tpu_torch.tools import export as export_tool
    from dinov2_od_tpu_torch.train.checkpoint import save_final_params

    cfg = lightweight_detector_config(image_size=56)
    params = init_detector_params(torch.Generator().manual_seed(3), cfg,
                                  device="cpu")
    ckpt = save_final_params(str(tmp_path), params)
    bundle = str(tmp_path / "bundle")
    assert export_tool.main([
        "--checkpoint", ckpt, "--output_dir", bundle, "--lightweight",
        "--image_size", "56", "--batch_sizes", "1,2",
        "--max_detections", "10", "--device", "cpu"]) == 0
    model = load_serving_bundle(bundle, device="cpu")
    _leaves_equal(model.params, fold_detector_lora(params, cfg))

    rng = np.random.default_rng(0)
    u8 = [(rng.uniform(size=(40, 48, 3)) * 255).astype(np.uint8)
          for _ in range(3)]
    # Run from a thread, as the server's batcher runs it: on the CPU the
    # main thread's GEMMs can round apart from another thread's in the
    # last bit.
    want = []
    worker = threading.Thread(target=lambda: want.extend(model.detect(
        [a.astype(np.float32) / 255.0 for a in u8], 0.0)))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    ready, result = [], {}
    args = ["--bundle", bundle, "--device", "cpu", "--host", "127.0.0.1",
            "--port", "0", "--max_batch", "4", "--batch_wait_ms", "20"]
    t = threading.Thread(target=lambda: result.setdefault(
        "rc", serve.main(args, on_ready=ready.append)))
    t.start()
    try:
        for _ in range(600):
            if ready or not t.is_alive():
                break
            t.join(timeout=0.1)
        assert ready, "server did not start"
        url = f"http://127.0.0.1:{ready[0].server_address[1]}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.load(r)
        assert health == {"status": "ok", "model": "bundle:" + bundle,
                          "quantize": "no", "backend": "cpu"}
        body = json.dumps({"images": [_png_b64(a) for a in u8],
                           "score_threshold": 0.0}).encode()
        req = urllib.request.Request(
            url + "/detect", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.load(r)["detections"]
        served = ready[0].RequestHandlerClass.model
        # The warm-up (1 image, the b1 size), then 3 images on b2 + b1.
        assert served.device_batches == 3
    finally:
        if ready:
            ready[0].shutdown()
        t.join(timeout=60)
    assert not t.is_alive() and result["rc"] == 0
    assert got == want and all(len(d) == 10 for d in got)
