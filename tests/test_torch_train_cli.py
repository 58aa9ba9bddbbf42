"""The port's training CLI and server entry point
(dinov2_od_tpu_torch/train/cli.py `main`, serve.py `main`) on the CPU at
the --lightweight config (ViT-S, decoder width 256) and 56 px: --debug
training with validation, --only_evaluate in fp32 and int8 from the
checkpoint it wrote, the MoE backbone trained and restored from its
checkpoint, every flag of a later slice (each raises
NotImplementedError naming its ROADMAP.md item), the import flags on a
missing path, the devices and decode backends, and `serve.main` serving
a saved checkpoint over HTTP.
"""

import base64
import io
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

import dinov2_od_tpu.train.cli as jcli

from dinov2_od_tpu_torch import serve
from dinov2_od_tpu_torch.data.synthetic import write_coco_dataset
from dinov2_od_tpu_torch.models.detector import init_detector_params
from dinov2_od_tpu_torch.train import cli


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small eager ops, and
    under the suite's parallel workers torch's default of a thread a
    core oversubscribes the machine (a test ~30x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    return write_coco_dataset(str(root), num_images=8, image_size=56, seed=7,
                              max_objects=2)


def test_main_debug_then_only_evaluate(tmp_path, synth):
    images_dir, ann = synth
    out = str(tmp_path / "debug")
    args = ["--train_images", images_dir, "--train_annotations", ann,
            "--val_images", images_dir, "--val_annotations", ann,
            "--lightweight", "--image_size", "56", "--batch_size", "2",
            "--debug", "--debug_samples", "4", "--num_epochs", "2",
            "--val_frequency", "5", "--output_dir", out, "--device", "cpu"]
    assert cli.main(args) == 0
    # --debug validates every val_frequency // 5 epochs on the subset.
    for epoch in (0, 1):
        with open(os.path.join(out, f"metrics_epoch_{epoch}.json")) as f:
            assert set(json.load(f)) >= {"AP", "AP50", "AP75"}
    with open(os.path.join(out, "predictions_epoch_1.json")) as f:
        assert {d["image_id"] for d in json.load(f)} <= set(range(1, 9))

    final = os.path.join(out, "final_model")
    ev = ["--val_images", images_dir, "--val_annotations", ann,
          "--lightweight", "--image_size", "56", "--batch_size", "3",
          "--only_evaluate", "--checkpoint", final, "--device", "cpu"]
    aps = {}
    for extra in ([], ["--quantize", "int8"]):
        eval_out = str(tmp_path / f"eval{len(extra)}")
        assert cli.main(ev + ["--output_dir", eval_out] + extra) == 0
        with open(os.path.join(eval_out, "metrics_epoch_0.json")) as f:
            aps[len(extra)] = json.load(f)["AP"]
        with open(os.path.join(eval_out, "predictions_epoch_0.json")) as f:
            assert len(json.load(f)) > 0
    assert all(0.0 <= ap <= 1.0 for ap in aps.values())
    assert cli.main(["--only_evaluate", "--lightweight", "--device", "cpu",
                     "--output_dir", str(tmp_path / "none")]) == 1


LATER_SLICES = [
    ["--distributed"], ["--multihost"], ["--model_parallel", "2"],
    ["--context_parallel"], ["--context_parallel_size", "2"],
    ["--pipeline_parallel"], ["--pipeline_parallel_size", "2"],
    ["--pipeline_microbatches", "4"], ["--fsdp"], ["--download_val_data"],
    ["--compilation_cache", "x"],
]


@pytest.mark.parametrize("flags", LATER_SLICES, ids=lambda f: f[0])
def test_flags_of_later_slices_raise(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(flags + ["--output_dir", str(tmp_path), "--device", "cpu"])


@pytest.mark.parametrize("flag", ["--pretrained_backbone",
                                  "--import_reference_checkpoint"])
def test_import_flags_raise_on_a_missing_path(flag, tmp_path):
    """Both import flags run (they raised NotImplementedError before the
    importers were ported); a path that is not there raises the JAX
    package's error, FileNotFoundError, from the same loader."""
    from dinov2_od_tpu.models.import_torch import _load_state_dict

    missing = str(tmp_path / "x")
    with pytest.raises(FileNotFoundError):
        _load_state_dict(missing)
    with pytest.raises(FileNotFoundError):
        cli.main([flag, missing, "--lightweight", "--image_size", "56",
                  "--output_dir", str(tmp_path), "--device", "cpu"])


def test_cli_devices_and_decode_backends(tmp_path, synth, monkeypatch):
    images_dir, ann = synth
    base = ["--train_images", images_dir, "--train_annotations", ann,
            "--lightweight", "--image_size", "56", "--output_dir",
            str(tmp_path)]
    with pytest.raises(ValueError, match="--device"):
        cli.main(base + ["--device", "tpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(base)  # --device defaults to cuda
    assert (cli.build_arg_parser().parse_args(base).decode_backend
            == jcli.build_arg_parser().parse_args(base).decode_backend
            == "auto")
    flags = lambda p: {s for a in p._actions for s in a.option_strings}
    assert flags(cli.build_arg_parser()) == flags(jcli.build_arg_parser())


def test_main_trains_the_moe_backbone_and_serves_its_checkpoint(
        tmp_path, synth, monkeypatch):
    """`--ffn_type moe --moe_experts 4` builds the JAX CLI's config (the
    four --moe_* flags passed on), trains 2 tiny epochs whose records
    carry each step's finite loss_moe_aux, and `Predictor.from_checkpoint`
    on its final_model holds the loop's final params bit for bit and gives
    their detections exactly."""
    from dinov2_od_tpu_torch.inference import Predictor
    from dinov2_od_tpu_torch.train import loop
    from dinov2_od_tpu_torch.train.state import tree_leaves

    images_dir, ann = synth
    out = str(tmp_path / "moe")
    model = ["--lightweight", "--image_size", "56", "--ffn_type", "moe",
             "--moe_experts", "4", "--moe_capacity_factor", "1.5"]
    args = ["--train_images", images_dir, "--train_annotations", ann,
            "--val_images", images_dir, "--val_annotations", ann,
            "--batch_size", "2", "--debug", "--debug_samples", "4",
            "--num_epochs", "2", "--val_frequency", "5", "--output_dir", out,
            "--device", "cpu"] + model
    det = cli.build_detector_config(cli.build_arg_parser().parse_args(args))
    jdet = jcli.build_detector_config(jcli.build_arg_parser().parse_args(
        args))
    assert det.backbone.ffn_type == "moe"
    for f in ("moe_num_experts", "moe_top_k", "moe_capacity_factor",
              "moe_aux_weight", "ffn_type_override", "lora_last_n_blocks"):
        assert getattr(det.backbone, f) == getattr(jdet.backbone, f), f
    assert (det.backbone.moe_num_experts,
            det.backbone.moe_capacity_factor) == (4, 1.5)

    kept = {}
    real = loop.run_training

    def keep(*a, **k):
        kept["state"] = real(*a, **k)
        return kept["state"]

    monkeypatch.setattr(loop, "run_training", keep)
    assert cli.main(args) == 0
    with open(os.path.join(out, "train_epoch_1.json")) as f:
        rec = json.load(f)
    aux = rec["loss_moe_aux"]
    assert len(aux) == len(rec["losses"]) == 2
    assert np.isfinite(aux).all() and min(aux) > 0
    assert rec["mean_loss_moe_aux"] == pytest.approx(np.mean(aux))

    images = list(np.random.default_rng(3).uniform(
        size=(3, 56, 56, 3)).astype(np.float32))
    served = Predictor.from_checkpoint(
        os.path.join(out, "final_model"), detector_cfg=det, batch_size=2,
        device="cpu")
    direct = Predictor(kept["state"].params, det, batch_size=2,
                       device="cpu")
    assert "moe_blocks" in served.params["backbone"]
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(served.params), tree_leaves(direct.params)))
    assert (served.detect(images, score_threshold=0.0)
            == direct.detect(images, score_threshold=0.0))


def _png_b64(rng, size=40):
    from PIL import Image

    arr = (rng.uniform(size=(size, size, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_serve_main_serves_a_checkpoint_over_http(tmp_path):
    from dinov2_od_tpu_torch.config import lightweight_detector_config
    from dinov2_od_tpu_torch.train.checkpoint import save_final_params

    cfg = lightweight_detector_config(image_size=56)
    params = init_detector_params(torch.Generator().manual_seed(3), cfg,
                                  device="cpu")
    path = save_final_params(str(tmp_path), params)
    ready, result = [], {}
    args = ["--checkpoint", path, "--lightweight", "--image_size", "56",
            "--batch_size", "2", "--device", "cpu", "--host", "127.0.0.1",
            "--port", "0", "--max_batch", "4", "--batch_wait_ms", "20"]
    t = threading.Thread(
        target=lambda: result.setdefault(
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
        assert health["status"] == "ok" and health["backend"] == "cpu"
        rng = np.random.default_rng(0)
        body = json.dumps({"images": [_png_b64(rng), _png_b64(rng)],
                           "score_threshold": 0.0}).encode()
        req = urllib.request.Request(url + "/detect", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            dets = json.load(r)["detections"]
        assert len(dets) == 2 and all(len(d) > 0 for d in dets)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            text = r.read().decode()
        assert "serving_images_total 2" in text
        assert "serving_device_batches_total 1" in text
    finally:
        if ready:
            ready[0].shutdown()
        t.join(timeout=60)
    assert not t.is_alive() and result["rc"] == 0
    # --bundle serves a bundle of tools/export.py; a directory without
    # one raises as the JAX package's loader does.
    with pytest.raises(FileNotFoundError, match="manifest.json"):
        serve.main(["--bundle", str(tmp_path / "no_bundle"),
                    "--device", "cpu"])
