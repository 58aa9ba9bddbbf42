"""The port's serving surface (dinov2_od_tpu_torch: postprocess, inference,
serve) against the JAX package, and its HTTP server, on the CPU at a tiny
size; plus the rule that the port imports nothing of JAX."""

import ast
import base64
import io
import json
import pathlib
import threading
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.evaluation import postprocess as jpost
from dinov2_od_tpu.inference import Predictor as JaxPredictor
from dinov2_od_tpu.inference import prepare_images as jax_prepare_images
from dinov2_od_tpu.models import init_detector_params as jax_init

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.evaluation import postprocess as ppost
from dinov2_od_tpu_torch.inference import Predictor, prepare_images
from dinov2_od_tpu_torch.models.detector import init_detector_params
from dinov2_od_tpu_torch.params import params_from_numpy
from dinov2_od_tpu_torch.serve import (
    DynamicBatcher,
    install_drain_handler,
    make_server,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
BACKBONE = dict(variant="small", image_size=56, hidden_dim_override=128,
                num_heads_override=2, depth_override=2, lora_r=2,
                lora_last_n_blocks=1, target_dim=32)
DECODER = dict(hidden_dim=32, num_queries=5, num_layers=1, num_heads=4,
               dim_feedforward=64, num_classes=6)


def _cfgs():
    return (
        jcfg.DetectorConfig(backbone=jcfg.BackboneConfig(**BACKBONE),
                            decoder=jcfg.DecoderConfig(**DECODER)),
        pcfg.DetectorConfig(backbone=pcfg.BackboneConfig(**BACKBONE),
                            decoder=pcfg.DecoderConfig(**DECODER)),
    )


# ---- post-processing -------------------------------------------------------


@pytest.mark.parametrize("parity_mode", [False, True])
def test_select_topk_matches_jax(parity_mode):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 5)).astype(np.float32) * 3
    boxes = rng.uniform(size=(3, 7, 4)).astype(np.float32)
    sizes = np.array([[40, 60], [56, 56], [100, 30]], np.int32)
    ref = jpost.select_topk_detections(
        jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(sizes),
        max_detections=12, parity_mode=parity_mode)
    out = ppost.select_topk_detections(
        torch.from_numpy(logits), torch.from_numpy(boxes),
        torch.from_numpy(sizes), max_detections=12, parity_mode=parity_mode)
    # Scores are distinct, so labels and boxes compare position by
    # position.
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(out[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-6, atol=1e-4)


def test_select_topk_ties_give_the_same_score_set():
    """torch.topk and lax.top_k may order equal scores differently:
    compare the selected score sets."""
    logits = np.zeros((2, 4, 3), np.float32)
    logits[:, 1] = 2.0
    boxes = np.full((2, 4, 4), 0.5, np.float32)
    sizes = np.full((2, 2), 10, np.int32)
    ref = jpost.select_topk_detections(
        jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(sizes),
        max_detections=5)
    out = ppost.select_topk_detections(
        torch.from_numpy(logits), torch.from_numpy(boxes),
        torch.from_numpy(sizes), max_detections=5)
    np.testing.assert_allclose(np.sort(out[0].numpy(), axis=1),
                               np.sort(np.asarray(ref[0]), axis=1),
                               rtol=1e-6)


def test_format_and_threshold_match_jax():
    rng = np.random.default_rng(1)
    scores = rng.uniform(size=(2, 6)).astype(np.float32)
    labels = rng.integers(0, 5, size=(2, 6))
    boxes = rng.uniform(size=(2, 6, 4)).astype(np.float32)
    lut = {0: 1, 1: 2, 3: 7}
    for mapping in ({}, lut):
        ref = jpost.format_detections(scores, labels, boxes, [4, 9], mapping,
                                      score_threshold=0.3)
        out = ppost.format_detections(scores, labels, boxes, [4, 9], mapping,
                                      score_threshold=0.3)
        assert out == ref


# ---- prepare_images and Predictor ------------------------------------------


def test_prepare_images_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    path = str(tmp_path / "im.png")
    Image.fromarray((rng.uniform(size=(30, 40, 3)) * 255).astype(np.uint8)
                    ).save(path)
    images = [rng.uniform(size=(56, 56, 3)).astype(np.float32),
              rng.uniform(size=(33, 47, 3)).astype(np.float32), path]
    for normalize in (True, False):
        ref = jax_prepare_images(images, 56, normalize)
        out = prepare_images(images, 56, normalize)
        np.testing.assert_array_equal(out[1], ref[1])
        np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def bridged():
    jc, pc = _cfgs()
    tree = jax.tree_util.tree_map(
        lambda a: np.array(a, copy=True),
        jax_init(jax.random.key(0), jc))
    rng = np.random.default_rng(3)
    for lin in tree["backbone"]["blocks"].values():
        if isinstance(lin, dict) and "lora_B" in lin:
            lin["lora_B"] = rng.normal(0, 0.1, lin["lora_B"].shape).astype(
                np.float32)
    return tree, jc, pc


def test_predictor_detect_matches_jax(bridged):
    """Predictor.detect on bridged params (LoRA folded, batch padding:
    3 images at batch size 2) against the JAX Predictor. fp32 scores
    agree to 1e-5; boxes are in pixels (x56), so to 1e-3."""
    tree, jc, pc = bridged
    rng = np.random.default_rng(4)
    images = [rng.uniform(size=(56, 56, 3)).astype(np.float32)
              for _ in range(3)]
    labels = {i: 10 + i for i in range(6)}
    ref = JaxPredictor(jax.tree_util.tree_map(jnp.asarray, tree), jc,
                       label_to_cat_id=labels, batch_size=2).detect(
        images, score_threshold=0.0, max_detections=8)
    pred = Predictor(params_from_numpy(tree, device="cpu"), pc,
                     label_to_cat_id=labels, batch_size=2, device="cpu")
    out = pred.detect(images, score_threshold=0.0, max_detections=8)
    assert pred.device_batches == 2
    assert len(out) == len(ref) == 3
    for got, want in zip(out, ref):
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g["category_id"] == w["category_id"]
            assert abs(g["score"] - w["score"]) <= 1e-5
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-3)


def test_double_buffered_detect_equals_sequential_and_jax(bridged):
    """5 images at batch size 2: three chunks, the last padded. The
    double-buffered schedule (chunk i+1 dispatched before chunk i's
    top-k is read back) gives the sequential schedule's detections
    exactly, and the JAX Predictor's within the tolerances above."""
    tree, jc, pc = bridged
    rng = np.random.default_rng(5)
    images = [rng.uniform(size=(56, 56, 3)).astype(np.float32)
              for _ in range(5)]
    ref = JaxPredictor(jax.tree_util.tree_map(jnp.asarray, tree), jc,
                       batch_size=2).detect(images, score_threshold=0.0,
                                            max_detections=8)
    pred = Predictor(params_from_numpy(tree, device="cpu"), pc,
                     batch_size=2, device="cpu")
    assert pred.overlap_chunks
    out = pred.detect(images, score_threshold=0.0, max_detections=8)
    assert pred.device_batches == 3
    pred.overlap_chunks = False
    seq = pred.detect(images, score_threshold=0.0, max_detections=8)
    assert pred.device_batches == 6
    assert out == seq
    assert len(out) == len(ref) == 5
    for got, want in zip(out, ref):
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert g["category_id"] == w["category_id"]
            assert abs(g["score"] - w["score"]) <= 1e-5
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-3)


def test_entry_points_need_cuda_unless_asked_for_cpu(bridged, monkeypatch):
    tree, _, pc = bridged
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(params_from_numpy(tree, device="cpu"), pc)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_detector_params(torch.Generator(), pc)
    # int8 serving quantizes after folding; unfolded LoRA raises.
    with pytest.raises(ValueError, match="fold_detector_lora"):
        Predictor(params_from_numpy(tree, device="cpu"), pc, quantize="int8",
                  fold_lora=False, device="cpu")
    with pytest.raises(ValueError, match="quantize mode"):
        Predictor(params_from_numpy(tree, device="cpu"), pc, quantize="int4",
                  device="cpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_nothing_of_jax():
    files = sorted((REPO / "dinov2_od_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "dinov2_od_tpu"), f"{path}: imports {mod}"


# ---- HTTP server -----------------------------------------------------------


def _png_b64(rng, size=48):
    from PIL import Image

    arr = (rng.uniform(size=(size, size, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(url, payload):
    req = urllib.request.Request(
        url, json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _scrape(url):
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        return {
            line.split()[0]: float(line.split()[1])
            for line in r.read().decode().splitlines()
            if line and not line.startswith("#")
        }


@pytest.fixture(scope="module")
def tiny_predictor():
    _, pc = _cfgs()
    params = init_detector_params(torch.Generator().manual_seed(0), pc,
                                  device="cpu")
    return Predictor(params, pc, batch_size=2, device="cpu")


@pytest.fixture(scope="module")
def server(tiny_predictor):
    srv = make_server(tiny_predictor, "127.0.0.1", 0, {"model": "tiny"})
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)


def test_healthz(server):
    with urllib.request.urlopen(server + "/healthz", timeout=30) as r:
        body = json.loads(r.read())
    assert r.status == 200 and body == {"status": "ok", "model": "tiny"}


def test_detect_endpoint(server):
    rng = np.random.default_rng(0)
    status, body = _post(
        server + "/detect",
        {"images": [_png_b64(rng), _png_b64(rng), _png_b64(rng)],
         "score_threshold": 0.0},
    )
    assert status == 200 and body["latency_ms"] > 0
    dets = body["detections"]
    assert len(dets) == 3
    for per_image in dets:
        assert len(per_image) == 30  # 5 queries x 6 classes, threshold 0
        for d in per_image:
            assert set(d) >= {"bbox", "score", "category_id"}
            assert len(d["bbox"]) == 4 and np.isfinite(d["bbox"]).all()


def test_detect_threshold_filters(server):
    rng = np.random.default_rng(1)
    img = _png_b64(rng)
    _, lo = _post(server + "/detect", {"images": [img], "score_threshold": 0})
    _, mid = _post(server + "/detect",
                   {"images": [img], "score_threshold": 0.5})
    assert all(d["score"] > 0.5 for d in mid["detections"][0])
    assert len(mid["detections"][0]) == sum(
        d["score"] > 0.5 for d in lo["detections"][0])


def test_bad_requests(server):
    for payload in ({}, {"images": []}, {"images": "nope"},
                    {"images": ["!!!not-base64!!!"]}):
        try:
            status, body = _post(server + "/detect", payload)
        except urllib.error.HTTPError as e:
            status, body = e.code, json.loads(e.read())
        assert status == 400 and "error" in body
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope", timeout=30)
    assert e.value.code == 404


def test_concurrent_requests(server):
    rng = np.random.default_rng(2)
    payload = {"images": [_png_b64(rng)], "score_threshold": 0.0}
    results = []

    def worker():
        results.append(_post(server + "/detect", payload))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    [t.start() for t in threads]
    [t.join(timeout=120) for t in threads]
    assert [r[0] for r in results] == [200] * 4
    first = results[0][1]["detections"]
    assert all(r[1]["detections"] == first for r in results)


def test_metrics_endpoint(server):
    before = _scrape(server)
    rng = np.random.default_rng(3)
    _post(server + "/detect",
          {"images": [_png_b64(rng), _png_b64(rng)], "score_threshold": 0.5})
    with pytest.raises(urllib.error.HTTPError):
        _post(server + "/detect", {"images": "bad"})
    after = _scrape(server)
    assert after["serving_requests_total"] - before["serving_requests_total"] == 2
    assert after["serving_images_total"] - before["serving_images_total"] == 2
    assert after["serving_errors_total"] - before["serving_errors_total"] == 1
    assert (after["serving_latency_seconds_sum"]
            > before["serving_latency_seconds_sum"])


def test_sigterm_drains_server():
    import signal

    class _Dummy:
        def detect(self, images, score_threshold=0.5):
            return [[] for _ in images]

    srv = make_server(_Dummy(), "127.0.0.1", 0)
    before = signal.getsignal(signal.SIGTERM)
    install_drain_handler(srv)
    t = threading.Thread(target=srv.serve_forever)
    t.start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_address[1]}/healthz", timeout=30
        ) as r:
            assert r.status == 200
        signal.raise_signal(signal.SIGTERM)
        t.join(timeout=30)
        assert not t.is_alive()  # serve_forever returned: drained
    finally:
        srv.server_close()
        signal.signal(signal.SIGTERM, before)


# ---- dynamic batching ------------------------------------------------------


class _CountingModel:
    """Fake model: fixed detections per image; records call sizes."""

    def __init__(self, block_s=0.0, scores=(0.9,)):
        self.calls = []
        self.block_s = block_s
        self.scores = scores

    def detect(self, images, score_threshold=0.5):
        import time

        self.calls.append(len(images))
        time.sleep(self.block_s)
        return [[{"bbox": [0, 0, 1, 1], "score": s, "category_id": 1}
                 for s in self.scores if s >= score_threshold]
                for _ in images]


def _run_threads(fn, args_list):
    threads = [threading.Thread(target=fn, args=a) for a in args_list]
    [t.start() for t in threads]
    [t.join(timeout=30) for t in threads]
    assert not any(t.is_alive() for t in threads)


def test_batcher_coalesces_concurrent_requests():
    model = _CountingModel(block_s=0.05)
    b = DynamicBatcher(model, max_batch=16, max_wait_ms=100.0)
    try:
        results = [None] * 8

        def worker(i):
            results[i] = b.submit([np.zeros((4, 4, 3))], 0.5)

        _run_threads(worker, [(i,) for i in range(8)])
        assert all(r is not None and len(r) == 1 for r in results)
        assert len(model.calls) < 8 and sum(model.calls) == 8
        assert b.batches == len(model.calls) and b.batched_images == 8
    finally:
        b.close()


def test_batcher_per_request_thresholds():
    model = _CountingModel(block_s=0.05, scores=(0.9, 0.6, 0.3))
    b = DynamicBatcher(model, max_batch=16, max_wait_ms=200.0)
    try:
        out = {}

        def worker(name, thr):
            out[name] = b.submit([np.zeros((4, 4, 3))], thr)

        _run_threads(worker, [("lo", 0.2), ("hi", 0.8)])
        assert [d["score"] for d in out["lo"][0]] == [0.9, 0.6, 0.3]
        assert [d["score"] for d in out["hi"][0]] == [0.9]
    finally:
        b.close()


def test_batcher_order_and_multi_image_requests():
    class _EchoModel:
        def detect(self, images, score_threshold=0.5):
            return [[{"bbox": [0, 0, 1, 1], "score": 0.9,
                      "category_id": int(im[0, 0, 0])}] for im in images]

    b = DynamicBatcher(_EchoModel(), max_batch=8, max_wait_ms=100.0)
    try:
        out = {}

        def worker(name, tags):
            imgs = [np.full((2, 2, 3), t, np.float32) for t in tags]
            out[name] = b.submit(imgs, 0.0)

        _run_threads(worker, [("a", [1, 2, 3]), ("b", [7, 8])])
        assert [d[0]["category_id"] for d in out["a"]] == [1, 2, 3]
        assert [d[0]["category_id"] for d in out["b"]] == [7, 8]
    finally:
        b.close()


def test_batcher_propagates_errors_to_all_waiters():
    class _BoomModel:
        def detect(self, images, score_threshold=0.5):
            raise RuntimeError("boom")

    b = DynamicBatcher(_BoomModel(), max_batch=8, max_wait_ms=50.0)
    try:
        errors = []

        def worker():
            try:
                b.submit([np.zeros((2, 2, 3))], 0.5)
            except RuntimeError as e:
                errors.append(str(e))

        _run_threads(worker, [()] * 3)
        assert errors == ["boom"] * 3
    finally:
        b.close()


def test_server_with_batcher_end_to_end(tiny_predictor):
    """Four concurrent one-image requests through the batcher and the
    port's Predictor: every request answered, images conserved, and each
    request's detections equal the same image run alone."""
    batcher = DynamicBatcher(tiny_predictor, max_batch=8, max_wait_ms=50.0)
    srv = make_server(tiny_predictor, "127.0.0.1", 0, {"model": "tiny"},
                      batcher=batcher)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        rng = np.random.default_rng(5)
        imgs = [_png_b64(rng) for _ in range(4)]
        replies = {}

        def worker(i):
            replies[i] = _post(url + "/detect",
                               {"images": [imgs[i]], "score_threshold": 0.0})

        _run_threads(worker, [(i,) for i in range(4)])
        assert sorted(replies) == [0, 1, 2, 3]
        assert all(status == 200 for status, _ in replies.values())
        metrics = _scrape(url)
        assert metrics["serving_device_batched_images_total"] == 4
        assert 1 <= metrics["serving_device_batches_total"] <= 4
        from dinov2_od_tpu_torch.serve import _decode_image

        for i, (_, body) in replies.items():
            alone = tiny_predictor.detect([_decode_image(imgs[i])],
                                          score_threshold=0.0)
            got = [d["score"] for d in body["detections"][0]]
            np.testing.assert_allclose(
                got, [d["score"] for d in alone[0]], rtol=1e-5)
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
        t.join(timeout=30)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where CUDA is
    absent, and where nothing of the repository but itself is present."""
    import shutil
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        run = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
