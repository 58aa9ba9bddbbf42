"""End-to-end HTTP serving latency and throughput (counterpart of
tools/bench_serving.py).

Measures what a client sees (JSON and base64 decode, the image decode,
the copy to the card, the forward, the copy back, the JSON response),
not only the forward that `python -m dinov2_od_tpu_torch.bench` with
BENCH_MODE=eval times:

    python -m dinov2_od_tpu_torch.tools.bench_serving [--model base]
        [--image_size 224] [--requests 50] [--threads 4]
        [--quantize int8] [--checkpoint DIR] [--device cuda]

Set-up as in the JAX tool: a `Predictor` at batch 1 (random weights from
seed 0 unless --checkpoint), warmed up; `make_server` on port 0 with no
batcher, so concurrent requests take turns at the server's device lock; a
JPEG payload of a uniform-noise image drawn from seed 0. The backbone is
bf16 (the JAX tool served the fp32 config at the TPU's bf16 matmul
precision and named it "bf16-eval"); `--quantize int8` serves W8A8.

- Single stream: one warm request, then `--requests` requests one after
  another; p50, p95 and p99 of the client's round trip, a closed loop.
- Concurrent: `--threads` clients send `--requests // --threads` requests
  each, back to back; images/s over the wall time.

Prints, before the result, a `split:` line: the medians over `--requests`
runs of the request's stages in-process at batch 1 (base64 + image
decode, preprocessing, the copy in, the forward with top-k, the copy
out, formatting and the JSON response; each stage waits for the card),
and the median of the server's own `latency_ms` (the `detect` call)
from the single-stream requests. The last line is the JAX tool's one
JSON line: metric (naming the card), p50_ms, p95_ms, p99_ms,
concurrent_img_per_s, requests, threads.

Runs on the CUDA card; `--device cpu` runs it on the CPU (for tests: no
CPU time is a device time).
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import io
import json
import sys
import threading
import time
import urllib.request
from typing import Callable, Optional

import numpy as np


def b64_image(size: int) -> str:
    """The payload image: uniform noise from seed 0, JPEG quality 90."""
    from PIL import Image

    arr = (np.random.default_rng(0).uniform(size=(size, size, 3)) * 255
           ).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=90)
    return base64.b64encode(buf.getvalue()).decode()


def _post(url: str, payload: bytes):
    """(client round trip in ms, the server's latency_ms)."""
    t0 = time.perf_counter()
    req = urllib.request.Request(
        url, payload, {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        body = json.loads(r.read())
    return (time.perf_counter() - t0) * 1e3, body["latency_ms"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="base")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--requests", type=int, default=50)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--quantize", default=None, choices=[None, "int8"])
    p.add_argument("--checkpoint", default=None,
                   help="serve trained weights; default random init")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cuda' (the default; raises without a card) or "
                        "'cpu'")
    return p.parse_args(argv)


def build_predictor(args, cfg_override: Optional[Callable] = None):
    """The served Predictor at batch 1: the model's config with a bf16
    backbone (`cfg_override(cfg)` may replace it, as the tests do)."""
    import torch

    from ..config import detector_config_for_model_name
    from ..inference import Predictor
    from ..models.detector import cast_frozen_weights, init_detector_params

    cfg = detector_config_for_model_name(
        f"facebook/dinov2-{args.model}", image_size=args.image_size)
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, dtype="bfloat16"))
    if cfg_override is not None:
        cfg = cfg_override(cfg)
    if args.checkpoint:
        return Predictor.from_checkpoint(
            args.checkpoint, detector_cfg=cfg, batch_size=1,
            quantize=args.quantize, device=args.device)
    params = init_detector_params(torch.Generator().manual_seed(0), cfg,
                                  device=args.device)
    if cfg.backbone.dtype == "bfloat16":  # stored as a checkpoint stores it
        params = cast_frozen_weights(params, cfg)
    return Predictor(params, cfg, batch_size=1, quantize=args.quantize,
                     device=args.device)


def serving_split(model, b64: str, n: int) -> dict:
    """Medians (ms) of a /detect request's stages at batch 1, run
    in-process `n` times, each stage waiting for the card."""
    import torch

    from ..evaluation.postprocess import format_detections
    from ..inference import prepare_images
    from ..serve import _decode_image

    cuda = model.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    size = model.cfg.backbone.image_size
    stages = {k: [] for k in ("decode", "prepare", "h2d", "forward", "d2h",
                              "format_json")}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        stages[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(n):
        image = timed("decode", _decode_image, b64)
        pixel, sizes = timed("prepare", prepare_images, [image], size,
                             model.normalize)
        x, s = timed("h2d", lambda: (model._upload(pixel),
                                     model._upload(sizes)))
        out = timed("forward", model._forward_topk, x, s, 100)

        def d2h():
            host, done = model._download(out)
            if done is not None:
                done.synchronize()
            return host.numpy()

        topk = timed("d2h", d2h)

        def respond():
            dets = format_detections(
                topk[..., 0], topk[..., 1].astype(np.int32), topk[..., 2:],
                np.arange(1), model.label_to_cat_id, score_threshold=0.5)
            return json.dumps({"detections": [dets], "latency_ms": 0.0})

        timed("format_json", respond)
    return {k: float(np.median(v)) for k, v in stages.items()}


def run(args, cfg_override: Optional[Callable] = None, out=None) -> dict:
    """Build, serve, measure; print the split line and the result line to
    `out` (stdout by default) and return the result."""
    import torch

    from ..serve import make_server

    out = out or sys.stdout
    model = build_predictor(args, cfg_override)
    size = model.cfg.backbone.image_size
    model.detect([np.zeros((size, size, 3), np.float32)],
                 score_threshold=1.0)  # warm (kernel builds) before timing
    b64 = b64_image(size)
    srv = make_server(model, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/detect"
        payload = json.dumps(
            {"images": [b64], "score_threshold": 0.5}).encode()
        _post(url, payload)  # one warm HTTP round
        rounds = [_post(url, payload) for _ in range(args.requests)]
        lat = sorted(r[0] for r in rounds)
        server_ms = float(np.median([r[1] for r in rounds]))
        q = lambda f: lat[min(len(lat) - 1, int(f * len(lat)))]

        # Concurrent: the server's device lock serialises detect; this
        # measures sustained images/s with request decode overlapped.
        done = []
        errors = []

        def worker(n):
            try:
                for _ in range(n):
                    _post(url, payload)
                    done.append(1)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))

        per = max(1, args.requests // args.threads)
        ts = [threading.Thread(target=worker, args=(per,))
              for _ in range(args.threads)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        dt = time.perf_counter() - t0
        if errors:
            raise RuntimeError(f"concurrent requests failed: {errors}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)

    split = serving_split(model, b64, args.requests)
    split["server_latency_ms_p50"] = server_ms
    split["client_round_trip_ms_p50"] = q(0.50)
    print("split: " + json.dumps(split), file=out, flush=True)
    card = (torch.cuda.get_device_name(model.device)
            if model.device.type == "cuda" else "cpu")
    rec = {
        "metric": f"HTTP serving b1 ViT-{args.model[0].upper()}"
                  f"/{args.image_size}"
                  + (f" {args.quantize}" if args.quantize else
                     " bf16-eval" if model.cfg.backbone.dtype == "bfloat16"
                     else " fp32-eval")
                  + f" ({card})",
        "p50_ms": round(q(0.50), 2),
        "p95_ms": round(q(0.95), 2),
        "p99_ms": round(q(0.99), 2),
        "concurrent_img_per_s": round(len(done) / dt, 2),
        "requests": args.requests,
        "threads": args.threads,
    }
    print(json.dumps(rec), file=out, flush=True)
    return rec


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
