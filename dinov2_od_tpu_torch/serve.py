"""HTTP detection serving endpoint (counterpart of dinov2_od_tpu/serve.py).

API:
    GET  /healthz  -> {"status": "ok", **model_info}
    GET  /metrics  -> Prometheus text format (requests, errors, images,
                      latency sum/count, device batches)
    POST /detect   body {"images": [<base64 JPEG/PNG bytes>, ...],
                         "score_threshold": 0.5}
                   -> {"detections": [[{bbox, score, category_id,
                       name?}, ...] per image], "latency_ms": float}

`make_server` wraps any object with `.detect(images, score_threshold=...)`
(a `Predictor`); `DynamicBatcher` coalesces concurrent requests into
shared device batches; `install_drain_handler` makes SIGTERM drain the
server. `main` is the command line:

    python -m dinov2_od_tpu_torch.serve --checkpoint outputs/final_model \
        [--quantize int8] [--max_batch 32] [--batch_wait_ms 5]
    python -m dinov2_od_tpu_torch.serve --bundle serving/detector-v1

It serves a checkpoint of the training loop (`Predictor.from_checkpoint`)
or a serving bundle of tools/export.py (`export.load_serving_bundle`:
folded weights and the detector config, served by the port's model
code).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def _decode_image(b64: str) -> np.ndarray:
    """base64 image bytes -> [H, W, 3] float32 in [0, 1]."""
    from PIL import Image

    raw = base64.b64decode(b64, validate=True)
    with Image.open(io.BytesIO(raw)) as pil:
        return np.asarray(pil.convert("RGB"), np.float32) / 255.0


class _Metrics:
    """Thread-safe monotonic counters, rendered in Prometheus text
    exposition format."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.images = 0
        self.latency_sum_s = 0.0

    def record(self, images: int = 0, latency_s: float = 0.0,
               error: bool = False) -> None:
        with self._lock:
            self.requests += 1
            self.errors += error
            self.images += images
            self.latency_sum_s += latency_s

    def render(self) -> str:
        with self._lock:
            return (
                "# TYPE serving_requests_total counter\n"
                f"serving_requests_total {self.requests}\n"
                "# TYPE serving_errors_total counter\n"
                f"serving_errors_total {self.errors}\n"
                "# TYPE serving_images_total counter\n"
                f"serving_images_total {self.images}\n"
                "# TYPE serving_latency_seconds summary\n"
                f"serving_latency_seconds_sum {self.latency_sum_s:.6f}\n"
                f"serving_latency_seconds_count {self.requests}\n"
            )


class DynamicBatcher:
    """Cross-request dynamic batching.

    Handler threads `submit()` and block; one dispatcher thread takes the
    first queued request, waits up to `max_wait_ms` for more while the
    batch is below `max_batch` images, issues ONE `model.detect` call at
    the lowest score threshold in the window, re-filters each request's
    detections at its own threshold, and fans the results (or the call's
    exception) back out. Request order within a batch is preserved.
    """

    _STOP = object()

    def __init__(self, model, max_batch: int = 32,
                 max_wait_ms: float = 5.0):
        self.model = model
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._queue: "queue.Queue" = queue.Queue()
        self.batches = 0          # device calls issued (for /metrics)
        self.batched_images = 0   # images through those calls
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, images, score_threshold: float):
        """Block until this request's results are ready (or raise the
        device call's exception)."""
        item = {
            "images": images,
            "threshold": float(score_threshold),
            "done": threading.Event(),
            "result": None,
            "error": None,
        }
        self._queue.put(item)
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def close(self):
        self._queue.put(self._STOP)
        self._thread.join(timeout=30)

    def _collect(self):
        """One batching window: block for the first item, then drain
        until max_batch images or max_wait_ms, whichever first."""
        first = self._queue.get()
        if first is self._STOP:
            return None
        batch = [first]
        n = len(first["images"])
        deadline = time.monotonic() + self.max_wait_s
        while n < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is self._STOP:
                self._queue.put(self._STOP)  # seen again by the loop
                break
            batch.append(item)
            n += len(item["images"])
        return batch

    def _run(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            images = [im for item in batch for im in item["images"]]
            threshold = min(item["threshold"] for item in batch)
            try:
                results = self.model.detect(images, score_threshold=threshold)
            except Exception as e:  # fan the failure out to all waiters
                logger.exception("batched detect failed")
                for item in batch:
                    item["error"] = e
                    item["done"].set()
                continue
            self.batches += 1
            self.batched_images += len(images)
            pos = 0
            for item in batch:
                k = len(item["images"])
                per_image = results[pos:pos + k]
                pos += k
                thr = item["threshold"]
                if thr > threshold:  # re-filter at the request's own bar
                    per_image = [
                        [d for d in dets if d["score"] >= thr]
                        for dets in per_image
                    ]
                item["result"] = per_image
                item["done"].set()


class _Handler(BaseHTTPRequestHandler):
    # Injected by make_server via subclassing.
    model = None
    model_info: dict = {}
    device_lock: threading.Lock = threading.Lock()
    metrics: _Metrics = _Metrics()
    batcher: Optional[DynamicBatcher] = None

    def log_message(self, fmt, *args):  # route to logging, not stderr
        logger.info("%s %s", self.address_string(), fmt % args)

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/metrics":
            text = self.metrics.render()
            if self.batcher is not None:
                text += (
                    "# TYPE serving_device_batches_total counter\n"
                    f"serving_device_batches_total {self.batcher.batches}\n"
                    "# TYPE serving_device_batched_images_total counter\n"
                    "serving_device_batched_images_total "
                    f"{self.batcher.batched_images}\n"
                )
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path != "/healthz":
            return self._reply(404, {"error": "unknown path"})
        self._reply(200, {"status": "ok", **self.model_info})

    def do_POST(self):
        if self.path != "/detect":
            return self._reply(404, {"error": "unknown path"})
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length))
            b64s = req["images"]
            if not isinstance(b64s, list) or not b64s:
                raise ValueError("'images' must be a non-empty list")
            images = [_decode_image(b) for b in b64s]
            threshold = float(req.get("score_threshold", 0.5))
        except Exception as e:  # malformed request
            self.metrics.record(error=True)
            return self._reply(400, {"error": f"bad request: {e}"})
        try:
            t0 = time.perf_counter()
            if self.batcher is not None:
                detections = self.batcher.submit(images, threshold)
            else:
                with self.device_lock:
                    detections = self.model.detect(
                        images, score_threshold=threshold
                    )
            latency_s = time.perf_counter() - t0
        except Exception as e:
            logger.exception("detect failed")
            self.metrics.record(error=True)
            return self._reply(500, {"error": f"inference failed: {e}"})
        self.metrics.record(images=len(images), latency_s=latency_s)
        self._reply(
            200, {"detections": detections, "latency_ms": latency_s * 1e3}
        )


def make_server(model, host: str = "127.0.0.1", port: int = 8000,
                model_info: Optional[dict] = None,
                batcher: Optional[DynamicBatcher] = None,
                ) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server around any object with a
    `.detect(images, score_threshold=...)` method. With `batcher`,
    concurrent requests are coalesced into shared device batches;
    without it a lock serializes whole requests."""
    handler = type(
        "BoundHandler",
        (_Handler,),
        {
            "model": model,
            "model_info": dict(model_info or {}),
            "device_lock": threading.Lock(),
            "metrics": _Metrics(),
            "batcher": batcher,
        },
    )
    return ThreadingHTTPServer((host, port), handler)


def install_drain_handler(server: ThreadingHTTPServer) -> None:
    """SIGTERM -> graceful drain: stop accepting, let in-flight handler
    threads finish, make serve_forever return."""
    import signal

    def _drain(signum, frame):
        logger.info("signal %d: draining, shutting down", signum)
        # shutdown() blocks until the serve loop exits: call it off the
        # signal-handling (main) thread.
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain)


def main(argv: Optional[List[str]] = None,
         on_ready: Optional[Callable[[ThreadingHTTPServer], None]] = None
         ) -> int:
    """Serve a checkpoint or a bundle until SIGTERM, Ctrl-C or
    `server.shutdown()`. `on_ready`, when given, gets the server once it
    listens (a caller running `main` in a thread stops it so; SIGTERM
    draining is installed only from the main thread)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint",
                     help="checkpoint directory of the training loop")
    src.add_argument("--bundle",
                     help="serving bundle directory (tools/export.py)")
    p.add_argument("--model_name", default="facebook/dinov2-base")
    p.add_argument("--num_classes", type=int, default=91)
    p.add_argument("--lightweight", action="store_true",
                   help="checkpoint was trained with the train CLI's "
                        "--lightweight config")
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--quantize", default=None, choices=[None, "int8"],
                   help="int8 W8A8 serving path (checkpoint mode)")
    p.add_argument("--compilation_cache", default="",
                   help="the JAX package's XLA cache; raises here")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cuda' (the default; raises without a card) or "
                        "'cpu'")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--no_dynamic_batching", action="store_true",
                   help="serialize requests instead of coalescing "
                        "concurrent ones into shared device batches")
    p.add_argument("--max_batch", type=int, default=32,
                   help="dynamic batching: max images per device call")
    p.add_argument("--batch_wait_ms", type=float, default=5.0,
                   help="dynamic batching: max time to wait for "
                        "more requests before dispatching")
    args = p.parse_args(argv)
    if args.compilation_cache:
        raise NotImplementedError(
            "--compilation_cache is XLA's; the port has no counterpart")

    logging.basicConfig(level=logging.INFO)
    if args.bundle:
        from .export import load_serving_bundle

        model = load_serving_bundle(args.bundle, device=args.device)
        info = {"model": "bundle:" + args.bundle,
                "quantize": model.manifest["quantize"] or "no"}
        size = model.image_size
    else:
        from .config import (detector_config_for_model_name,
                             lightweight_detector_config)
        from .inference import Predictor

        if args.lightweight:
            det_cfg = lightweight_detector_config(
                num_classes=args.num_classes, image_size=args.image_size)
        else:
            det_cfg = detector_config_for_model_name(
                args.model_name, num_classes=args.num_classes,
                image_size=args.image_size)
        model = Predictor.from_checkpoint(
            args.checkpoint, detector_cfg=det_cfg,
            batch_size=args.batch_size, quantize=args.quantize,
            device=args.device)
        info = {"model": args.model_name, "quantize": args.quantize or "no"}
        size = det_cfg.backbone.image_size
    info["backend"] = str(model.device)

    # Warm the path (kernel builds) before accepting traffic.
    model.detect([np.zeros((size, size, 3), np.float32)], score_threshold=1.0)

    batcher = None
    if not args.no_dynamic_batching:
        batcher = DynamicBatcher(model, max_batch=args.max_batch,
                                 max_wait_ms=args.batch_wait_ms)
    server = make_server(model, args.host, args.port, info, batcher=batcher)
    if threading.current_thread() is threading.main_thread():
        install_drain_handler(server)
    logger.info("serving on %s:%d", args.host, server.server_address[1])
    try:
        if on_ready is not None:
            on_ready(server)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()
    logger.info("server drained and closed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
