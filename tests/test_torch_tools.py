"""The port's measurement and input tools (dinov2_od_tpu_torch/tools/
bench_{serving,qkv_layout,attn_scaling,evaluator,input}.py) on the CPU at
small sizes: each prints the JAX tool's keys, and what the tools share
with the JAX tools (the evaluator's synthetic set) is equal. Times taken
here are CPU times, checked only for order and sign."""

import dataclasses
import importlib.util
import io
import json
import os

import pytest
import torch

from dinov2_od_tpu_torch.ops import flash_attention as fa
from dinov2_od_tpu_torch.tools import (bench_attn_scaling, bench_evaluator,
                                       bench_input, bench_qkv_layout,
                                       bench_serving)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING_KEYS = ["metric", "p50_ms", "p95_ms", "p99_ms",
                "concurrent_img_per_s", "requests", "threads"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: small eager ops beside the suite's other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(out: io.StringIO):
    return out.getvalue().splitlines()


def _tiny_detector(cfg):
    """ViT at 28 px, 2 blocks of width 64, one head; a one-layer decoder."""
    bb = dataclasses.replace(cfg.backbone, dtype="float32", image_size=28,
                             depth_override=2, hidden_dim_override=64,
                             num_heads_override=1, target_dim=32)
    dec = dataclasses.replace(cfg.decoder, hidden_dim=32, num_layers=1,
                              dim_feedforward=32, num_queries=5)
    return dataclasses.replace(cfg, backbone=bb, decoder=dec)


def test_bench_serving_prints_the_jax_line():
    out = io.StringIO()
    args = bench_serving.parse_args(["--device", "cpu", "--requests", "12",
                                     "--threads", "3", "--image_size", "28"])
    rec = bench_serving.run(args, _tiny_detector, out=out)
    split_line, last = _lines(out)
    assert json.loads(last) == rec and list(rec) == SERVING_KEYS
    assert rec["p50_ms"] <= rec["p95_ms"] <= rec["p99_ms"]
    assert rec["concurrent_img_per_s"] > 0
    assert rec["requests"] == 12 and rec["threads"] == 3
    assert rec["metric"] == "HTTP serving b1 ViT-B/28 fp32-eval (cpu)"
    split = json.loads(split_line.removeprefix("split: "))
    assert list(split) == ["decode", "prepare", "h2d", "forward", "d2h",
                           "format_json", "server_latency_ms_p50",
                           "client_round_trip_ms_p50"]
    assert all(v > 0 for v in split.values())


def test_tools_need_a_card_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_serving.run(bench_serving.parse_args(["--image_size", "28"]),
                          _tiny_detector)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_qkv_layout.run(bench_qkv_layout.parse_args([]))
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_attn_scaling.run(bench_attn_scaling.parse_args([]))
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_input.run(bench_input.parse_args(
            ["--dir", str(tmp_path), "--train"]))
    for tool in (bench_serving, bench_qkv_layout, bench_attn_scaling,
                 bench_input):
        assert tool.parse_args([]).device == "cuda"


def test_bench_qkv_layout_prints_the_jax_line():
    out = io.StringIO()
    rec = bench_qkv_layout.run(bench_qkv_layout.parse_args(
        ["--device", "cpu", "--batch", "2", "--seq", "8", "--dim", "16",
         "--depth", "3"]), out=out, target_seconds=0.01, repeats=1)
    assert json.loads(_lines(out)[-1]) == rec
    assert list(rec) == ["metric", "prefused_ms", "per_step_concat_ms",
                         "delta_ms_per_fwd"]
    assert rec["prefused_ms"] > 0 and rec["per_step_concat_ms"] > 0
    x = torch.randn(2, 8, 16)
    wq, wk, wv = (torch.randn(3, 16, 16) for _ in range(3))
    torch.testing.assert_close(
        bench_qkv_layout.run_fused(x, torch.cat([wq, wk, wv], dim=2)),
        bench_qkv_layout.run_concat(x, wq, wk, wv))


def test_bench_attn_scaling_flat_variant_and_forcing():
    out = io.StringIO()
    recs = bench_attn_scaling.run(bench_attn_scaling.parse_args(
        ["--device", "cpu", "--seq", "24", "--heads", "2", "--kv_len", "20",
         "--batches", "1", "2", "--variants", "flat"]), out=out,
        target_seconds=0.01, repeats=1)
    assert [json.loads(l) for l in _lines(out)] == recs
    assert [(r["batch"], r["variant"]) for r in recs] == [(1, "flat"),
                                                          (2, "flat")]
    for r in recs:
        assert list(r) == ["batch", "variant", "fwd_ms", "fwdbwd_ms",
                           "fwd_us_per_img", "fwdbwd_us_per_img",
                           "fwd_device_ms", "fwdbwd_device_ms", "launches"]
        assert r["launches"] == {}  # the plain versions launch nothing
        assert r["fwd_device_ms"] is r["fwdbwd_device_ms"] is None
        assert r["fwd_ms"] > 0 and r["fwdbwd_ms"] > 0
    q = torch.zeros(1, 272, 12, 64)
    routes = {}
    for variant in ("allheads", "bhsd", "flat"):
        with bench_attn_scaling.forced(variant):
            routes[variant] = (fa._forward_fn(q, q, False),
                               fa._backward_fn(q, q, False))
    assert routes["allheads"] == (fa.flash_attention_allheads_fwd,
                                  fa.flash_attention_allheads_bwd)
    assert routes["bhsd"] == (fa.flash_attention_bhsd_fwd,
                              fa.flash_attention_bhsd_bwd)
    assert routes["flat"] == routes["allheads"]  # JAX's own choice here
    assert bench_attn_scaling.parse_args([]).variants == ["flat", "allheads",
                                                          "bhsd"]


def test_bench_evaluator_synth_equal_to_jax_and_matchers_agree():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_evaluator", os.path.join(REPO, "tools",
                                            "bench_evaluator.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    for kw in (dict(n_img=12), dict(n_img=7, n_cat=5, seed=3)):
        assert bench_evaluator.synth(**kw) == jax_tool.synth(**kw)
    out = io.StringIO()
    rec = bench_evaluator.run(bench_evaluator.parse_args(["--images", "25"]),
                              out=out)
    assert json.loads(_lines(out)[-1]) == rec
    assert rec["images"] == 25 and rec["detections"] == 2500
    assert set(rec["evaluate_s"]) == {"native", "numpy"}
    assert rec["metrics_equal"]
    assert rec["metrics"]["native"] == rec["metrics"]["numpy"]
    assert 0 < rec["metrics"]["native"]["AP"] < 1


def test_bench_input_host_phases(tmp_path):
    out = io.StringIO()
    args = bench_input.parse_args(["--dir", str(tmp_path / "syn"), "--gen",
                                   "16", "--batch", "4", "--packed"])
    assert args.device == "cuda" and args.source_size == 640
    res = bench_input.run(args, out=out)
    assert json.loads(_lines(out)[-1]) == res
    assert res["decode_backend_auto"] == "native"
    assert set(res["decode"]) == {"pil_float32", "pil_uint8", "cv2_uint8",
                                  "native_uint8", "native_batch"}
    assert set(res["loader"]) == {f"threaded_w{w}" for w in (1, 2, 4, 8)}
    assert res["packed_loader"] > 0
    assert all(v > 0 for v in [*res["decode"].values(),
                               *res["loader"].values()])
    assert "grain: not ported" in out.getvalue()
    assert len(os.listdir(tmp_path / "syn" / "images")) == 16
