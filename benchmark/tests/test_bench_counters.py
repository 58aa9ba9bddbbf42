"""The yardstick's arithmetic against hand counts at small shapes: FLOPs,
bytes, roofline bounds, the trace's reduction and the metric readers."""

import re

import pytest

from benchmark.harness import common, flops, trace
from benchmark.harness.context import Readings

CFG = {"hidden_size": 8, "num_attention_heads": 2, "mlp_ratio": 2,
       "patch_size": 2, "image_size": 4, "num_hidden_layers": 3,
       "lora_last_n_blocks": 1, "lora_r": 1, "decoder_hidden_dim": 4,
       "decoder_layers": 1, "decoder_heads": 2, "decoder_ffn_dim": 6,
       "num_queries": 2, "num_classes": 3, "n_points": 1}


def test_attention_counts_by_hand():
    # b=1, h=2, s=3, dh=4, bf16: q k^T and p v, 2 * 3 * 3 * 4 each, a head.
    f, n = flops.attention_fwd(1, 2, 3, 4)
    assert f == 2 * 2 * (2 * 3 * 3 * 4)
    assert n == 4 * 3 * 2 * 4 * 2 + 2 * 3 * 4
    f, n = flops.attention_bwd(1, 2, 3, 4)
    assert f == 2 * 5 * (2 * 3 * 3 * 4)
    assert n == 7 * 3 * 2 * 4 * 2 + 2 * 2 * 3 * 4


def test_bound_takes_the_slower_roof():
    t, by = flops.bound_s(989e12, 1.0)
    assert t == pytest.approx(1.0) and by == "operations"
    t, by = flops.bound_s(1.0, 3.35e12)
    assert t == pytest.approx(1.0) and by == "bytes"


def test_vit_block_by_hand():
    # s = (4 / 2)^2 + 1 = 5 tokens, d = 8, mlp 16, one image.
    s, d, m = 5, 8, 16
    linears = 2 * s * (d * 3 * d + d * d + d * m + m * d)
    attn = 4 * s * s * d
    assert flops.vit_block_flops(CFG, 1) == linears + attn
    lora = 2 * s * sum(i * 1 + 1 * o for i, o in
                       ((d, d),) * 4 + ((d, m), (m, d)))
    assert flops.vit_block_flops(CFG, 1, lora=True) == linears + attn + lora
    assert flops.vit_block_flops(CFG, 3) == 3 * (linears + attn)


def test_backbone_by_hand():
    s, d = 5, 8
    patch = 2 * 4 * (2 * 2 * 3) * d
    block = flops.vit_block_flops(CFG, 1)
    proj = 2 * s * d * 4
    assert flops.backbone_flops(CFG, 1, lora=False) == patch + 3 * block + proj
    adapted = flops.vit_block_flops(CFG, 1, lora=True)
    assert flops.backbone_flops(CFG, 2, lora=True) == pytest.approx(
        2 * (patch + 2 * block + adapted + proj))


def test_decoder_by_hand():
    q, d, f, hw = 2, 4, 6, 4
    per_layer = (4 * 2 * q * d * d + 4 * q * q * d + 2 * q * d * 2
                 + 2 * q * d * 2 * 1 * 2 + 2 * q * d * 2 * 1
                 + 2 * hw * d * d + 2 * q * 1 * 4 * d + 2 * q * 1 * d
                 + 2 * q * d * d + 2 * q * d * f + 2 * q * f * d)
    heads = 2 * q * d * 3 + 2 * q * d * 2 + 2 * q * 2 * 4
    assert flops.decoder_flops(CFG, 1) == per_layer + heads


def test_train_adds_the_backward():
    s, d, m = 5, 8, 16
    fwd = flops.backbone_flops(CFG, 1, lora=True) + flops.decoder_flops(CFG, 1)
    frozen = 2 * s * (3 * d * d + d * d + d * m + m * d)
    lora = 2 * s * sum(i + o for i, o in ((d, d),) * 4 + ((d, m), (m, d)))
    bwd = (2 * flops.decoder_flops(CFG, 1) + 2 * 2 * s * d * 4
           + frozen + 2 * lora + 2 * 4 * s * s * d - 2 * s * d * 3 * d)
    assert flops.train_flops(CFG, 1) == pytest.approx(fwd + bwd)


def test_attention_work_sums_blocks():
    t = flops.attention_work(CFG, 2, train=True)["bound_s"]
    fwd = flops.bound_s(*flops.attention_fwd(2, 2, 5, 4))[0]
    bwd = flops.bound_s(*flops.attention_bwd(2, 2, 5, 4))[0]
    assert t == pytest.approx(3 * fwd + 1 * bwd)


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def hand_trace():
    """A 100 us window: kernels at [10, 30) and [20, 40) (overlapping, one
    the port's B1), a copy at [60, 70); the host in `bench.step` over
    [0, 100) and in `matcher_host_solve` over [40, 58)."""
    b1 = trace.attention_kernel_names()[0]
    return [
        _ev(trace.WINDOW_SPAN, "user_annotation", 1000, 100),
        _ev("bench.step", "user_annotation", 1000, 100),
        _ev("matcher_host_solve", "user_annotation", 1040, 18),
        _ev(f"void {b1}<true>(Args)", "kernel", 1010, 20),
        _ev("ampere_bf16_s16816gemm", "kernel", 1020, 20),
        _ev("Memcpy HtoD", "gpu_memcpy", 1060, 10),
        _ev("outside", "kernel", 1200, 10),
    ]


def test_summary_of_a_hand_made_trace():
    s = trace.summarize(hand_trace())
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(40e-6)  # [10, 40) and [60, 70)
    assert s.idle_share == pytest.approx(0.6)
    assert s.attention_s == pytest.approx(20e-6)
    assert s.groups_s["attention"] == pytest.approx(20e-6)
    assert s.groups_s["gemm"] == pytest.approx(20e-6)
    # Gaps [70, 100), [40, 60), [0, 10): the one at 40 opened under the
    # matcher's span, the narrowest open then.
    assert [g[0] for g in s.gaps] == ["bench.step", "matcher_host_solve",
                                      "bench.step"]
    assert [g[1] for g in s.gaps] == pytest.approx([30e-6, 20e-6, 10e-6])
    assert s.spans_s["matcher_host_solve"] == pytest.approx(18e-6)
    bd = trace.breakdown(s)
    assert len(bd["device_ops"]) == 3 and len(bd["idle_gaps"]) == 3


def test_torch_attention_kernels_are_attention():
    match = trace.attention_matcher()
    assert match("void pytorch_flash::flash_fwd_kernel<Flash_fwd_traits>")
    assert match("fmha_cutlassF_bf16_aligned_64x64_rf_sm80")
    assert not match("ampere_bf16_s16816gemm_bf16_128x64")
    assert not match("void at::native::vectorized_elementwise_kernel")


def test_port_flash_kernels_are_listed():
    """Every `__global__` kernel of the port's flash-attention sources is
    named under benchmark/kernels/attention/, so its time counts as
    attention."""
    rx = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                    r"\([^)]*\)\s*)?(\w+)\s*\(")
    csrc = common.ROOT / "dinov2_od_tpu_torch" / "csrc"
    found = {n for f in csrc.glob("flash_attn*.cu")
             for n in rx.findall(f.read_text())}
    assert found and found <= set(trace.attention_kernel_names())


def test_readers_on_hand_readings():
    s = trace.summarize(hand_trace())
    r = Readings(kind="train", window_s=2.0,
                 model_flops=0.5 * 2.0 * flops.PEAK_BF16_FLOPS,
                 counters={"steps": 4, "images": 8, "auction_rounds": 400,
                           "auction_calls": 4, "jv_calls": 0},
                 trace=s, trace_attention_bound_s=5e-6, trace_steps=2,
                 window_units=4)
    read = {n: common.load_reader(n)(r) for n in (
        "mfu.train", "idle_share.train", "attn_roofline.train",
        "device_busy_ms_per_step.train", "auction_rounds_per_step.train",
        "matcher_host_ms.train")}
    assert read["mfu.train"] == pytest.approx(50.0)
    # 20 us busy a step in the trace, 4 steps in the untraced 2 s window.
    assert read["idle_share.train"] == pytest.approx(
        100.0 * (1.0 - 4 * 20e-6 / 2.0))
    assert read["attn_roofline.train"] == pytest.approx(25.0)
    assert read["device_busy_ms_per_step.train"] == pytest.approx(0.02)
    assert read["auction_rounds_per_step.train"] == pytest.approx(100.0)
    assert read["matcher_host_ms.train"] == pytest.approx(0.009)


def test_readers_without_a_trace_read_nothing():
    r = Readings(kind="train", window_s=2.0, model_flops=0.0,
                 counters={"steps": 4, "images": 8, "auction_rounds": 0,
                           "auction_calls": 0, "jv_calls": 4})
    # Nothing to read: no reader returns a 0 share.
    for n in ("mfu.train", "idle_share.train", "attn_roofline.train",
              "device_busy_ms_per_step.train",
              "auction_rounds_per_step.train", "matcher_host_ms.train"):
        assert common.load_reader(n)(r) is None, n
