"""The port's measurement path on the CPU: the bench's configuration
against the one the repo's bench.py builds from the same knobs, the bench
refusing to run without a card, the timing helpers with device="cpu",
trace_step's grouping of kernel names, its Chrome-trace parser and its
split of the card's time by the train step's phases, and the span helper.

bench.py builds its TrainConfig inside `main()`, so the test runs the
statements of `main` up to that `cfg = TrainConfig(...)` assignment, taken
out of its source with `ast`; bench.py itself is not edited."""

import ast
import dataclasses
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from dinov2_od_tpu_torch.bench import bench_config
from dinov2_od_tpu_torch.tools import trace_step
from dinov2_od_tpu_torch.utils.benchmark import measure_steps_per_sec, time_fn
from dinov2_od_tpu_torch.utils import profiling
from dinov2_od_tpu_torch.utils.profiling import TRACE_FILE, annotate, trace

REPO = Path(__file__).resolve().parent.parent
KNOBS = ("BENCH_BATCH", "BENCH_MODEL", "BENCH_IMAGE_SIZE", "BENCH_MODE",
         "BENCH_PREFIX_INT8", "BENCH_QUANT", "BENCH_REMAT", "BENCH_AUG",
         "BENCH_FFN", "BENCH_MOE_EXPERTS", "BENCH_SCAN_UNROLL")


def _jax_bench_config():
    """The TrainConfig that bench.py's main() builds from os.environ."""
    src = (REPO / "bench.py").read_text()
    tree = ast.parse(src)
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = []
    for stmt in main.body:
        body.append(stmt)
        if (isinstance(stmt, ast.Assign)
                and getattr(stmt.targets[0], "id", "") == "cfg"):
            break
    else:
        raise AssertionError("bench.py's main() builds no cfg")
    ns = {"os": os}
    exec(compile(ast.Module(body=body, type_ignores=[]), "bench.py", "exec"),
         ns)
    return ns["cfg"]


def _mismatches(ours, theirs, path="cfg"):
    """Fields both dataclasses have whose values differ."""
    if not dataclasses.is_dataclass(ours):
        return [] if ours == theirs else [f"{path}: {ours!r} != {theirs!r}"]
    out = []
    names = {f.name for f in dataclasses.fields(theirs)}
    for f in dataclasses.fields(ours):
        if f.name in names:
            out += _mismatches(getattr(ours, f.name),
                               getattr(theirs, f.name), f"{path}.{f.name}")
    return out


@pytest.mark.parametrize("env", [
    {},
    {"BENCH_MODEL": "large", "BENCH_IMAGE_SIZE": "560", "BENCH_BATCH": "8"},
    {"BENCH_MODEL": "large", "BENCH_IMAGE_SIZE": "518", "BENCH_BATCH": "8",
     "BENCH_MODE": "eval", "BENCH_QUANT": "int8"},
    {"BENCH_PREFIX_INT8": "1", "BENCH_SCAN_UNROLL": "1"},
    {"BENCH_REMAT": "1", "BENCH_AUG": "1", "BENCH_MODEL": "small"},
    {"BENCH_FFN": "moe", "BENCH_MOE_EXPERTS": "4", "BENCH_MODEL": "giant"},
], ids=["default", "vit_l_560", "vit_l_518_int8", "prefix_int8", "remat_aug",
        "moe"])
def test_bench_config_matches_bench_py(env, monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    for knob, value in env.items():
        monkeypatch.setenv(knob, value)
    ours, theirs = bench_config(env), _jax_bench_config()
    assert _mismatches(ours, theirs) == []
    # The fields that carry the knobs are among those compared.
    bb = ours.detector.backbone
    assert (ours.data.batch_size, bb.image_size, bb.dtype) == (
        theirs.data.batch_size, theirs.detector.backbone.image_size,
        "bfloat16")


@pytest.mark.parametrize("module", ["dinov2_od_tpu_torch.bench",
                                    "dinov2_od_tpu_torch.tools.trace_step",
                                    "dinov2_od_tpu_torch.tools."
                                    "bench_attn_roofline"])
def test_measurement_entry_points_fail_without_a_card(module):
    """Run on a machine without CUDA, each exits non-zero and prints no
    result."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", module], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_time_fn_on_the_cpu_counts_its_calls_and_times_the_slope():
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.002)

    sec = time_fn(fn, 7, iters=16, repeats=3, device="cpu")
    # One warm-up call, then 3 x (16 // 8 + 16) calls, each with the args.
    assert len(calls) == 1 + 3 * (2 + 16) and set(calls) == {7}
    assert 0.0015 < sec < 0.05  # sleep(2 ms) takes at least 2 ms
    with pytest.raises(ValueError, match="iters"):
        time_fn(fn, 7, iters=1, device="cpu")


def test_measure_steps_per_sec_chains_states_on_the_cpu():
    seen = []

    def step(state, batch, gen):
        seen.append(state)
        time.sleep(0.001)
        return state + 1, {"loss": batch}

    sec, per_sec = measure_steps_per_sec(step, 0, 5, None, iters=4,
                                         device="cpu")
    # Warm-up, a throwaway step, the 1-step base, then 1 + 4 steps, each
    # handed the state the one before returned.
    assert seen == list(range(1 + 1 + 1 + 5))
    assert sec > 0 and sec * per_sec == pytest.approx(1.0)


# Kernel names as torch.profiler recorded them on an H100 (NVIDIA H100 80GB
# HBM3) in trace_step's ViT-B train step and ViT-L/560 forward, the first
# 160 characters; the port's two templated kernels last, in the same
# demangled form, named from their sources.
KERNEL_NAMES = [
    ("nvjet_tst_128x192_64x5_2x1_v_bz_coopB_NNN",
     "gemm"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsiz"
     "e2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
     "gemm"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x256_8x4_nt_align1>(cut"
     "lass_80_simt_sgemm_128x256_8x4_nt_align1::Params)",
     "gemm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128"
     "_64x3_tn_align2>(cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128_64x3"
     "_tn_align2::Params)",
     "gemm"),
    ("void cublasLt::splitKreduce_kernel<32, 16, int, float, float, float, f"
     "loat, false, float, float, float, true, false, false, false>(cublasLt:"
     ":cublasSplitKParams<",
     "gemm"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_imp"
     "l_nocast<at::native::CUDAFunctor_add<c10::BFloat16> >(at::TensorIterat"
     "orBase&, at::native:",
     "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::GeluCUDA"
     "KernelImpl(at::TensorIteratorBase&, at::native::GeluType)::{lambda()#1"
     "}::operator()() cons",
     "elementwise"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::"
     "native::(anonymous namespace)::TensorListMetadata<2>, at::native::(ano"
     "nymous namespace)::B",
     "elementwise"),
    ("void at::native::(anonymous namespace)::distribution_elementwise_grid_"
     "stride_kernel<float, 4, at::native::templates::cuda::uniform_and_trans"
     "form<float, float, a",
     "elementwise"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_k"
     "ernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() const:"
     ":{lambda()#4}::opera",
     "copy_transpose"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16"
     "_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}, std::ar"
     "ray<char*, 2ul> >(in",
     "copy_transpose"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized"
     "<at::native::(anonymous namespace)::OpaqueType<2u>, unsigned int, 1, 1"
     "28, 1, 16, 8>(char*,",
     "copy_transpose"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native"
     "::_cuda_scatter_gather_internal_kernel<false, at::native::OpaqueType<4"
     ">, long>::operator()",
     "copy_transpose"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<f"
     "loat, float, false>(int, float, float const*, float const*, float cons"
     "t*, float*, float*, ",
     "reduce_norm"),
    ("void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernelTem"
     "plate<float, float, 32u, 32u, 256u, false, false, false>(long, long, f"
     "loat const*, float c",
     "reduce_norm"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, at:"
     ":native::func_wrapper_t<float, at::native::sum_functor<float, float, f"
     "loat>::operator()(at",
     "reduce_norm"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, float, "
     "6, false, false>(float*, float const*, int, int, int, bool const*, int"
     ", bool)",
     "reduce_norm"),
    ("(anonymous namespace)::flash_fwd_bf16_kernel(__nv_bfloat16 const*, __n"
     "v_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, int, "
     "int, int, float, (an",
     "flash_attn"),
    ("(anonymous namespace)::flat_bwd_bf16_kernel(CUtensorMap_st, CUtensorM"
     "ap_st, CUtensorMap_st, CUtensorMap_st, bwd_units::UnitArgs)",
     "flash_attn"),
    ("(anonymous namespace)::dq_f32_kernel((anonymous namespace)::Args)",
     "flash_attn"),
    ("(anonymous namespace)::bhsd_fwd_bf16_kernel(__nv_bfloat16 const*, __nv"
     "_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, int, i"
     "nt, int, float, (ano",
     "flash_attn"),
    ("void (anonymous namespace)::int8_gemm_kernel<__nv_bfloat16>("
     "__nv_bfloat16 const*, signed char const*, float const*, float const*",
     "int8_gemm"),
    ("void (anonymous namespace)::roofline_kernel<2, 4>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, int, "
     "float)", "attn_roofline"),
]


@pytest.mark.parametrize("name,group", KERNEL_NAMES,
                         ids=[g + str(i) for i, (_, g) in
                              enumerate(KERNEL_NAMES)])
def test_trace_step_groups_card_kernel_names(name, group):
    assert trace_step.classify(name) == group


def test_every_port_kernel_source_names_its_kernels():
    found = trace_step.port_kernels()
    from dinov2_od_tpu_torch.ops import _build

    assert set(found.values()) == set(_build.SOURCES)
    assert found["flash_fwd_bf16_kernel"] == "flash_attn_fwd"
    assert found["roofline_kernel"] == "attn_roofline"


def test_trace_step_parser_sums_kernel_events_only(tmp_path):
    def ev(name, dur, cat="kernel", ph="X"):
        return {"ph": ph, "cat": cat, "name": name, "pid": 0, "tid": 7,
                "ts": 0, "dur": dur}

    events = [
        ev("aten::mm", 900.0, cat="cpu_op"),   # host lane: not device time
        ev("cudaLaunchKernel", 50.0, cat="cuda_runtime"),
        ev("nvjet_tst_64x8_64x16_4x1_v_bz_TNT", 300.0),
        ev("nvjet_tst_64x8_64x16_4x1_v_bz_TNT", 300.0),
        ev("(anonymous namespace)::flash_fwd_bf16_kernel(...)", 120.0),
        ev("(anonymous namespace)::flat_bwd_bf16_kernel(...)", 60.0),
        ev("void at::native::vectorized_elementwise_kernel<4, ...>", 90.0),
        ev("Memcpy DtoH (Device -> Pinned)", 40.0, cat="gpu_memcpy"),
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace_step.summarize(str(path), steps=2)
    assert s["device_ms_per_step"] == pytest.approx(0.435)
    assert s["kernels_per_step"] == 2.5
    assert s["by_group"] == pytest.approx(
        {"gemm": 0.3, "flash_attn": 0.09, "elementwise": 0.045})
    assert sum(s["by_group"].values()) == pytest.approx(
        s["device_ms_per_step"])
    assert s["by_source"] == pytest.approx(
        {"flash_attn_fwd": 0.06, "flash_attn_bwd": 0.03})


@pytest.mark.filterwarnings("ignore:CUDA is not available")
def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(str(tmp_path)), annotate("matcher"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    events = json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert {"aten::mm", "matcher"} <= names
    # No card, no kernel events: nothing for trace_step to count.
    s = trace_step.summarize(str(tmp_path / TRACE_FILE), steps=1)
    assert s["device_ms_per_step"] == 0 and s["kernels_per_step"] == 0


def test_annotate_records_only_under_a_profiler(monkeypatch):
    made = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: made.append(name) or
                        torch.profiler.record_function(name))
    assert annotate("a") is annotate("b")  # the shared no-op
    with annotate("a"), annotate("b"):
        pass
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("inside"):
            torch.ones(2) + 1
    assert made == ["inside"]
    assert "inside" in {e.name for e in prof.events()}
    with annotate("after"):
        pass
    assert made == ["inside"]


def _x(name, cat, ts, dur, corr=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def hand_phase_trace():
    """A 100 us window (at 1000 us). The host: step.forward over [0, 30),
    step.criterion over [30, 60) holding step.match over [35, 55) and its
    auction.check over [40, 50), step.backward over [60, 90), nothing
    after. Launches (correlation id: time): 1 at 1 (forward), 2 at 36
    (match), a cudaGraphLaunch 3 at 41 (match: three kernels), 4 at 58
    (criterion), 5 at 61 (backward), 6 at 95 (no phase), and 7 at 20 in
    the forward whose kernel runs past the window's end."""
    k = "kernel"
    return [
        _x("trace_step.window", "user_annotation", 1000, 100),
        _x("step.forward", "user_annotation", 1000, 30),
        _x("step.criterion", "user_annotation", 1030, 30),
        _x("step.match", "user_annotation", 1035, 20),
        _x("auction.check", "user_annotation", 1040, 10),
        _x("step.backward", "user_annotation", 1060, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 1001, 2, corr=1),
        _x("cudaLaunchKernel", "cuda_runtime", 1020, 2, corr=7),
        _x("cudaMemcpyAsync", "cuda_runtime", 1036, 2, corr=2),
        _x("cudaGraphLaunch", "cuda_runtime", 1041, 2, corr=3),
        _x("cuLaunchKernel", "cuda_driver", 1058, 1, corr=4),
        _x("cudaLaunchKernel", "cuda_runtime", 1061, 2, corr=5),
        _x("cudaLaunchKernel", "cuda_runtime", 1095, 2, corr=6),
        # Device: [5, 25) forward; [25, 30) forward too (overlapping the
        # first, which started earlier); a copy [36, 38) from the match;
        # the graph's kernels [42, 44), [44, 47), [50, 52); [58, 60) the
        # criterion; [62, 88) the backward; [96, 120) with no phase,
        # clipped to [96, 100).
        _x("gemm_a", k, 1005, 20, corr=1),
        _x("gemm_b", k, 1022, 8, corr=7),
        _x("Memcpy DtoH", "gpu_memcpy", 1036, 2, corr=2),
        _x("round_a", k, 1042, 2, corr=3),
        _x("round_b", k, 1044, 3, corr=3),
        _x("round_c", k, 1050, 2, corr=3),
        _x("loss", k, 1058, 2, corr=4),
        _x("gemm_bwd", k, 1062, 26, corr=5),
        _x("tail", k, 1096, 24, corr=6),
        _x("outside", k, 1200, 10, corr=8),
    ]


def test_phase_split_of_a_hand_made_trace():
    split = trace_step.phase_split(hand_phase_trace())
    us = 1e-6
    assert split["window_s"] == pytest.approx(100 * us)
    assert split["phase_busy_s"] == pytest.approx({
        "step.forward": 25 * us, "step.match": 9 * us,
        "step.criterion": 2 * us, "step.backward": 26 * us,
        "none": 4 * us})
    # Gaps [0, 5) forward, [30, 36) criterion, [38, 42) match (under the
    # auction's check, a deeper span but no phase), [47, 50) match,
    # [52, 58) match (closed at 55: the gap's start decides), [60, 62)
    # backward, [88, 96) backward (then no phase).
    assert split["phase_idle_s"] == pytest.approx({
        "step.forward": 5 * us, "step.criterion": 6 * us,
        "step.match": 13 * us, "step.backward": 10 * us, "none": 0.0})
    assert split["busy_s"] == pytest.approx(66 * us)
    assert sum(split["phase_idle_s"].values()) == pytest.approx(
        split["window_s"] - split["busy_s"])
    assert split["phase_counts"] == {"step.forward": 1, "step.criterion": 1,
                                     "step.match": 1, "step.backward": 1}
    out = io.StringIO()
    trace_step.report_phases(split, steps=2, out=out)
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    # By busy plus idle time, in ms a step.
    assert lines[0] == {"phase": "step.backward", "busy_ms": 0.013,
                        "idle_ms": 0.005, "spans": 0.5}
    assert {line["phase"] for line in lines} == set(split["phase_busy_s"])


def test_phase_split_reads_zero_for_a_phase_that_got_nothing():
    events = [_x("bench.window", "user_annotation", 0, 10),
              _x("step.update", "user_annotation", 2, 3),
              _x("k", "kernel", 0, 10, corr=1)]
    split = trace_step.phase_split(events, window="bench.window")
    assert split["phase_busy_s"] == {"step.update": 0.0, "none": 10e-6}
    assert split["phase_idle_s"] == {"step.update": 0.0, "none": 0.0}
    with pytest.raises(ValueError, match="no trace_step.window span"):
        trace_step.phase_split(events)
