"""The attention roofline tool's ablation kernel, T1 (`kernel` in
tools/bench_attn_roofline.py, :69), against its port
(dinov2_od_tpu_torch/ops/attn_roofline.py).

The JAX kernel is a closure inside the tool's `main()`, so the test takes
its `FunctionDef` out of the tool's source with `ast`, compiles it with
what `main` binds around it (`jax`, `jnp`, `fa` and the numpy float64
`scale`), and runs it through `pl.pallas_call(..., interpret=True)` with
the tool's BlockSpec (:91-100). The tool itself is not edited.

On the CPU the wrapper runs the plain version; the `gpu`-marked test holds
the CUDA kernel against it on the card and skips without one."""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from dinov2_od_tpu_torch.ops import _build
from dinov2_od_tpu_torch.ops import attn_roofline as t1
from dinov2_od_tpu_torch.ops import flash_attention as fa

REPO = Path(__file__).resolve().parent.parent
TOOL = REPO / "tools" / "bench_attn_roofline.py"
DH = 64
SCALE = 1.0 / np.sqrt(DH)  # the tool's numpy float64 scale
# Plain version against the JAX kernel, both bf16 outputs:
# - relative Frobenius error <= 4e-3: both compute s in fp32 and round p
#   and o to bf16 at the same points; only the summation order differs;
# - at least 99% of the elements bit-equal: an fp32 sum in another order
#   lands on the other side of a bf16 rounding step only rarely (0.14% at
#   most in these cases), while a q' rounded to bf16 moves the logits by
#   2^-9 and about half the outputs (the control below: 46-58% equal).
REL_TOL = 4e-3
EQUAL_SHARE = 0.99
# [B, H, S, 64]: 48 and 80 rows, and each side of the kernel's 32-row unit
# (32, 40; 72 past two units).
SHAPES = [(1, 2, 48, 64), (2, 1, 80, 64), (1, 2, 32, 64), (1, 2, 40, 64),
          (2, 1, 72, 64)]
SHAPE_IDS = ["48x2h", "80x2b", "32x2h", "40x2h", "72x2b"]


@pytest.fixture(scope="module")
def jax_t1():
    """T1 as the tool defines it, run in Pallas interpret mode: a function
    of numpy q, k, v and the stage, returning o as fp32 numpy."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from dinov2_od_tpu.ops import flash_attention as jfa

    tree = ast.parse(TOOL.read_text(), filename=str(TOOL))
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    kernel = next(n for n in main.body
                  if isinstance(n, ast.FunctionDef) and n.name == "kernel")
    ns = {"jax": jax, "jnp": jnp, "fa": jfa, "scale": SCALE}
    exec(compile(ast.Module(body=[kernel], type_ignores=[]), str(TOOL),
                 "exec"), ns)

    def run(q, k, v, stage):
        b, h, s, dh = q.shape
        spec = pl.BlockSpec((1, 1, s, dh), lambda bi, hi: (bi, hi, 0, 0))
        f = pl.pallas_call(
            functools.partial(ns["kernel"], stage=stage),
            grid=(b, h), in_specs=[spec, spec, spec], out_specs=spec,
            out_shape=jax.ShapeDtypeStruct((b, h, s, dh), jnp.bfloat16),
            interpret=True)
        args = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
        return np.asarray(f(*args).astype(jnp.float32))

    return run


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device, torch.bfloat16) for a in arrays]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bf16_q_plain(q, k, v, stage):
    """The control: T1's math with q' rounded to bf16, as the production
    kernels scale q."""
    qs = (q.float() * t1.q_multiplier(SCALE)).to(torch.bfloat16).float()
    s = qs @ k.float().transpose(-1, -2)
    if stage != "mxu_only":
        s = s - s.amax(-1, keepdim=True)
    p = torch.exp2(s) if stage == "plus_exp2" else s
    return (p.to(torch.bfloat16).float() @ v.float()).to(torch.bfloat16)


@pytest.mark.parametrize("stage", t1.STAGES)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_jax_kernel(jax_t1, shape, stage):
    arrays = _inputs(shape)
    ref = jax_t1(*arrays, stage)
    q, k, v = _torch(arrays)
    out = t1.attn_roofline(q, k, v, scale=SCALE, stage=stage)
    assert out.dtype == torch.bfloat16 and out.shape == shape
    got = out.float().numpy()
    assert _rel(got, ref) <= REL_TOL
    assert np.mean(got == ref) >= EQUAL_SHARE
    # The control fails the same check: a bf16 q' is not T1's function.
    ctl = _bf16_q_plain(q, k, v, stage).float().numpy()
    assert np.mean(ctl == ref) < EQUAL_SHARE


def test_q_multiplier_is_the_fp32_rounding_of_the_float64_product():
    m = t1.q_multiplier(SCALE)
    assert m == float(np.float32(np.float64(SCALE) * 1.4426950408889634))
    assert m != SCALE * 1.4426950408889634  # fp32, not the float64 value


def test_wrapper_checks_its_inputs():
    q, k, v = _torch(_inputs((1, 1, 16, 64)))
    with pytest.raises(ValueError, match="stage"):
        t1.attn_roofline(q, k, v, scale=SCALE, stage="plus_sum")
    with pytest.raises(TypeError):
        t1.attn_roofline(q.float(), k, v, scale=SCALE, stage="mxu_only")
    with pytest.raises(ValueError, match="head_dim"):
        t1.attn_roofline(q[..., :32], k[..., :32], v[..., :32], scale=SCALE,
                         stage="mxu_only")
    long = torch.zeros((1, 1, t1.MAX_SEQ + 16, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=str(t1.MAX_SEQ)):
        t1.attn_roofline(long, long, long, scale=SCALE, stage="mxu_only")


@pytest.mark.parametrize("seq,kernel", [(1370, "bhsd"), (272, "allheads")])
def test_production_routing_matches_the_jax_dispatch(seq, kernel):
    """The tool's production variant is the non-flat forward: at its
    default shape JAX's `_head_group(16, 1376, 1376, 2)` is 0 (B5f); at
    --seq 272 the all-heads kernel (B4f)."""
    s_pad = fa._round_up(seq, fa._SUBLANE)
    q = torch.empty((8, s_pad, 16, 64), device="meta")
    assert fa._allheads_fwd(q, q) == (kernel == "allheads")


@pytest.mark.gpu
@pytest.mark.parametrize("stage", t1.STAGES)
@pytest.mark.parametrize("shape", [(8, 16, 1376, 64), (2, 16, 1616, 64),
                                   (1, 3, t1.MAX_SEQ, 64), (2, 2, 98, 64),
                                   *SHAPES[2:]],
                         ids=["tool_default", "vit_l_560", "limit", "ragged",
                              *SHAPE_IDS[2:]])
def test_kernel_matches_plain_on_card(shape, stage):
    """T1 against its plain version on the card; tolerance and its reason:
    chip_smoke.py T1_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _torch(_inputs(shape), "cuda")
    before = _build.launch_counts["attn_roofline"]
    out = t1.attn_roofline(q, k, v, scale=SCALE, stage=stage)
    assert _build.launch_counts["attn_roofline"] == before + 1
    ref = t1.attn_roofline_plain(q, k, v, scale=SCALE, stage=stage)
    torch.cuda.synchronize()
    err = (out.float() - ref.float())
    assert torch.isfinite(out.float()).all()
    assert (err.norm() / ref.float().norm()).item() <= 1e-3
    assert err.abs().max().item() <= 2.0 ** -6 * ref.float().abs().max().item()
