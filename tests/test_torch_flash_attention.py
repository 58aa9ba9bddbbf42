"""The port's flash-attention forward (dinov2_od_tpu_torch/ops/
flash_attention.py) against the JAX kernel run in Pallas interpret mode,
and its wrapper's dispatch. On the CPU the wrapper runs the plain
version; the `gpu`-marked test holds the CUDA kernel against it on the
card and skips without one."""

import numpy as np
import pytest
import torch

from dinov2_od_tpu_torch.ops import _build
from dinov2_od_tpu_torch.ops import flash_attention as fa
from dinov2_od_tpu_torch.ops.attention import multi_head_attention

# (batch, seq, heads, kv_len): S not a multiple of 16, masked keys, one
# valid key. Heads even: the JAX flat path pairs 64-wide heads.
CASES = [(2, 37, 2, None), (1, 40, 4, 29), (2, 19, 2, 1)]
DH = 64
# Plain version against the JAX kernel, max abs error. fp32: the same
# math in another summation order. bf16: both round q*scale and p to
# bf16 at the same points, so only an fp32 sum landing on the other side
# of a bf16 rounding step can differ — one bf16 ulp of o (|o| < 2).
TOL = {
    "float32": {"o": 1e-5, "lse": 1e-5},
    "bfloat16": {"o": 1e-2, "lse": 1e-3},
}


@pytest.fixture(scope="module")
def jnp():
    """jax.numpy, imported by the tests that compare with JAX only, so
    the card-only test below runs where JAX is not installed
    (`pytest --noconftest ... -m gpu`)."""
    import jax.numpy

    return jax.numpy


def _qkv(seed, b, s, h, dtype):
    """The same seeded q, k, v as numpy fp32 arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, s, h, DH)).astype(np.float32)
            for _ in range(3)]
    return arrs, [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_jax_kernel(jnp, dtype, case):
    from dinov2_od_tpu.ops.flash_attention import (
        flash_attention as jax_flash,
        flash_attention_lse as jax_flash_lse,
    )

    b, s, h, kv_len = case
    arrs, (q, k, v) = _qkv(7, b, s, h, dtype)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrs)
    scale = DH ** -0.5
    o_ref = jax_flash(jq, jk, jv, scale=scale, interpret=True, flat=True,
                      kv_len=kv_len)
    _, lse_ref = jax_flash_lse(jq, jk, jv, scale=scale, interpret=True,
                               flat=True, kv_len=kv_len)
    o, lse = fa.flash_attention_lse(q, k, v, scale=scale, kv_len=kv_len)
    assert o.dtype == q.dtype and o.shape == (b, s, h, DH)
    assert lse.dtype == torch.float32 and lse.shape == (b, s, h)
    err_o = np.abs(np.asarray(o_ref, np.float32) - o.float().numpy()).max()
    err_lse = np.abs(np.asarray(lse_ref) - lse.numpy()).max()
    assert err_o <= TOL[dtype]["o"], err_o
    assert err_lse <= TOL[dtype]["lse"], err_lse


# B1's tile edges (csrc/flash_fwd_units.cuh): 128-key tiles, and the fitted
# 8-key tail that kv_len 129 .. 136 and 257 .. 264 take. Each length on
# either side of an edge, with all keys, all but one and one; and tails
# behind five or more full tiles, where the kernel's 5-stage ring must move
# past the tail's slot: 641 (5 x 128 + 1), 1025 (ViT-B/14 at 448 px) and
# 1157 (at 476 px).
EDGE_CASES = [(s, kv) for s in (128, 129, 256, 257, 264, 265, 641, 1025,
                                1157)
              for kv in (s, s - 1, 1)]


@pytest.mark.parametrize("case", EDGE_CASES,
                         ids=lambda c: f"s{c[0]}_kv{c[1]}")
def test_plain_matches_jax_kernel_at_tile_edges(jnp, case):
    """The plain version (what B1 is held to on the card) against the JAX
    flat kernel in interpret mode, bf16, at B1's tile edges."""
    from dinov2_od_tpu.ops.flash_attention import (
        flash_attention_lse as jax_flash_lse,
    )

    s, kv_len = case
    arrs, (q, k, v) = _qkv(13, 1, s, 2, "bfloat16")
    jq, jk, jv = (jnp.asarray(a, "bfloat16") for a in arrs)
    o_ref, lse_ref = jax_flash_lse(jq, jk, jv, scale=DH ** -0.5,
                                   interpret=True, flat=True, kv_len=kv_len)
    o, lse = fa.flash_attention_lse(q, k, v, scale=DH ** -0.5, kv_len=kv_len)
    assert o.shape == (1, s, 2, DH) and lse.shape == (1, s, 2)
    err_o = np.abs(np.asarray(o_ref, np.float32) - o.float().numpy()).max()
    err_lse = np.abs(np.asarray(lse_ref) - lse.numpy()).max()
    assert err_o <= TOL["bfloat16"]["o"], err_o
    assert err_lse <= TOL["bfloat16"]["lse"], err_lse


def test_log2_lse_and_masked_keys():
    """The log2 lse is the natural one over ln 2, and keys at or past
    kv_len carry no weight: changing them changes nothing."""
    _, (q, k, v) = _qkv(3, 1, 24, 2, "float32")
    o, lse2 = fa.flash_attention_fwd(q, k, v, scale=0.125, kv_len=10)
    _, lse = fa.flash_attention_lse(q, k, v, scale=0.125, kv_len=10)
    np.testing.assert_allclose(lse2.transpose(1, 2).numpy() * np.log(2.0),
                               lse.numpy(), rtol=1e-6)
    k2, v2 = k.clone(), v.clone()
    k2[:, 10:] = 1e3
    v2[:, 10:] = -7.0
    o2, _ = fa.flash_attention_fwd(q, k2, v2, scale=0.125, kv_len=10)
    assert torch.equal(o, o2)


def test_cpu_tensor_takes_plain_version():
    _build.reset_launch_counts()
    _, (q, k, v) = _qkv(1, 2, 21, 2, "bfloat16")
    q.requires_grad_(True)
    o = fa.flash_attention(q, k, v, scale=0.125, kv_len=17)
    o_plain, _ = fa.flash_attention_fwd_plain(q, k, v, scale=0.125,
                                              kv_len=17)
    out = multi_head_attention(q, k, v, impl="flash")
    o.float().sum().backward()  # the backward's plain version
    assert torch.equal(o, o_plain)
    assert out.shape == q.shape
    assert q.grad is not None and q.grad.shape == q.shape
    assert _build.launch_counts == {name: 0 for name in _build.SOURCES}


def test_strided_views_of_fused_qkv():
    """q, k, v as the three slices of one fused [B, S, 3D] buffer, as the
    backbone passes them, give the result of contiguous copies."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.normal(size=(2, 30, 3 * 2 * DH))
                           .astype(np.float32))
    q, k, v = (t.view(2, 30, 2, DH) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    o = fa.flash_attention(q, k, v, scale=0.125)
    o_c = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             scale=0.125)
    assert torch.equal(o, o_c)


@pytest.mark.parametrize("impl", ["auto", "xla", "flash"])
def test_multi_head_attention_matches_jax_xla(jnp, impl):
    from dinov2_od_tpu.ops.attention import _xla_attention

    arrs, (q, k, v) = _qkv(11, 2, 33, 2, "float32")
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    ref = np.asarray(_xla_attention(jq, jk, jv, DH ** -0.5,
                                    kv_valid_len=20))
    out = multi_head_attention(q, k, v, impl=impl, kv_valid_len=20)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_unsupported_inputs_raise():
    _, (q, k, v) = _qkv(2, 1, 8, 2, "float32")
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half(), scale=0.125)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, scale=0.125, kv_len=9)
    # Sq != Sk takes the BHSD family; the flat one is self-attention only.
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :5], v[:, :5], scale=0.125, flat=True)
    # As JAX's: the ring needs a mesh and its axis.
    with pytest.raises(ValueError, match="requires mesh and seq_axis"):
        multi_head_attention(q, k, v, impl="ring")
    # The flash kernel never materialises the probabilities to drop.
    with pytest.raises(ValueError, match="dropout"):
        multi_head_attention(q, k, v, impl="flash", dropout_rate=0.1,
                             generator=torch.Generator())
    # As in JAX, seq_axis matters only to impl='ring'.
    assert torch.equal(multi_head_attention(q, k, v, seq_axis="model"),
                       multi_head_attention(q, k, v))
    # Tensor-parallel heads are this rank's heads: attention as it is.
    assert torch.equal(multi_head_attention(q, k, v, tp_axis="model"),
                       multi_head_attention(q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [257, 200])
def test_kernel_matches_plain_on_card(dtype, kv_len):
    """The CUDA kernel against its plain version at the ViT-B serving
    shape (B=32, S=257, H=12, dh=64), q/k/v as views of one fused buffer.
    Tolerances and their reasons: chip_smoke.py TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 3e-3)}[dtype]
    gen = torch.Generator().manual_seed(0)
    b, s, h = 32, 257, 12
    qkv = torch.randn((b, s, 3 * h * DH), generator=gen)
    qkv = qkv.to("cuda", getattr(torch, dtype))
    q, k, v = (t.view(b, s, h, DH) for t in qkv.chunk(3, dim=-1))
    before = _build.launch_counts["flash_attn_fwd"]
    o, lse = fa.flash_attention_fwd(q, k, v, scale=0.125, kv_len=kv_len)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, scale=0.125,
                                                  kv_len=kv_len)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attn_fwd"] == before + 1
    assert (o.float() - o_ref.float()).abs().max().item() <= tol[0]
    assert (lse - lse_ref).abs().max().item() <= tol[1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", EDGE_CASES,
                         ids=lambda c: f"s{c[0]}_kv{c[1]}")
def test_kernel_matches_plain_at_tile_edges_on_card(dtype, case):
    """B1 at its tile edges (4 images, 12 heads, the fused qkv views):
    within chip_smoke.py's ALLHEADS_TOL (both take p against the exact row
    max), o and the lse bit-equal from run to run, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-3)}[dtype]
    s, kv_len = case
    gen = torch.Generator().manual_seed(s + kv_len)
    qkv = torch.randn((4, s, 3 * 12 * DH), generator=gen)
    qkv = qkv.to("cuda", getattr(torch, dtype))
    q, k, v = (t.view(4, s, 12, DH) for t in qkv.chunk(3, dim=-1))
    before = _build.launch_counts["flash_attn_fwd"]
    o, lse = fa.flash_attention_fwd(q, k, v, scale=0.125, kv_len=kv_len)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, scale=0.125, kv_len=kv_len)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, scale=0.125,
                                                  kv_len=kv_len)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attn_fwd"] == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert (o.float() - o_ref.float()).abs().max().item() <= tol[0]
    assert (lse - lse_ref).abs().max().item() <= tol[1]


@pytest.mark.gpu
@pytest.mark.parametrize("s", [17, 257])
def test_auto_takes_kernel_at_any_length_on_card(s):
    """'auto' sends every head-dim-64 self-attention on the card to a
    kernel, short sequences included (17 tokens: a 56 px image): 2 heads
    pair into the flat B1, 3 heads take the all-heads B4f, as in JAX."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for h, name in ((2, "flash_attn_fwd"), (3, "flash_attn_allheads_fwd")):
        _, (q, k, v) = _qkv(2, 2, s, h, "float32")
        q, k, v = q.cuda(), k.cuda(), v.cuda()
        before = dict(_build.launch_counts)
        out = multi_head_attention(q, k, v, impl="auto")
        ref = multi_head_attention(q.cpu(), k.cpu(), v.cpu(), impl="flash")
        assert _build.launch_counts == {**before, name: before[name] + 1}
        assert (out.cpu() - ref).abs().max().item() <= 1e-5


@pytest.mark.gpu
def test_detector_on_card_matches_cpu():
    """A small fp32 detector (head dim 64, so the backbone takes the
    kernel) on the card against the same params on the CPU, where the
    plain version runs: 1e-4, the whole-detector fp32 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dinov2_od_tpu_torch import config as pcfg
    from dinov2_od_tpu_torch.models.detector import (
        detector_apply, init_detector_params)
    from dinov2_od_tpu_torch.params import params_from_numpy, params_to_numpy

    cfg = pcfg.DetectorConfig(
        backbone=pcfg.BackboneConfig(
            variant="small", image_size=224, hidden_dim_override=128,
            num_heads_override=2, depth_override=2, target_dim=64),
        decoder=pcfg.DecoderConfig(hidden_dim=64, num_queries=5,
                                   num_layers=2, num_heads=4,
                                   dim_feedforward=96, num_classes=6),
    )
    cpu = init_detector_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    card = params_from_numpy(params_to_numpy(cpu), device="cuda")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 224, 224, 3)).astype(np.float32))
    before = _build.launch_counts["flash_attn_fwd"]
    out = detector_apply(card, cfg, x.cuda())
    ref = detector_apply(cpu, cfg, x)
    assert _build.launch_counts["flash_attn_fwd"] == before + 2
    for key in ("pred_logits", "pred_boxes"):
        err = (out[key].cpu() - ref[key]).abs().max().item()
        assert err <= 1e-4, (key, err)
