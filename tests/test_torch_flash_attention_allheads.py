"""The port's all-heads flash-attention pair (B4f forward, B4b backward; the
counterparts of `_fwd_kernel_allheads` and `_bwd_kernel_allheads` in
dinov2_od_tpu/ops/flash_attention.py) against the JAX kernels run in
Pallas interpret mode, and the port's copy of the JAX rules that route a
shape to them. On the CPU the wrappers run the plain versions; the
`gpu`-marked test holds the CUDA kernels against them on the card and
skips without one.

Each case is one where the JAX dispatch (`_flash_fwd`, `_bhsd_bwd_impl`,
with no block_q and `flat=False`) reaches the all-heads kernel, which the
test asserts with JAX's own helpers."""

import types

import numpy as np
import pytest
import torch

from dinov2_od_tpu_torch.ops import _build
from dinov2_od_tpu_torch.ops import flash_attention as fa

DH = 64
SCALE = DH ** -0.5
# Plain versions against the JAX kernels. Forward, max abs error: fp32 the
# same math summed in another order; bf16: both take p against the exact
# row max and round q*scale and p to bf16 at the same points, so only an
# fp32 sum on the other side of a bf16 rounding step differs: one bf16 ulp
# of o (|o| < 2), and the lse by an fp32 rounding. Backward, max abs error
# of each of dq, dk, dv over max(1, its largest magnitude): fp32 the same
# math in another order; bf16 p and ds rounded at the same points, an
# element moved by one bf16 ulp where an fp32 sum rounds apart (2^-7).
FWD_TOL = {
    "float32": {"o": 1e-5, "lse": 1e-5},
    "bfloat16": {"o": 1e-2, "lse": 1e-3},
}
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}

# (b, sq, sk, h, kv_len)
CASES = {
    # ViT-B's 12 heads under 4-way tensor parallelism: 3 heads a rank.
    "s257_h3": (2, 257, 257, 3, None),
    # The same at the TPU's padded length, 272, keys from 257 on masked
    # (what the TPU's TP path runs after its one-time padding,
    # dinov2_od_tpu/models/vit.py:363).
    "s272_kv257_h3": (1, 272, 272, 3, 257),
    # Sq != Sk: 50 queries over 300 keys, 2 heads.
    "cross_50x300_h2": (2, 50, 300, 2, None),
}
# The backward's cases add S 640, the longest self-attention the backward
# rule sends to the all-heads kernel (one head's five logits buffers,
# 640 x 640 x 20 B, fit the 8 MiB budget).
BWD_CASES = {**CASES, "s640_h1": (1, 640, 640, 1, None)}


@pytest.fixture(scope="module")
def jax_mods():
    """jax and jax.numpy, imported by the tests that compare with JAX
    only, so the card-only test below runs where JAX is not installed."""
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _jax_routes(b, sq, sk, h):
    """(flat, forward all-heads, backward all-heads) as the JAX dispatch
    decides them, from its own helpers and conditions
    (`flash_attention`, `_flash_fwd`, `_bhsd_bwd_impl`; no block_q)."""
    from dinov2_od_tpu.ops import flash_attention as jfa

    q = types.SimpleNamespace(shape=(b, sq, h, DH))
    k = types.SimpleNamespace(shape=(b, sk, h, DH))
    flat = jfa._flat_eligible(q, k)
    sk_pad = jfa._round_up(sk, jfa._SUBLANE)
    sq_pad = jfa._round_up(sq, jfa._auto_block(sq, sk_pad))
    g = jfa._head_group(h, sq_pad, sk_pad, n_buffers=2)
    fwd = g > 1 or (g == 1 and sq_pad == jfa._round_up(sq, jfa._SUBLANE))
    sq_pad = jfa._round_up(sq, jfa._SUBLANE)
    sk_pad = jfa._round_up(sk, jfa._auto_block(sk, sq_pad, n_buffers=4))
    bwd = jfa._head_group(h, sq_pad, sk_pad, n_buffers=5) >= 1
    return flat, fwd, bwd


def _arrays(seed, b, sq, sk, h):
    """q [b, sq, h, 64], k, v [b, sk, h, 64] and dO [b, sq, h, 64], fp32."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, DH)).astype(np.float32)
            for s in (sq, sk, sk, sq)]


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _rel_err(ref, out):
    """max |ref - out| over max(1, max |ref|)."""
    ref = np.asarray(ref, np.float32)
    err = np.abs(ref - out.detach().float().numpy()).max()
    return float(err / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_matches_jax_kernel(jax_mods, dtype, case):
    _, jnp = jax_mods
    from dinov2_od_tpu.ops.flash_attention import flash_attention as jflash

    b, sq, sk, h, kv_len = CASES[case]
    assert _jax_routes(b, sq, sk, h)[:2] == (False, True)
    arrs = _arrays(1, b, sq, sk, h)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrs[:3])
    ref = jflash(jq, jk, jv, scale=SCALE, interpret=True, flat=False,
                 kv_len=kv_len)
    q, k, v = (_t(a, dtype) for a in arrs[:3])
    o, lse = fa.flash_attention_allheads_fwd_plain(q, k, v, scale=SCALE,
                                                   kv_len=kv_len)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    err = np.abs(np.asarray(ref, np.float32) - o.float().numpy()).max()
    assert err <= FWD_TOL[dtype]["o"], err
    # The port's wrapper routes the shape to B4f and computes the same o.
    o_auto = fa.flash_attention(q, k, v, scale=SCALE, kv_len=kv_len)
    assert torch.equal(o_auto, o)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_plain_backward_matches_jax_kernel(jax_mods, dtype, case):
    jax, jnp = jax_mods
    from dinov2_od_tpu.ops.flash_attention import flash_attention as jflash

    b, sq, sk, h, kv_len = BWD_CASES[case]
    assert _jax_routes(b, sq, sk, h)[::2] == (False, True)
    arrs = _arrays(3, b, sq, sk, h)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: jflash(
        q, k, v, scale=SCALE, interpret=True, flat=False, kv_len=kv_len),
        jq, jk, jv)
    ref = vjp(jdo)
    q, k, v, do = (_t(a, dtype) for a in arrs)
    o, lse = fa.flash_attention_allheads_fwd(q, k, v, scale=SCALE,
                                             kv_len=kv_len)
    grads = fa.flash_attention_allheads_bwd(q, k, v, o, lse, do, scale=SCALE,
                                            kv_len=kv_len)
    for name, r, g, x in zip("qkv", ref, grads, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert _rel_err(r, g) <= BWD_TOL[dtype], (name, _rel_err(r, g))
    if kv_len is not None:  # masked keys: dk and dv exactly zero
        assert not grads[1][:, kv_len:].any()
        assert not grads[2][:, kv_len:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_cotangent_through_allheads_like_jax(jax_mods, dtype):
    """B3 riding on B4: a cotangent on both outputs of flash_attention_lse
    at the tensor-parallel head count (S 257, H 3), against JAX's
    `_flash_bhsd_lse`, whose forward and backward both take the all-heads
    kernel here. Tolerances: BWD_TOL."""
    jax, jnp = jax_mods
    from dinov2_od_tpu.ops.flash_attention import (
        flash_attention_lse as jflash_lse)

    b, s, h, kv_len = 1, 257, 3, 240
    assert _jax_routes(b, s, s, h) == (False, True, True)
    arrs = _arrays(4, b, s, s, h)
    glse = np.random.default_rng(5).normal(size=(b, s, h)).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: jflash_lse(
        q, k, v, scale=SCALE, interpret=True, flat=False, kv_len=kv_len),
        jq, jk, jv)
    ref = vjp((jdo, jnp.asarray(glse)))
    q, k, v = (_t(a, dtype).requires_grad_(True) for a in arrs[:3])
    o, lse = fa.flash_attention_lse(q, k, v, scale=SCALE, kv_len=kv_len)
    do = _t(arrs[3], dtype).float()
    got = torch.autograd.grad((o.float() * do).sum()
                              + (lse * torch.from_numpy(glse)).sum(),
                              (q, k, v))
    for name, r, g in zip("qkv", ref, got):
        assert _rel_err(r, g) <= BWD_TOL[dtype], (name, _rel_err(r, g))
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


@pytest.mark.parametrize("b", [1, 8, 32])
def test_routing_matches_jax(jax_mods, b):
    """The port's forward and backward rules (`_allheads_fwd`,
    `_allheads_bwd`, `_flat_eligible`) against the JAX dispatch's own over
    a grid of (Sq, Sk, H), across the routing edges: S_pad 1024 for the
    forward, 640 for the backward, the 1536 flat limit and Sq != Sk."""
    lengths = (1, 17, 50, 257, 272, 640, 641, 656, 1008, 1024, 1025, 1040,
               1370, 1601, 4096, 16384, 16385)
    for sq in lengths:
        for sk in lengths:
            for h in (1, 2, 3, 4, 6, 12, 16):
                q = types.SimpleNamespace(shape=(b, sq, h, DH))
                k = types.SimpleNamespace(shape=(b, sk, h, DH))
                got = (fa._flat_eligible(q, k), fa._allheads_fwd(q, k),
                       fa._allheads_bwd(q, k))
                assert got == _jax_routes(b, sq, sk, h), (sq, sk, h)
    tp_rank = types.SimpleNamespace(shape=(32, 257, 3, DH))
    assert (fa._flat_eligible(tp_rank, tp_rank), fa._allheads_fwd(
        tp_rank, tp_rank), fa._allheads_bwd(tp_rank, tp_rank)) == (
            False, True, True)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 641, 641, 3, 641),
                                   (2, 1025, 1025, 3, 1025),
                                   (2, 1157, 1157, 3, 1157),
                                   (2, 50, 1157, 3, 1157)],
                         ids=["s641", "s1025", "s1157", "cross1157"])
def test_forward_tail_past_five_tiles_on_card(shape):
    """B4f, bf16, where kv_len is a fitted 8-key tail behind five or more
    full 128-key tiles (csrc/flash_fwd_units.cuh): the 5-stage ring must
    move past the tail's slot. Within ALLHEADS_TOL, o and the lse bit-equal
    from run to run, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, sq, sk, h, kv_len = shape
    gen = torch.Generator().manual_seed(sk)
    q = torch.randn((b, sq, h, DH), generator=gen).to("cuda", torch.bfloat16)
    k, v = (torch.randn((b, sk, h, DH), generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(2))
    before = _build.launch_counts["flash_attn_allheads_fwd"]
    o, lse = fa.flash_attention_allheads_fwd(q, k, v, scale=SCALE,
                                             kv_len=kv_len)
    o2, lse2 = fa.flash_attention_allheads_fwd(q, k, v, scale=SCALE,
                                               kv_len=kv_len)
    o_ref, lse_ref = fa.flash_attention_allheads_fwd_plain(
        q, k, v, scale=SCALE, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attn_allheads_fwd"] == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert (o.float() - o_ref.float()).abs().max().item() <= 1e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 257, 257, 3, 257),
                                   (32, 257, 257, 3, 200),
                                   (2, 50, 1601, 16, 1601),
                                   (2, 1024, 1024, 2, 1024),
                                   (2, 640, 640, 2, 600)],
                         ids=["tp_rank", "masked", "cross", "s1024", "s640"])
def test_kernels_match_plain_on_card(dtype, shape):
    """B4f and B4b against their plain versions on the card, q/k/v as views
    of one fused buffer where Sq == Sk; B4b's three gradients bit-equal
    from run to run. Tolerances and their reasons: chip_smoke.py
    ALLHEADS_TOL and BWD_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fwd_tol = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-3)}[dtype]
    bwd_tol = {"float32": 1e-5, "bfloat16": 2.0 ** -7}[dtype]
    b, sq, sk, h, kv_len = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(0)
    if sq == sk:
        qkv = torch.randn((b, sq, 3 * h * DH), generator=gen).to("cuda", dt)
        q, k, v = (t.view(b, sq, h, DH) for t in qkv.chunk(3, dim=-1))
    else:
        q = torch.randn((b, sq, h, DH), generator=gen).to("cuda", dt)
        k, v = (torch.randn((b, sk, h, DH), generator=gen).to("cuda", dt)
                for _ in range(2))
    do = torch.randn((b, sq, h, DH), generator=gen).to("cuda", dt)
    before = dict(_build.launch_counts)
    o, lse = fa.flash_attention_allheads_fwd(q, k, v, scale=SCALE,
                                             kv_len=kv_len)
    got = fa.flash_attention_allheads_bwd(q, k, v, o, lse, do, scale=SCALE,
                                          kv_len=kv_len)
    again = fa.flash_attention_allheads_bwd(q, k, v, o, lse, do, scale=SCALE,
                                            kv_len=kv_len)
    o_ref, lse_ref = fa.flash_attention_allheads_fwd_plain(
        q, k, v, scale=SCALE, kv_len=kv_len)
    ref = fa.flash_attention_allheads_bwd_plain(
        q, k, v, do, lse, fa._delta(do, o, None), scale=SCALE, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attn_allheads_fwd"] == (
        before["flash_attn_allheads_fwd"] + 1)
    assert _build.launch_counts["flash_attn_allheads_bwd"] == (
        before["flash_attn_allheads_bwd"] + 2)
    assert (o.float() - o_ref.float()).abs().max().item() <= fwd_tol[0]
    assert (lse - lse_ref).abs().max().item() <= fwd_tol[1]
    for g, r, g2 in zip(got, ref, again):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= bwd_tol * max(1.0, r.float().abs().max().item())
        assert torch.equal(g, g2)
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()
