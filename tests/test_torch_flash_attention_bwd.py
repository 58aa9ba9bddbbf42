"""The port's flash-attention backward (dinov2_od_tpu_torch/ops/
flash_attention.py) against the JAX kernel's gradients, run in Pallas
interpret mode, and the autograd wiring around it. On the CPU the
backward runs its plain version; the `gpu`-marked test holds the CUDA
kernel against it on the card and skips without one."""

import numpy as np
import pytest
import torch

from dinov2_od_tpu_torch.ops import _build
from dinov2_od_tpu_torch.ops import flash_attention as fa

DH = 64
SCALE = DH ** -0.5
# (batch, seq, heads, kv_len): a ragged S (40 = 2 x 16 + 8), masked keys,
# one valid key. Heads even: the JAX flat path pairs 64-wide heads.
CASES = [(2, 40, 2, None), (1, 40, 2, 29), (2, 19, 2, 1)]
# Plain backward against the JAX kernel's gradients: max abs error of each
# of dq, dk, dv over max(1, its largest magnitude). fp32: the same math
# summed in another order (measured <= 3e-6). bf16: both round q*scale,
# dO*scale, p and ds to bf16 at the same points, so only an fp32 sum that
# lands on the other side of a bf16 rounding step can differ, by one bf16
# ulp, 2^-7 relative (measured: bit-identical but for ~1e-6 in the
# one-key case, whose dq and dk are rounding noise around 0).
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


@pytest.fixture(scope="module")
def jax_mods():
    """jax and jax.numpy, imported by the tests that compare with JAX
    only, so the card-only test below runs where JAX is not installed
    (`pytest --noconftest ... -m gpu`)."""
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _arrays(seed, b, s, h, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, DH)).astype(np.float32)
            for _ in range(n)]


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _rel_err(ref, out):
    """max |ref - out| over max(1, max |ref|)."""
    ref = np.asarray(ref, np.float32)
    err = np.abs(ref - out.detach().float().numpy()).max()
    return float(err / max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_backward_matches_jax_kernel(jax_mods, dtype, case):
    jax, jnp = jax_mods
    from dinov2_od_tpu.ops.flash_attention import flash_attention as jflash

    b, s, h, kv_len = case
    arrs = _arrays(3, b, s, h)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: jflash(q, k, v, scale=SCALE,
                                            interpret=True, flat=True,
                                            kv_len=kv_len), jq, jk, jv)
    ref = vjp(jdo)
    q, k, v, do = (_t(a, dtype) for a in arrs)
    o, lse = fa.flash_attention_fwd(q, k, v, scale=SCALE, kv_len=kv_len)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=SCALE,
                                   kv_len=kv_len)
    for name, r, g in zip("qkv", ref, grads):
        assert g.dtype == q.dtype and g.shape == q.shape
        assert _rel_err(r, g) <= TOL[dtype], (name, _rel_err(r, g))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_keys_get_exactly_zero_dk_dv(dtype):
    q, k, v, do = (_t(a, dtype) for a in _arrays(5, 2, 33, 2))
    o, lse = fa.flash_attention_fwd(q, k, v, scale=SCALE, kv_len=20)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=SCALE,
                                        kv_len=20)
    assert not dk[:, 20:].any() and not dv[:, 20:].any()
    assert dk[:, :20].abs().sum() > 0 and dv[:, :20].abs().sum() > 0
    # What lies in the masked keys does not reach dq either.
    k2, v2 = k.clone(), v.clone()
    k2[:, 20:], v2[:, 20:] = 1e3, -7.0
    o2, lse2 = fa.flash_attention_fwd(q, k2, v2, scale=SCALE, kv_len=20)
    dq2, _, _ = fa.flash_attention_bwd(q, k2, v2, o2, lse2, do, scale=SCALE,
                                       kv_len=20)
    assert torch.equal(dq, dq2)


@pytest.mark.parametrize("kv_len", [None, 23])
def test_autograd_matches_torch_autograd_of_plain_forward(kv_len):
    """The port's autograd on the CPU (the plain backward behind
    `_FlashAttention`) against torch autograd through the plain forward's
    own ops, fp32: 1e-5, another summation order of the same math."""
    arrs = _arrays(7, 2, 37, 2)
    go = torch.from_numpy(arrs[3])

    def grads(fn):
        q, k, v = (torch.from_numpy(a).requires_grad_(True)
                   for a in arrs[:3])
        out = fn(q, k, v)
        return torch.autograd.grad((out * go).sum(), (q, k, v))

    got = grads(lambda q, k, v: fa.flash_attention(q, k, v, scale=SCALE,
                                                   kv_len=kv_len))
    ref = grads(lambda q, k, v: fa.flash_attention_fwd_plain(
        q, k, v, scale=SCALE, kv_len=kv_len)[0])
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_gradient_matches_jax(jax_mods, dtype):
    """A cotangent on both outputs of flash_attention_lse: the lse's folds
    into delta. Tolerances: TOL."""
    jax, jnp = jax_mods
    from dinov2_od_tpu.ops.flash_attention import (
        flash_attention_lse as jflash_lse)

    b, s, h, kv_len = 2, 40, 2, 31
    arrs = _arrays(9, b, s, h)
    glse = np.random.default_rng(10).normal(size=(b, s, h)).astype(
        np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: jflash_lse(q, k, v, scale=SCALE,
                                                interpret=True, flat=True,
                                                kv_len=kv_len), jq, jk, jv)
    ref = vjp((jdo, jnp.asarray(glse)))
    q, k, v = (_t(a, dtype).requires_grad_(True) for a in arrs[:3])
    o, lse = fa.flash_attention_lse(q, k, v, scale=SCALE, kv_len=kv_len)
    got = torch.autograd.grad(
        (o.float() * _t(arrs[3], dtype).float()).sum()
        + (lse * torch.from_numpy(glse)).sum(), (q, k, v))
    for name, r, g in zip("qkv", ref, got):
        assert _rel_err(r, g) <= TOL[dtype], (name, _rel_err(r, g))
    # The lse cotangent moves dq and dk, not dv.
    no_lse = torch.autograd.grad((fa.flash_attention(
        q, k, v, scale=SCALE, kv_len=kv_len).float()
        * _t(arrs[3], dtype).float()).sum(), (q, k, v))
    assert torch.equal(no_lse[2], got[2])
    assert not torch.equal(no_lse[0], got[0])


def test_bwd_checks_its_inputs():
    q, k, v, do = (_t(a, "float32") for a in _arrays(2, 1, 8, 2))
    o, lse = fa.flash_attention_fwd(q, k, v, scale=SCALE)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, o, lse, do, scale=SCALE, kv_len=9)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q.half(), k.half(), v.half(), o, lse, do,
                               scale=SCALE)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [257, 200])
def test_kernel_matches_plain_on_card(dtype, kv_len):
    """The CUDA backward against its plain version at the ViT-B train
    shape (B=32, S=257, H=12, dh=64), q/k/v as views of one fused buffer.
    Tolerances (relative to max(1, the largest gradient)) and their
    reasons: chip_smoke.py BWD_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = {"float32": 1e-5, "bfloat16": 2.0 ** -7}[dtype]
    gen = torch.Generator().manual_seed(0)
    b, s, h = 32, 257, 12
    qkv = torch.randn((b, s, 3 * h * DH), generator=gen)
    qkv = qkv.to("cuda", getattr(torch, dtype))
    q, k, v = (t.view(b, s, h, DH) for t in qkv.chunk(3, dim=-1))
    do = torch.randn((b, s, h, DH), generator=gen).to("cuda", q.dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, scale=SCALE, kv_len=kv_len)
    delta = fa._delta(do, o, None)
    before = _build.launch_counts["flash_attn_bwd"]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=SCALE,
                                 kv_len=kv_len)
    ref = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta, scale=SCALE,
                                       kv_len=kv_len)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attn_bwd"] == before + 1
    for g, r in zip(got, ref):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= tol * max(1.0, r.float().abs().max().item())
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


# B3 on the card, each family at a shape a path gives it: the flat
# kernels at ring attention's local ViT-L/560 shard under a ring of 2
# (801 tokens, 16 heads; kv_len 801 and the straddling shard's 800), the
# all-heads pair at ViT-B's 3 heads a rank under TP 4, the blocked pair
# at ViT-L/560 whole (1601 tokens). (batch, S, heads, kv_len, the forward
# and backward kernels the family launches)
LSE_CASES = [
    (8, 801, 16, 801, "flash_attn_fwd", "flash_attn_bwd"),
    (8, 801, 16, 800, "flash_attn_fwd", "flash_attn_bwd"),
    (32, 257, 3, 257, "flash_attn_allheads_fwd", "flash_attn_allheads_bwd"),
    (8, 1601, 16, 1601, "flash_attn_bhsd_fwd", "flash_attn_bhsd_bwd"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", LSE_CASES,
                         ids=lambda c: f"s{c[1]}_h{c[2]}_kv{c[3]}")
def test_lse_route_with_lse_cotangent_matches_plain_on_card(case):
    """B3, `flash_attention_lse`, bf16 with a nonzero cotangent of its lse
    (as ring attention's backward gives it): o, the lse and dq, dk, dv
    against the plain versions composed on the same inputs (the plain
    forward, then the lse cotangent folded into delta and the plain
    backward). One forward and one backward launch of the family's
    kernels, two of the route. Tolerances: chip_smoke.py TOL (o, lse) and
    BWD_TOL (gradients)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, s, h, kv_len, fwd_name, bwd_name = case
    gen = torch.Generator().manual_seed(s + kv_len)
    q, k, v, do = (torch.randn((b, s, h, DH), generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(4))
    dlse = torch.randn((b, s, h), generator=gen).cuda()
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    before = (dict(_build.launch_counts), dict(_build.route_counts))
    o, lse = fa.flash_attention_lse(qq, kk, vv, scale=SCALE, kv_len=kv_len)
    got = torch.autograd.grad((o, lse), (qq, kk, vv), (do, dlse))
    torch.cuda.synchronize()
    counts, route = _build.launch_counts, _build.route_counts
    assert counts[fwd_name] == before[0][fwd_name] + 1
    assert counts[bwd_name] == before[0][bwd_name] + 1
    assert route["flash_attention_lse"] == (
        before[1]["flash_attention_lse"] + 2)
    o_ref, lse2 = fa.flash_attention_bhsd_fwd_plain(q, k, v, scale=SCALE,
                                                    kv_len=kv_len)
    glse2 = (dlse * fa._LN2).transpose(1, 2)
    ref = fa.flash_attention_bhsd_bwd_plain(
        q, k, v, do, lse2, fa._delta(do, o_ref, glse2), scale=SCALE,
        kv_len=kv_len)
    assert (o.float() - o_ref.float()).abs().max().item() <= 1e-2
    assert (lse - lse2.transpose(1, 2) * fa._LN2).abs().max().item() <= (
        3e-3 * fa._LN2)
    for g, r in zip(got, ref):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= 2.0 ** -7 * max(1.0, r.float().abs().max().item())
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()
