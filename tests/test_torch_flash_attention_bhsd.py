"""The port's blocked BHSD flash-attention pair (B5f forward, B5b
backward; the counterparts of `_fwd_kernel` and `_dkv_kernel` in
dinov2_od_tpu/ops/flash_attention.py) against the JAX kernels run in
Pallas interpret mode, and the port's copy of the JAX family choice (the
all-heads pair B4f/B4b has its own file,
tests/test_torch_flash_attention_allheads.py). On the CPU the wrappers run
the plain versions; the `gpu`-marked test holds the CUDA kernels against
them on the card and skips without one.

Each JAX case names the TPU kernel the JAX dispatch (`_flash_fwd`,
`_bhsd_bwd_impl`) reaches at its shape."""

import types

import numpy as np
import pytest
import torch

from dinov2_od_tpu_torch.ops import _build
from dinov2_od_tpu_torch.ops import flash_attention as fa

DH = 64
SCALE = DH ** -0.5
# Plain forward against the JAX kernel, max abs error. fp32: the same math
# summed in another order (rows of up to 1040 keys). bf16: both round
# q*scale and p (against the exact row max) to bf16 at the same points, so
# only an fp32 sum landing on the other side of a bf16 rounding step can
# differ: one bf16 ulp of o (|o| < 2), and lse by an fp32 rounding.
FWD_TOL = {
    "float32": {"o": 1e-5, "lse": 1e-5},
    "bfloat16": {"o": 1e-2, "lse": 1e-3},
}
# Plain backward against the JAX kernel's gradients: max abs error of each
# of dq, dk, dv over max(1, its largest magnitude). fp32: the same math in
# another summation order; bf16: p and ds rounded to bf16 at the same
# points, so an fp32 sum on the other side of a rounding step moves an
# element by one bf16 ulp, 2^-7 relative.
BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}

# Forward cases (b, sq, sk, h, kv_len, block_q) and the JAX kernel each
# reaches through `_flash_fwd`:
FWD_CASES = {
    # _head_group(2, 1040, 1040, 2) = 0: one head's logits (8.7 MB) exceed
    # the 8 MiB budget -> _fwd_kernel (B5f).
    "s1040_h2": (1, 1040, 1040, 2, None, None),
    # The same with the keys from 1000 on masked -> _fwd_kernel.
    "s1040_h2_kv1000": (1, 1040, 1040, 2, 1000, None),
    # block_q=128 at 257 tokens pads q to 384 != 272 -> _fwd_kernel.
    "s257_h1_bq128": (2, 257, 257, 1, None, 128),
    # Sq != Sk: block_q=48 pads q to 96 != 64 -> _fwd_kernel.
    "cross_50x300_bq48": (2, 50, 300, 1, None, 48),
    "cross_50x300_kv250_bq48": (1, 50, 300, 1, 250, 48),
    # ViT-B's 12 heads under 4-way tensor parallelism: 3 heads, which the
    # flat kernels cannot pair -> _fwd_kernel_allheads (B4f), whose
    # function B5f's plain version computes too (the port's wrapper routes
    # the shape to B4f, as JAX does).
    "s257_h3": (1, 257, 257, 3, None, None),
}

# Backward cases (b, sq, sk, h, kv_len, block_q); an explicit block_q
# forces `_bhsd_bwd_impl` onto _dkv_kernel (B5b), as does S=1040, where
# _head_group(2, 1040, 1056, 5) = 0.
BWD_CASES = {
    # q padded to 272 rows (the q_len mask lane), keys to 272.
    "s257_h1_bq128": (1, 257, 257, 1, None, 128),
    # Keys from 250 on masked.
    "s300_h2_kv250_bq128": (1, 300, 300, 2, 250, 128),
    # Sq != Sk.
    "cross_50x300_bq48": (2, 50, 300, 1, None, 48),
    # No block_q: the automatic blocked path, 528-key blocks.
    "s1040_h2": (1, 1040, 1040, 2, None, None),
}


@pytest.fixture(scope="module")
def jax_mods():
    """jax and jax.numpy, imported by the tests that compare with JAX
    only, so the card-only test below runs where JAX is not installed
    (`pytest --noconftest ... -m gpu`)."""
    import jax
    import jax.numpy as jnp

    return jax, jnp


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
@pytest.mark.parametrize("case", list(FWD_CASES))
def test_plain_forward_matches_jax_kernel(jax_mods, dtype, case):
    _, jnp = jax_mods
    from dinov2_od_tpu.ops.flash_attention import flash_attention as jflash

    b, sq, sk, h, kv_len, block_q = FWD_CASES[case]
    arrs = _arrays(1, b, sq, sk, h)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrs[:3])
    ref = jflash(jq, jk, jv, scale=SCALE, interpret=True, flat=False,
                 kv_len=kv_len, block_q=block_q)
    q, k, v = (_t(a, dtype) for a in arrs[:3])
    o, lse = fa.flash_attention_bhsd_fwd_plain(q, k, v, scale=SCALE,
                                               kv_len=kv_len)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    err = np.abs(np.asarray(ref, np.float32) - o.float().numpy()).max()
    assert err <= FWD_TOL[dtype]["o"], err
    # The family the port's wrapper picks computes the same o.
    o_auto = fa.flash_attention(q, k, v, scale=SCALE, kv_len=kv_len)
    assert torch.equal(o_auto, o)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["s1040_h2", "s1040_h2_kv1000"])
def test_bhsd_lse_matches_jax_kernel(jax_mods, dtype, case):
    """flash_attention_lse through the BHSD family against JAX's
    `_flash_bhsd_lse` (`flat=False`), which reaches _fwd_kernel here."""
    _, jnp = jax_mods
    from dinov2_od_tpu.ops.flash_attention import (
        flash_attention_lse as jflash_lse)

    b, sq, sk, h, kv_len, _ = FWD_CASES[case]
    arrs = _arrays(2, b, sq, sk, h)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in arrs[:3])
    o_ref, lse_ref = jflash_lse(jq, jk, jv, scale=SCALE, interpret=True,
                                flat=False, kv_len=kv_len)
    q, k, v = (_t(a, dtype) for a in arrs[:3])
    o, lse = fa.flash_attention_lse(q, k, v, scale=SCALE, kv_len=kv_len,
                                    flat=False)
    assert lse.shape == (b, sq, h)
    err_o = np.abs(np.asarray(o_ref, np.float32) - o.float().numpy()).max()
    err_lse = np.abs(np.asarray(lse_ref) - lse.numpy()).max()
    assert err_o <= FWD_TOL[dtype]["o"], err_o
    assert err_lse <= FWD_TOL[dtype]["lse"], err_lse


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_plain_backward_matches_jax_kernel(jax_mods, dtype, case):
    jax, jnp = jax_mods
    from dinov2_od_tpu.ops.flash_attention import flash_attention as jflash

    b, sq, sk, h, kv_len, block_q = BWD_CASES[case]
    arrs = _arrays(3, b, sq, sk, h)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: jflash(
        q, k, v, scale=SCALE, interpret=True, flat=False, kv_len=kv_len,
        block_q=block_q), jq, jk, jv)
    ref = vjp(jdo)
    q, k, v, do = (_t(a, dtype) for a in arrs)
    o, lse = fa.flash_attention_bhsd_fwd(q, k, v, scale=SCALE, kv_len=kv_len)
    grads = fa.flash_attention_bhsd_bwd(q, k, v, o, lse, do, scale=SCALE,
                                        kv_len=kv_len)
    for name, r, g, x in zip("qkv", ref, grads, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert _rel_err(r, g) <= BWD_TOL[dtype], (name, _rel_err(r, g))
    if kv_len is not None:  # masked keys: dk and dv exactly zero
        assert not grads[1][:, kv_len:].any()
        assert not grads[2][:, kv_len:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_cotangent_folds_into_delta_like_jax(jax_mods, dtype):
    """A cotangent on both outputs of flash_attention_lse at S=700, H=1:
    JAX's forward takes _fwd_kernel_allheads there, its backward
    _dkv_kernel (_head_group(1, 704, 704, 5) = 0), with the lse cotangent
    folded into delta (`_flash_bhsd_lse`). Tolerances: BWD_TOL."""
    jax, jnp = jax_mods
    from dinov2_od_tpu.ops.flash_attention import (
        flash_attention_lse as jflash_lse)

    b, s, h, kv_len = 1, 700, 1, 650
    arrs = _arrays(4, b, s, s, h)
    glse = np.random.default_rng(5).normal(size=(b, s, h)).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in arrs)
    _, vjp = jax.vjp(lambda q, k, v: jflash_lse(
        q, k, v, scale=SCALE, interpret=True, flat=False, kv_len=kv_len),
        jq, jk, jv)
    ref = vjp((jdo, jnp.asarray(glse)))
    q, k, v = (_t(a, dtype).requires_grad_(True) for a in arrs[:3])
    o, lse = fa.flash_attention_lse(q, k, v, scale=SCALE, kv_len=kv_len,
                                    flat=False)
    do = _t(arrs[3], dtype).float()
    got = torch.autograd.grad((o.float() * do).sum()
                              + (lse * torch.from_numpy(glse)).sum(),
                              (q, k, v))
    for name, r, g in zip("qkv", ref, got):
        assert _rel_err(r, g) <= BWD_TOL[dtype], (name, _rel_err(r, g))
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


def test_padded_query_rows_and_keys_give_exact_zeros():
    """q_len masks query rows: their dq is exactly 0 and nothing of theirs
    reaches dk or dv; keys at or past kv_len get exactly zero dk and dv,
    whatever they hold."""
    arrs = _arrays(6, 2, 90, 120, 2)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    o, lse = fa.flash_attention_bhsd_fwd(q, k, v, scale=SCALE, kv_len=100)
    delta = fa._delta(do, o, None)
    dq, dk, dv = fa.flash_attention_bhsd_bwd_plain(
        q, k, v, do, lse, delta, scale=SCALE, kv_len=100, q_len=70)
    assert not dq[:, 70:].any() and dq[:, :70].abs().sum() > 0
    assert not dk[:, 100:].any() and not dv[:, 100:].any()
    # Garbage in the masked query rows and keys changes nothing.
    q2, do2, k2 = q.clone(), do.clone(), k.clone()
    q2[:, 70:], do2[:, 70:], k2[:, 100:] = 1e3, -5.0, 7.0
    lse2 = lse.clone()
    lse2[:, :, 70:] = -1e4
    got = fa.flash_attention_bhsd_bwd_plain(
        q2, k2, v, do2, lse2, delta, scale=SCALE, kv_len=100, q_len=70)
    assert torch.equal(got[0][:, :70], dq[:, :70])
    assert torch.equal(got[1][:, :100], dk[:, :100])
    assert torch.equal(got[2], dv)


def test_backward_at_1370_tokens_is_finite_and_exact():
    """Mirror of tests/test_flash_attention.py::test_backward_block_mismatch_no_nan
    (S=1370, H=1): there the backward's q padding outgrew the saved lse.
    The port pads nothing; its BHSD backward must stay finite and match
    torch autograd through the plain forward's ops (fp32, 1e-5: the same
    math in another order)."""
    arrs = _arrays(11, 1, 1370, 1370, 1)
    go = torch.from_numpy(arrs[3])

    def grads(fn):
        q, k, v = (torch.from_numpy(a).requires_grad_(True)
                   for a in arrs[:3])
        return torch.autograd.grad((fn(q, k, v) * go).sum(), (q, k, v))

    got = grads(lambda q, k, v: fa.flash_attention(q, k, v, scale=SCALE))
    ref = grads(lambda q, k, v: fa.flash_attention_bhsd_fwd_plain(
        q, k, v, scale=SCALE)[0])
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert (g - r).abs().max().item() <= 1e-5


@pytest.mark.parametrize("s", [257, 1370, 1535, 1536, 1537, 1552, 1601])
def test_family_choice_matches_jax(jax_mods, s):
    """The port's `_flat_eligible` against JAX's at every head count from
    1 to 24, across the 1536/1537 edge, and Sq != Sk never flat."""
    from dinov2_od_tpu.ops import flash_attention as jfa

    for h in range(1, 25):
        q = types.SimpleNamespace(shape=(2, s, h, DH))
        for sk in (s, s + 1):
            k = types.SimpleNamespace(shape=(2, sk, h, DH))
            assert fa._flat_eligible(q, k) == jfa._flat_eligible(q, k), (
                s, sk, h)
    vit_l_560 = types.SimpleNamespace(shape=(8, 1601, 16, DH))
    assert not fa._flat_eligible(vit_l_560, vit_l_560)


def test_wrapper_routes_by_family():
    """flat=None picks as JAX does; flat=True takes only self-attention;
    the CPU takes the plain versions of the picked kernels and launches
    nothing; the backward takes the forward's family (flat or BHSD) and,
    inside BHSD, the all-heads (B4) or blocked (B5) kernel by its own
    rule."""
    calls = {"bhsd_fwd": 0, "bhsd_bwd": 0, "fwd": 0, "bwd": 0,
             "allheads_fwd": 0, "allheads_bwd": 0}
    wrapped = {}
    for key, name in (("bhsd_fwd", "flash_attention_bhsd_fwd_plain"),
                      ("bhsd_bwd", "flash_attention_bhsd_bwd_plain"),
                      ("fwd", "flash_attention_fwd_plain"),
                      ("bwd", "flash_attention_bwd_plain"),
                      ("allheads_fwd", "flash_attention_allheads_fwd_plain"),
                      ("allheads_bwd", "flash_attention_allheads_bwd_plain")):
        fn = getattr(fa, name)
        wrapped[name] = fn

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        setattr(fa, name, counted)
    try:
        _build.reset_launch_counts()
        # (Sq, Sk, H, forward, backward): paired heads; 3 heads and Sq != Sk
        # inside the budget (B4 both ways); S 700 (B4f, then B5b, as JAX's
        # `_head_group(1, 704, 704, 5) = 0`); S 1040 (B5 both ways).
        for sq, sk, h, want, bwd in (
                (40, 40, 2, "fwd", "bwd"),
                (40, 40, 3, "allheads_fwd", "allheads_bwd"),
                (20, 40, 2, "allheads_fwd", "allheads_bwd"),
                (700, 700, 1, "allheads_fwd", "bhsd_bwd"),
                (1040, 1040, 1, "bhsd_fwd", "bhsd_bwd")):
            arrs = _arrays(7, 1, sq, sk, h)
            q, k, v = (torch.from_numpy(a).requires_grad_(True)
                       for a in arrs[:3])
            before = dict(calls)
            fa.flash_attention(q, k, v, scale=SCALE).sum().backward()
            assert calls[want] == before[want] + 1
            assert calls[bwd] == before[bwd] + 1
            assert sum(calls.values()) == sum(before.values()) + 2
        assert _build.launch_counts == {n: 0 for n in _build.SOURCES}
    finally:
        for name, fn in wrapped.items():
            setattr(fa, name, fn)
    q, k, v = (torch.from_numpy(a) for a in _arrays(8, 1, 20, 30, 2)[:3])
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, scale=SCALE, flat=True)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v[:, :29], scale=SCALE)
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd_fwd(q, k, v, scale=SCALE, kv_len=31)
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd_bwd_plain(
            q, k, v, q, torch.zeros(1, 2, 20), torch.zeros(1, 2, 20),
            scale=SCALE, q_len=21)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 1601, 1601, 16, 1601),
                                   (2, 1601, 1601, 16, 1500),
                                   (2, 50, 1601, 16, 1601),
                                   (4, 257, 257, 3, 257)],
                         ids=["vit_l_560", "masked", "cross", "h3"])
def test_kernels_match_plain_on_card(dtype, shape):
    """B5f and B5b against their plain versions on the card, q/k/v as views
    of one fused buffer where Sq == Sk. Tolerances and their reasons:
    chip_smoke.py BHSD_TOL and BHSD_BWD_TOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fwd_tol = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 3e-3)}[dtype]
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
    o, lse = fa.flash_attention_bhsd_fwd(q, k, v, scale=SCALE, kv_len=kv_len)
    got = fa.flash_attention_bhsd_bwd(q, k, v, o, lse, do, scale=SCALE,
                                      kv_len=kv_len)
    o_ref, lse_ref = fa.flash_attention_bhsd_fwd_plain(q, k, v, scale=SCALE,
                                                       kv_len=kv_len)
    ref = fa.flash_attention_bhsd_bwd_plain(
        q, k, v, do, lse, fa._delta(do, o, None), scale=SCALE, kv_len=kv_len)
    torch.cuda.synchronize()
    for name in ("flash_attn_bhsd_fwd", "flash_attn_bhsd_bwd"):
        assert _build.launch_counts[name] == before[name] + 1
    assert (o.float() - o_ref.float()).abs().max().item() <= fwd_tol[0]
    assert (lse - lse_ref).abs().max().item() <= fwd_tol[1]
    for g, r in zip(got, ref):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= bwd_tol * max(1.0, r.float().abs().max().item())
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()
