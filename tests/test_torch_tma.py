"""The TMA arguments of the port's Hopper kernels, and the operands they
are handed, on the CPU; the kernels themselves on the card.

B6 (csrc/int8_gemm.cu), the bf16 kernels of B5b, B5f, B4b, B2, B4f and B1
(csrc/flash_attn_bhsd_bwd.cu, csrc/flash_attn_bhsd_fwd.cu,
csrc/flash_attn_allheads_bwd.cu, csrc/flash_attn_bwd.cu,
csrc/flash_attn_allheads_fwd.cu, csrc/flash_attn_fwd.cu) and T1
(csrc/attn_roofline.cu) load their tiles by TMA from tensor maps
that their C entry points encode from specs computed in Python
(ops/_tma.py). These tests hold the specs to the tensors they describe
(dims innermost first, byte strides, boxes), including the fused qkv
slices the attention kernels read in place and one slice of a stacked
int8 tree that B6 reads without a copy, and check that a layout TMA
cannot address raises. The `gpu`-marked tests hold the kernels against
their plain versions on the card at the main paths' shapes (chip_smoke.py
INT8_CASES, BHSD_CASES, ALLHEADS_CASES, BWD_CASES and FWD_CASES) and skip
without one."""

import numpy as np
import pytest
import torch

from dinov2_od_tpu_torch.models import quantize as pq
from dinov2_od_tpu_torch.ops import _build, _tma
from dinov2_od_tpu_torch.ops import flash_attention as fa
from dinov2_od_tpu_torch.ops import int8_gemm as pg
from dinov2_od_tpu_torch.params import params_from_numpy

DH = 64


def _unpack(spec):
    """(rank, dims, byte strides, box) of a spec."""
    assert len(spec) == _tma.SPEC_LEN
    rank = spec[0]
    return rank, spec[1:1 + rank], spec[6:5 + rank], spec[10:10 + rank]


def _stacked_int8(depth=3, k=2048, n=384, seed=0):
    rng = np.random.default_rng(seed)
    return pq.quantize_linear({
        "kernel": torch.from_numpy(
            rng.normal(size=(depth, k, n)).astype(np.float32)),
        "bias": torch.zeros(depth, n)})


# ---- ops/_tma.py -----------------------------------------------------------


@pytest.mark.parametrize("dtype,item", [(torch.bfloat16, 2),
                                        (torch.float32, 4),
                                        (torch.int8, 1)])
def test_spec_of_a_contiguous_matrix(dtype, item):
    t = torch.zeros((300, 256), dtype=dtype)
    rank, dims, strides, box = _unpack(
        _tma.tensor_map_spec(t, (1, 0), (128 // item, 64)))
    assert (rank, dims, strides, box) == (2, [256, 300], [256 * item],
                                          [128 // item, 64])


def test_spec_rejects_what_tma_cannot_address():
    base = torch.zeros(4096, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        _tma.tensor_map_spec(base.view(64, 64).t(), (1, 0), (64, 64))
    with pytest.raises(ValueError, match="aligned data pointer"):
        _tma.tensor_map_spec(base[1:1025].view(16, 64), (1, 0), (64, 16))
    # A row stride of 196 bf16 (392 bytes) is no multiple of 16 bytes.
    odd = base.as_strided((2, 10, 3, DH), (1960, 196, DH, 1))
    with pytest.raises(ValueError, match="multiples of 16"):
        _tma.tensor_map_spec(odd, (3, 2, 1, 0), (DH, 1, 8, 1))
    with pytest.raises(ValueError, match="box"):
        _tma.tensor_map_spec(base.view(64, 64), (1, 0), (64, 512))
    with pytest.raises(ValueError, match="box"):  # 4 bytes innermost
        _tma.tensor_map_spec(base.view(64, 64), (1, 0), (2, 64))
    with pytest.raises(ValueError, match="order"):
        _tma.tensor_map_spec(base.view(64, 64), (0, 0), (64, 64))


def test_as_c_array_concatenates_specs():
    t = torch.zeros((64, 64), dtype=torch.bfloat16)
    spec = _tma.tensor_map_spec(t, (1, 0), (64, 64))
    arr = _tma.as_c_array(spec, spec)
    assert list(arr) == spec + spec


# ---- B5b's tensor maps -----------------------------------------------------


@pytest.mark.parametrize("b,s,h", [(8, 1601, 16), (32, 257, 3)])
def test_bhsd_bwd_specs_describe_the_fused_qkv_slices(b, s, h):
    """q, k and v as the three views of one fused qkv GEMM output: each
    map starts at its slice and steps by the fused row; dO and the fp32
    dq scratch are contiguous. Boxes: one head, 64 q rows or 128 keys;
    for the fp32 dq scratch 16 rows of 32 head dims (128 bytes)."""
    qkv = torch.zeros((b, s, 3 * h * DH), dtype=torch.bfloat16)
    q, k, v = (t.view(b, s, h, DH) for t in qkv.chunk(3, dim=-1))
    do = torch.zeros((b, s, h, DH), dtype=torch.bfloat16)
    dq = torch.zeros((b, s, h, DH), dtype=torch.float32)
    specs = fa.bhsd_bwd_tma_specs(q, k, v, do, dq)
    assert len(specs) == 5
    row = 3 * h * DH * 2
    for spec, rows in zip(specs[:3], (64, 128, 128)):
        assert _unpack(spec) == (4, [DH, h, s, b], [DH * 2, row, s * row],
                                 [DH, 1, rows, 1])
    assert _unpack(specs[3]) == (4, [DH, h, s, b],
                                 [DH * 2, h * DH * 2, s * h * DH * 2],
                                 [DH, 1, 64, 1])
    assert _unpack(specs[4]) == (4, [DH, h, s, b],
                                 [DH * 4, h * DH * 4, s * h * DH * 4],
                                 [DH // 2, 1, 16, 1])
    # The slices' own data pointers are what the maps start from: k's is
    # h * 64 bf16 past q's, 16-byte aligned.
    assert k.data_ptr() - q.data_ptr() == h * DH * 2


def test_bhsd_bwd_specs_raise_on_a_misaligned_stride():
    base = torch.zeros(4 * 20 * 3 * 68, dtype=torch.bfloat16)
    # Heads 68 bf16 apart (136 bytes: not a multiple of 16).
    q = base.as_strided((4, 20, 3, DH), (20 * 3 * 68, 3 * 68, 68, 1))
    ok = torch.zeros((4, 20, 3, DH), dtype=torch.bfloat16)
    dq = torch.zeros((4, 20, 3, DH))
    with pytest.raises(ValueError, match="dim 2"):
        fa.bhsd_bwd_tma_specs(q, ok, ok, ok, dq)
    fa.bhsd_bwd_tma_specs(ok, ok, ok, ok, dq)


# ---- B5f's and B4b's tensor maps -------------------------------------------

# (batch, Sq, Sk, heads): ViT-L/560's self-attention, ViT-B's 3 heads a rank
# under 4-way tensor parallelism, and the cross shape (50 queries over 1601
# keys).
SPEC_SHAPES = [(8, 1601, 1601, 16), (32, 257, 257, 3), (8, 50, 1601, 16)]


def _operands(b, sq, sk, h):
    """q, k, v as the three views of one fused qkv GEMM output where
    Sq == Sk (else contiguous), and a contiguous dO."""
    if sq == sk:
        qkv = torch.zeros((b, sq, 3 * h * DH), dtype=torch.bfloat16)
        q, k, v = (t.view(b, sq, h, DH) for t in qkv.chunk(3, dim=-1))
    else:
        q = torch.zeros((b, sq, h, DH), dtype=torch.bfloat16)
        k, v = (torch.zeros((b, sk, h, DH), dtype=torch.bfloat16)
                for _ in range(2))
    return q, k, v, torch.zeros((b, sq, h, DH), dtype=torch.bfloat16)


def _head_map(t, rows):
    """What a spec over [B, S, H, 64] `t` must hold: dims innermost first,
    byte strides of head, row and batch, a box of `rows` rows of one
    head."""
    b, s, h, _ = t.shape
    return (4, [DH, h, s, b], [t.stride(2) * 2, t.stride(1) * 2,
                               t.stride(0) * 2], [DH, 1, rows, 1])


@pytest.mark.parametrize("b,sq,sk,h", SPEC_SHAPES,
                         ids=["vit_l_560", "tp_h3", "cross"])
@pytest.mark.parametrize("kernel", ["b5f", "b4b"])
def test_fwd_and_allheads_bwd_specs_describe_the_operands(kernel, b, sq, sk,
                                                          h):
    """B5f's maps (q, k, v in 128-row boxes: a query tile, a key tile) and
    B4b's (q, k, v, dO in 64-row boxes: a unit's rows, a streamed tile)
    start at each operand's own pointer and step by its real strides, so
    the fused qkv slices are read in place (each row is the fused row,
    3 * h * 64 bf16 long)."""
    q, k, v, do = _operands(b, sq, sk, h)
    if kernel == "b5f":
        specs, tensors, rows = fa.bhsd_fwd_tma_specs(q, k, v), (q, k, v), 128
    else:
        specs = fa.allheads_bwd_tma_specs(q, k, v, do)
        tensors, rows = (q, k, v, do), 64
    assert len(specs) == len(tensors)
    for spec, t in zip(specs, tensors):
        assert _unpack(spec) == _head_map(t, rows)
    if sq == sk:
        assert _unpack(specs[0])[2][1] == 3 * h * DH * 2
        assert k.data_ptr() - q.data_ptr() == h * DH * 2


@pytest.mark.parametrize("kernel", ["b5f", "b4b"])
def test_fwd_and_allheads_bwd_specs_raise_on_a_misaligned_stride(kernel):
    base = torch.zeros(4 * 20 * 3 * 68, dtype=torch.bfloat16)
    # Heads 68 bf16 apart (136 bytes: not a multiple of 16).
    bad = base.as_strided((4, 20, 3, DH), (20 * 3 * 68, 3 * 68, 68, 1))
    ok = torch.zeros((4, 20, 3, DH), dtype=torch.bfloat16)
    fn = {"b5f": lambda *t: fa.bhsd_fwd_tma_specs(*t[:3]),
          "b4b": fa.allheads_bwd_tma_specs}[kernel]
    fn(ok, ok, ok, ok)
    for i in range(3 if kernel == "b5f" else 4):
        args = [ok, ok, ok, ok]
        args[i] = bad
        with pytest.raises(ValueError, match="dim 2"):
            fn(*args)


# ---- B2's and B4f's tensor maps --------------------------------------------

# (batch, S, heads) of B2: ViT-B/14 at 224 px (the train step's shape) and
# ViT-L/14 at 518 px, the longest self-attention the flat rule sends to B2.
B2_SPEC_SHAPES = [(32, 257, 12), (8, 1370, 16)]


@pytest.mark.parametrize("b,s,h", B2_SPEC_SHAPES, ids=["vit_b_224",
                                                       "vit_l_518"])
def test_flat_bwd_specs_describe_the_fused_qkv_slices(b, s, h):
    """B2's maps (q, k, v, dO in 64-row boxes of one head: a unit's own
    tile or a streamed one) start at each operand's own pointer and step
    by its real strides: q, k and v are read in place from the fused qkv
    output (each row 3 * h * 64 bf16 long), dO is contiguous."""
    q, k, v, do = _operands(b, s, s, h)
    specs = fa.flat_bwd_tma_specs(q, k, v, do)
    assert [_unpack(spec) for spec in specs] == [
        _head_map(t, 64) for t in (q, k, v, do)]
    assert _unpack(specs[0])[2][1] == 3 * h * DH * 2
    assert _unpack(specs[3])[2][1] == h * DH * 2
    assert v.data_ptr() - q.data_ptr() == 2 * h * DH * 2


# A rank's q, k, v under 4-way tensor parallelism (3 heads at 257 tokens,
# views of its fused qkv output) and the cross shape (50 queries over
# ViT-L/560's 1601 keys).
@pytest.mark.parametrize("b,sq,sk,h", [(32, 257, 257, 3), (8, 50, 1601, 16)],
                         ids=["tp_h3", "cross"])
def test_allheads_fwd_specs_describe_the_operands(b, sq, sk, h):
    """B4f's maps: q in boxes of 64 rows of one head (a unit's query rows),
    k and v in boxes of 128 rows (a key tile), each over its own pointer
    and real strides."""
    q, k, v, _ = _operands(b, sq, sk, h)
    specs = fa.allheads_fwd_tma_specs(q, k, v)
    assert [_unpack(spec) for spec in specs] == [
        _head_map(q, 64), _head_map(k, 128), _head_map(v, 128)]
    # Rows past the tensor's end read as zeros: the row dims are Sq and Sk.
    assert _unpack(specs[0])[1][2] == sq and _unpack(specs[1])[1][2] == sk


@pytest.mark.parametrize("b,s,h", B2_SPEC_SHAPES, ids=["vit_b_224",
                                                       "vit_l_518"])
def test_flat_fwd_specs_describe_the_fused_qkv_slices(b, s, h):
    """B1's maps (B4f's body: q in 64-row boxes of one head, a unit's rows;
    k and v in 128-row boxes, a key tile) start at each slice of the fused
    qkv output and step by the fused row; the row dims are S, so a key or
    row past it reads as zero."""
    q, k, v, _ = _operands(b, s, s, h)
    specs = fa.flat_fwd_tma_specs(q, k, v)
    assert [_unpack(spec) for spec in specs] == [
        _head_map(q, 64), _head_map(k, 128), _head_map(v, 128)]
    assert _unpack(specs[0])[2][1] == 3 * h * DH * 2
    assert all(_unpack(spec)[1][2] == s for spec in specs)
    assert specs == fa.allheads_fwd_tma_specs(q, k, v)


@pytest.mark.parametrize("kernel", ["b2", "b4f", "b1"])
def test_flat_bwd_and_allheads_fwd_specs_raise_on_a_misaligned_stride(
        kernel):
    base = torch.zeros(4 * 20 * 3 * 68, dtype=torch.bfloat16)
    # Heads 68 bf16 apart (136 bytes: not a multiple of 16).
    bad = base.as_strided((4, 20, 3, DH), (20 * 3 * 68, 3 * 68, 68, 1))
    ok = torch.zeros((4, 20, 3, DH), dtype=torch.bfloat16)
    fn = {"b2": fa.flat_bwd_tma_specs,
          "b4f": lambda *t: fa.allheads_fwd_tma_specs(*t[:3]),
          "b1": lambda *t: fa.flat_fwd_tma_specs(*t[:3])}[kernel]
    fn(ok, ok, ok, ok)
    for i in range(4 if kernel == "b2" else 3):
        args = [ok, ok, ok, ok]
        args[i] = bad
        with pytest.raises(ValueError, match="dim 2"):
            fn(*args)


# ---- T1's tensor maps ------------------------------------------------------


def _bhsd_map(t, rows):
    """What a spec over [B, H, S, 64] `t` must hold: dims innermost first,
    byte strides of row, head and batch, a box of `rows` rows of one
    head."""
    b, h, s, _ = t.shape
    return (4, [DH, s, h, b], [t.stride(2) * 2, t.stride(1) * 2,
                               t.stride(0) * 2], [DH, rows, 1, 1])


@pytest.mark.parametrize("layout", ["contiguous", "bshd_view"])
def test_roofline_specs_describe_the_operands(layout):
    """T1's maps: q in boxes of 32 rows of one head (a unit's rows), k and v
    in boxes of 64 rows (a key tile), over the tool's contiguous
    [8, 16, 1376, 64] and over [B, H, S, 64] views of [B, S, H, 64]
    tensors, through their real strides."""
    from dinov2_od_tpu_torch.ops import attn_roofline as t1

    if layout == "contiguous":
        q, k, v = (torch.zeros((8, 16, 1376, DH), dtype=torch.bfloat16)
                   for _ in range(3))
    else:
        q, k, v = (torch.zeros((2, 1616, 16, DH), dtype=torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
    specs = t1.attn_roofline_tma_specs(q, k, v)
    assert [_unpack(spec) for spec in specs] == [
        _bhsd_map(q, 32), _bhsd_map(k, 64), _bhsd_map(v, 64)]


def test_roofline_specs_raise_on_what_tma_cannot_address():
    from dinov2_od_tpu_torch.ops import attn_roofline as t1

    ok = torch.zeros((1, 2, 40, DH), dtype=torch.bfloat16)
    # Rows 68 bf16 apart (136 bytes: not a multiple of 16).
    bad = torch.zeros(2 * 40 * 68, dtype=torch.bfloat16).as_strided(
        (1, 2, 40, DH), (2 * 40 * 68, 40 * 68, 68, 1))
    t1.attn_roofline_tma_specs(ok, ok, ok)
    for i in range(3):
        args = [ok, ok, ok]
        args[i] = bad
        with pytest.raises(ValueError, match="multiples of 16"):
            t1.attn_roofline_tma_specs(*args)
    with pytest.raises(ValueError, match="contiguous"):
        t1.attn_roofline_tma_specs(ok.transpose(2, 3), ok, ok)


# ---- B6's operands ---------------------------------------------------------


def test_b6_takes_a_k_major_slice_of_a_stacked_tree_in_place():
    """quantize_linear stores the stacked [depth, K, N] kernel K-major; one
    layer's slice is described where it lies (no copy: the map's base is
    the slice's own pointer, its N stride K bytes)."""
    kq = _stacked_int8()["kernel_q"]
    sl = kq[1]
    assert sl.stride() == (1, 2048)
    assert sl.data_ptr() == kq.data_ptr() + 2048 * 384
    assert _unpack(pg.weight_spec(sl)) == (2, [2048, 384], [2048],
                                           [128, 128])
    codes = torch.zeros((8224, 3072), dtype=torch.int8)
    assert _unpack(pg.codes_spec(codes)) == (2, [3072, 8224], [3072],
                                             [128, 128])


def test_b6_raises_on_a_kernel_it_does_not_take():
    kq = _stacked_int8()["kernel_q"][0]
    with pytest.raises(ValueError, match="K-major"):
        pg.weight_spec(kq.contiguous())  # N-contiguous, the JAX layout
    off = torch.as_strided(kq, kq.shape, kq.stride(),
                           kq.storage_offset() + 1)
    with pytest.raises(ValueError, match="aligned data pointer"):
        pg.weight_spec(off)  # K-major, but one byte off alignment
    with pytest.raises(ValueError, match="int8"):
        pg.weight_spec(kq.float())
    # The launch path checks the layout before it builds anything.
    x = torch.zeros((4, 2048))
    ws, b = torch.ones(384), torch.zeros(384)
    with pytest.raises(ValueError, match="K-major"):
        pg._launch(x, kq.contiguous(), ws, b)


def test_bridged_int8_kernels_are_k_major():
    """A JAX int8 tree crossing params_from_numpy gets its kernel_q laid
    out K-major, the values and shapes unchanged, so B6 reads it in
    place."""
    rng = np.random.default_rng(1)
    kq = rng.integers(-127, 128, size=(2, 2048, 256), dtype=np.int8)
    tree = {"blocks": {"fc2": {"kernel_q": kq,
                               "w_scale": np.ones((2, 256), np.float32),
                               "bias": np.zeros((2, 256), np.float32)}}}
    got = params_from_numpy(tree, device="cpu")["blocks"]["fc2"]
    assert got["kernel_q"].stride() == (256 * 2048, 1, 2048)
    np.testing.assert_array_equal(got["kernel_q"].numpy(), kq)
    assert got["w_scale"].is_contiguous()
    pg.weight_spec(got["kernel_q"][1])


# ---- the kernels on the card -----------------------------------------------

INT8_CASES = [(8224, 3072, 768, "bfloat16"), (8224, 3072, 768, "float32"),
              (10960, 4096, 1024, "bfloat16"), (8219, 3072, 768, "bfloat16")]


@pytest.mark.gpu
@pytest.mark.parametrize("case", INT8_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_b6_on_card_at_a_stacked_slice(case):
    """B6 on one layer's slice of a stacked K-major tree (read in place)
    against its plain version: within one rounding of the output dtype
    (chip_smoke.py INT8_CASES), exactly one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m, k, n, name = case
    gen = torch.Generator().manual_seed(0)
    qp = pq.quantize_linear({
        "kernel": torch.randn((2, k, n), generator=gen) / k ** 0.5,
        "bias": torch.randn((2, n), generator=gen) * 0.02})
    qp = {key: v.cuda()[1] for key, v in qp.items()}
    assert qp["kernel_q"].stride() == (1, k)
    x = torch.randn((m, k), generator=gen).to("cuda", getattr(torch, name))
    before = _build.launch_counts["int8_gemm"]
    out = pg.fused_int8_linear(x, qp)
    ref = pg.fused_int8_linear_plain(x, qp)
    torch.cuda.synchronize()
    assert _build.launch_counts["int8_gemm"] == before + 1
    limit = torch.finfo(out.dtype).eps * ref.float().abs().clamp_min(1.0)
    assert bool(((out.float() - ref.float()).abs() <= limit).all())


BHSD_CASES = [(8, 1601, 1601, 16, 1601), (8, 1601, 1601, 16, 1500),
              (8, 50, 1601, 16, 1601), (32, 257, 257, 3, 257),
              (4, 1024, 1024, 4, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BHSD_CASES,
                         ids=["vit_l_560", "masked", "cross", "h3", "s1024"])
def test_b5b_on_card_at_the_main_shapes(case):
    """B5b's bf16 kernel against its plain version at chip_smoke.py's
    BHSD_CASES and at S 1024, where the all-heads routing sends the
    backward to B5b: within BWD_TOL (two bf16 ulps of the largest
    gradient), masked keys' dk and dv exactly 0, one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, sq, sk, h, kv_len = case
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(1)
    if sq == sk:
        qkv = torch.randn((b, sq, 3 * h * DH), generator=gen).to("cuda", dt)
        q, k, v = (t.view(b, sq, h, DH) for t in qkv.chunk(3, dim=-1))
    else:
        q = torch.randn((b, sq, h, DH), generator=gen).to("cuda", dt)
        k, v = (torch.randn((b, sk, h, DH), generator=gen).to("cuda", dt)
                for _ in range(2))
    do = torch.randn((b, sq, h, DH), generator=gen).to("cuda", dt)
    scale = DH ** -0.5
    o, lse = fa.flash_attention_bhsd_fwd_plain(q, k, v, scale=scale,
                                               kv_len=kv_len)
    if sq == 1024:  # the routing edge: the backward goes to B5b
        assert not fa._allheads_bwd(q, k)
    before = _build.launch_counts["flash_attn_bhsd_bwd"]
    got = fa.flash_attention_bhsd_bwd(q, k, v, o, lse, do, scale=scale,
                                      kv_len=kv_len)
    ref = fa.flash_attention_bhsd_bwd_plain(
        q, k, v, do, lse, fa._delta(do, o, None), scale=scale, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attn_bhsd_bwd"] == before + 1
    for g, r in zip(got, ref):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= 2.0 ** -7 * max(1.0, r.float().abs().max().item())
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


def _case_inputs(case, seed):
    """q, k, v (fused qkv views where Sq == Sk) and dO on the card."""
    b, sq, sk, h, _ = case
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(seed)
    if sq == sk:
        qkv = torch.randn((b, sq, 3 * h * DH), generator=gen).to("cuda", dt)
        q, k, v = (t.view(b, sq, h, DH) for t in qkv.chunk(3, dim=-1))
    else:
        q = torch.randn((b, sq, h, DH), generator=gen).to("cuda", dt)
        k, v = (torch.randn((b, sk, h, DH), generator=gen).to("cuda", dt)
                for _ in range(2))
    do = torch.randn((b, sq, h, DH), generator=gen).to("cuda", dt)
    return q, k, v, do


@pytest.mark.gpu
@pytest.mark.parametrize("case", BHSD_CASES[:4],
                         ids=["vit_l_560", "masked", "cross", "h3"])
def test_b5f_on_card_at_the_main_shapes(case):
    """B5f's bf16 kernel against its plain version at chip_smoke.py's
    BHSD_CASES: within TOL (o one bf16 ulp, 1e-2; the lse 3e-3, since the
    kernel rounds p against its running max over 128-key tiles), one
    launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kv_len = case[4]
    q, k, v, _ = _case_inputs(case, 2)
    scale = DH ** -0.5
    before = _build.launch_counts["flash_attn_bhsd_fwd"]
    o, lse = fa.flash_attention_bhsd_fwd(q, k, v, scale=scale, kv_len=kv_len)
    o_ref, lse_ref = fa.flash_attention_bhsd_fwd_plain(q, k, v, scale=scale,
                                                       kv_len=kv_len)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attn_bhsd_fwd"] == before + 1
    assert (o.float() - o_ref.float()).abs().max().item() <= 1e-2
    assert (lse - lse_ref).abs().max().item() <= 3e-3


ALLHEADS_CASES = [(32, 257, 257, 3, 257), (32, 257, 257, 3, 200),
                  (8, 50, 1601, 16, 1601), (4, 640, 640, 4, 600)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ALLHEADS_CASES,
                         ids=["tp_h3", "masked", "cross", "s640"])
def test_b4b_on_card_at_the_main_shapes(case):
    """B4b's bf16 kernel against its plain version at chip_smoke.py's
    ALLHEADS_CASES that the routing sends to it: within BWD_TOL (two bf16
    ulps of the largest gradient), masked keys' dk and dv exactly 0, dq,
    dk and dv bit-equal from run to run, one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kv_len = case[4]
    q, k, v, do = _case_inputs(case, 3)
    assert fa._allheads_bwd(q, k)
    scale = DH ** -0.5
    o, lse = fa.flash_attention_allheads_fwd_plain(q, k, v, scale=scale,
                                                   kv_len=kv_len)
    before = _build.launch_counts["flash_attn_allheads_bwd"]
    got = fa.flash_attention_allheads_bwd(q, k, v, o, lse, do, scale=scale,
                                          kv_len=kv_len)
    again = fa.flash_attention_allheads_bwd(q, k, v, o, lse, do,
                                            scale=scale, kv_len=kv_len)
    ref = fa.flash_attention_allheads_bwd_plain(
        q, k, v, do, lse, fa._delta(do, o, None), scale=scale, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attn_allheads_bwd"] == before + 2
    for g, r, g2 in zip(got, ref, again):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= 2.0 ** -7 * max(1.0, r.float().abs().max().item())
        assert torch.equal(g, g2)
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


# B2's cases (batch, Sq, Sk, heads, kv_len): chip_smoke.py BWD_CASES, and
# 17 tokens (one unit of each role, one tile).
B2_CASES = [(32, 257, 257, 12, 257), (32, 257, 257, 12, 200),
            (8, 1370, 1370, 16, 1370), (2, 17, 17, 2, 17)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", B2_CASES,
                         ids=["vit_b_224", "masked", "vit_l_518", "short"])
def test_b2_on_card_at_the_main_shapes(case):
    """B2's bf16 kernel on the fused qkv views against its plain version at
    chip_smoke.py's BWD_CASES: within BWD_TOL (two bf16 ulps of the largest
    gradient), masked keys' dk and dv exactly 0, dq, dk and dv bit-equal
    from run to run, one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kv_len = case[4]
    q, k, v, do = _case_inputs(case, 4)
    assert fa._flat_eligible(q, k)
    scale = DH ** -0.5
    o, lse = fa.flash_attention_fwd_plain(q, k, v, scale=scale,
                                          kv_len=kv_len)
    before = _build.launch_counts["flash_attn_bwd"]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                 kv_len=kv_len)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, scale=scale,
                                   kv_len=kv_len)
    ref = fa.flash_attention_bwd_plain(
        q, k, v, do, lse, fa._delta(do, o, None), scale=scale, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attn_bwd"] == before + 2
    for g, r, g2 in zip(got, ref, again):
        err = (g.float() - r.float()).abs().max().item()
        assert err <= 2.0 ** -7 * max(1.0, r.float().abs().max().item())
        assert torch.equal(g, g2)
    assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ALLHEADS_CASES + [(4, 1024, 1024, 4, 1024),
                                                   (2, 1, 100, 4, 77)],
                         ids=["tp_h3", "masked", "cross", "s640", "s1024",
                              "one_row"])
def test_b4f_on_card_at_the_main_shapes(case):
    """B4f's bf16 kernel against its plain version at every chip_smoke.py
    ALLHEADS_CASES case (S 1024: the longest self-attention the forward
    rule sends to it): within ALLHEADS_TOL (o 1e-2, one bf16 ulp; the lse
    1e-3, since both take p against the exact row max), one launch
    counted; and one query row over 77 live keys of 100 (a single K tile
    in both passes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kv_len = case[4]
    q, k, v, _ = _case_inputs(case, 5)
    assert fa._allheads_fwd(q, k)
    scale = DH ** -0.5
    before = _build.launch_counts["flash_attn_allheads_fwd"]
    o, lse = fa.flash_attention_allheads_fwd(q, k, v, scale=scale,
                                             kv_len=kv_len)
    o_ref, lse_ref = fa.flash_attention_allheads_fwd_plain(
        q, k, v, scale=scale, kv_len=kv_len)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attn_allheads_fwd"] == before + 1
    assert (o.float() - o_ref.float()).abs().max().item() <= 1e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


# B1's cases (batch, S, heads, kv_len): chip_smoke.py FWD_CASES' main
# shapes (the serving shape with all keys and with 200, ViT-L/518).
B1_CASES = [(32, 257, 12, 257), (32, 257, 12, 200), (8, 1370, 16, 1370)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", B1_CASES,
                         ids=["vit_b_224", "masked", "vit_l_518"])
def test_b1_on_card_at_the_main_shapes(case):
    """B1's bf16 kernel on the fused qkv views against its plain version:
    within ALLHEADS_TOL (B4f's body, p against the exact row max), o and
    the lse bit-equal from run to run, one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, s, h, kv_len = case
    q, k, v, _ = _case_inputs((b, s, s, h, kv_len), 6)
    scale = DH ** -0.5
    before = _build.launch_counts["flash_attn_fwd"]
    o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, kv_len=kv_len)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, scale=scale, kv_len=kv_len)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, scale=scale,
                                                  kv_len=kv_len)
    torch.cuda.synchronize()
    assert _build.launch_counts["flash_attn_fwd"] == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert (o.float() - o_ref.float()).abs().max().item() <= 1e-2
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_t1_on_card_reads_strided_views():
    """T1 over [B, H, S, 64] views of [B, S, H, 64] tensors (TMA through the
    real strides) gives what it gives on contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dinov2_od_tpu_torch.ops import attn_roofline as t1

    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((2, 300, 4, DH), generator=gen).to(
        "cuda", torch.bfloat16).transpose(1, 2) for _ in range(3))
    for stage in t1.STAGES:
        out = t1.attn_roofline(q, k, v, scale=0.125, stage=stage)
        ref = t1.attn_roofline(q.contiguous(), k.contiguous(),
                               v.contiguous(), scale=0.125, stage=stage)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)


def test_ptxas_summary_reads_registers_and_spills():
    """The build's `-Xptxas -v` report, as chip_smoke.py reads it to fail
    a spilling TMA + wgmma kernel."""
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116int8_"
        "gemm_kernelIfEEvv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_116int8_"
        "gemm_kernelIfEEvv\n"
        "    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 16 barriers\n"
        "ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers\n")
    got = _build.ptxas_summary(log)
    assert got == {
        "_ZN12_GLOBAL__N_116int8_gemm_kernelIfEEvv": {
            "registers": 168, "stack": 8, "spill_stores": 12,
            "spill_loads": 4},
        "_Z1kv": {"registers": 32, "stack": 0, "spill_stores": 0,
                  "spill_loads": 0}}
