"""The auction's solve against its contract: each image alone, charged in
chunks of `rounds_per_step` rounds until it converges or spends its
budget, ends exactly where the batched rounds leave it.

The kernel (csrc/auction.cu) runs each image alone in its own block; the
batched tensor-op rounds (`_solve_eager`, what `auction_assign` runs on
the CPU) run every image until the last converges, the converged ones
placing no bids. The two must agree bit for bit: prices, owners, and the
rounds (`rounds_per_step` x the most chunks any image ran, summed over
the phases). On the CPU a plain per-image solve written here stands for
the kernel; on the card (`gpu` marker) the kernel itself is held to the
eager rounds on the same CUDA tensors:

    python -m pytest --noconftest tests/test_torch_auction_kernel.py -m gpu

No JAX here: the card has none.
"""

import pytest
import torch

from dinov2_od_tpu_torch.ops import _build, auction, matching
from dinov2_od_tpu_torch.ops.auction import auction_assign
from dinov2_od_tpu_torch.tools.bench_auction import (ROUND_CAP,
                                                     ROUNDS_PER_STEP,
                                                     matcher_problem,
                                                     solve_inputs)

NEG = -1e9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: many small eager ops under the suite's
    parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image_round(ben, p, col_of_row, row_of_col, valid, e) -> bool:
    """One round of one image, in place. False, changing nothing, when
    every valid row is assigned."""
    rows = torch.nonzero(valid & (col_of_row < 0)).flatten()
    if len(rows) == 0:
        return False
    v = ben[rows] - p  # [R, N]
    v1, j1 = v.max(dim=1)  # the first column on ties
    v2 = v.scatter(1, j1[:, None], NEG).amax(dim=1)
    bid = (v1 + p[j1]) - v2 + e
    for j in j1.unique().tolist():
        mine = j1 == j
        best = bid[mine].max()
        if not best > NEG / 2:
            continue
        row = int(rows[mine][bid[mine] == best][0])  # the lowest row
        old = int(row_of_col[j])
        if old >= 0:
            col_of_row[old] = -1
        row_of_col[j], col_of_row[row], p[j] = row, j, best
    return True


def _image_solve(ben, valid, phases, k, cap):
    """One image alone: per phase, a fresh assignment while budget
    remains, then chunks of k rounds while a valid row is unassigned and
    budget remains; the rounds after convergence are not run. Returns
    (prices, col_of_row, row_of_col, chunks a phase)."""
    m, n = ben.shape
    p = torch.zeros(n)
    col_of_row = torch.full((m,), -1, dtype=torch.int64)
    row_of_col = torch.full((n,), -1, dtype=torch.int64)
    budget, chunks = cap, []
    for e in phases:
        if budget > 0:
            col_of_row.fill_(-1)
            row_of_col.fill_(-1)
        c = 0
        while budget > 0 and bool((valid & (col_of_row < 0)).any()):
            budget, c = budget - k, c + 1
            for _ in range(k):
                if not _image_round(ben, p, col_of_row, row_of_col, valid,
                                    e):
                    break
        chunks.append(c)
    return p, col_of_row, row_of_col, chunks


# Seeded matcher problems (tools/bench_auction.py `matcher_problem`): the
# coco100 cells' shapes (B 128 and 16, 50 queries, 100 GT slots, 1 +
# geometric counts of mean 7.3, pad columns with the tie table), exact
# ties, a square problem under eps-scaling (5 phases), a round budget
# that runs out (the greedy completion places the rest), and
# near-duplicate GT boxes.
CASES = {
    "coco100_b128": dict(problem=dict(seed=1, batch=128)),
    "coco100_b16_ties": dict(problem=dict(seed=2, batch=16, ties=True)),
    "square_eps_scaling": dict(problem=dict(seed=3, batch=4, queries=100)),
    "round_cap_greedy": dict(problem=dict(seed=4, batch=16, ties=True),
                             rounds_per_step=4, round_cap=10),
    "near_duplicates": dict(problem=dict(seed=5, batch=6,
                                         near_duplicates=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_each_image_alone_equals_the_batched_auction(case):
    spec = CASES[case]
    k = spec.get("rounds_per_step", ROUNDS_PER_STEP)
    cap = spec.get("round_cap", ROUND_CAP)
    problem = matcher_problem(**spec["problem"])
    cost, row_valid, col_pad, square = problem
    out, rounds = auction_assign(cost, row_valid, col_pad,
                                 scale_phases=square, rounds_per_step=k,
                                 round_cap=cap)
    benefit, _, phases = solve_inputs(*problem)
    assert len(phases) == (5 if case == "square_eps_scaling" else 1)
    p, _, _, eager_rounds = auction._solve_eager(benefit, row_valid, phases,
                                                 k, cap)
    assert eager_rounds == rounds
    chunks, left = [], False
    for i in range(benefit.shape[0]):
        pi, ci, ri, chunks_i = _image_solve(benefit[i], row_valid[i],
                                            phases, k, cap)
        assert torch.equal(pi, p[i]), (case, i)
        kept = ri >= 0
        assert torch.equal(ri[kept], out[i][kept]), (case, i)
        # Leftover valid rows (out of budget) take free columns, greedily.
        leftover = row_valid[i] & (ci < 0)
        left |= bool(leftover.any())
        if leftover.any():
            filled = out[i][~kept]
            assert sorted(filled[filled >= 0].tolist()) == torch.nonzero(
                leftover).flatten().tolist()
        else:
            assert torch.equal(ri, out[i]), (case, i)
        chunks.append(chunks_i)
    assert rounds == k * sum(max(c) for c in zip(*chunks))
    assert left == (case == "round_cap_greedy")


@pytest.mark.parametrize("bad,message", [
    ("float64", "float32"), ("row_valid_shape", "row_valid"),
    ("row_valid_int", "row_valid"), ("strided", "contiguous"),
    ("no_phase", "phases"), ("no_image", "images"), ("cpu", "CUDA")])
def test_kernel_wrapper_refuses_what_it_does_not_take(bad, message):
    """The wrapper checks before it builds or launches: each malformed
    input raises ValueError, and a CPU tensor too (the CPU runs the
    plain version, never the kernel)."""
    benefit, row_valid, phases = solve_inputs(*matcher_problem(seed=7,
                                                               batch=2))
    args = [benefit, row_valid, phases, ROUNDS_PER_STEP, ROUND_CAP]
    if bad == "float64":
        args[0] = benefit.double()
    elif bad == "row_valid_shape":
        args[1] = row_valid[:, :10]
    elif bad == "row_valid_int":
        args[1] = row_valid.int()
    elif bad == "strided":
        args[0] = benefit.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "no_phase":
        args[2] = []
    elif bad == "no_image":
        args[0], args[1] = benefit[:0], row_valid[:0]
    before = dict(_build.launch_counts)
    with pytest.raises(ValueError, match=message):
        auction._solve_kernel(*args)
    assert _build.launch_counts == before


# ---------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _same(got, want):
    return (all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
            and got[3] == want[3])


@pytest.mark.gpu
def test_kernel_equals_the_eager_rounds_on_the_card(cuda):
    """200 seeded matcher problems at the coco100 shapes (B 128 and 16 in
    turn, exact ties in every other), a square problem under eps-scaling,
    and a shape whose benefit does not fit shared memory beside the
    state: the kernel's prices, owners and rounds equal the eager rounds'
    on the same CUDA tensors, bit for bit."""
    lib = auction._kernel_lib()
    assert lib.auction_staged(50, 100) == 1
    assert lib.auction_staged(300, 400) == 0
    cases = [dict(seed=s, batch=(128, 16)[s % 2], ties=bool(s // 2 % 2))
             for s in range(200)]
    cases += [dict(seed=200, batch=16, queries=100),
              dict(seed=201, batch=8, queries=300, slots=400, ties=True),
              dict(seed=202, batch=8, near_duplicates=True)]
    differ = []
    for spec in cases:
        benefit, row_valid, phases = solve_inputs(
            *matcher_problem(**spec, device=cuda))
        args = (benefit, row_valid, phases, ROUNDS_PER_STEP, ROUND_CAP)
        got, want = auction._solve_kernel(*args), auction._solve_eager(*args)
        if not _same(got, want):
            differ.append((spec, got[3], want[3]))
    # And a budget that runs out mid-phase and across the square phases.
    for spec, k, cap in ((dict(seed=203, batch=16, ties=True), 4, 10),
                         (dict(seed=204, batch=4, queries=100), 8, 60)):
        benefit, row_valid, phases = solve_inputs(
            *matcher_problem(**spec, device=cuda))
        args = (benefit, row_valid, phases, k, cap)
        got, want = auction._solve_kernel(*args), auction._solve_eager(*args)
        if not _same(got, want):
            differ.append((spec, got[3], want[3]))
    torch.cuda.synchronize()
    assert not differ, differ


@pytest.mark.gpu
def test_kernel_launches_once_a_solve_on_the_card(cuda, monkeypatch):
    """On the card `auction_assign` and the matcher launch the kernel
    once a solve and never reach the eager rounds; the result equals the
    CPU's plain version."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA problem reached the eager rounds")

    cost, row_valid, col_pad, _ = matcher_problem(seed=9, batch=16)
    want = auction_assign(cost, row_valid, col_pad)
    monkeypatch.setattr(auction, "_solve_eager", refuse)
    before = _build.launch_counts["auction"]
    for n in range(1, 4):
        got = auction_assign(cost.to(cuda), row_valid.to(cuda),
                             col_pad.to(cuda))
        assert _build.launch_counts["auction"] == before + n
        assert torch.equal(got[0].cpu(), want[0]) and got[1] == want[1]
    gen = torch.Generator().manual_seed(9)
    args = (torch.randn(16, 50, 91, generator=gen),
            torch.rand(16, 50, 4, generator=gen) * 0.5 + 0.25,
            torch.randint(0, 91, (16, 100), generator=gen),
            torch.rand(16, 100, 4, generator=gen) * 0.5 + 0.25,
            torch.arange(100)[None].expand(16, 100) < 9)
    before = _build.launch_counts["auction"]
    matching.hungarian_match(*(a.to(cuda) for a in args))
    assert _build.launch_counts["auction"] == before + 1
