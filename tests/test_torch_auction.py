"""The port's auction solver and the matcher's auction route
(dinov2_od_tpu_torch/ops/{auction,matching}.py) against the JAX package's
on the same seeded numpy inputs, on the CPU.

Tolerance: both solvers are eps-optimal, so each total cost over the
valid pairs must lie within the auction's bound of scipy's optimum,
M * eps * (cost range) with eps = 1e-3 (dinov2_od_tpu/ops/auction.py:24-30),
plus 1e-3 of fp32 summation slack. Without pad columns the two packages
run the same arithmetic and give the same assignment; with them their
tie-break tables differ (a seeded torch.Generator against JAX's
key(17)), which moves only which pad column takes a leftover bidder.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from dinov2_od_tpu import config as jcfg
from dinov2_od_tpu.ops import matching as jmatching
from dinov2_od_tpu.ops.auction import auction_assign as jax_auction

from dinov2_od_tpu_torch import config as pcfg
from dinov2_od_tpu_torch.ops import matching as pmatching
from dinov2_od_tpu_torch.ops.auction import auction_assign

PAD = 1e4
EPS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small eager ops, and
    under the suite's parallel workers torch's default of a thread a
    core oversubscribes the machine (a test ~30x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _padded_problem(rng, n, nv, scale=10.0):
    """tests/test_auction.py's square problem: nv valid rows of n."""
    cost = (rng.normal(size=(n, n)) * scale).astype(np.float32)
    cost[nv:, :] = PAD
    valid = np.arange(n) < nv
    real_max = cost[cost < PAD].max() if nv else 0.0
    return cost, np.minimum(cost, real_max + 1.0), valid


def _check_assignment(row_of_col, valid, n_rows):
    assigned = row_of_col[row_of_col >= 0]
    assert len(set(assigned.tolist())) == len(assigned), "row assigned twice"
    assert valid[assigned].all(), "invalid row assigned"
    assert np.isin(np.where(valid)[0], assigned).all()


def _total(cost, row_of_col):
    return sum(cost[r, c] for c, r in enumerate(row_of_col) if r >= 0)


@pytest.mark.parametrize("n,nv", [(8, 5), (50, 25), (100, 93), (100, 100),
                                  (64, 0)])
def test_auction_matches_jax_and_bound(n, nv):
    rng = np.random.default_rng(n * 1000 + nv)
    cost, clipped, valid = _padded_problem(rng, n, nv)
    out, rounds = auction_assign(torch.from_numpy(clipped)[None],
                                 torch.from_numpy(valid)[None])
    out = out[0].numpy()
    ref = np.asarray(jax_auction(jnp.asarray(clipped), jnp.asarray(valid)))
    _check_assignment(out, valid, n)
    # No pad columns: the same rounds in the same order, the same result.
    np.testing.assert_array_equal(out, ref)
    assert rounds % 8 == 0 and (rounds > 0) == (nv > 0)
    if nv:
        ri, ci = linear_sum_assignment(cost)
        opt = sum(cost[r, c] for r, c in zip(ri, ci) if valid[r])
        span = clipped.max() - clipped.min()
        assert _total(cost, out) <= opt + nv * EPS * span + 1e-3


def test_batch_equals_each_problem_alone():
    """Images converge after different round counts; a converged image
    places no bids while the others go on, so the batch gives each image
    what it gets alone."""
    rng = np.random.default_rng(3)
    problems = [_padded_problem(rng, 40, nv)[1:] for nv in (40, 7, 0, 33)]
    cost = torch.from_numpy(np.stack([p[0] for p in problems]))
    valid = torch.from_numpy(np.stack([p[1] for p in problems]))
    batch, _ = auction_assign(cost, valid)
    for i in range(len(problems)):
        alone, _ = auction_assign(cost[i:i + 1], valid[i:i + 1])
        assert torch.equal(batch[i], alone[0])


def test_round_cap_keeps_a_valid_assignment():
    """A budget too small to converge: the greedy completion still gives
    every valid row one column."""
    rng = np.random.default_rng(1)
    _, clipped, valid = _padded_problem(rng, 30, 30)
    out, rounds = auction_assign(torch.from_numpy(clipped)[None],
                                 torch.from_numpy(valid)[None],
                                 rounds_per_step=2, round_cap=4)
    assert rounds == 4
    _check_assignment(out[0].numpy(), valid, 30)


def _near_duplicate_costs(seed, q, g=100, n_valid=93):
    """tests/test_auction.py's adversarial case: near-duplicate GT boxes."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(q, 91)).astype(np.float32)
    pb = (1 / (1 + np.exp(-rng.normal(size=(q, 4))))).astype(np.float32)
    gl = rng.integers(0, 6, size=(g,)).astype(np.int32)
    base = np.clip(rng.uniform(0.2, 0.8, (1, 4)), 0.05, 0.95)
    gb = np.clip(base + rng.normal(scale=0.01, size=(g, 4)), 0.02,
                 0.98).astype(np.float32)
    valid = np.arange(g) < n_valid
    cqg = np.asarray(jmatching.matching_cost_matrix(
        jnp.asarray(logits), jnp.asarray(pb), jnp.asarray(gl),
        jnp.asarray(gb), jnp.asarray(valid), jcfg.MatcherConfig()))
    return cqg, valid


@pytest.mark.parametrize("q", [100, 50])
def test_near_duplicate_boxes_within_bound_both_packages(q):
    """The matcher's transposed construction (queries bid, eps-scaling in
    the square case) on massed near-ties: both packages stay inside the
    round budget and the bound; the port's pad tie-break table differs
    from JAX's, so only the totals are compared."""
    g = 100
    cqg, valid = _near_duplicate_costs(5 + q, q)
    n = max(q, g)
    cost = np.full((q, n), PAD, np.float32)
    cost[:, :g] = cqg
    clipped = np.minimum(cost, cqg[:, valid].max() + 1.0)
    col_pad = ~np.pad(valid, (0, n - g))
    out, _ = auction_assign(torch.from_numpy(clipped)[None],
                            torch.ones((1, q), dtype=torch.bool),
                            torch.from_numpy(col_pad)[None],
                            scale_phases=(q == n))
    out = out[0].numpy()
    ref = np.asarray(jax_auction(jnp.asarray(clipped), jnp.ones(q, bool),
                                 jnp.asarray(col_pad), scale_phases=(q == n)))
    ri, ci = linear_sum_assignment(cqg[:, valid])
    opt = cqg[:, valid][ri, ci].sum()
    span = clipped.max() - clipped.min()
    for got in (out, ref):
        assigned = got[got >= 0]
        assert len(set(assigned.tolist())) == len(assigned) == q
        tot = sum(cqg[got[c], c] for c in range(g) if got[c] >= 0 and valid[c])
        nmatch = sum(1 for c in range(g) if got[c] >= 0 and valid[c])
        assert nmatch == min(q, valid.sum())
        assert tot <= opt + q * EPS * span + 0.1, (tot, opt)


def _matcher_inputs(seed, b=3, q=50, g=100, c=91, n_valid=(93, 40, 0)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, q, c)).astype(np.float32)
    pb = np.clip(rng.uniform(0.1, 0.9, (b, q, 4)) * [1, 1, 0.3, 0.3], 0.02,
                 1).astype(np.float32)
    gl = rng.integers(0, c, size=(b, g)).astype(np.int32)
    gb = np.clip(rng.uniform(0.1, 0.9, (b, g, 4)) * [1, 1, 0.3, 0.3], 0.02,
                 1).astype(np.float32)
    valid = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        valid[i, :n] = True
    return logits, pb, gl, gb, valid


@pytest.mark.parametrize("q", [50, 100])
def test_hungarian_match_auto_routes_to_auction_like_jax(q):
    """At 100 GT slots `auto` takes the auction in both packages; the
    matched totals agree within twice the auction's bound (each is within
    one of scipy's optimum), and the same GT slots are matched."""
    args = _matcher_inputs(11 + q, q=q)
    ref = jmatching.hungarian_match(*(jnp.asarray(x) for x in args),
                                    jcfg.MatcherConfig())
    pmatching.reset_solver_stats()
    out = pmatching.hungarian_match(*(torch.from_numpy(x) for x in args),
                                    pcfg.MatcherConfig())
    assert pmatching.solver_stats["auction"] == 1
    assert pmatching.solver_stats["jv"] == 0
    assert pmatching.solver_stats["auction_rounds"] > 0
    cost = np.asarray(jmatching.jax.vmap(
        lambda *a: jmatching.matching_cost_matrix(*a, jcfg.MatcherConfig())
    )(*(jnp.asarray(x) for x in args)))
    qg_ref = np.asarray(ref.query_of_gt)
    mv_ref = np.asarray(ref.match_valid)
    qg, mv = out.query_of_gt.numpy(), out.match_valid.numpy()
    np.testing.assert_array_equal(mv, mv_ref)
    assert (qg[~mv] == -1).all()
    for b in range(cost.shape[0]):
        valid = args[4][b]
        tot = cost[b][qg[b][mv[b]], np.where(mv[b])[0]].sum()
        tot_ref = cost[b][qg_ref[b][mv_ref[b]], np.where(mv_ref[b])[0]].sum()
        span = (np.ptp(np.minimum(cost[b], cost[b][:, valid].max() + 1.0))
                if valid.any() else 0.0)
        assert abs(tot - tot_ref) <= 2 * q * EPS * span + 1e-2, (b, tot,
                                                               tot_ref)
        used = qg[b][mv[b]]
        assert len(set(used.tolist())) == len(used)


def test_sparse_slots_stay_on_jv():
    args = _matcher_inputs(2, g=25, n_valid=(4, 25, 0))
    pmatching.reset_solver_stats()
    pmatching.hungarian_match(*(torch.from_numpy(x) for x in args),
                              pcfg.MatcherConfig())
    assert pmatching.solver_stats == {"jv": 1, "auction": 0,
                                      "auction_rounds": 0}
    with pytest.raises(ValueError, match="assignment"):
        pmatching.hungarian_match(*(torch.from_numpy(x) for x in args),
                                  pcfg.MatcherConfig(assignment="greedy"))
