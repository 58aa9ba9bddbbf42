"""Auction assignment solver, the dense-GT path of the matcher
(counterpart of dinov2_od_tpu/ops/auction.py).

The exact solver (ops/hungarian.py) copies the cost to the host and
solves each image with scipy. The auction algorithm (Bertsekas) stays on
the params' device: each *round* is a handful of batched [B, M, N] tensor
ops in which every unassigned row of every image bids at once (Jacobi
style), and a few hundred rounds finish the assignment. The design is the
JAX package's:

- Rectangular, bidders = the smaller side. The matcher orients the
  problem so queries (rows, all real) bid for GT-slot columns. With 50
  queries bidding into 100 columns there are always spare columns, so
  near-tie costs (93 near-duplicate GT boxes) cause little price war: a
  displaced bidder finds another near-identical column at price ~0. The
  reverse orientation price-wars in eps increments.
- One phase at fixed eps when M < N: a column that receives a bid stays
  assigned within the phase, so every unassigned column still has price
  0 at the end and eps-complementary slackness gives
  total_cost <= optimal + M * eps * (cost range). eps-scaling is unsound
  there (abandoned columns keep stale prices).
- eps-scaling (eps0 -> /theta -> ... -> eps) only when M == N: every
  phase of a square auction ends with all columns assigned, so no stale
  prices exist and the textbook scaling bound applies.
- Pad-column tie-break: padding columns all cost the same, so bidders
  forced onto them bid in eps increments. A tiny distinct preference
  (delta times a fixed pseudo-random table, on pad columns only) breaks
  those ties; it changes only which pad column takes a leftover bidder.
  JAX draws its table from `jax.random.key(17)`; the port draws its own
  from a seeded `torch.Generator`, so the two may park a leftover bidder
  on different pad columns (never a different real pairing cost).
- `rounds_per_step` rounds between convergence checks: the check is the
  one host sync, so the loop syncs once per `rounds_per_step` rounds,
  and once more as a phase ends. Rounds after an image converged place
  no bids (no-ops). In a profiled run each check is an `auction.check`
  span, so the trace counts the syncs where they happen.
- On a CUDA device the `rounds_per_step` rounds run as one CUDA graph
  replay: a round is ~25 tiny tensor ops, which issued eagerly cost their
  launches, not their work (~0.5 ms a round on an H100, PERF.md). The
  graph is captured once per (shape, eps, rounds_per_step) and kept
  (an `auction.capture` span in a profiled run), its state in static
  buffers that the rounds update in place; the same ops
  run eagerly on the CPU. One auction at a time uses a graph (the train
  step's matcher calls them one after another).
- `round_cap` rounds at most per image, then a greedy completion keeps
  the output a valid partial assignment.

Near-ties may resolve differently than scipy's optimum, which the loss
cannot feel; tests compare total cost, not indices.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..utils.profiling import annotate

# Bid and price sentinel; fp32 like the costs it is compared with.
_NEG = -1e9
_TIE_SEED = 17


def _tie_table(m: int, n: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(_TIE_SEED)
    return torch.rand((m, n), generator=gen, dtype=torch.float32).to(device)


class _EagerRounds:
    """`k` rounds at eps `e` as eager tensor ops. `load` takes a problem
    and its state (p, col_of_row, row_of_col); `run(active)` advances the
    state by `k` rounds."""

    def __init__(self, k: int, e: float):
        self.k, self.e = k, e

    def load(self, benefit, row_valid, p, col_of_row, row_of_col):
        self.benefit, self.row_valid = benefit, row_valid
        self.p, self.col_of_row, self.row_of_col = p, col_of_row, row_of_col

    def run(self, active):
        b, m, n = self.benefit.shape
        rows = torch.arange(m, device=self.benefit.device)
        cols = torch.arange(n, device=self.benefit.device)
        state = (self.p, self.col_of_row, self.row_of_col)
        for _ in range(self.k):
            state = _one_round(self.benefit, cols, rows, self.row_valid,
                               active, self.e, state)
        self.p, self.col_of_row, self.row_of_col = state


class _GraphedRounds:
    """The same `k` rounds captured once as a CUDA graph over static
    buffers: `load` copies a problem and its state in, `run` replays the
    graph, which updates the state buffers in place."""

    def __init__(self, b: int, m: int, n: int, k: int, e: float, device):
        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=device)

        self.benefit = full((b, m, n), 0.0, torch.float32)
        self.row_valid = full((b, m), False, torch.bool)
        self.active = full((b,), False, torch.bool)
        self.p = full((b, n), 0.0, torch.float32)
        self.col_of_row = full((b, m), -1, torch.int64)
        self.row_of_col = full((b, n), -1, torch.int64)
        eager = _EagerRounds(k, e)

        def rounds():
            eager.load(self.benefit, self.row_valid, self.p,
                       self.col_of_row, self.row_of_col)
            eager.run(self.active)
            return eager.p, eager.col_of_row, eager.row_of_col

        # Warm up on a side stream (no active image: no bids), then
        # capture. Other threads may use the card meanwhile (the loader's
        # copies), so only this thread's calls are checked.
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            rounds()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            for buf, new in zip((self.p, self.col_of_row, self.row_of_col),
                                rounds()):
                buf.copy_(new)

    def load(self, benefit, row_valid, p, col_of_row, row_of_col):
        for buf, src in ((self.benefit, benefit), (self.row_valid, row_valid),
                         (self.p, p), (self.col_of_row, col_of_row),
                         (self.row_of_col, row_of_col)):
            buf.copy_(src)

    def run(self, active):
        self.active.copy_(active)
        self.graph.replay()


# Captured graphs by (batch, rows, columns, rounds, eps, device).
_graphs: Dict[tuple, _GraphedRounds] = {}


def _rounds(shape, k: int, e: float, device):
    """The round runner for a problem of `shape` on `device`."""
    if device.type != "cuda":
        return _EagerRounds(k, e)
    key = (*shape, k, e, device)
    if key not in _graphs:
        with annotate("auction.capture"):
            _graphs[key] = _GraphedRounds(*shape, k, e, device)
    return _graphs[key]


def _one_round(benefit, cols, rows, row_valid, active, e, state):
    """One Jacobi bidding round over every image. `active` [B] marks the
    images still inside their while loop (JAX's per-image cond under
    vmap); the others place no bids."""
    p, col_of_row, row_of_col = state
    unass = row_valid & (col_of_row < 0) & active[:, None]  # [B, M]
    v = benefit - p[:, None, :]  # [B, M, N]
    v1, j1 = v.max(dim=2)  # best column per row (first of ties)
    best_mask = j1[..., None] == cols  # [B, M, N]
    v2 = v.masked_fill(best_mask, _NEG).amax(dim=2)  # second best
    b1 = v1 + torch.gather(p, 1, j1)
    bid = torch.where(unass, b1 - v2 + e, _NEG)  # [B, M]
    bidmat = torch.where(best_mask & unass[..., None], bid[..., None],
                         _NEG)
    # Column-wise winner (lowest row index wins exact ties).
    colmax, winner = bidmat.max(dim=1)  # [B, N]
    has_bid = colmax > _NEG / 2
    p = torch.where(has_bid, colmax, p)
    row_of_col = torch.where(has_bid, winner, row_of_col)
    # col_of_row rebuilt from row_of_col: displaced owners drop out.
    own = row_of_col[:, None, :] == rows[:, None]  # [B, M, N]
    col_of_row = torch.where(own.any(dim=2), own.byte().argmax(dim=2), -1)
    return p, col_of_row, row_of_col


@torch.no_grad()
def auction_assign(
    cost: torch.Tensor,
    row_valid: torch.Tensor,
    col_pad: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-3,
    scale_phases: bool = False,
    eps0: float = 0.1,
    theta: float = 4.0,
    delta: float = 4e-3,
    rounds_per_step: int = 8,
    round_cap: int = 4000,
) -> Tuple[torch.Tensor, int]:
    """Assign valid rows to columns, minimizing total cost (eps-optimal),
    for a batch of problems.

    Args:
      cost: [B, M, N] cost, M <= N. Padding entries must hold a value
        above every real entry (the caller clips them to just above the
        real max for the tightest bound).
      row_valid: [B, M] bool; invalid rows never bid and stay unassigned.
      col_pad: optional [B, N] bool marking uniform-cost padding columns
        that receive the tie-breaking perturbation.
      eps: bid increment relative to each image's cost range; the final
        increment of the scaling mode.
      scale_phases: run eps0 -> /theta -> ... -> eps. Sound only when
        every column ends each phase assigned (square, all rows valid).

    Returns:
      (row_of_col [B, N] int64, the valid row assigned to each column, -1
      if none; the number of rounds run, a multiple of rounds_per_step).
    """
    b, m, n = cost.shape
    cost = cost.float()
    # Benefits in [0, 1] per image (higher is better).
    cmax = cost.amax(dim=(1, 2), keepdim=True)
    cmin = cost.amin(dim=(1, 2), keepdim=True)
    benefit = (cmax - cost) / torch.clamp(cmax - cmin, min=1e-12)
    if col_pad is not None:
        benefit = benefit + torch.where(
            col_pad[:, None, :], delta, 0.0) * _tie_table(m, n, cost.device)
    dev = cost.device

    eps_phases = []
    if scale_phases:
        e = eps0
        while e > eps:
            eps_phases.append(e)
            e /= theta
    eps_phases.append(eps)

    prices = torch.zeros((b, n), device=dev)
    budget = torch.full((b,), round_cap, device=dev, dtype=torch.int64)
    col_of_row = torch.full((b, m), -1, device=dev, dtype=torch.int64)
    row_of_col = torch.full((b, n), -1, device=dev, dtype=torch.int64)
    rounds = 0
    for phase_eps in eps_phases:
        # A phase starts from no assignment while round budget remains;
        # an image that spent its budget keeps its earlier result.
        fresh = (budget > 0)[:, None]
        runner = _rounds((b, m, n), rounds_per_step, phase_eps, dev)
        runner.load(benefit, row_valid, prices,
                    torch.where(fresh, -1, col_of_row),
                    torch.where(fresh, -1, row_of_col))
        while True:
            active = ((row_valid & (runner.col_of_row < 0)).any(dim=1)
                      & (budget > 0))
            with annotate("auction.check"):  # the one host sync per step
                converged = not bool(active.any())
            if converged:
                break
            runner.run(active)
            budget = budget - rounds_per_step * active
            rounds += rounds_per_step
        prices, col_of_row, row_of_col = (
            runner.p.clone(), runner.col_of_row.clone(),
            runner.row_of_col.clone())
    rows = torch.arange(m, device=dev)

    # Greedy completion if the budget ran out: the r-th leftover valid
    # row takes the r-th free column.
    left_rows = row_valid & (col_of_row < 0)  # [B, M]
    free_cols = row_of_col < 0  # [B, N]
    row_rank = torch.cumsum(left_rows.long(), dim=1) - 1
    col_rank = torch.cumsum(free_cols.long(), dim=1) - 1
    rows_by_rank = torch.full((b, m + 1), -1, device=dev, dtype=torch.int64)
    rows_by_rank.scatter_(1, torch.where(left_rows, row_rank, m),
                          rows.expand(b, m).clone())
    n_left = left_rows.sum(dim=1, keepdim=True)
    fill = torch.where(
        free_cols & (col_rank < n_left),
        torch.gather(rows_by_rank, 1, col_rank.clamp(0, m - 1)),
        -1,
    )
    return torch.where(row_of_col >= 0, row_of_col, fill), rounds
