"""Auction assignment solver, the dense-GT path of the matcher
(counterpart of dinov2_od_tpu/ops/auction.py).

The exact solver (ops/hungarian.py) copies the cost to the host and
solves each image with scipy. The auction algorithm (Bertsekas) stays on
the params' device: in each *round* every unassigned row of an image
bids at once (Jacobi style), and a few hundred rounds finish the
assignment. The design is the JAX package's:

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
- `rounds_per_step` rounds a chunk: an image still unassigned with
  budget left runs `rounds_per_step` more rounds and is charged for all
  of them. Rounds after an image converged place no bids (no-ops), so
  each image's state is what it gets alone, and the rounds reported are,
  over the phases, `rounds_per_step` times the most chunks any image ran.
- On a CUDA device the whole solve is one launch of a hand-written
  kernel (csrc/auction.cu): one block an image runs its rounds on the
  card until it converges or spends its budget, with the image's
  benefit and state in shared memory when they fit (else the benefit is
  read from device memory). The host reads each image's chunks back
  once, in an `auction.check` span of a profiled run: one host sync a
  solve. On the CPU the same rounds run as batched tensor ops
  (`_solve_eager`, the kernel's plain version), with a convergence check
  a chunk, each in an `auction.check` span.
- `round_cap` rounds at most per image, then a greedy completion keeps
  the output a valid partial assignment.

Near-ties may resolve differently than scipy's optimum, which the loss
cannot feel; tests compare total cost, not indices.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from ..utils.profiling import annotate
from . import _build

# Bid and price sentinel; fp32 like the costs it is compared with.
_NEG = -1e9
_TIE_SEED = 17
_KERNEL = "auction"
_MAX_PHASES = 32  # csrc/auction.cu kMaxPhases

# The pad tie-break table by (rows, columns, device), made once.
_tie_tables: Dict[tuple, torch.Tensor] = {}


def _tie_table(m: int, n: int, device) -> torch.Tensor:
    key = (m, n, torch.device(device))
    if key not in _tie_tables:
        gen = torch.Generator().manual_seed(_TIE_SEED)
        _tie_tables[key] = torch.rand(
            (m, n), generator=gen, dtype=torch.float32).to(device)
    return _tie_tables[key]


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


def _benefit(cost, col_pad, delta):
    """Benefits in [0, 1] per image (higher is better), plus the pad
    columns' tie-break."""
    b, m, n = cost.shape
    cmax = cost.amax(dim=(1, 2), keepdim=True)
    cmin = cost.amin(dim=(1, 2), keepdim=True)
    benefit = (cmax - cost) / torch.clamp(cmax - cmin, min=1e-12)
    if col_pad is not None:
        benefit = benefit + torch.where(
            col_pad[:, None, :], delta, 0.0) * _tie_table(m, n, cost.device)
    return benefit


def _eps_phases(eps, scale_phases, eps0, theta) -> List[float]:
    phases = []
    if scale_phases:
        e = eps0
        while e > eps:
            phases.append(e)
            e /= theta
    return phases + [eps]


def _solve_eager(benefit, row_valid, eps_phases, rounds_per_step,
                 round_cap):
    """The solve as batched tensor-op rounds, the kernel's plain version:
    every image runs chunks of `rounds_per_step` rounds while it has an
    unassigned valid row and budget left; a phase starts from no
    assignment while budget remains (an image that spent its budget
    keeps its earlier result) and from the last phase's prices.

    Returns (prices [B, N], col_of_row [B, M], row_of_col [B, N], the
    rounds run)."""
    b, m, n = benefit.shape
    dev = benefit.device
    rows = torch.arange(m, device=dev)
    cols = torch.arange(n, device=dev)
    p = torch.zeros((b, n), device=dev)
    budget = torch.full((b,), round_cap, device=dev, dtype=torch.int64)
    col_of_row = torch.full((b, m), -1, device=dev, dtype=torch.int64)
    row_of_col = torch.full((b, n), -1, device=dev, dtype=torch.int64)
    rounds = 0
    for e in eps_phases:
        fresh = (budget > 0)[:, None]
        col_of_row = torch.where(fresh, -1, col_of_row)
        row_of_col = torch.where(fresh, -1, row_of_col)
        while True:
            active = ((row_valid & (col_of_row < 0)).any(dim=1)
                      & (budget > 0))
            with annotate("auction.check"):  # a host sync a chunk
                converged = not bool(active.any())
            if converged:
                break
            for _ in range(rounds_per_step):
                p, col_of_row, row_of_col = _one_round(
                    benefit, cols, rows, row_valid, active, e,
                    (p, col_of_row, row_of_col))
            budget = budget - rounds_per_step * active
            rounds += rounds_per_step
    return p, col_of_row, row_of_col, rounds


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(_KERNEL)
    if lib.auction_solve.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.auction_solve.argtypes = [p] * 6 + [i] * 3 + [p] + [i] * 3 + [p]
        lib.auction_solve.restype = i
        lib.auction_staged.argtypes = [i, i]
        lib.auction_staged.restype = i
        lib.auction_error_string.argtypes = [i]
        lib.auction_error_string.restype = ctypes.c_char_p
    return lib


def _solve_kernel(benefit, row_valid, eps_phases, rounds_per_step,
                  round_cap):
    """`_solve_eager` as one launch of csrc/auction.cu on a CUDA device;
    the same results, bit for bit, read back with one host sync."""
    if benefit.dtype != torch.float32 or benefit.dim() != 3:
        raise ValueError(f"benefit must be float32 [B, M, N]; got "
                         f"{benefit.dtype} {tuple(benefit.shape)}")
    b, m, n = benefit.shape
    if (row_valid.dtype != torch.bool or tuple(row_valid.shape) != (b, m)
            or row_valid.device != benefit.device):
        raise ValueError(f"row_valid must be bool [{b}, {m}] on "
                         f"{benefit.device}; got {row_valid.dtype} "
                         f"{tuple(row_valid.shape)} on {row_valid.device}")
    if not (benefit.is_contiguous() and row_valid.is_contiguous()):
        raise ValueError("the auction kernel reads contiguous benefit and "
                         "row_valid")
    if b < 1 or not 1 <= len(eps_phases) <= _MAX_PHASES:
        raise ValueError(f"the auction kernel takes 1 or more images and 1 "
                         f"to {_MAX_PHASES} eps phases; got {b} and "
                         f"{len(eps_phases)}")
    if rounds_per_step < 1 or not -2**31 <= round_cap < 2**31:
        raise ValueError(f"rounds_per_step must be >= 1 and round_cap a "
                         f"32-bit int; got {rounds_per_step}, {round_cap}")
    if benefit.device.type != "cuda":
        raise ValueError(f"the auction kernel runs on CUDA tensors; got "
                         f"{benefit.device}")
    lib = _kernel_lib()
    dev = benefit.device
    prices = torch.empty((b, n), dtype=torch.float32, device=dev)
    col_of_row = torch.empty((b, m), dtype=torch.int64, device=dev)
    row_of_col = torch.empty((b, n), dtype=torch.int64, device=dev)
    chunks = torch.empty((b, len(eps_phases)), dtype=torch.int32, device=dev)
    eps_c = (ctypes.c_float * len(eps_phases))(*eps_phases)
    with torch.cuda.device(dev):
        if lib.auction_staged(m, n) < 0:
            raise ValueError(f"an auction image of [{m}, {n}] does not fit "
                             f"a block's shared memory")
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.auction_solve(
            benefit.data_ptr(), row_valid.data_ptr(), prices.data_ptr(),
            col_of_row.data_ptr(), row_of_col.data_ptr(), chunks.data_ptr(),
            b, m, n, ctypes.addressof(eps_c), len(eps_phases),
            rounds_per_step, round_cap, stream)
    if rc != 0:
        msg = lib.auction_error_string(rc).decode()
        raise RuntimeError(f"auction launch failed: {msg} ({rc})")
    _build.launch_counts[_KERNEL] += 1
    with annotate("auction.check"):  # the solve's one host sync
        most = chunks.amax(dim=0).tolist()
    return prices, col_of_row, row_of_col, rounds_per_step * sum(most)


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
    benefit = _benefit(cost.float(), col_pad, delta).contiguous()
    solve = _solve_eager if cost.device.type == "cpu" else _solve_kernel
    _, col_of_row, row_of_col, rounds = solve(
        benefit, row_valid.contiguous(),
        _eps_phases(eps, scale_phases, eps0, theta),
        rounds_per_step, round_cap)
    dev = cost.device
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
