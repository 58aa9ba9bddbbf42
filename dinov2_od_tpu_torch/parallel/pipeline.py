"""Pipeline parallelism of the backbone's depth over the mesh's stages:
GPipe and the interleaved schedule (counterpart of
dinov2_od_tpu/parallel/pipeline.py).

The schedule is the JAX package's, tick for tick. With P stages, v chunks
a stage (`num_chunks`) and m microbatches the run takes v m + P - 1
ticks. At tick t stage p works on u = t - p, which names a group g of P
microbatches, a lap c and a member r (u = g v P + c P + r): microbatch
j = g P + r through the stage's c-th local chunk, global chunk c P + p
(JAX's permutation of the stack, `interleave_chunks`: stage p holds
chunks {p, P + p, ...}). Stage 0 takes a new microbatch on lap 0 and the
previous stage's output otherwise; each tick's output goes to the next
stage (under the interleaved schedule the last stage's wraps to stage 0
for the next lap), and the last stage's output on the last lap is the
microbatch's result. The results are summed over the stage group (JAX's
psum), so every stage holds the whole [B, S, D] output.

Where JAX's shard_map runs one SPMD program over the stages, each rank
here runs its own chunks and posts its own transfers
(parallel/collectives.py `stage_exchange`):

- Bubble ticks (u outside [0, v m)) are skipped with their transfers:
  every rank works out liveness from (t, p), so both ends of a transfer
  agree. JAX computes on garbage there and masks the result; the values
  are equal. `skip_bubbles=False` computes and ships the bubble ticks as
  JAX's dataflow does, for comparison.
- The backward. Autograd on each rank runs its own graph, and a rank
  whose tick takes no gradient (a bubble, or a frozen stage) would never
  post the transfer its neighbour waits for. So the whole schedule is one
  autograd.Function: its forward keeps one graph a live tick, cut at the
  stage boundaries, and its backward walks the ticks in reverse. At each
  it takes the output's cotangent (received from the next stage, or on
  the last stage's last lap this rank's cotangent of the result), runs
  the backward through that tick's chunk and sends the input's cotangent
  to the stage the input came from. Whether a transfer carries a
  cotangent is a function of (t, p) and of the blocks that train, the
  same on every rank, so every rank posts the transfers its neighbours
  wait for. The result's cotangent is read on the last stage only: every
  stage runs the decoder on the same summed result, so it is the same on
  each, and a psum's transpose would count it P times.
- `frozen_blocks`: the first blocks' params take no gradient (JAX
  stop-gradients those rows of the stack). They run without autograd
  unless the pipeline's input needs a gradient, so a stage whose chunks
  are all frozen runs no backward at all.
- Each rank holds the whole stack (params are replicated over the
  stages, parallel/sharding.py) and indexes its own blocks out of it; the
  gradient it returns for a stacked leaf is zero outside its blocks' rows
  (the train step sums it over the stage group).

Remat (`use_remat`) is the block function's own (models/vit.py wraps each
adapted block in `torch.utils.checkpoint`), as `jax.checkpoint(fn)` wraps
JAX's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from .collectives import stage_exchange, stage_sum

Params = Dict[str, Any]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _block(tree, i: int):
    """Block i's params out of a stacked tree (views)."""
    return _tree_map(lambda a: a[i], tree)


def check_schedule(depth: int, n_stages: int, num_chunks: int = 1,
                   num_microbatches: int = 0) -> int:
    """The JAX package's checks of the stack and the schedule, with its
    messages; returns the microbatch count (0 means the stage count)."""
    v = num_chunks
    if v < 1:
        raise ValueError(f"num_chunks must be >= 1, got {v}")
    if depth % (n_stages * v) != 0:
        raise ValueError(
            f"depth {depth} not divisible by stages x chunks "
            f"({n_stages} x {v})"
        )
    m = num_microbatches or n_stages
    if v > 1 and m % n_stages != 0:
        raise ValueError(
            f"interleaved schedule needs microbatches ({m}) divisible by "
            f"stages ({n_stages})"
        )
    return m


def interleave_chunks(tree, n_stages: int, num_chunks: int):
    """JAX's permutation of each leaf's leading depth dim for the
    interleaved schedule: global chunk c P + p becomes stage p's c-th
    local chunk ([L] -> [v, P, cd] -> [P, v, cd] -> [L]), so stage p's
    blocks are the p-th of P equal row ranges of the result. The identity
    under GPipe (v = 1)."""
    v = num_chunks
    if v == 1:
        return tree

    def perm(a):
        cd = a.shape[0] // (n_stages * v)
        return a.reshape((v, n_stages, cd) + a.shape[1:]).transpose(
            0, 1).reshape(a.shape)

    return _tree_map(perm, tree)


def stage_chunks(depth: int, n_stages: int, num_chunks: int,
                 stage: int) -> List[List[int]]:
    """The global block indices of each of `stage`'s local chunks, in lap
    order: its rows of `interleave_chunks` over the block indices."""
    per = depth // n_stages
    order = interleave_chunks(torch.arange(depth), n_stages, num_chunks)
    return order[stage * per:(stage + 1) * per].view(num_chunks, -1).tolist()


class _Schedule:
    """JAX's tick arithmetic for this rank's stage, and which transfers
    each tick posts."""

    def __init__(self, depth: int, n_stages: int, v: int, m: int,
                 stage: int, skip: bool, grad_from: int):
        self.P, self.v, self.m, self.p, self.skip = n_stages, v, m, stage, skip
        self.cd = depth // (n_stages * v)
        self.ticks = v * m + n_stages - 1
        self.chunks = stage_chunks(depth, n_stages, v, stage)
        # The first block boundary (block i's input; the depth is the
        # output) whose activation depends on something that takes a
        # gradient: 0 when the pipeline's input does, one past the frozen
        # blocks when only the params do, past the depth when nothing does.
        self.grad_from = grad_from

    def at(self, t: int, q: Optional[int] = None):
        """(live, lap c, microbatch j) of stage q (this one by default)
        at tick t; off the schedule (a bubble) u is clipped as JAX clips
        it."""
        q = self.p if q is None else q
        u = t - q
        live = 0 <= u < self.v * self.m
        uc = min(max(u, 0), self.v * self.m - 1)
        g, rem = divmod(uc, self.v * self.P)
        c, r = divmod(rem, self.P)
        return live, c, g * self.P + r

    def ships(self, t: int, q: int, skip: Optional[bool] = None) -> bool:
        """Whether stage q's output of tick t goes to the next stage: on
        JAX's edges (the wrap from the last stage to stage 0 under the
        interleaved schedule only), and with skipped bubbles only where
        the next stage takes it as its input."""
        if q == self.P - 1 and self.v == 1:
            return False
        if not (self.skip if skip is None else skip):
            return True
        live, c, _ = self.at(t, q)
        return live and (q < self.P - 1 or c < self.v - 1)

    def graph_needed(self, c: int, q: Optional[int] = None) -> bool:
        """Whether the output of stage q's chunk on lap c depends on
        something that takes a gradient."""
        q = self.p if q is None else q
        return self.grad_from <= (c * self.P + q + 1) * self.cd

    def carries_grad(self, t: int, q: int) -> bool:
        """Whether the backward sends a cotangent back over stage q's
        transfer of tick t."""
        return self.ships(t, q, skip=True) and self.graph_needed(
            self.at(t, q)[1], q)


class _Run:
    """One call's state: the schedule, the block function and the stack
    (frozen rows detached, trainable leaves as this call's leaves)."""

    def __init__(self, sched: _Schedule, block_fn: Callable, mesh,
                 stacked_params: Params, trainable: List[bool],
                 frozen_blocks: int):
        self.sched, self.block_fn, self.mesh = sched, block_fn, mesh
        self.stack = stacked_params
        self.trainable, self.frozen = trainable, frozen_blocks
        self.saved: Dict[int, tuple] = {}

    def params_of(self, aliases: List[torch.Tensor]):
        """The stack twice: detached (the frozen rows), and with the
        trainable leaves replaced by `aliases`."""
        it = iter(aliases)
        flags = iter(self.trainable)
        detached = _tree_map(lambda a: a.detach(), self.stack)
        live = _tree_map(lambda a: next(it) if next(flags) else a.detach(),
                         self.stack)
        return detached, live

    def chunk(self, inp, c: int, t: int, graph: bool, trees) -> torch.Tensor:
        """Stage p's chunk c on `inp`; with `graph`, recorded for the
        backward (this tick's input cut from the rest as a leaf)."""
        detached, live = trees
        blocks = self.sched.chunks[c]
        if not graph:
            with torch.no_grad():
                h = inp
                for i in blocks:
                    h = self.block_fn(h, _block(detached, i))
            return h
        g0 = self.sched.grad_from
        with torch.enable_grad():
            h0 = inp.detach().requires_grad_(g0 <= blocks[0])
            h = h0
            for i in blocks:
                if h.requires_grad or i >= self.frozen:
                    h = self.block_fn(h, _block(
                        live if i >= self.frozen else detached, i))
                else:
                    with torch.no_grad():
                        h = self.block_fn(h, _block(detached, i))
        self.saved[t] = (h0, h)
        return h.detach()

    def forward(self, x: torch.Tensor, aliases: List[torch.Tensor],
                graphs: bool) -> torch.Tensor:
        s, mesh = self.sched, self.mesh
        p, last = s.p, s.P - 1
        trees = self.params_of(aliases)
        x_micro = x.reshape((s.m, x.shape[0] // s.m) + x.shape[1:])
        results = torch.zeros_like(x_micro)
        recv = torch.zeros_like(x_micro[0])
        for t in range(s.ticks):
            live, c, j = s.at(t)
            out = None
            if live or not s.skip:
                inp = x_micro[j] if (p == 0 and c == 0) else recv
                out = self.chunk(inp, c, t, graphs and live
                                 and s.graph_needed(c), trees)
                if live and p == last and c == s.v - 1:
                    results[j] = out
            got = stage_exchange(
                out if s.ships(t, p) else None, mesh.stage_rank(1),
                recv if s.ships(t, (p - 1) % s.P) else None,
                mesh.stage_rank(-1), mesh)
            if got is not None:
                recv = got
        return stage_sum(results, mesh).reshape(x.shape)

    def backward(self, g: torch.Tensor, x_shape, x_grad: bool,
                 aliases: List[torch.Tensor]):
        s, mesh = self.sched, self.mesh
        p, last = s.p, s.P - 1
        g_micro = g.reshape((s.m, x_shape[0] // s.m) + tuple(x_shape[1:]))
        grads = [torch.zeros_like(a) for a in aliases]
        gx = torch.zeros_like(g_micro) if x_grad else None
        d_out = None  # the cotangent of this rank's output at tick t
        for t in reversed(range(s.ticks)):
            _, c, j = s.at(t)
            g_in = None
            if t in self.saved:
                h0, h = self.saved.pop(t)
                d = g_micro[j] if (p == last and c == s.v - 1) else d_out
                inputs = ([h0] if h0.requires_grad else []) + aliases
                # A block function that leaves the trainable leaves unused
                # gives an output without a graph: zero cotangents.
                got = (list(torch.autograd.grad(h, inputs, d,
                                                allow_unused=True))
                       if h.requires_grad else
                       [torch.zeros_like(a) for a in inputs])
                if h0.requires_grad:
                    g_in = got.pop(0)
                    if p == 0 and c == 0:
                        gx[j] += g_in
                for acc, gi in zip(grads, got):
                    if gi is not None:
                        acc += gi
            if t == 0:
                break
            # Tick t's input came over the previous stage's transfer of
            # tick t - 1; this rank's output of tick t - 1 went on over
            # its own.
            d_out = stage_exchange(
                g_in if s.carries_grad(t - 1, (p - 1) % s.P) else None,
                mesh.stage_rank(-1),
                g_micro[0] if s.carries_grad(t - 1, p) else None,
                mesh.stage_rank(1), mesh)
        return None if gx is None else gx.reshape(x_shape), grads


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _Run, x, *leaves):
        aliases = [a.detach().requires_grad_() for a in leaves]
        ctx.run, ctx.aliases, ctx.x_shape = run, aliases, x.shape
        return run.forward(x, aliases, graphs=True)

    @staticmethod
    def backward(ctx, g):
        gx, grads = ctx.run.backward(g, ctx.x_shape, ctx.needs_input_grad[1],
                                     ctx.aliases)
        return (None, gx, *grads)


def pipeline_blocks(
    x: torch.Tensor,
    stacked_params: Params,
    block_fn: Callable,
    mesh,
    num_microbatches: int = 0,
    skip_bubbles: bool = False,
    num_chunks: int = 1,
    frozen_blocks: int = 0,
) -> torch.Tensor:
    """Run a depth-stacked block sequence as a pipeline over `mesh`'s
    stages (the JAX package's `pipeline_blocks` over its stage axis).

    Args:
      x: [B, ...] this data rank's input activations (the same on every
        stage and model rank of its line).
      stacked_params: nested dicts whose leaves have a leading depth dim
        L (the whole stack, on every rank); L must divide into stages x
        num_chunks equal chunks. Leaves that require a gradient get one:
        this rank's blocks' rows, zero elsewhere.
      block_fn: (x, one block's params) -> x, the sequential path's body.
      num_microbatches: microbatch count m (0: the stage count); this
        rank's batch must divide by it, and under num_chunks > 1 m must
        be a multiple of the stage count.
      skip_bubbles: skip the bubble ticks' compute and transfers (the
        default computes them, as JAX does; the values are equal).
      num_chunks: chunks a stage (v): 1 is GPipe, v > 1 the interleaved
        schedule with a v-times smaller bubble.
      frozen_blocks: the first blocks' params take no gradient.

    Returns:
      [B, ...] the output activations, on every stage.
    """
    n_stages = mesh.stage_size
    leaves = _leaves(stacked_params)
    depth = leaves[0].shape[0]
    m = check_schedule(depth, n_stages, num_chunks, num_microbatches)
    b = x.shape[0] * mesh.data_size
    if x.shape[0] % m != 0:
        raise ValueError(
            f"batch {b} not divisible by data shards x microbatches "
            f"({mesh.data_size} x {m})"
        )
    grad = torch.is_grad_enabled()
    trainable = [grad and a.requires_grad for a in leaves]
    frozen = min(max(frozen_blocks, 0), depth)
    trains = any(trainable) and frozen < depth
    x_grad = grad and x.requires_grad
    grad_from = 0 if x_grad else (frozen + 1 if trains else depth + 1)
    sched = _Schedule(depth, n_stages, num_chunks, m, mesh.stage_index,
                      skip_bubbles, grad_from)
    run = _Run(sched, block_fn, mesh, stacked_params, trainable, frozen)
    if grad_from > depth:
        return run.forward(x, [], graphs=False)
    return _Pipeline.apply(run, x, *[a for a, t in zip(leaves, trainable)
                                     if t])
