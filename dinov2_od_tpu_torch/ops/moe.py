"""Mixture-of-Experts FFN (counterpart of
dinov2_od_tpu/ops/moe.py).

GShard-style capacity routing with static shapes, as the JAX package
does it:

- Each expert has C = ceil(top_k * tokens / experts * capacity_factor)
  slots a batch row; a token routed past its expert's capacity is dropped
  there (a zero combine weight: the residual carries it).
- Routing decisions become one [B, N, E, C] combine tensor; dispatch and
  combine are products with it (`torch.einsum`, i.e. batched GEMMs), not
  scatter-adds, so the backward is deterministic on the card and keeps
  the JAX package's sum structure; the expert FFN is one batched GEMM
  pair over E.
- The gate math is fp32 whatever the activations' dtype; the router
  product itself is taken in the activations' dtype, as in JAX.

The top-k choice is k successive `argmax`es with the chosen expert masked
out: `torch.argmax` returns the first maximal index, which gives
`jax.lax.top_k`'s order on ties (the lower index first). `torch.topk`
does not.

`moe_ffn_plain` computes the same function one token at a time with
Python loops; the tests hold the batched version against it.

Under a process mesh (parallel/), where GSPMD partitions the JAX
package's einsums, `moe_ffn` places the split by hand (one body: on one
process every size is 1 and every collective the identity):

- Expert parallelism over the model axis. Megatron TP keeps the tokens
  replicated over the model group, so no all-to-all is needed: every
  model rank routes all of its rows (the routing is the same on each),
  dispatches to and multiplies only its own E / M experts (its shard of
  the [E, ...] leaves, parallel/sharding.py), and combines a partial sum
  over them, reduced over the model group once, as a row-parallel linear
  is. Only an expert's owner sees its output's cotangent, so the
  router's and x's gradients through the combine are partial there
  (`partial_grad` sums the router's, `copy_to_model` x's); the aux term
  is whole on every model rank, and its path enters that sum 1 / M a
  rank (`aux_once_over_model`).
- Data and context splits. Capacity is per batch row, so a data split
  changes no slot. Under context parallelism a rank holds a contiguous
  shard of every row, and a token's slot is its place in the whole row:
  each top-k round adds the counts of the ring ranks before this one
  (one [B, E] gather a round, `ring_counts`) and the row's slots kept in
  earlier rounds. Capacity comes from the real length; the pad rows of
  the ring (models/vit.py pads the tokens once to a multiple of it)
  claim no slot and enter neither the aux nor the output.
- The aux is the global batch's. E * sum_e f_e * P_e is not linear in
  the per-rank means, so f (no gradient) is summed over the data group
  and the ring, and each rank's term takes its share of P's token sum
  over the global token count: the data group's sum of the ranks' terms
  is the JAX package's aux (the train step sums the loss terms there),
  and P's sum over the ring makes each rank of a ring hold its row's
  whole term, its gradient its own tokens'.

`moe_routing_split_plain` runs the split routing one shard at a time
from a table of every shard's counts, without a world: the tests hold
the ring's slots and the aux terms against the whole row's.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..parallel.collectives import (
    copy_to_model,
    reduce_from_model,
    reduce_from_ring,
    ring_counts,
    sum_over_batch,
)
from ..parallel.sharding import context_size, data_place, model_size

Params = Dict[str, Any]
CountsFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def moe_capacity(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots an expert a batch row of `num_tokens` tokens (the JAX
    package's expression, in its order of operations)."""
    return max(1, math.ceil(top_k * num_tokens / num_experts
                            * capacity_factor))


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, in
    descending order with the lower index first on ties."""
    masked = probs
    idx = []
    for _ in range(k):
        i = masked.argmax(-1)
        idx.append(i)
        # probs are >= 0, so -1 never wins again.
        masked = masked.scatter(-1, i[..., None], -1.0)
    idx = torch.stack(idx, -1)
    return probs.gather(-1, idx), idx


def _whole_row(local: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`route`'s counts of a whole row: no shard before it."""
    return torch.zeros_like(local), local


def route(logits: torch.Tensor, top_k: int, capacity: int,
          valid: Optional[torch.Tensor] = None,
          counts_fn: CountsFn = _whole_row
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k capacity routing of the rows of logits [B, N, E].

    `valid` [N] bool marks the real rows (None: all are); the others
    claim no slot. `counts_fn(local)`, given this shard's choices of one
    round a row and expert ([B, E] int), returns those of the shards
    before it and of the whole row; the default routes a whole row.

    Returns (combine [B, N, E, C] fp32: the renormalised top-k gate of a
    token at its assigned slot, 0 elsewhere and for dropped tokens;
    probs [B, N, E] fp32 and top1 [B, N, E] fp32, the one-hot top-1
    choice, each 0 on the rows that are not real)."""
    b, n, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    # Slots are claimed round by round (top-1 choices first), and within a
    # round in token order: a token's position in its expert's list is the
    # exclusive cumsum over the row (the earlier shards' claims of this
    # round first) plus the slots kept in earlier rounds; the round keeps
    # what the row's total leaves of each expert's capacity.
    slots = torch.arange(capacity, device=logits.device)
    combine = logits.new_zeros((b, n, e, capacity), dtype=torch.float32)
    counts = torch.zeros((b, e), dtype=torch.int64, device=logits.device)
    experts = torch.arange(e, device=logits.device)
    real = None if valid is None else valid[None, :, None].long()
    for j in range(top_k):
        onehot = (gate_idx[..., j, None] == experts).long()  # [B, N, E]
        if real is not None:
            onehot = onehot * real
        before, total = counts_fn(onehot.sum(1))
        pos = onehot.cumsum(1) - onehot + (before + counts)[:, None, :]
        keep = (pos < capacity) & (onehot > 0)
        slot = (pos[..., None] == slots).float()  # [B, N, E, C]
        combine = combine + (gate_vals[..., j, None, None]
                             * keep[..., None].float() * slot)
        counts = counts + torch.minimum(total, capacity - counts)

    top1 = (gate_idx[..., 0, None] == experts).float()
    if real is not None:
        top1, probs = top1 * real, probs * real
    return combine, probs, top1


def load_balance(top1_sum: torch.Tensor, prob_sum: torch.Tensor,
                 n_tokens: int) -> torch.Tensor:
    """E * sum_e f_e * P_e from the top-1 count [E] and a probability sum
    [E] over `n_tokens` tokens (a share of the sum gives that share of the
    loss)."""
    e = top1_sum.shape[-1]
    return e * ((top1_sum / n_tokens) * (prob_sum / n_tokens)).sum()


def moe_routing(logits: torch.Tensor, top_k: int, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity routing from router logits [B, N, E] of whole rows
    (`route`).

    Returns (combine [B, N, E, C] fp32; aux: the fp32 load-balance loss
    E * sum_e f_e * P_e, f_e the share of tokens whose top-1 choice is e
    and P_e e's mean probability, over every token of the batch; 1 at
    perfect balance)."""
    b, n, _ = logits.shape
    combine, probs, top1 = route(logits, top_k, capacity)
    return combine, load_balance(top1.sum(dim=(0, 1)),
                                 probs.sum(dim=(0, 1)), b * n)


def moe_routing_split_plain(logits: torch.Tensor, top_k: int,
                            capacity: int, ring: int, data: int = 1,
                            valid_len: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split routing of a mesh without a world: logits [B, N, E] cut
    into `data` parts of the batch and `ring` contiguous shards of every
    row (N a multiple of `ring`; rows from `valid_len` on are the ring's
    pad), each shard routed on its own (`route`) with the counts of the
    shards before it and of its row read from a table of every shard's
    choices a round.

    Returns (combine [B, N, E, C], the shards' parts in place; the aux
    terms [data, ring] as the ranks of that mesh hold them: f over the
    global batch, P summed over the ring, so every rank of a ring holds
    its data part's whole term, and the sum over the data parts is the
    aux of the real rows)."""
    b, n, e = logits.shape
    w, bw = n // ring, b // data
    seq = n if valid_len is None else valid_len
    experts = torch.arange(e, device=logits.device)
    shards = [[logits[d * bw:(d + 1) * bw, r * w:(r + 1) * w]
               for r in range(ring)] for d in range(data)]
    valid = [torch.arange(r * w, (r + 1) * w, device=logits.device) < seq
             for r in range(ring)]
    # Every shard's choices of each round, a row and an expert.
    table = [[[((_top_k(torch.softmax(x.float(), -1), top_k)[1][..., j, None]
                 == experts) & valid[r][None, :, None]).long().sum(1)
               for j in range(top_k)] for r, x in enumerate(row)]
             for row in shards]
    outs, top1s, probs = [], [], []
    for d in range(data):
        ring_probs = 0
        for r in range(ring):
            rounds = iter(range(top_k))

            def counts_fn(local, d=d, r=r, rounds=rounds):
                j = next(rounds)
                mine = [table[d][s][j] for s in range(ring)]
                return sum(mine[:r], torch.zeros_like(local)), sum(mine)

            c, p, t = route(shards[d][r], top_k, capacity, valid[r],
                            counts_fn)
            outs.append(c)
            top1s.append(t.sum(dim=(0, 1)))
            ring_probs = ring_probs + p.sum(dim=(0, 1))
        probs.append(ring_probs)
    f = sum(top1s)
    n_tokens = b * seq
    aux = torch.stack([load_balance(f, p, n_tokens) for p in probs])
    combine = torch.cat([torch.cat(outs[d * ring:(d + 1) * ring], dim=1)
                         for d in range(data)])
    return combine, aux[:, None].expand(data, ring)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def aux_once_over_model(aux: torch.Tensor, mesh) -> torch.Tensor:
    """The aux term as it is, its gradient divided by the model group's
    size: every model rank holds the whole term, and the router's and the
    input's gradients are summed over that group (their combine path is
    partial there), so the term's path is counted once in the sum."""
    m = model_size(mesh)
    return aux if m == 1 else _ScaleGrad.apply(aux, 1.0 / m)


def moe_ffn(x: torch.Tensor, mp: Params, *, top_k: int,
            capacity_factor: float,
            activation: Callable[[torch.Tensor], torch.Tensor],
            mesh=None, valid_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward of x [B, N, d]: route, the experts' FFN, combine.

    mp holds router_kernel [d, E], fc1_kernel [E, d, m], fc1_bias [E, m],
    fc2_kernel [E, m, d] and fc2_bias [E, d]; every product runs in x's
    dtype. Returns (out [B, N, d] in x's dtype, aux fp32).

    Under `mesh`: x is this rank's rows (its batch slice; under context
    parallelism its shard of every row, of a row padded past `valid_len`
    real tokens), mp this rank's shard (E / M experts under a model axis
    of M); out is x's rows whole, aux this data rank's share of the
    global batch's loss (the data group's sum is the whole), whole over
    the ring and the model group."""
    b, n, _ = x.shape
    e = mp["router_kernel"].shape[-1]
    ring = context_size(mesh)
    seq = n * ring if valid_len is None else valid_len
    capacity = moe_capacity(seq, e, top_k, capacity_factor)
    dt = x.dtype

    x = copy_to_model(x, mesh)
    logits = x @ mp["router_kernel"].to(dt)  # [B, N, E]
    valid, counts_fn = None, _whole_row
    if ring > 1:
        valid = (mesh.context_index * n
                 + torch.arange(n, device=x.device)) < seq
        counts_fn = lambda local: ring_counts(local, mesh)  # noqa: E731
    combine, probs, top1 = route(logits, top_k, capacity, valid, counts_fn)
    n_tokens = b * data_place(mesh)[0] * seq
    aux = load_balance(sum_over_batch(top1.sum(dim=(0, 1)), mesh),
                       reduce_from_ring(probs.sum(dim=(0, 1)), mesh),
                       n_tokens)
    aux = aux_once_over_model(aux, mesh)

    # This rank's experts: the [E / M] shard of the expert leaves.
    e_local = mp["fc1_kernel"].shape[0]
    first = (0 if mesh is None else mesh.model_index) * e_local
    combine = combine[:, :, first:first + e_local]
    out = _experts(x, combine, mp, activation)
    return reduce_from_model(out, mesh), aux


def _experts(x: torch.Tensor, combine: torch.Tensor, mp: Params,
             activation) -> torch.Tensor:
    """Dispatch x [B, N, d] to the slots of `combine` [B, N, E, C], the
    experts' FFN (one batched GEMM pair over E) and the combine."""
    dt = x.dtype
    dispatch = (combine > 0).to(dt)
    dispatched = torch.einsum("bnec,bnd->ebcd", dispatch, x)
    h = (torch.einsum("ebcd,edm->ebcm", dispatched, mp["fc1_kernel"].to(dt))
         + mp["fc1_bias"].to(dt)[:, None, None, :])
    h = activation(h)
    out_e = (torch.einsum("ebcm,emd->ebcd", h, mp["fc2_kernel"].to(dt))
             + mp["fc2_bias"].to(dt)[:, None, None, :])
    # The combine weights zero the slots nothing was sent to, so the fc2
    # bias of an empty slot does not reach the output.
    return torch.einsum("bnec,ebcd->bnd", combine.to(dt), out_e)


def moe_ffn_plain(x: torch.Tensor, mp: Params, *, top_k: int,
                  capacity_factor: float,
                  activation: Callable[[torch.Tensor], torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`moe_ffn` one token at a time in fp32, with Python loops for the
    choice, the slot count and the experts: the tests' oracle."""
    b, n, d = x.shape
    e = mp["router_kernel"].shape[-1]
    capacity = moe_capacity(n, e, top_k, capacity_factor)
    x32 = x.float()
    w = {k: v.float() for k, v in mp.items()}
    probs = torch.softmax((x @ mp["router_kernel"].to(x.dtype)).float(),
                          dim=-1)
    out = torch.zeros((b, n, d), dtype=torch.float32, device=x.device)
    top1_count = torch.zeros(e)
    for bi in range(b):
        choices = []
        for t in range(n):
            p = probs[bi, t].tolist()
            order = sorted(range(e), key=lambda i: (-p[i], i))[:top_k]
            total = max(sum(p[i] for i in order), 1e-9)
            choices.append([(i, p[i] / total) for i in order])
            top1_count[order[0]] += 1
        used = [0] * e
        for j in range(top_k):
            for t in range(n):
                expert, gate = choices[t][j]
                if used[expert] >= capacity:
                    continue
                used[expert] += 1
                h = activation(x32[bi, t] @ w["fc1_kernel"][expert]
                               + w["fc1_bias"][expert])
                y = h @ w["fc2_kernel"][expert] + w["fc2_bias"][expert]
                out[bi, t] += gate * y
    f = top1_count / (b * n)
    aux = e * (f * probs.mean(dim=(0, 1)).cpu()).sum()
    return out, aux
