"""Mixture-of-Experts FFN on one process (counterpart of
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

Expert parallelism (experts sharded over the model axis) is ROADMAP.md
Queue A item 7; models/vit.py refuses MoE under a mesh.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch

Params = Dict[str, Any]


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


def moe_routing(logits: torch.Tensor, top_k: int, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity routing from router logits [B, N, E].

    Returns (combine [B, N, E, C] fp32: the renormalised top-k gate of a
    token at its assigned slot, 0 elsewhere and for dropped tokens;
    aux: the fp32 load-balance loss E * sum_e f_e * P_e, f_e the share of
    tokens whose top-1 choice is e and P_e e's mean probability, over
    every token of the batch; 1 at perfect balance)."""
    b, n, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    # Slots are claimed round by round (top-1 choices first), and within a
    # round in token order: a token's position in its expert's list is the
    # exclusive cumsum over the row plus the slots kept in earlier rounds.
    slots = torch.arange(capacity, device=logits.device)
    combine = logits.new_zeros((b, n, e, capacity), dtype=torch.float32)
    counts = torch.zeros((b, e), dtype=torch.int64, device=logits.device)
    experts = torch.arange(e, device=logits.device)
    for j in range(top_k):
        onehot = (gate_idx[..., j, None] == experts).long()  # [B, N, E]
        pos = onehot.cumsum(1) - onehot + counts[:, None, :]
        keep = (pos < capacity) & (onehot > 0)
        slot = (pos[..., None] == slots).float()  # [B, N, E, C]
        combine = combine + (gate_vals[..., j, None, None]
                             * keep[..., None].float() * slot)
        counts = counts + (onehot * keep.long()).sum(1)

    top1 = (gate_idx[..., 0, None] == experts).float()
    f = top1.mean(dim=(0, 1))
    p = probs.mean(dim=(0, 1))
    aux = e * (f * p).sum()
    return combine, aux


def moe_ffn(x: torch.Tensor, mp: Params, *, top_k: int,
            capacity_factor: float,
            activation: Callable[[torch.Tensor], torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward of x [B, N, d]: route, the experts' FFN, combine.

    mp holds router_kernel [d, E], fc1_kernel [E, d, m], fc1_bias [E, m],
    fc2_kernel [E, m, d] and fc2_bias [E, d]; every product runs in x's
    dtype. Returns (out [B, N, d] in x's dtype, aux fp32)."""
    n = x.shape[1]
    e = mp["router_kernel"].shape[-1]
    capacity = moe_capacity(n, e, top_k, capacity_factor)
    dt = x.dtype

    logits = x @ mp["router_kernel"].to(dt)  # [B, N, E]
    combine, aux = moe_routing(logits, top_k, capacity)
    dispatch = (combine > 0).to(dt)

    dispatched = torch.einsum("bnec,bnd->ebcd", dispatch, x)
    h = (torch.einsum("ebcd,edm->ebcm", dispatched, mp["fc1_kernel"].to(dt))
         + mp["fc1_bias"].to(dt)[:, None, None, :])
    h = activation(h)
    out_e = (torch.einsum("ebcm,emd->ebcd", h, mp["fc2_kernel"].to(dt))
             + mp["fc2_bias"].to(dt)[:, None, None, :])
    # The combine weights zero the slots nothing was sent to, so the fc2
    # bias of an empty slot does not reach the output.
    out = torch.einsum("bnec,ebcd->bnd", combine.to(dt), out_e)
    return out, aux


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
