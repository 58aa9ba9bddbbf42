"""Shared neural-net primitives as plain functions over param dicts.

Counterpart of dinov2_od_tpu/models/layers.py. Linear kernels are stored
`[in, out]` as in the JAX package, so `x @ kernel` is the forward and the
bridge (params.py) copies leaves without transposing. Initialisers follow
the torch defaults (nn.Linear kaiming-uniform bound; LoRA A default-init,
B zero) and draw from an explicit `torch.Generator`; they make the port's
own random models. The parity tests instead carry the JAX package's
initial values across, since the two frameworks' generators differ.

Under tensor parallelism (parallel/) a column-parallel linear is `linear`
on this rank's shard after `copy_to_model`, and a row-parallel one is
`row_linear`: the partial product summed over the model group, then the
replicated bias.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..parallel.collectives import reduce_from_model
from ..parallel.sharding import keep_mask, model_size
from .quantize import int8_linear

Params = Dict[str, torch.Tensor]


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's `dtype` string."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return _DTYPES[name]


def stack_params(trees):
    """Stack per-layer param trees along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: stack_params([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def index_params(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i's params out of a stacked tree (views, no copies)."""
    return {k: (index_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    another; a CUDA request without a card raises instead of running on
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# Initializers (drawn on the CPU from `gen`, then moved to `device`)
# ---------------------------------------------------------------------------

def _uniform(gen, shape, bound, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32)
    t.uniform_(-bound, bound, generator=gen)
    return t.to(device)


def torch_linear_init(gen, in_dim: int, out_dim: int, device) -> Params:
    """nn.Linear default: W, b ~ U(-1/sqrt(in), 1/sqrt(in))."""
    bound = 1.0 / math.sqrt(in_dim)
    return {
        "kernel": _uniform(gen, (in_dim, out_dim), bound, device),
        "bias": _uniform(gen, (out_dim,), bound, device),
    }


def xavier_linear_init(gen, in_dim: int, out_dim: int, device) -> Params:
    bound = math.sqrt(6.0 / (in_dim + out_dim))
    return {
        "kernel": _uniform(gen, (in_dim, out_dim), bound, device),
        "bias": torch.zeros((out_dim,), device=device),
    }


def trunc_normal_init(gen, shape, device, std: float = 0.02) -> torch.Tensor:
    """std * N(0, 1) truncated to +-2 standard deviations."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
    return t.to(device)


def layernorm_init(dim: int, device) -> Params:
    return {
        "scale": torch.ones((dim,), device=device),
        "bias": torch.zeros((dim,), device=device),
    }


def lora_init(gen, in_dim: int, out_dim: int, r: int, device) -> Params:
    """LoRA pair: A nn.Linear-default init, B zeros."""
    return {
        "lora_A": _uniform(gen, (in_dim, r), 1.0 / math.sqrt(in_dim), device),
        "lora_B": torch.zeros((r, out_dim), device=device),
    }


# ---------------------------------------------------------------------------
# Apply functions
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    if "kernel_q" in p:  # int8 params (models/quantize.py)
        return int8_linear(x, p)
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def row_linear(x: torch.Tensor, p: Params, mesh=None) -> torch.Tensor:
    """A row-parallel linear: x holds this rank's input columns and p this
    rank's kernel rows; the partial products summed over the model group,
    then the replicated bias added once. `linear` without a mesh."""
    if model_size(mesh) == 1:
        return linear(x, p)
    return (reduce_from_model(x @ p["kernel"].to(x.dtype), mesh)
            + p["bias"].to(x.dtype))


def lora_linear(x: torch.Tensor, p: Params, alpha: float) -> torch.Tensor:
    """Frozen base linear + alpha * B(A(x)); the scaling is `alpha`, not
    alpha / r."""
    out = linear(x, p)
    if "lora_A" in p:
        delta = (x @ p["lora_A"].to(x.dtype)) @ p["lora_B"].to(x.dtype)
        out = out + alpha * delta
    return out


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with fp32 statistics (population variance) for any x
    dtype; the result is cast back to x's dtype."""
    y = F.layer_norm(
        x.float(), (x.shape[-1],), p["scale"].float(), p["bias"].float(), eps
    )
    return y.to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            deterministic: bool, mesh=None,
            shard_dim: Optional[int] = None) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale it by 1/(1 - rate). Identity when deterministic, at rate 0 or
    without a generator (on x's device) to draw the mask from. Under a
    mesh the mask is this rank's part of the global one (`keep_mask`);
    `shard_dim` names a dim of x split over the model axis."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = keep_mask(x.shape, keep, generator, x.device, mesh, shard_dim)
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


def fold_lora(p: Params, alpha: float) -> Params:
    """W' = W + alpha * A @ B, so the adapted linear is one matmul."""
    if "lora_A" not in p:
        return p
    return {
        "kernel": p["kernel"] + alpha * (p["lora_A"] @ p["lora_B"]),
        "bias": p["bias"],
    }
