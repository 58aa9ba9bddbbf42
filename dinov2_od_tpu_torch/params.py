"""Bridge between the JAX package's param tree and the port's.

The port keeps the JAX layouts on purpose, so the bridge is a leaf-wise
copy that changes no shape:

- backbone block leaves stay stacked `[depth, ...]`;
- `patch_embed.kernel` stays HWIO `[p, p, 3, D]`; the port's backbone
  reshapes it to the same `(py, px, c)`-ordered patch GEMM as the JAX
  one;
- decoder layers stay stacked `[num_layers, ...]`;
- each layer's `deform` dict holds the DeformableParams fields by name;
- linear kernels stay `[in, out]`.

Nested dicts map to nested dicts and arrays to tensors. bf16 arrays (the
`bfloat16` numpy dtype that JAX arrays carry) become bf16 tensors;
`params_to_numpy` returns them as fp32 arrays (exact), since numpy itself
has no bf16. An int8 tree (models/quantize.py: int8 `kernel_q`, fp32
`w_scale`) crosses with its dtypes kept, both ways; its `kernel_q` leaves
are laid out K-major on the way in, as `quantize_linear` stores them (the
same values and shape: the layout the int8 GEMMs read in place).

Under tensor parallelism `params_from_numpy(tree, mesh=...)` gives this
rank's shard (parallel/sharding.py `shard_params`); `gather_params` gives
the full tree back.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .models.layers import resolve_device
from .models.quantize import k_major
from .parallel.sharding import shard_params


def _to_tensor(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device, torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_numpy(tree: Mapping[str, Any], device="cuda", mesh=None):
    """The JAX param tree (numpy or JAX arrays as leaves) as the port's
    param tree of tensors on `device` (CUDA unless the caller asks for
    the CPU; raises when CUDA is absent); this rank's shard of it under
    `mesh`."""
    dev = resolve_device(device)
    full = _from_numpy(tree, dev)
    return full if mesh is None else shard_params(full, mesh)


def _from_numpy(tree, dev):
    if isinstance(tree, Mapping):
        return {k: (k_major(_from_numpy(v, dev)) if k == "kernel_q"
                    else _from_numpy(v, dev)) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):  # a NamedTuple such as DeformableParams
        return _from_numpy(tree._asdict(), dev)
    return _to_tensor(tree, dev)


def params_to_numpy(tree):
    """The port's param tree as nested dicts of numpy arrays (bf16 leaves
    as fp32), copied: later in-place updates of the tensors do not reach
    them."""
    if isinstance(tree, Mapping):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.array(t.numpy(), copy=True)
