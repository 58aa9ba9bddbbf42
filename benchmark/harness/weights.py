"""The detector's weights, made from the seed on the device.

The tree's keys and shapes are the port's own: its initialiser runs on
PyTorch's meta device, which records shapes and computes nothing. The
dtypes are the configuration's: the frozen backbone weights (the patch
embedding, the CLS token, the position embedding and every block's
linears) in its `backbone_dtype`, the rest in float32. The values
are the benchmark's: one uniform draw per dtype on the card from a
generator seeded with the run's seed, cut into the leaves and scaled by
each leaf's law below. The same seed gives the same tree, so the plain
reference can be handed the weights again after the program has updated
its own in place.

The laws follow the usual initialisers (kernels and biases uniform in
+-1/sqrt(fan_in), LayerNorm scales 1 and biases 0, LayerScale at the
configuration's value, embeddings of scale 0.02), with every LoRA factor
and the deformable projections drawn non-zero, as a checkpoint part-way
through fine-tuning has them, so that every trainable path carries a
gradient from the first step.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import torch

Tree = Dict[str, Any]

# Leaf-name rules, first match wins: (name, law, scale). A law is "one",
# "layerscale", "fan_in" (uniform +-scale/sqrt(fan_in), fan_in
# the product of the leaf's dims but its last; a bias takes its kernel's)
# or "uniform" (uniform +-scale).
_LAWS = (
    ("scale", "one", 1.0),
    ("ls1", "layerscale", 1.0),
    ("ls2", "layerscale", 1.0),
    ("cls_token", "uniform", 0.02 * math.sqrt(3.0)),
    ("pos_embed", "uniform", 0.02 * math.sqrt(3.0)),
    ("router_kernel", "uniform", 0.02 * math.sqrt(3.0)),
    ("query_embed", "uniform", math.sqrt(3.0)),
    ("lora_B", "fan_in", 0.1),
    ("offsets_kernel", "fan_in", 0.1),
    ("offsets_bias", "uniform", 0.05),
)


def _walk(tree: Tree, path=()) -> Iterator[Tuple[tuple, torch.Tensor]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _set(tree: Tree, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


# The frozen backbone leaves stored in the configuration's dtype: the
# kernel and bias of these linears, and these leaves whole.
_FROZEN_LINEARS = ("patch_embed", "q", "k", "v", "proj", "fc1", "fc2")
_FROZEN_LEAVES = ("cls_token", "pos_embed")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def is_frozen(path: tuple) -> bool:
    """A backbone weight that fine-tuning does not train and the
    configuration stores in its `backbone_dtype`."""
    if path[0] != "backbone":
        return False
    if path[-1] in _FROZEN_LEAVES:
        return True
    return (path[-1] in ("kernel", "bias") and len(path) >= 2
            and path[-2] in _FROZEN_LINEARS)


def layout(det_cfg, backbone_dtype: str) -> Tree:
    """The detector's param tree on the meta device: the port's keys and
    shapes, the frozen backbone weights in `backbone_dtype`."""
    from dinov2_od_tpu_torch.models.detector import init_detector_params

    with torch.device("meta"):
        tree = init_detector_params(torch.Generator(), det_cfg,
                                    device="meta")
    out: Tree = {}
    for path, leaf in _walk(tree):
        _set(out, path, leaf.to(_DTYPES[backbone_dtype])
             if is_frozen(path) else leaf)
    return out


def _law(path: tuple, shape, siblings: Dict[str, Any], layerscale: float
         ) -> Tuple[str, float]:
    name = path[-1]
    for rule, law, scale in _LAWS:
        if name == rule:
            if law == "layerscale":
                return "const", layerscale
            if law == "fan_in":
                return "bound", scale / math.sqrt(_fan_in(shape, path))
            return {"one": ("const", 1.0),
                    "uniform": ("bound", scale)}[law]
    if name.endswith("bias"):
        # LayerNorm biases (beside a "scale") start at 0; a linear's bias
        # takes its kernel's fan-in.
        if "scale" in siblings:
            return "const", 0.0
        kernel = siblings.get(name[:-len("bias")] + "kernel")
        if kernel is not None:
            return "bound", 1.0 / math.sqrt(
                _fan_in(kernel.shape, path[:-1] + ("kernel",)))
        return "bound", 0.02
    return "bound", 1.0 / math.sqrt(_fan_in(shape, path))


def _fan_in(shape, path: tuple) -> int:
    """The input width of a kernel [..., in, out]: a stacked leaf's leading
    depth (or expert) axis is not an input, a patch kernel's [p, p, 3, D]
    are."""
    dims = list(shape[:-1])
    if path[-1] == "kernel" and "patch_embed" in path:
        return max(1, math.prod(dims))
    return max(1, dims[-1] if dims else 1)


def make_params(det_cfg, backbone_dtype: str, seed: int, device) -> Tree:
    """The detector's param tree on `device`, drawn from `seed`: a few
    large draws, then one scale a leaf."""
    tree = layout(det_cfg, backbone_dtype)
    leaves = list(_walk(tree))
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    by_dtype: Dict[torch.dtype, int] = {}
    for _, leaf in leaves:
        by_dtype[leaf.dtype] = by_dtype.get(leaf.dtype, 0) + leaf.numel()
    flat = {dt: torch.empty(n, dtype=dt, device=device).uniform_(
                -1.0, 1.0, generator=gen)
            for dt, n in sorted(by_dtype.items(), key=lambda kv: str(kv[0]))}
    offset = {dt: 0 for dt in flat}
    out: Tree = {}
    layerscale = det_cfg.backbone.layerscale_init
    parents: Dict[tuple, Dict[str, Any]] = {}
    for path, leaf in leaves:
        parents.setdefault(path[:-1], {})[path[-1]] = leaf
    for path, leaf in leaves:
        dt, n = leaf.dtype, leaf.numel()
        t = flat[dt][offset[dt]:offset[dt] + n].view(leaf.shape)
        offset[dt] += n
        law, v = _law(path, leaf.shape, parents[path[:-1]], layerscale)
        # A tensor of its own a leaf: views of one buffer would share
        # autograd's version counter between leaves.
        _set(out, path, torch.full_like(t, v) if law == "const" else t * v)
    return out


def leaf_items(tree: Tree):
    """(path, leaf) of every leaf, in key order."""
    return list(_walk(tree))
