"""Deformable attention sampling (counterpart of
dinov2_od_tpu/ops/deformable.py).

Offsets and attention weights are linear projections of the query;
sampling locations are clip(reference + offset, 0, 1) scaled to pixel
coordinates; bilinear interpolation over the 4 clipped corner indices,
with weights from the unclipped floor; softmax weights over the points.
The JAX package samples with a one-hot matmul because TPU gathers are
slow; on a GPU one batched gather of the four corners is the direct form.
Corners that clip onto the same cell accumulate in both.

Under a mesh (parallel/) each rank samples its `n_heads / tp` heads: the
value projection is column-parallel, the output projection row-parallel
(one all-reduce), and the replicated offset and weight projections are
sliced to the rank's heads' columns.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..models.layers import Params
from ..parallel.collectives import copy_to_model, reduce_from_model
from ..parallel.sharding import local_slice, model_size


class DeformableParams(NamedTuple):
    """Projection weights of one deformable attention module.

    Shapes (D = model dim, H = heads, P = points):
      offsets: kernel [D, H*P*2], bias [H*P*2]
      weights: kernel [D, H*P], bias [H*P]
      value / output: kernel [D, D], bias [D]
    """

    offsets_kernel: torch.Tensor
    offsets_bias: torch.Tensor
    weights_kernel: torch.Tensor
    weights_bias: torch.Tensor
    value_kernel: torch.Tensor
    value_bias: torch.Tensor
    output_kernel: torch.Tensor
    output_bias: torch.Tensor


def init_deformable_params(gen: torch.Generator, d_model: int, n_heads: int,
                           n_points: int, device) -> Params:
    """Offsets and weights zero, projections Xavier-uniform with zero
    bias (the JAX package's init). Returned as a dict of the
    DeformableParams fields, as the decoder's param tree holds it."""
    bound = math.sqrt(6.0 / (2 * d_model))

    def xavier():
        t = torch.empty((d_model, d_model)).uniform_(-bound, bound,
                                                     generator=gen)
        return t.to(device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    hp = n_heads * n_points
    return DeformableParams(
        offsets_kernel=zeros(d_model, hp * 2),
        offsets_bias=zeros(hp * 2),
        weights_kernel=zeros(d_model, hp),
        weights_bias=zeros(hp),
        value_kernel=xavier(),
        value_bias=zeros(d_model),
        output_kernel=xavier(),
        output_bias=zeros(d_model),
    )._asdict()


def bilinear_gather(
    values: torch.Tensor,
    loc_x: torch.Tensor,
    loc_y: torch.Tensor,
    spatial_shape: Tuple[int, int],
) -> torch.Tensor:
    """Bilinear sampling of per-head value maps at fractional pixel coords.

    Args:
      values: [B, HW, H, Dh] flattened per-head feature map.
      loc_x, loc_y: [B, Q, H, P] pixel coordinates (already scaled).
      spatial_shape: (h, w) with h * w == HW.

    Returns:
      [B, Q, H, P, Dh] sampled features.
    """
    h, w = spatial_shape
    b, q, nh, p = loc_x.shape
    dh = values.shape[-1]

    x0 = torch.floor(loc_x)
    y0 = torch.floor(loc_y)
    # Interpolation weights use the unclipped floor.
    wx1 = loc_x - x0
    wx0 = 1.0 - wx1
    wy1 = loc_y - y0
    wy0 = 1.0 - wy1
    x0 = x0.long()
    y0 = y0.long()
    x0c, x1c = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    y0c, y1c = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)

    # The four corners in one gather: [B, Q, H, P, 4] -> [B, H, 4*Q*P].
    idx = torch.stack(
        [y0c * w + x0c, y1c * w + x0c, y0c * w + x1c, y1c * w + x1c], dim=-1
    )
    wgt = torch.stack([wx0 * wy0, wx0 * wy1, wx1 * wy0, wx1 * wy1], dim=-1)
    idx = idx.permute(0, 2, 1, 3, 4).reshape(b, nh, q * p * 4, 1)
    values_t = values.permute(0, 2, 1, 3)  # [B, H, HW, Dh]
    g = torch.gather(values_t, 2, idx.expand(b, nh, q * p * 4, dh))
    g = g.reshape(b, nh, q, p, 4, dh).permute(0, 2, 1, 3, 4, 5)
    return (g * wgt[..., None].to(g.dtype)).sum(dim=4)


def deformable_attention(
    query: torch.Tensor,
    reference_points: torch.Tensor,
    memory: torch.Tensor,
    spatial_shape: Tuple[int, int],
    params: DeformableParams,
    n_heads: int,
    n_points: int,
    mesh=None,
) -> torch.Tensor:
    """Deformable cross-attention.

    Args:
      query: [B, Q, D]
      reference_points: [B, Q, 2] normalized (x, y) in [0, 1].
      memory: [B, HW, D] flattened feature map.
      spatial_shape: (h, w).
      mesh: a process mesh whose model axis splits the heads (params: this
        rank's shard); None runs whole.

    Returns:
      [B, Q, D]
    """
    h, w = spatial_shape
    b, q, d = query.shape
    tp = model_size(mesh)
    dh = d // n_heads
    off_k, off_b = params.offsets_kernel, params.offsets_bias
    wt_k, wt_b = params.weights_kernel, params.weights_bias
    if tp > 1:
        n_heads //= tp
        query = copy_to_model(query, mesh)
        reference_points = copy_to_model(reference_points, mesh)
        memory = copy_to_model(memory, mesh)
        # The replicated projections' columns of this rank's heads
        # (head-major: head, point[, xy]).
        off = local_slice(off_b.shape[0], mesh)
        wt = local_slice(wt_b.shape[0], mesh)
        off_k, off_b = off_k[:, off], off_b[off]
        wt_k, wt_b = wt_k[:, wt], wt_b[wt]

    offsets = (query @ off_k + off_b).reshape(b, q, n_heads, n_points, 2)
    weights = (query @ wt_k + wt_b).reshape(b, q, n_heads, n_points)
    weights = torch.softmax(weights, dim=-1)
    values = (memory @ params.value_kernel + params.value_bias).reshape(
        b, -1, n_heads, dh
    )

    loc = torch.clamp(reference_points[:, :, None, None, :] + offsets,
                      0.0, 1.0)
    loc_x = loc[..., 0] * (w - 1)
    loc_y = loc[..., 1] * (h - 1)

    sampled = bilinear_gather(values, loc_x, loc_y, (h, w))
    out = (sampled * weights[..., None]).sum(dim=3)  # [B, Q, H, Dh]
    out = out.reshape(b, q, n_heads * dh) @ params.output_kernel
    return reduce_from_model(out, mesh) + params.output_bias


def factor_spatial_shape(hw: int) -> Tuple[int, int]:
    """(h, w) grid of a flattened length: a perfect square if possible,
    else the closest factor pair with h <= w."""
    root = int(hw**0.5)
    if root * root == hw:
        return (root, root)
    for i in range(root, 0, -1):
        if hw % i == 0:
            return (i, hw // i)
    return (root, root)
