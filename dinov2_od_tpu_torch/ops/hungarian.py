"""Exact min-cost assignment of GT slots to queries (counterpart of
dinov2_od_tpu/ops/hungarian.py).

The JAX package solves on the device with Jonker-Volgenant shortest
augmenting paths in `lax.while_loop`s. Eager PyTorch would turn those
loops into thousands of tiny launches, each with a host sync, so the port
solves where the original PyTorch matcher did: the `[B, Q, G]` cost is
built on the card, copied to the host once per criterion call, and
`scipy.optimize.linear_sum_assignment` solves each image's valid GT rows.
The result goes back to the device in one copy. Both solvers are exact,
so they reach the same total cost; ties may break differently.
"""

from __future__ import annotations

import numpy as np
import torch


def hungarian_assign_batched(cost: torch.Tensor,
                             gt_valid: torch.Tensor) -> torch.Tensor:
    """Optimal query for each valid GT slot, image by image.

    Args:
      cost: [B, Q, G] finite matching cost (any device).
      gt_valid: [B, G] bool.

    Returns:
      query_of_gt [B, G] int64 on cost's device: the query matched to each
      GT slot, -1 for invalid slots and for valid ones left unmatched
      (an image with more valid GT than queries).
    """
    from scipy.optimize import linear_sum_assignment

    with torch.profiler.record_function("matcher_host_solve"):
        cost_np = cost.detach().float().cpu().numpy()
        valid_np = gt_valid.detach().cpu().numpy().astype(bool)
        out = np.full(valid_np.shape, -1, np.int64)
        for b in range(cost_np.shape[0]):
            gts = np.nonzero(valid_np[b])[0]
            if gts.size == 0:
                continue
            rows, cols = linear_sum_assignment(cost_np[b][:, gts].T)
            out[b, gts[rows]] = cols
        return torch.from_numpy(out).to(cost.device)
