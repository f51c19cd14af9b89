"""The consistency loss of the gv path (counterpart of
picad_tpu/objectives/losses.py:weighted_mse_outer).

The reference's gv consistency broadcasts (B, B, ...) before its mean;
`weighted_mse_outer` gives the same value in O(B) memory:
mean_{i,j,p}[w[j,p] d[i,p]] = mean_p[mean_j w * mean_i d].  With a
`row_mask`, inside a process group both batch means are the global
batch's (parallel/mesh.global_sum).  The step's
supervised losses are its masked forms (train/step.py).
"""

from __future__ import annotations

import torch

from picad_tpu_torch.parallel.mesh import global_sum


def weighted_mse_outer(input: torch.Tensor, target: torch.Tensor, weight: torch.Tensor,
                       row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The reference gv path's value without the B^2 blow-up; `row_mask`
    ((B,), 1 = real row) restricts both batch means to real rows."""
    d = (input - target) ** 2
    d = d.reshape(d.shape[0], *weight.shape[1:])
    if row_mask is None:
        return (weight.mean(dim=0) * d.mean(dim=0)).mean()
    rm = row_mask.reshape(-1, *([1] * (weight.ndim - 1)))
    n = torch.clamp(global_sum(row_mask.sum()), min=1.0)
    return (global_sum((weight * rm).sum(dim=0)) / n * (global_sum((d * rm).sum(dim=0)) / n)).mean()
