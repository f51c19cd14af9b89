"""Loss functions, numerically matched to the reference (utils/losses.py).

Counterpart of picad_tpu/objectives/losses.py, the public API of the
JAX package's objectives:

- `spread_loss` keeps the reference's double `/b` normalization
  (losses.py:33-35): loss = (sum(max(margin - (at - x), 0)^2)/b
  - margin^2) / b, while absloss = sum(max(.9 - (at - x), 0)^2)/b - .81;
  the reference's fixed r = 0 makes margin == m_min.
- `dice_loss` flattens over the whole batch (losses.py:44-57), smooth 1.
- `iou_loss` is the soft-Jaccard counterpart of `dice_loss`, which the
  reference CLI names (`--loc_loss iou`) but never defines.
- `bce_with_logits` is nn.BCEWithLogitsLoss's mean.
- `weighted_mse_loss` (losses.py:74-75) broadcasts as torch does.
- `capsule_margin_loss` is the reference's unused CapsuleLoss
  (losses.py:61-72).
- `weighted_mse_outer`, the gv consistency: the reference broadcasts
  (B, B, ...) before its mean; this gives the same value in O(B) memory,
  mean_{i,j,p}[w[j,p] d[i,p]] = mean_p[mean_j w * mean_i d].  With a
  `row_mask`, inside a process group both batch means are the global
  batch's (parallel/mesh.global_sum).

The train step uses its own masked, globally summed forms of the
supervised losses (train/step.py) and `weighted_mse_outer`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from picad_tpu_torch.parallel.mesh import global_sum


def spread_loss(x: torch.Tensor, target: torch.Tensor, *, m_min: float = 0.2,
                m_max: float = 0.9) -> tuple[torch.Tensor, torch.Tensor]:
    """Margin-based spread loss over class scores x (B, C) and int
    labels target (B,) -> (loss, absloss) scalars (losses.py:14-37, r = 0)."""
    b = x.shape[0]
    margin = m_min + (m_max - m_min) * 0.0
    at = x.gather(1, target.long().reshape(b, 1))  # (B, 1)
    absloss = torch.clamp(0.9 - (at - x), min=0.0) ** 2
    loss = torch.clamp(margin - (at - x), min=0.0) ** 2
    absloss = absloss.sum() / b - 0.9**2
    loss = (loss.sum() / b - margin**2) / b  # the reference's second /b (losses.py:35)
    return loss, absloss


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """1 - Dice over the sigmoid of logits, flattened over the batch."""
    inputs = torch.sigmoid(logits).reshape(-1)
    targets = targets.reshape(-1)
    intersection = (inputs * targets).sum()
    return 1.0 - (2.0 * intersection + smooth) / (inputs.sum() + targets.sum() + smooth)


def iou_loss(logits: torch.Tensor, targets: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Soft-Jaccard loss (the reference's missing `IoULoss`)."""
    inputs = torch.sigmoid(logits).reshape(-1)
    targets = targets.reshape(-1)
    intersection = (inputs * targets).sum()
    union = inputs.sum() + targets.sum() - intersection
    return 1.0 - (intersection + smooth) / (union + smooth)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits (nn.BCEWithLogitsLoss)."""
    return F.binary_cross_entropy_with_logits(logits, targets)


def weighted_mse_loss(input: torch.Tensor, target: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """(weight * (input - target)^2).mean() with broadcasting (losses.py:74-75)."""
    return (weight * (input - target) ** 2).mean()


def capsule_margin_loss(labels: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """The reference's unused CapsuleLoss (losses.py:61-72)."""
    left = torch.relu(0.9 - classes) ** 2
    right = torch.relu(classes - 0.1) ** 2
    return (labels * left + 0.5 * (1.0 - labels) * right).sum()


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
