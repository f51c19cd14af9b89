"""Scalar metrics (reference utils/metrics.py).

The port's copy of picad_tpu/eval/metrics.py: numpy host-side helpers,
and the per-step training accuracy as a torch op (`accuracy_torch`, the
JAX package's `accuracy_jnp`), which stays on the tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch


def get_accuracy(class_scores, labels) -> float:
    """argmax accuracy (reference utils/metrics.py:7-13)."""
    scores = np.asarray(class_scores)
    labels = np.asarray(labels).reshape(-1)
    pred = np.argmax(scores, axis=1)
    return float(np.mean(pred == labels))


def accuracy_torch(class_scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Same as get_accuracy, as a 0-d f32 tensor on the scores' device."""
    pred = class_scores.argmax(dim=1)
    return (pred == labels.reshape(-1)).to(torch.float32).mean()


def get_accuracy2(predictions, targets, threshold: float = 0.5) -> float:
    """Pixel 'f-measure' accuracy (tp+tn)/(all) at a threshold
    (reference utils/metrics.py:16-25)."""
    p = np.asarray(predictions) > threshold
    t = np.asarray(targets).astype(bool)
    tp = np.sum(p & t)
    tn = np.sum(~p & ~t)
    return float((tp + tn) / p.size)


def binary_mask_iou(gt, pred) -> float:
    """Binary-mask IoU; NaN when gt is empty (reference IOU2, metrics.py:171-193).

    The caller filters NaNs exactly like main_ucf101.py:261-266
    (`if iou == iou`).
    """
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    if gt.sum() <= 0:
        return float("nan")
    inter = np.count_nonzero((gt + pred) == 2)
    union = np.count_nonzero(gt + pred)
    return inter / union
