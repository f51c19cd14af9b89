"""Optimizer + LR scheduling (counterpart of picad_tpu/train/optimizer.py).

- Adam(lr, eps=1e-6) as the reference (main_ucf101.py:416); AdamW when
  `weight_decay` is set.  torch's Adam update lr * m_hat / (sqrt(v_hat)
  + eps) is optax's adam with eps_root = 0, which the JAX package uses.
- `ReduceLROnPlateau` is the port's own copy of the JAX package's
  host-side scheduler (torch semantics: mode 'min', relative threshold
  1e-4, patience 5, factor 0.1, min_lr 1e-7; main_ucf101.py:417), whose
  three counters the train state carries.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-4, *,
                   eps: float = 1e-6, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    if weight_decay:
        return torch.optim.AdamW(params, lr=lr, eps=eps, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, eps=eps)


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau('min') semantics."""

    def __init__(self, lr: float, *, factor: float = 0.1, patience: int = 5,
                 min_lr: float = 1e-7, threshold: float = 1e-4, cooldown: int = 0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.cooldown = cooldown
        self.best = float("inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def step(self, metric: float) -> float:
        """Feed an epoch metric; returns the (possibly reduced) LR."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr
