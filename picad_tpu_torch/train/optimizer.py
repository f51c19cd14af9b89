"""Optimizer + LR scheduling (counterpart of picad_tpu/train/optimizer.py).

- Adam(lr, eps=1e-6) as the reference (main_ucf101.py:416); AdamW when
  `weight_decay` is set.  torch's Adam update lr * m_hat / (sqrt(v_hat)
  + eps) is optax's adam with eps_root = 0, which the JAX package uses.
- On a card the update is torch's fused one, capturable, with the
  learning rate a 0-d f32 tensor on the card (`FusedAdam`, `FusedAdamW`),
  so that a CUDA graph of the train step (train/graph.py) holds the
  update and reads the live rate at each replay.  On the CPU, and inside
  a process group (whose step stays eager), it is plain Adam with a
  float rate.
- `ReduceLROnPlateau` is the port's own copy of the JAX package's
  host-side scheduler (torch semantics: mode 'min', relative threshold
  1e-4, patience 5, factor 0.1, min_lr 1e-7; main_ucf101.py:417), whose
  three counters the train state carries.
"""

from __future__ import annotations

from typing import Iterable

import torch

from picad_tpu_torch.parallel import mesh


class _TensorLR:
    """Adam or AdamW, fused, with each group's lr a 0-d f32 tensor on the
    parameters' device (and capturable on a card).  Its state_dict is
    plain Adam's: lr a float, fused and capturable off, each `step` a CPU
    tensor, so that a checkpoint, or bench/check.py's CPU reference, loads
    into a plain Adam.  load_state_dict takes either form and copies into
    the live tensors (lr, moments, steps) in place, where a captured
    graph keeps reading them."""

    def state_dict(self) -> dict:
        sd = super().state_dict()
        for g in sd["param_groups"]:
            g.update(lr=float(g["lr"]), fused=None, capturable=False)
        states = sd["state"]
        steps = torch.stack([s["step"] for s in states.values()]).cpu() if states else None
        # new dicts: super() hands out the live per-parameter ones
        sd["state"] = {k: {**s, "step": steps[i].clone()} for i, (k, s) in enumerate(states.items())}
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        lrs = [g["lr"] for g in self.param_groups]
        live = {p: dict(s) for p, s in self.state.items()}
        capturable = self.param_groups[0]["capturable"]
        super().load_state_dict(state_dict)
        for g, lr in zip(self.param_groups, lrs):
            lr.copy_(torch.as_tensor(g["lr"], dtype=torch.float32))
            g.update(lr=lr, fused=True, capturable=capturable)
        for p, s in self.state.items():
            for k, v in s.items():
                v = v.to(device=p.device, dtype=torch.float32 if k == "step" else v.dtype)
                old = live.get(p, {}).get(k)
                if old is not None and old.shape == v.shape and old.dtype == v.dtype:
                    s[k] = old.copy_(v)
                else:
                    s[k] = v


class FusedAdam(_TensorLR, torch.optim.Adam):
    pass


class FusedAdamW(_TensorLR, torch.optim.AdamW):
    pass


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-4, *,
                   eps: float = 1e-6, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    """Adam (AdamW with `weight_decay`) over `params`: on a card
    FusedAdam/FusedAdamW, capturable, whose lr is a 0-d tensor there; on
    the CPU or inside a process group plain Adam with a float lr."""
    params = list(params)
    dev = params[0].device
    kw = dict(eps=eps) | (dict(weight_decay=weight_decay) if weight_decay else {})
    if dev.type != "cuda" or mesh.is_active():
        return (torch.optim.AdamW if weight_decay else torch.optim.Adam)(params, lr=lr, **kw)
    return (FusedAdamW if weight_decay else FusedAdam)(
        params, lr=torch.tensor(lr, dtype=torch.float32, device=dev), fused=True,
        capturable=True, **kw)


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
