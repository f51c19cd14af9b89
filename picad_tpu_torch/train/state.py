"""Train state (counterpart of picad_tpu/train/state.py): the model (its
parameters and BN running stats), the optimizer, the dropout generator,
the step and epoch counts, and the ReduceLROnPlateau counters."""

from __future__ import annotations

import dataclasses

import torch

from picad_tpu_torch._device import resolve_device
from picad_tpu_torch.models.capsules import CapsNet, build_train_capsnet
from picad_tpu_torch.train.optimizer import make_optimizer


@dataclasses.dataclass
class TrainState:
    model: CapsNet
    optimizer: torch.optim.Optimizer
    generator: torch.Generator  # dropout masks, on the model's device
    step: int = 0
    epoch: int = 0  # last completed epoch (for resume)
    # ReduceLROnPlateau counters (train/optimizer.py), for a resumed run
    # to keep its patience window
    sched_best: float = float("inf")
    sched_bad: int = 0
    sched_cooldown: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(
    *,
    state_dict=None,
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    seed: int = 0,
    device=None,
    **model_kwargs,
) -> TrainState:
    """A fresh train state on `device` (default: the CUDA card): the
    train-mode CapsNet of `build_train_capsnet` (weights from
    `state_dict` or seeded with `seed`; `model_kwargs` are its options,
    e.g. bn_groups, dropout_rate, compute_dtype), the optimizer of
    `make_optimizer`, and the dropout generator, seeded with `seed` on
    the same device."""
    dev = resolve_device(device)
    model = build_train_capsnet(state_dict, seed=seed, device=dev, **model_kwargs)
    optimizer = make_optimizer(model.parameters(), lr, weight_decay=weight_decay)
    generator = torch.Generator(device=dev).manual_seed(seed)
    return TrainState(model, optimizer, generator)
