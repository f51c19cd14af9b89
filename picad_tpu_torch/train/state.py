"""Train state (counterpart of picad_tpu/train/state.py): the model (its
parameters and BN running stats), the optimizer, the dropout generator,
the step and epoch counts, and the ReduceLROnPlateau counters."""

from __future__ import annotations

import dataclasses

import torch

from picad_tpu_torch._device import resolve_device
from picad_tpu_torch.models.capsules import CapsNet, build_train_capsnet
from picad_tpu_torch.parallel import mesh
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

    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    def with_learning_rate(self, lr: float) -> "TrainState":
        """Set the live learning rate of every parameter group."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return self

    def with_scheduler(self, scheduler) -> "TrainState":
        """Mirror a ReduceLROnPlateau's counters into the state."""
        self.sched_best = float(scheduler.best)
        self.sched_bad = int(scheduler.num_bad_epochs)
        self.sched_cooldown = int(scheduler.cooldown_counter)
        return self

    def load_scheduler(self, scheduler) -> None:
        """Restore a ReduceLROnPlateau's counters and live LR from the
        state (call after a checkpoint restore)."""
        scheduler.best = self.sched_best
        scheduler.num_bad_epochs = self.sched_bad
        scheduler.cooldown_counter = self.sched_cooldown
        scheduler.lr = self.learning_rate()


def create_train_state(
    *,
    state_dict=None,
    lr: float = 1e-4,
    weight_decay: float = 0.0,
    eps: float = 1e-6,
    seed: int = 0,
    device=None,
    **model_kwargs,
) -> TrainState:
    """A fresh train state on `device` (default: the CUDA card): the
    train-mode CapsNet of `build_train_capsnet` (weights from
    `state_dict` or seeded with `seed`; `model_kwargs` are its options,
    e.g. bn_groups, dropout_rate, compute_dtype), the optimizer of
    `make_optimizer` (Adam with `eps`; AdamW with `weight_decay`), and
    the dropout generator, seeded with `seed` on the same device.

    Inside a process group every rank builds the same weights from
    `seed`, and its dropout generator is seeded from (seed, rank)
    (`mesh.rank_seed`; rank 0 keeps `seed`)."""
    dev = resolve_device(device)
    model = build_train_capsnet(state_dict, seed=seed, device=dev, **model_kwargs)
    optimizer = make_optimizer(model.parameters(), lr, eps=eps, weight_decay=weight_decay)
    generator = torch.Generator(device=dev).manual_seed(mesh.rank_seed(seed, mesh.rank()))
    return TrainState(model, optimizer, generator)


def broadcast_model(state: TrainState) -> TrainState:
    """Every rank takes rank 0's parameters and BN running stats (after a
    load that each rank made from its own copy of a file, such as
    --pretrained_i3d): the ranks start equal.  Nothing without a group."""
    mesh.broadcast_tensors(list(state.model.parameters()) + list(state.model.buffers()))
    return state
