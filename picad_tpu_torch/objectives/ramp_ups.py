"""Consistency-weight ramp schedules (reference utils/ramp_ups.py:3-64).

The port's own copy of picad_tpu/objectives/ramp_ups.py: host-side
scalar schedules.  The active one in all reference configs is
`exp_rampup(num_epochs)` (main_ucf101.py:419).
"""

from __future__ import annotations

import math


def pseudo_rampup(t1: float, t2: float):
    def schedule(epoch: float) -> float:
        if epoch > t1:
            alpha = (epoch - t1) / (t2 - t1)
            if epoch > t2:
                alpha = 1.0
        else:
            alpha = 0.0
        return alpha

    return schedule


def exp_rampup(rampup_length: float):
    """exp(-5 (1 - e/L)^2) for e < L, else 1 (arXiv:1610.02242)."""

    def schedule(epoch: float) -> float:
        if epoch < rampup_length:
            epoch = min(max(epoch, 0.0), rampup_length)
            phase = 1.0 - epoch / rampup_length
            return float(math.exp(-5.0 * phase * phase))
        return 1.0

    return schedule


def linear_rampup(rampup_length: float):
    def schedule(epoch: float) -> float:
        if epoch < rampup_length:
            return epoch / rampup_length
        return 1.0

    return schedule


def exp_rampdown(rampdown_length: float, num_epochs: float):
    def schedule(epoch: float) -> float:
        if epoch >= (num_epochs - rampdown_length):
            ep = 0.5 * (epoch - (num_epochs - rampdown_length))
            return float(math.exp(-(ep * ep) / rampdown_length))
        return 1.0

    return schedule


def cosine_rampdown(rampdown_length: float, num_epochs: float):
    def schedule(epoch: float) -> float:
        if epoch >= (num_epochs - rampdown_length):
            ep = 0.5 * (epoch - (num_epochs - rampdown_length))
            return float(0.5 * (math.cos(math.pi * ep / rampdown_length) + 1))
        return 1.0

    return schedule


def exp_warmup(rampup_length: float, rampdown_length: float, num_epochs: float):
    up = exp_rampup(rampup_length)
    down = exp_rampdown(rampdown_length, num_epochs)

    def schedule(epoch: float) -> float:
        return up(epoch) * down(epoch)

    return schedule
