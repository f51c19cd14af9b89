"""The consistency-weight ramp (reference utils/ramp_ups.py:15-24).

The port's own copy of `exp_rampup` from picad_tpu/objectives/ramp_ups.py,
the schedule every reference config uses (main_ucf101.py:419).  The
reference's other, unused schedules come with the Trainer slice
(ROADMAP.md).
"""

from __future__ import annotations

import math


def exp_rampup(rampup_length: float):
    """exp(-5 (1 - e/L)^2) for e < L, else 1 (arXiv:1610.02242)."""

    def schedule(epoch: float) -> float:
        if epoch < rampup_length:
            epoch = min(max(epoch, 0.0), rampup_length)
            phase = 1.0 - epoch / rampup_length
            return float(math.exp(-5.0 * phase * phase))
        return 1.0

    return schedule
