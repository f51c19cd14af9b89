"""The port's copy of the JAX package's loss configuration
(picad_tpu/config.py:LossConfig), with the same fields and defaults."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class LossConfig:
    loc_loss: str = "dice"  # 'dice' | 'iou'
    const_loss: str = "l2"  # 'l2' (jsd/l1 behave as l2, like the reference)
    wt_loc: float = 1.0
    wt_cls: float = 1.0
    wt_cons: float = 0.1
    # temporal-variance mask (--bv)
    bv: bool = False
    n_frames: int = 3  # variance window (3 or 5), NOT clip length
    predict_maps: bool = False  # sigmoid before the variance mask
    bv_wt: float = 0.5
    # gradient mask (--gv)
    gv: bool = False
    lower_thresh: Optional[float] = None
    upper_thresh: Optional[float] = None
    gv_wt: float = 0.5
    thresh_epoch: int = 11  # pseudo-label switch-on epoch
    spread_m_min: float = 0.2
    spread_m_max: float = 0.9
