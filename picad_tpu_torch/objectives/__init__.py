"""Loss and schedule library (counterpart of picad_tpu/objectives)."""

from picad_tpu_torch.objectives.losses import (
    bce_with_logits,
    capsule_margin_loss,
    dice_loss,
    iou_loss,
    spread_loss,
    weighted_mse_loss,
)
from picad_tpu_torch.objectives.ramp_ups import (
    cosine_rampdown,
    exp_rampdown,
    exp_rampup,
    exp_warmup,
    linear_rampup,
    pseudo_rampup,
)
