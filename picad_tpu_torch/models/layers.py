"""Building-block layers of the port, eval and train mode.

Counterpart of picad_tpu/models/layers.py.  Parameter and buffer names
are the reference state-dict keys (Unit3D: `conv3d.weight`, `bn.weight`,
`bn.bias`, `bn.running_mean`, `bn.running_var`), so a reference-format
state dict loads with `load_state_dict(strict=True)`.  Tensors are
channels-first (N, C, *spatial); parameters are stored in f32 and the
convolutions cast x and w to the compute type, as the JAX package does.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from picad_tpu_torch.ops.bn_stats import group_stats
from picad_tpu_torch.ops.convops import conv_nd
from picad_tpu_torch.parallel import mesh

# Tensors with at least this many elements take their train-mode batch
# statistics from the shifted one-pass reduction (ops/bn_stats.py, the
# K6 kernel on the card); smaller ones keep the two-pass form
# (picad_tpu/models/layers.py:69).  Tests lower it to 0.
BN_ONEPASS_MIN = 1 << 22


class WeightBias(nn.Module):
    """Holds a conv weight (and optionally a bias) under the reference
    key names `weight` / `bias`; the owning module does the math."""

    def __init__(self, weight_shape: tuple[int, ...], bias: int | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(weight_shape))
        self.bias = nn.Parameter(torch.zeros(bias)) if bias is not None else None


class TorchBatchNorm(nn.Module):
    """BatchNorm over channel dim 1 with torch's rules (reference
    nn.BatchNorm3d(eps=1e-3, momentum=0.01)), math in f32, result cast
    back to the input's type (picad_tpu/models/layers.py:97-198).
    Buffers are only `running_mean` / `running_var`.

    Eval: the running statistics.  Train: biased batch statistics
    normalize; `stats_groups` = G splits the batch into G contiguous
    groups, each normalized by its own statistics, and the running stats
    take G sequential EMA steps toward each group's mean and UNBIASED
    variance (in place, without gradient) -- the numerics of G separate
    forwards.  Zero-padded rows of a ragged batch count in the
    statistics, as in the JAX step.

    Inside a process group the statistics are the global batch's (exact
    sync-BN, as XLA makes them over the JAX package's mesh): each rank's
    per-group (mean, var) are combined over the ranks by
    `mesh.global_stats`, and the running stats' unbiased factor counts
    the global batch."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.01,
                 stats_groups: int = 1):
        super().__init__()
        self.eps, self.momentum, self.stats_groups = eps, momentum, stats_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        # False while an activation checkpoint recomputes the forward
        # (`frozen_running_stats`): the step's one update already happened
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (x.float() - self.running_mean.view(shape)) * inv.view(shape)
            return (y + self.bias.view(shape)).to(x.dtype)

        G = self.stats_groups
        B, C = x.shape[0], x.shape[1]
        n = (B // G) * math.prod(x.shape[2:])
        xg = x.float().reshape(G, B // G, C, -1)
        if x.numel() >= BN_ONEPASS_MIN:
            mean_g, var_g = group_stats(x, G)  # (G, C) each; K6 on the card
        else:
            mean_g = xg.mean(dim=(1, 3))
            var_g = (xg - mean_g[:, None, :, None]).square().mean(dim=(1, 3))
        if mesh.is_active():
            mean_g, var_g = mesh.global_stats(mean_g, var_g)
            n *= mesh.world_size()
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                unbiased = var_g * (n / max(n - 1, 1))
                for g in range(G):  # sequential EMA == one update per forward
                    self.running_mean.mul_(1 - m).add_(m * mean_g[g])
                    self.running_var.mul_(1 - m).add_(m * unbiased[g])
        inv = torch.rsqrt(var_g + self.eps) * self.weight  # (G, C)
        y = (xg - mean_g[:, None, :, None]) * inv[:, None, :, None]
        y = y + self.bias[None, None, :, None]
        return y.reshape(x.shape).to(x.dtype)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Every TorchBatchNorm in `module` leaves its running stats alone
    inside the block: the recompute context of an activation checkpoint,
    so a rematerialized forward updates them once, as JAX's nn.remat."""
    bns = [m for m in module.modules() if isinstance(m, TorchBatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class Dropout3d(nn.Module):
    """Channelwise dropout (picad_tpu/models/layers.py:201-216): in train
    mode whole (sample, channel) maps are zeroed with probability `rate`
    and the rest scaled by 1/keep; the identity at eval.  The mask is
    drawn from `generator` (torch's default one when None)."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0], x.shape[1]) + (1,) * (x.ndim - 2)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Unit3D(nn.Module):
    """Conv3d (TF-SAME, no bias) + BN + ReLU (models/pytorch_i3d.py:48-120).
    `bn_groups` is the BN's stats_groups, used in train mode only."""

    def __init__(self, cin, cout, kernel=(1, 1, 1), stride=(1, 1, 1),
                 compute_dtype=torch.float32, bn_groups: int = 1):
        super().__init__()
        self.stride = tuple(stride)
        self.compute_dtype = compute_dtype
        self.conv3d = WeightBias((cout, cin, *kernel))
        self.bn = TorchBatchNorm(cout, stats_groups=bn_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.conv3d.weight
        if x.shape[2] == 1 and w.shape[2] == 3 and self.stride[0] == 1:
            # T=1 with temporal kernel 3 and SAME padding: the edge
            # temporal taps only see zero padding, so the conv IS a 2-D
            # conv with the centre slice (same values, 1/3 the FLOPs;
            # picad_tpu/models/layers.py:242-259)
            y = conv_nd(x[:, :, 0].to(dt), w[:, :, 1].to(dt),
                        self.stride[1:], "SAME")[:, :, None]
        else:
            y = conv_nd(x.to(dt), w.to(dt), self.stride, "SAME")
        return torch.relu(self.bn(y))
