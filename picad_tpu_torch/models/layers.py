"""Building-block layers of the port, eval mode.

Counterpart of picad_tpu/models/layers.py.  Parameter and buffer names
are the reference state-dict keys (Unit3D: `conv3d.weight`, `bn.weight`,
`bn.bias`, `bn.running_mean`, `bn.running_var`), so a reference-format
state dict loads with `load_state_dict(strict=True)`.  Tensors are
channels-first (N, C, *spatial); parameters are stored in f32 and the
convolutions cast x and w to the compute type, as the JAX package does.

Only the eval forward exists in this slice: train-mode BatchNorm and
Dropout3d raise NotImplementedError until the training slice ports them.
"""

from __future__ import annotations

import torch
from torch import nn

from picad_tpu_torch.ops.convops import conv_nd

_TRAIN_MSG = (
    "{} runs in eval mode only: the train-mode forward comes with the "
    "training slice of the port (ROADMAP.md); call model.eval()"
)


class WeightBias(nn.Module):
    """Holds a conv weight (and optionally a bias) under the reference
    key names `weight` / `bias`; the owning module does the math."""

    def __init__(self, weight_shape: tuple[int, ...], bias: int | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(weight_shape))
        self.bias = nn.Parameter(torch.zeros(bias)) if bias is not None else None


class TorchBatchNorm(nn.Module):
    """BatchNorm over channel dim 1, eval mode: the running statistics,
    eps 1e-3, math in f32, result cast back to the input's type
    (picad_tpu/models/layers.py:128-131).  Buffers are only
    `running_mean` / `running_var` (no `num_batches_tracked`)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(_TRAIN_MSG.format("TorchBatchNorm"))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * inv.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


class Dropout3d(nn.Module):
    """Channelwise dropout; the identity at eval."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(_TRAIN_MSG.format("Dropout3d"))
        return x


class Unit3D(nn.Module):
    """Conv3d (TF-SAME, no bias) + BN + ReLU (models/pytorch_i3d.py:48-120)."""

    def __init__(self, cin, cout, kernel=(1, 1, 1), stride=(1, 1, 1),
                 compute_dtype=torch.float32):
        super().__init__()
        self.stride = tuple(stride)
        self.compute_dtype = compute_dtype
        self.conv3d = WeightBias((cout, cin, *kernel))
        self.bn = TorchBatchNorm(cout)

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
