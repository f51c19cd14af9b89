"""Inception-v1 I3D encoder up to Mixed_4f, with the decoder's skip outputs.

Counterpart of picad_tpu/models/i3d.py (reference models/pytorch_i3d.py:
152-353), eval mode, channels-first (B, C, T, H, W).  Returns
(Mixed_4f, out56, out112): out112 is the Conv3d_1a_7x7 activation and
out56 the Conv3d_2c_3x3 activation.

The stem is the plain 7^3/s2 conv.  The JAX package's StemS2D is a TPU
layout trick with the same math and is not ported.

Shapes for a (B, 3, 8, 224, 224) clip:
  Conv3d_1a_7x7 s2 -> (B, 64, 4, 112, 112) = out112
  MaxPool3d_2a (1,3,3)/(1,2,2) -> (B, 64, 4, 56, 56)
  Conv3d_2b_1x1 -> 64; Conv3d_2c_3x3 s(2,1,1) -> (B, 192, 2, 56, 56) = out56
  MaxPool3d_3a (1,3,3)/(1,2,2) -> (B, 192, 2, 28, 28)
  Mixed_3b -> 256; Mixed_3c -> 480
  MaxPool3d_4a (3,3,3)/(2,1,1) -> (B, 480, 1, 28, 28)
  Mixed_4b..4f -> 512, 512, 512, 528, 832
"""

from __future__ import annotations

import torch
from torch import nn

from picad_tpu_torch.models.layers import Unit3D
from picad_tpu_torch.ops.convops import max_pool_same_zero_pad

# name -> (input channels, branch widths [b0, b1a, b1b, b2a, b2b, b3b])
INCEPTION_SPECS = {
    "Mixed_3b": (192, [64, 96, 128, 16, 32, 32]),
    "Mixed_3c": (256, [128, 128, 192, 32, 96, 64]),
    "Mixed_4b": (480, [192, 96, 208, 16, 48, 64]),
    "Mixed_4c": (512, [160, 112, 224, 24, 64, 64]),
    "Mixed_4d": (512, [128, 128, 256, 24, 64, 64]),
    "Mixed_4e": (512, [112, 144, 288, 32, 64, 64]),
    "Mixed_4f": (528, [256, 160, 320, 32, 128, 128]),
}


class InceptionModule(nn.Module):
    """4-branch inception block, concat order [1x1, 1x1->3x3, 1x1->3x3,
    maxpool->1x1] (reference :124-149)."""

    def __init__(self, cin, oc, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype)
        self.b0 = Unit3D(cin, oc[0], **kw)
        self.b1a = Unit3D(cin, oc[1], **kw)
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3), **kw)
        self.b2a = Unit3D(cin, oc[3], **kw)
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3), **kw)
        self.b3b = Unit3D(cin, oc[5], **kw)

    def forward(self, x):
        b0 = self.b0(x)
        b1 = self.b1b(self.b1a(x))
        b2 = self.b2b(self.b2a(x))
        # T=1: a temporal window over zero padding is the identity on
        # post-ReLU (>= 0) inputs, so the pool drops to (1, 3, 3)
        pool_k = (1, 3, 3) if x.shape[2] == 1 else (3, 3, 3)
        b3 = self.b3b(max_pool_same_zero_pad(x, pool_k, (1, 1, 1)))
        return torch.cat([b0, b1, b2, b3], dim=1)


class InceptionI3d(nn.Module):
    """I3D encoder to Mixed_4f; module names are the reference keys."""

    def __init__(self, compute_dtype=torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype)
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2), **kw)
        self.Conv3d_2b_1x1 = Unit3D(64, 64, **kw)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3), (2, 1, 1), **kw)
        for name, (cin, oc) in INCEPTION_SPECS.items():
            self.add_module(name, InceptionModule(cin, oc, **kw))

    def forward(self, x):
        """x (B, 3, T, H, W) -> (Mixed_4f, out56, out112)."""
        out112 = x = self.Conv3d_1a_7x7(x)
        x = max_pool_same_zero_pad(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2b_1x1(x)
        out56 = x = self.Conv3d_2c_3x3(x)
        x = max_pool_same_zero_pad(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same_zero_pad(x, (3, 3, 3), (2, 1, 1))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        return x, out56, out112
