"""Inception-v1 I3D encoder, with the decoder's skip outputs.

Counterpart of picad_tpu/models/i3d.py (reference models/pytorch_i3d.py:
152-353), channels-first (B, C, T, H, W).  In train mode every Unit3D's
BatchNorm uses `bn_groups` groups of the batch (one per folded view).  Returns
(final endpoint, out56, out112): out112 is the Conv3d_1a_7x7 activation
and out56 the Conv3d_2c_3x3 activation.  The final endpoint is Mixed_4f
by default (the CapsNet's encoder); `final_endpoint` can stop anywhere
in VALID_ENDPOINTS, up to Mixed_5c, or go on to "Logits", the full
Kinetics classifier with `I3DLogitsHead` (picad_tpu/models/i3d.py:52-72,
:170-217).

The stem is StemS2D by default (`s2d_stem=True`, as in the JAX package):
the 7^3/s2 conv on 3 channels computed as a 4^3/s1 conv on 24 channels,
with the plain stem's parameters.  Odd T, H or W fall back to the plain
conv, as the JAX package does (picad_tpu/models/i3d.py:238).

Shapes for a (B, 3, 8, 224, 224) clip:
  Conv3d_1a_7x7 s2 -> (B, 64, 4, 112, 112) = out112
  MaxPool3d_2a (1,3,3)/(1,2,2) -> (B, 64, 4, 56, 56)
  Conv3d_2b_1x1 -> 64; Conv3d_2c_3x3 s(2,1,1) -> (B, 192, 2, 56, 56) = out56
  MaxPool3d_3a (1,3,3)/(1,2,2) -> (B, 192, 2, 28, 28)
  Mixed_3b -> 256; Mixed_3c -> 480
  MaxPool3d_4a (3,3,3)/(2,1,1) -> (B, 480, 1, 28, 28)
  Mixed_4b..4f -> 512, 512, 512, 528, 832
  MaxPool3d_5a (2,2,2)/(2,2,2) -> (B, 832, 1, 14, 14)
  Mixed_5b -> 832; Mixed_5c -> 1024
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from picad_tpu_torch.models.layers import Unit3D, WeightBias
from picad_tpu_torch.ops.convops import conv_nd, max_pool_same_zero_pad

# endpoints in construction order (reference :221-296)
VALID_ENDPOINTS = (
    "Conv3d_1a_7x7", "MaxPool3d_2a_3x3", "Conv3d_2b_1x1", "Conv3d_2c_3x3",
    "MaxPool3d_3a_3x3", "Mixed_3b", "Mixed_3c", "MaxPool3d_4a_3x3", "Mixed_4b",
    "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f", "MaxPool3d_5a_2x2", "Mixed_5b",
    "Mixed_5c",
)
# name -> (window, stride), zero-padded TF-SAME
POOL_SPECS = {
    "MaxPool3d_2a_3x3": ((1, 3, 3), (1, 2, 2)),
    "MaxPool3d_3a_3x3": ((1, 3, 3), (1, 2, 2)),
    "MaxPool3d_4a_3x3": ((3, 3, 3), (2, 1, 1)),
    "MaxPool3d_5a_2x2": ((2, 2, 2), (2, 2, 2)),
}

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
# past the CapsNet's encoder (a full I3D's final endpoints)
TAIL_SPECS = {
    "Mixed_5b": (832, [256, 160, 320, 32, 128, 128]),
    "Mixed_5c": (832, [384, 192, 384, 48, 128, 128]),
}


# The S2D conv's layout.  Its packed input comes out of `s2d_pack` in
# channels_last_3d strides; False makes it contiguous NCDHW first, and
# True keeps it (the conv's output then needs a contiguous copy for the
# BN).  chip_smoke.py phase 10 times both: NCDHW is the faster on the
# H100 (PERF.md).
S2D_CHANNELS_LAST = False


def s2d_pack(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 space-to-depth of a channels-last (B, T, H, W, C) tensor ->
    (B, T/2, H/2, W/2, 8C), channel order (tp, hp, wp, c): the packing of
    picad_tpu/models/i3d.py:122-126 and train/step.py:86."""
    B, T, H, W, C = x.shape
    xp = x.reshape(B, T // 2, 2, H // 2, 2, W // 2, 2, C)
    return xp.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, T // 2, H // 2, W // 2, 8 * C)


class StemS2D(Unit3D):
    """Conv3d_1a_7x7 via space-to-depth (picad_tpu/models/i3d.py:76-138):
    the 7^3/s2 SAME conv on C channels as a 4^3/s1 conv on 8C channels.

    out[o] = sum_k x[2o + k - 2] w[k] with SAME pads (2, 3); splitting x
    by parity p and k = 2j + p gives a stride-1 kernel-4 conv with pads
    (1, 2) in each dim, on the kernel zero-padded 7 -> 8 and re-indexed.
    The parameters are the plain stem's (`conv3d.weight` (64, C, 7, 7, 7)
    and `bn`), so state dicts load unchanged.

    A uint8 input is the PACKED clip of the packed prep (train/step.py),
    (B, 8C, T/2, H/2, W/2) of raw pixels: /255 folds into the kernel,
    conv(x, w/255) == conv(x/255, w).  A float input with an odd T, H or
    W takes the plain conv (the JAX package's fallback)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.conv3d.weight
        cout, cin = w.shape[:2]
        if x.dtype == torch.uint8:
            if x.shape[1] != 8 * cin:
                raise ValueError(f"a packed uint8 stem input has {8 * cin} channels, "
                                 f"not {x.shape[1]}")
            xp = x.to(dt)  # 0..255, exact in bf16
            w = w * (1.0 / 255.0)
        elif any(d % 2 for d in x.shape[2:]):
            return super().forward(x)
        else:
            xp = s2d_pack(x.to(dt).permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
        if not S2D_CHANNELS_LAST:
            xp = xp.contiguous()
        wp = F.pad(w.to(dt), (0, 1, 0, 1, 0, 1)).reshape(cout, cin, 4, 2, 4, 2, 4, 2)
        wp = wp.permute(0, 3, 5, 7, 1, 2, 4, 6).reshape(cout, 8 * cin, 4, 4, 4)
        y = F.conv3d(F.pad(xp, (1, 2, 1, 2, 1, 2)), wp).contiguous()
        return torch.relu(self.bn(y))


class InceptionModule(nn.Module):
    """4-branch inception block, concat order [1x1, 1x1->3x3, 1x1->3x3,
    maxpool->1x1] (reference :124-149)."""

    def __init__(self, cin, oc, compute_dtype=torch.float32, bn_groups=1):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, bn_groups=bn_groups)
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
        # post-ReLU (>= 0) inputs, so the pool drops to (1, 3, 3); stride-1
        # pools are separable with the all-ties backward (ops/convops.py)
        pool_k = (1, 3, 3) if x.shape[2] == 1 else (3, 3, 3)
        b3 = self.b3b(max_pool_same_zero_pad(x, pool_k, (1, 1, 1)))
        return torch.cat([b0, b1, b2, b3], dim=1)


class I3DLogitsHead(nn.Module):
    """The full I3D's classification head (reference :298-321,
    picad_tpu/models/i3d.py:170-210): average pool (2, 7, 7) stride 1
    VALID, dropout (train mode, elementwise, from `generator`), then a
    1x1x1 conv with bias, no BN and no activation.  The conv is the
    reference's `logits.conv3d` (`weight`, `bias`).  x (B, 1024, T, H, W)
    -> logits (B, num_classes, T', H', W'), squeezed to (B, num_classes,
    T') when `spatial_squeeze` (H' = W' = 1), the reference's layout."""

    def __init__(self, cin=1024, num_classes=400, dropout_rate=0.5, spatial_squeeze=True,
                 compute_dtype=torch.float32):
        super().__init__()
        self.dropout_rate, self.spatial_squeeze = dropout_rate, spatial_squeeze
        self.compute_dtype = compute_dtype
        self.conv3d = WeightBias((num_classes, cin, 1, 1, 1), num_classes)

    def forward(self, x, generator: torch.Generator | None = None):
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        if self.training and self.dropout_rate > 0:
            keep = 1.0 - self.dropout_rate
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        dt = self.compute_dtype
        y = conv_nd(x.to(dt), self.conv3d.weight.to(dt)) + self.conv3d.bias.view(1, -1, 1, 1, 1)
        return y.squeeze(4).squeeze(3) if self.spatial_squeeze else y


class InceptionI3d(nn.Module):
    """I3D encoder to `final_endpoint` (one of VALID_ENDPOINTS, or
    "Logits" for the classifier, whose head is `logits`); module names
    are the reference keys, and only the modules up to the endpoint
    exist.  `s2d_stem` picks StemS2D or the plain Unit3D for
    Conv3d_1a_7x7 (the same parameters and function)."""

    def __init__(self, compute_dtype=torch.float32, bn_groups=1, s2d_stem=True,
                 final_endpoint="Mixed_4f", num_classes=400):
        super().__init__()
        if final_endpoint not in VALID_ENDPOINTS + ("Logits",):
            raise ValueError(f"unknown final_endpoint {final_endpoint!r}")
        self.final_endpoint = final_endpoint
        last = (VALID_ENDPOINTS.index(final_endpoint) if final_endpoint in VALID_ENDPOINTS
                else len(VALID_ENDPOINTS) - 1)
        self.endpoints = VALID_ENDPOINTS[: last + 1]
        kw = dict(compute_dtype=compute_dtype, bn_groups=bn_groups)
        units = {"Conv3d_2b_1x1": (64, 64, (1, 1, 1), (1, 1, 1)),
                 "Conv3d_2c_3x3": (64, 192, (3, 3, 3), (2, 1, 1))}
        for ep in self.endpoints:
            if ep == "Conv3d_1a_7x7":
                stem = StemS2D if s2d_stem else Unit3D
                self.add_module(ep, stem(3, 64, (7, 7, 7), (2, 2, 2), **kw))
            elif ep in units:
                self.add_module(ep, Unit3D(*units[ep], **kw))
            elif ep not in POOL_SPECS:
                cin, oc = {**INCEPTION_SPECS, **TAIL_SPECS}[ep]
                self.add_module(ep, InceptionModule(cin, oc, **kw))
        if final_endpoint == "Logits":
            self.logits = I3DLogitsHead(1024, num_classes, compute_dtype=compute_dtype)

    def forward(self, x, generator: torch.Generator | None = None):
        """x (B, 3, T, H, W), or the packed uint8 (B, 24, T/2, H/2, W/2)
        for StemS2D -> (final endpoint, out56, out112); `generator` draws
        the logits head's dropout in train mode."""
        if x.dtype == torch.uint8 and not isinstance(self.Conv3d_1a_7x7, StemS2D):
            raise ValueError("packed uint8 input requires the space-to-depth stem")
        out56 = out112 = None
        for ep in self.endpoints:
            x = (max_pool_same_zero_pad(x, *POOL_SPECS[ep]) if ep in POOL_SPECS
                 else getattr(self, ep)(x))
            if ep == "Conv3d_1a_7x7":
                out112 = x
            elif ep == "Conv3d_2c_3x3":
                out56 = x
        if self.final_endpoint == "Logits":
            x = self.logits(x, generator)
        return x, out56, out112
