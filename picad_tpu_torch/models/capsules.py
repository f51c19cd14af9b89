"""Capsule localization network: PrimaryCaps, ConvCaps, CapsNet.

Counterpart of picad_tpu/models/capsules.py (reference
models/capsules_ucf101.py).  Module and parameter names are the reference
state-dict keys (checkpoint/torch_convert.py:112-139 of the JAX package),
so a reference-format state dict loads with `load_state_dict(strict=True)`.

Casts follow the JAX package: convolutions cast x and w to the compute
type, biases are added in f32 (so the capsule and decoder activations
between convs are f32), BatchNorm runs in f32, EM routing keeps its
(b, C) chain in f32, and the seg logits and class scores return in f32.

Class scores are the spatial mean of the capsule activations.  At eval
the pose mask is the one-hot of their argmax; in train mode it is the
ground-truth one-hot for labelled rows and, for unlabelled rows, all ones
before `thresh_epoch` and the argmax one-hot from then on (the
pseudo-label gate, picad_tpu/models/capsules.py:329-345).  Train mode
also draws the channel dropout of the encoder output and of the fused
head from an explicit generator.  ConvCaps has the K=(1,1) mode CapsNet
uses and the general-K and `w_shared` (class capsule) modes it does not.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from picad_tpu_torch._device import default_compute_dtype, resolve_device
from picad_tpu_torch.models.i3d import InceptionI3d
from picad_tpu_torch.models.layers import Dropout3d, WeightBias, frozen_running_stats
from picad_tpu_torch.ops.convops import conv_nd, conv_transpose_nd
from picad_tpu_torch.ops.em_routing import em_routing
from picad_tpu_torch.ops.fused_head import fused_decoder_head
from picad_tpu_torch.ops.tapconv import tap_conv_valid


class PrimaryCaps(nn.Module):
    """Pose + sigmoid-activation 9x9 VALID convs (reference :10-49), as two
    separate convs (the JAX package's default `_PCAPS_SPLIT`), each through
    the tap-GEMM conv (ops/tapconv.py: K3-K5 on the card).
    (B, 832, 28, 28) -> channels-last (B, 20, 20, caps*P*P + caps)."""

    def __init__(self, cin=832, caps_types=32, pose_size=4, kernel=9,
                 compute_dtype=torch.float32):
        super().__init__()
        psize = pose_size * pose_size
        self.compute_dtype = compute_dtype
        self.pose = WeightBias((caps_types * psize, cin, kernel, kernel), caps_types * psize)
        self.a = WeightBias((caps_types, cin, kernel, kernel), caps_types)

    def forward(self, x):
        dt = self.compute_dtype
        xc = x.to(dt).permute(0, 2, 3, 1).contiguous()  # (B, 28, 28, Ci)

        def conv(m: WeightBias):  # weight (Co, Ci, kh, kw) -> (kh, kw, Ci, Co)
            w = m.weight.to(dt).permute(2, 3, 1, 0).contiguous()
            return tap_conv_valid(xc, w) + m.bias

        return torch.cat([conv(self.pose), torch.sigmoid(conv(self.a))], dim=-1)


class ConvCaps(nn.Module):
    """Matrix-capsule layer with EM routing (reference :52-331), in the
    three modes of picad_tpu/models/capsules.py:122-230:

    - K=(1,1) convolutional (the mode CapsNet uses): one vote einsum per
      position, then EM routing per position;
    - general K convolutional: the KxK patches of capsules (stride
      `stride`, VALID) route jointly, patch-major then capsule type.  The
      reference's generic-K path is dead code whose permute+view
      (:228, :301) scrambles the patch order; like the JAX package, this
      is the correct patch order, not that scramble;
    - `w_shared` class capsules (reference :310-329): every position
      shares one transformation matrix per capsule type, `coor_add` adds
      the scaled coordinates (reference add_coord :270-288: vote entry 0
      += i/h, entry 1 += j/w), and the layer returns only the C output
      activations (B, C).

    `weights` is the reference's (1, K0*K1*Bi, C, P, P) ((1, Bi, C, P, P)
    at K=(1,1) and when shared)."""

    def __init__(self, in_caps=32, out_caps=24, pose_size=4, iters=3,
                 compute_dtype=torch.float32, kernel=(1, 1), stride=(1, 1),
                 eps=1e-8, lam=1e-6, coor_add=False, w_shared=False):
        super().__init__()
        P = pose_size
        self.in_caps, self.out_caps, self.P, self.iters = in_caps, out_caps, P, iters
        self.compute_dtype = compute_dtype
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.eps, self.lam = eps, lam
        self.coor_add, self.w_shared = coor_add, w_shared
        taps = 1 if w_shared else self.kernel[0] * self.kernel[1]
        self.beta_u = nn.Parameter(torch.zeros(out_caps, P * P))
        self.beta_a = nn.Parameter(torch.zeros(out_caps))
        self.weights = nn.Parameter(torch.zeros(1, taps * in_caps, out_caps, P, P))

    def forward(self, x):
        """x (B, h, w, Bi*(P*P + 1)) -> (B, oh, ow, C*P*P + C), or (B, C)
        activations when `w_shared`."""
        P, Bi, C = self.P, self.in_caps, self.out_caps
        psize = P * P
        b, h, w, c = x.shape
        assert c == Bi * (psize + 1), (c, Bi, psize)
        if self.w_shared:
            return self._class_caps(x)
        (K0, K1), (s0, s1) = self.kernel, self.stride
        if (K0, K1) == (1, 1):
            oh, ow = h, w
            patches = x
        else:
            oh, ow = (h - K0) // s0 + 1, (w - K1) // s1 + 1
            patches = torch.stack([x[:, i:i + s0 * oh:s0, j:j + s1 * ow:s1, :]
                                   for i in range(K0) for j in range(K1)],
                                  dim=3)  # (b, oh, ow, K0*K1, c)
        taps = K0 * K1
        pose = patches[..., : Bi * psize].reshape(b * oh * ow, taps * Bi, P, P)
        act = patches[..., Bi * psize :].reshape(b * oh * ow, taps * Bi, 1)
        mu, a_out = self._route(
            torch.einsum("nipq,ijqr->nijpr", pose.to(self.compute_dtype),
                         self.weights[0].to(self.compute_dtype)), act)
        return torch.cat(
            [mu.reshape(b, oh, ow, C * psize), a_out.reshape(b, oh, ow, C)], dim=-1
        )

    def _route(self, v, act, coords=None):
        """votes v (n, Bi', C, P, P) or (n, Bi', C, P*P), act (n, Bi', 1)
        -> EM routing's (mu, a_out), after the optional coordinates."""
        n, bi = v.shape[:2]
        v = v.reshape(n, bi, self.out_caps, self.P * self.P)
        if coords is not None:
            v = v + coords.to(v.dtype)
        return em_routing(v, act.to(v.dtype), self.beta_u, self.beta_a, iters=self.iters,
                          eps=self.eps, lam=self.lam)

    def _class_caps(self, x):
        P, Bi, C = self.P, self.in_caps, self.out_caps
        psize = P * P
        b, h, w, _ = x.shape
        # one routing over all h*w*Bi input capsules of a sample
        pose = x[..., : Bi * psize].reshape(b, h * w, Bi, P, P)
        act = x[..., Bi * psize :].reshape(b, h * w * Bi, 1)
        coords = None
        if self.coor_add:
            coord = torch.zeros((h, w, psize), dtype=torch.float32, device=x.device)
            coord[:, :, 0] += (torch.arange(h, dtype=torch.float32, device=x.device) / h)[:, None]
            coord[:, :, 1] += (torch.arange(w, dtype=torch.float32, device=x.device) / w)[None, :]
            coords = coord.reshape(1, h * w, 1, 1, psize).expand(b, h * w, Bi, C, psize)
            coords = coords.reshape(b, h * w * Bi, C, psize)
        # the shared W: input capsule (s, i) votes with weights[0, i]
        cdt = self.compute_dtype
        v = torch.einsum("nsipq,ijqr->nsijpr", pose.to(cdt), self.weights[0].to(cdt))
        _, a_out = self._route(v.reshape(b, h * w * Bi, C, psize), act, coords)
        return a_out  # (B, C) f32


class CapsNet(nn.Module):
    """I3D encoder + capsule head + skip decoder (reference :334-512).

    `fused_head=True` runs upsample4 -> Dropout3d -> smooth as the fused
    op (ops/fused_head.py), whose big composite is the CUDA kernel on the
    card; `fused_head=False` is the literal ConvT chain, kept as the
    parity baseline.  Parameters live in f32; `compute_dtype` is the type
    the convolutions run in.  `bn_groups` > 1 when the original and the
    flipped views run as one batch (train mode only); `dropout_rate` is
    the channel dropout of the encoder output and of the decoder head.
    `s2d_stem` picks the I3D stem (models/i3d.py).  `remat_encoder`
    recomputes the I3D encoder's activations in the backward instead of
    storing them (torch.utils.checkpoint; picad_tpu/models/capsules.py:
    266-300), with one BN running-stat update per forward as in JAX.
    """

    def __init__(self, num_classes=24, pose_size=4, compute_dtype=torch.float32,
                 fused_head=True, bn_groups=1, dropout_rate=0.5, s2d_stem=True,
                 remat_encoder=False):
        super().__init__()
        C, P = num_classes, pose_size
        self.num_classes, self.pose_size = C, P
        self.compute_dtype = compute_dtype
        self.fused_head = fused_head
        self.bn_groups = bn_groups
        self.dropout_rate = dropout_rate
        self.remat_encoder = remat_encoder
        kw = dict(compute_dtype=compute_dtype)
        self.conv1 = InceptionI3d(bn_groups=bn_groups, s2d_stem=s2d_stem, **kw)
        self.drop_enc = Dropout3d(dropout_rate)
        self.primary_caps = PrimaryCaps(832, 32, P, 9, **kw)
        self.conv_caps = ConvCaps(32, C, P, **kw)
        # ConvTranspose weights (Cin, Cout, *k); conv weights (Cout, Cin, *k)
        self.upsample1 = WeightBias((C * P * P, 64, 9, 9), 64)
        self.upsample2 = WeightBias((128, 64, 3, 3, 3), 64)
        self.upsample3 = WeightBias((128, 64, 3, 3, 3), 64)
        self.upsample4 = WeightBias((128, 128, 3, 3, 3), 128)
        self.smooth = WeightBias((128, 1, 3, 3, 3), 1)
        self.conv28 = WeightBias((64, 832, 3, 3), 64)
        self.conv56 = WeightBias((64, 192, 3, 3, 3), 64)
        self.conv112 = WeightBias((64, 64, 3, 3, 3), 64)
        self.drop_dec = Dropout3d(dropout_rate)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CapsNet":
        """Random weights from `generator`, drawn with the JAX package's
        initializers: lecun-normal Unit3D kernels, normal(0.1) PrimaryCaps
        kernels, normal(1) capsule parameters, normal(0.02) ConvT kernels,
        torch's U(+-1/sqrt(fan_in)) for the other kernels and all biases;
        BatchNorm at identity statistics."""
        g = generator
        for name, m in self.named_modules():
            if not isinstance(m, WeightBias):
                continue
            fan_in = m.weight[0].numel()
            bound = fan_in ** -0.5
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "conv3d":
                std = bound / 0.87962566103423978  # flax truncated lecun_normal
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=g)
            elif name.startswith("primary_caps"):
                m.weight.normal_(0.0, 0.1, generator=g)
            elif leaf.startswith("upsample") or leaf == "smooth":
                m.weight.normal_(0.0, 0.02, generator=g)
            else:
                m.weight.uniform_(-bound, bound, generator=g)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=g)
        for p in self.conv_caps.parameters():
            p.normal_(0.0, 1.0, generator=g)
        return self

    def _convt(self, m: WeightBias, x, stride, padding, output_padding):
        dt = self.compute_dtype
        w = m.weight
        if (x.ndim == 5 and x.shape[2] == 1 and w.shape[2:] == (3, 3, 3)
                and (stride, padding, output_padding) == (2, 1, 1)):
            # T_in=1 (upsample2): output frame t comes solely from kernel
            # slice t+1 (slice 0 lands on the cropped t=-1), so two 2-D
            # ConvTs replace the 3-D one: same values, 1/3 the FLOPs
            # (picad_tpu/models/capsules.py:358-371)
            x2 = x[:, :, 0].to(dt)
            y = torch.stack(
                [conv_transpose_nd(x2, w[:, :, k].to(dt), 2, 1, 1) for k in (1, 2)],
                dim=2,
            )
        else:
            y = conv_transpose_nd(x.to(dt), w.to(dt), stride, padding, output_padding)
        return y + m.bias.view((1, -1) + (1,) * (y.ndim - 2))

    def _conv(self, m: WeightBias, x):
        dt = self.compute_dtype
        y = conv_nd(x.to(dt), m.weight.to(dt), 1, m.weight.shape[-1] // 2)
        return y + m.bias.view((1, -1) + (1,) * (y.ndim - 2))

    def _encoder(self, x):
        if not (self.remat_encoder and self.training and torch.is_grad_enabled()):
            return self.conv1(x)
        return checkpoint(
            self.conv1, x, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), frozen_running_stats(self.conv1)))

    def forward(self, img: torch.Tensor, classification=None, concat_labels=None,
                epoch=0, thresh_epoch=0, *, generator: torch.Generator | None = None):
        """img (B, 8, H, W, 3) channels-last, H and W divisible by 16 with
        H/8 - 8 >= 1 (224 in the reference) -> (seg_logits (B, 8, H, W) f32,
        class_scores (B, C) f32, feat (B, h*w, C)).  A uint8 img is the
        packed clip of the packed prep (train/step.py), (B, 4, H/2, W/2, 24):
        its logical T, H and W are twice its dims.

        Eval needs only img: the mask is the argmax one-hot (the JAX eval
        call passes a dummy action it ignores).  Train mode needs the
        labels `classification` (B,) and `concat_labels` (B,) (1 =
        labelled), the epoch and thresh_epoch of the pseudo-label gate,
        and draws its dropout from `generator`."""
        C, psize = self.num_classes, self.pose_size ** 2
        dt = self.compute_dtype
        B, T, H, W, _ = img.shape
        if img.dtype == torch.uint8:
            T, H, W = 2 * T, 2 * H, 2 * W
        if T != 8:
            raise ValueError(f"the I3D/decoder temporal schedule needs T=8, got {T}")
        if self.training and (classification is None or concat_labels is None):
            raise ValueError("the train-mode forward needs classification and concat_labels")
        relu = torch.relu

        x, cross56, cross112 = self._encoder(img.permute(0, 4, 1, 2, 3))
        h28, w28 = H // 8, W // 8
        # T = 1 at Mixed_4f; dropout after the 4-D reshape (capsules.py:313)
        x = self.drop_enc(x.reshape(B, 832, h28, w28), generator)
        cross28 = x
        combined = self.conv_caps(self.primary_caps(x))

        h, w = combined.shape[1], combined.shape[2]
        ranges = C * psize
        activations = combined[..., ranges : ranges + C]  # (B, h, w, C)
        feat = activations.reshape(B, h * w, C)
        class_scores = activations.mean(dim=(1, 2))
        one_hot_pred = F.one_hot(class_scores.argmax(dim=1), C).to(torch.float32)
        if self.training:
            one_hot_gt = F.one_hot(classification.long().reshape(B), C).to(torch.float32)
            unlabeled = (torch.ones_like(one_hot_gt) if float(epoch) < float(thresh_epoch)
                         else one_hot_pred)
            sel = (concat_labels.reshape(B, 1) == 0).to(torch.float32)
            class_mask = sel * unlabeled + (1.0 - sel) * one_hot_gt
        else:
            class_mask = one_hot_pred
        poses = combined[..., :ranges].reshape(B, h, w, C, psize)
        poses = (poses * class_mask[:, None, None, :, None]).reshape(B, h, w, ranges)

        # decoder (reference :358-374, :486-509), channels-first
        x = relu(self._convt(self.upsample1, poses.permute(0, 3, 1, 2), 1, 0, 0))
        c28 = relu(self._conv(self.conv28, cross28))
        x = torch.cat([x, c28], dim=1).reshape(B, 128, 1, h28, w28)
        x = relu(self._convt(self.upsample2, x, 2, 1, 1))  # (B, 64, 2, 56, 56)
        x = torch.cat([x, relu(self._conv(self.conv56, cross56))], dim=1)
        x = relu(self._convt(self.upsample3, x, 2, 1, 1))  # (B, 64, 4, 112, 112)
        x = torch.cat([x, relu(self._conv(self.conv112, cross112))], dim=1)

        up4, sm = self.upsample4, self.smooth
        if self.fused_head:
            drop_scale = torch.ones((B, 128), dtype=torch.float32, device=img.device)
            if self.training and self.dropout_rate > 0.0:
                keep = 1.0 - self.dropout_rate
                mask = torch.rand((B, 128), generator=generator, device=img.device) < keep
                drop_scale = mask.to(torch.float32) / keep
            x_cl = x.to(dt).permute(0, 2, 3, 4, 1).contiguous()  # (B, 4, 112, 112, 128)
            seg = fused_decoder_head(x_cl, up4.weight, up4.bias, sm.weight, sm.bias, drop_scale)
        else:
            y = self.drop_dec(self._convt(up4, x, 2, 1, 1), generator)  # (B, 128, 8, 224, 224)
            seg = self._convt(sm, y, 1, 1, 0)[:, 0]
        seg_logits = seg.reshape(B, 8, H, W).to(torch.float32)
        return seg_logits, class_scores.to(torch.float32), feat


def build_capsnet(
    state_dict=None,
    *,
    num_classes: int = 24,
    pose_size: int = 4,
    compute_dtype: torch.dtype | None = None,
    fused_head: bool = True,
    seed: int = 0,
    device=None,
    bn_groups: int = 1,
    dropout_rate: float = 0.5,
    s2d_stem: bool = True,
    remat_encoder: bool = False,
) -> CapsNet:
    """The eval-mode CapsNet on `device` (default: the CUDA card); the
    train-mode one is `build_train_capsnet`.

    Weights come from a reference-format `state_dict` (numpy arrays or
    tensors) or, without one, from `init_weights` seeded with `seed`.
    compute_dtype defaults to bf16 on the card and f32 on the CPU.
    `s2d_stem` and `remat_encoder` are CapsNet's options."""
    from picad_tpu_torch.checkpoint.convert import load_reference_state_dict

    dev = resolve_device(device)
    model = CapsNet(
        num_classes,
        pose_size,
        compute_dtype=compute_dtype or default_compute_dtype(dev),
        fused_head=fused_head,
        bn_groups=bn_groups,
        dropout_rate=dropout_rate,
        s2d_stem=s2d_stem,
        remat_encoder=remat_encoder,
    )
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        load_reference_state_dict(model, state_dict)
    return model.to(dev).eval()


def build_train_capsnet(state_dict=None, *, bn_groups: int = 1,
                        dropout_rate: float = 0.5, **kwargs) -> CapsNet:
    """The train-mode counterpart of `build_capsnet`: BatchNorm with
    `bn_groups` statistics groups (2: the train step folds the original
    and flipped views into one batch) and channel dropout `dropout_rate`."""
    return build_capsnet(state_dict, bn_groups=bn_groups, dropout_rate=dropout_rate,
                         **kwargs).train()
