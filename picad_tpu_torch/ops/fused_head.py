"""Fused decoder head: upsample4 -> Dropout3d -> smooth in one pass.

Counterpart of picad_tpu/ops/fused_head.py (read its docstring for the
derivation).  The reference head is affine,

    y   = ConvTranspose3d(128 -> 128, k3, s2, p1, op1)(x) + b4
    y   = Dropout3d(y)                 # per-(sample, channel) scale d
    seg = ConvTranspose3d(128 -> 1, k3, s1, p1)(y) + bs,

so it collapses into one stride-2 transposed convolution with the 5^3
composite kernel Kc_b[tau, c] = sum_m (K1 * K2)[tau, c, m] d[b, m], plus
an inclusion-exclusion over the o=0 faces that removes the mass up4
scatters onto its cropped plane, plus an analytic border-aware bias map
for b4.  No (B, 8, 224, 224, 128) intermediate is ever formed.

At d = 3 the big composite runs in `fused_head_kernel.composite_convt`:
the CUDA kernel on the card, its plain version on the CPU.  The lower-rank
face corrections stay plain torch.

Layouts: x is channels-last (B, *sp, C) as in the JAX package; the ConvT
weights are torch-layout, k1 (C, M, 3, 3, 3) and k2 (M, 1, 3, 3, 3).
"""

from __future__ import annotations

import itertools
import string

import torch

from picad_tpu_torch.ops.fused_head_kernel import (
    composite_convt,
    composite_convt_plain,
)


def compose_transpose_kernels(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Kernel-index-sum composition of two ConvT kernels over d axes.

    k1 (Cin, M, *3^d), k2 (M, 1, *3^d) -> P (Cin, M, *5^d) with
    P[c, m, a + b] = sum k1[c, m, a] * k2[m, 0, b];
    d = 0 degenerates to P[c, m] = k1[c, m] * k2[m, 0].
    """
    d = k1.ndim - 2
    k2v = k2[:, 0]  # (M, *3^d)
    if d == 0:
        return k1 * k2v[None, :]
    P = torch.zeros(k1.shape[:2] + (5,) * d, dtype=k1.dtype, device=k1.device)
    for a in itertools.product(range(3), repeat=d):
        idx = (slice(None), slice(None)) + tuple(slice(ai, ai + 3) for ai in a)
        k1a = k1[(slice(None), slice(None)) + a]  # (Cin, M)
        P[idx] += k1a[(...,) + (None,) * d] * k2v[None]
    return P


def _raw_fused(x, k1, k2, drop_scale):
    """Composite scatter WITHOUT the cropped-plane correction.

    x (B, *sp^d, C), k1 (C, M, *3^d), k2 (M, 1, *3^d), drop (B, M) ->
    (B, *(2 * sp)^d) f32, d = 0..3.
    """
    d = x.ndim - 2
    f32 = torch.float32
    P = compose_transpose_kernels(k1.to(f32), k2.to(f32))  # (C, M, *5^d)
    spatial = list(range(2, 2 + d))
    Kc = torch.einsum(
        P, [0, 1] + spatial, drop_scale.to(f32), [d + 2, 1],
        [d + 2] + spatial + [0],
    )  # (B, *5^d, C)
    if d == 0:
        return torch.einsum("bc,bc->b", x.to(f32), Kc)
    if d == 3:
        return composite_convt(x, Kc)
    return composite_convt_plain(x, Kc)


def _exact_fused(x, k1, k2, drop_scale):
    """Inclusion-exclusion over axis subsets: subtract the cropped-plane
    leak on every o=0 face."""
    d = x.ndim - 2
    out = _raw_fused(x, k1, k2, drop_scale)
    for r in range(1, d + 1):
        for S in itertools.combinations(range(d), r):
            pick = tuple(0 if a in S else slice(None) for a in range(d))
            k2_pick = tuple(2 if a in S else slice(None) for a in range(d))
            corr = _raw_fused(
                x[(slice(None),) + pick],
                k1[(slice(None), slice(None)) + pick],
                k2[(slice(None), slice(None)) + k2_pick],
                drop_scale,
            )
            sign = -1.0 if r % 2 == 1 else 1.0
            out[(slice(None),) + pick] += sign * corr
    return out


def smooth_bias_map(k2: torch.Tensor, out_shape: tuple[int, ...]) -> torch.Tensor:
    """S[pos, m] = sum of the k2 taps that land in-domain at pos.

    Equals ConvT(k3, s1, p1) of a one-hot channel map: tap beta of the
    unflipped kernel multiplies y[o + 1 - beta], so the valid-tap set
    factorizes per axis into small indicator contractions.
    k2 (M, 1, *3^d) -> (*out_shape, M).
    """
    d = k2.ndim - 2
    s = k2[:, 0].permute(*range(1, d + 1), 0)  # (*3^d, M)
    letters = string.ascii_lowercase
    for axis in range(d):
        size = out_shape[axis]
        o = torch.arange(size, device=k2.device)[:, None]
        beta = torch.arange(k2.shape[2 + axis], device=k2.device)[None, :]
        y_idx = o + 1 - beta
        ind = ((y_idx >= 0) & (y_idx < size)).to(k2.dtype)
        s_dims = letters[: s.ndim]
        out_dims = s_dims.replace(s_dims[axis], "z")
        s = torch.einsum(f"z{s_dims[axis]},{s_dims}->{out_dims}", ind, s)
    return s


def fused_decoder_head(
    x: torch.Tensor,  # (B, T, H, W, C) decoder tensor before upsample4
    k1: torch.Tensor,  # (C, M, 3, 3, 3) upsample4 ConvT weight
    b4: torch.Tensor,  # (M,) upsample4 bias
    k2: torch.Tensor,  # (M, 1, 3, 3, 3) smooth ConvT weight
    bs: torch.Tensor,  # (1,) smooth bias
    drop_scale: torch.Tensor,  # (B, M) channel dropout scale (ones at eval)
) -> torch.Tensor:
    """Exact smooth(dropout(upsample4(x))) without the full-resolution
    intermediate.  Returns (B, 2T, 2H, 2W) logits in x.dtype."""
    B, T, H, W, C = x.shape
    f32 = torch.float32
    out = _exact_fused(x, k1, k2, drop_scale)
    S = smooth_bias_map(k2.to(f32), (2 * T, 2 * H, 2 * W))  # (T2, H2, W2, M)
    db = drop_scale.to(f32) * b4.to(f32)[None, :]
    bias = torch.einsum("thwm,bm->bthw", S, db)
    return (out + bias + bs.to(f32).reshape(())).to(x.dtype)
