"""Convolution / pooling primitives with the reference's semantics.

Counterpart of picad_tpu/ops/convops.py.  The port runs channels-first
(N, C, *spatial) tensors with torch-layout weights internally, so these
are thin wrappers over torch's convolutions that add what torch lacks:

- TF-style "SAME" padding (models/pytorch_i3d.py:21-45 of the reference):
  total pad = max(k - s, 0) if s divides the size, else
  max(k - size % s, 0); low = pad // 2, high = pad - low.  It can be
  asymmetric, so it is an explicit F.pad before a VALID conv.
- Zero-padded max pooling: the reference zero-pads (F.pad) and then
  max-pools, which differs from -inf padding wherever inputs are
  negative.
- ConvTransposeNd with output_padding is torch's own definition.
- Stride-1 max pools are separable, with the JAX package's tied-max
  backward (convops.py:148-268): every tied maximum of a window gets
  the window's gradient.  Strided pools keep the joint pool, whose
  backward gives each window's gradient to its first maximum in scan
  order, as XLA's select-and-scatter does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _tuple(v, n: int) -> tuple[int, ...]:
    if isinstance(v, (tuple, list)):
        assert len(v) == n, (v, n)
        return tuple(int(x) for x in v)
    return (int(v),) * n


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF-SAME padding (low, high) for one spatial dim."""
    if size % stride == 0:
        pad = max(kernel - stride, 0)
    else:
        pad = max(kernel - (size % stride), 0)
    lo = pad // 2
    return (lo, pad - lo)


def _pad_spatial(x: torch.Tensor, pads) -> torch.Tensor:
    """F.pad with per-spatial-dim (lo, hi) pairs, first dim first."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    if not any(flat):
        return x
    return F.pad(x, flat)


def conv_nd(x: torch.Tensor, weight: torch.Tensor, stride=1, padding="VALID"):
    """N-d convolution, x (N, Cin, *sp), weight (Cout, Cin, *k).

    padding: 'SAME' (TF rule above), 'VALID', an int, or per-dim ints.
    """
    n = x.ndim - 2
    stride = _tuple(stride, n)
    kdims = weight.shape[2:]
    if padding == "SAME":
        pads = [same_pads(x.shape[2 + i], kdims[i], stride[i]) for i in range(n)]
        x = _pad_spatial(x, pads)
        padding = 0
    elif padding == "VALID":
        padding = 0
    return _CONV[n](x, weight, stride=stride, padding=_tuple(padding, n))


def conv_transpose_nd(
    x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0, output_padding=0
):
    """torch ConvTransposeNd, x (N, Cin, *sp), weight (Cin, Cout, *k).

    out = (in - 1) * stride - 2 * padding + kernel + output_padding.
    """
    n = x.ndim - 2
    return _CONV_T[n](
        x,
        weight,
        stride=_tuple(stride, n),
        padding=_tuple(padding, n),
        output_padding=_tuple(output_padding, n),
    )


def max_pool_same_zero_pad(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """Max pool with TF-SAME *zero* padding, x (N, C, *sp), 1 <= sp <= 3.

    Stride-1 pools run as one 1-D stage per axis whose kernel is larger
    than 1, in axis order (the same values as the joint window: max is
    associative and each stage zero-pads its own axis), each with the
    all-ties backward of `_MaxPoolAxis`.  Strided pools are one joint
    pool."""
    n = x.ndim - 2
    kernel = _tuple(kernel, n)
    stride = _tuple(stride, n)
    if all(s == 1 for s in stride):
        for a in range(n):
            if kernel[a] != 1:
                x = _MaxPoolAxis.apply(x, 2 + a, kernel[a])
        return x
    pads = [same_pads(x.shape[2 + i], kernel[i], stride[i]) for i in range(n)]
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[n]
    return pool(_pad_spatial(x, pads), kernel, stride)


def _shift(t: torch.Tensor, dim: int, shift: int, fill: float) -> torch.Tensor:
    """t shifted by `shift` along dim (out[i] = t[i - shift]), filled."""
    if shift == 0:
        return t
    size = t.shape[dim]
    pad_shape = list(t.shape)
    pad_shape[dim] = abs(shift)
    pad = torch.full(pad_shape, fill, dtype=t.dtype, device=t.device)
    if shift > 0:
        return torch.cat([pad, t.narrow(dim, 0, size - shift)], dim=dim)
    return torch.cat([t.narrow(dim, -shift, size + shift), pad], dim=dim)


class _MaxPoolAxis(torch.autograd.Function):
    """Stride-1 zero-padded max pool along one dim, with the JAX
    package's backward (convops.py:248-265):

        dx[i] = sum over windows j containing i of 1[x[i] == y[j]] g[j],

    k shifted compare-and-add passes in f32, cast to x's type."""

    @staticmethod
    def forward(ctx, x, dim, k):
        lo, hi = same_pads(x.shape[dim], k, 1)
        pads = [(0, 0)] * (x.ndim - 2)
        pads[dim - 2] = (lo, hi)
        y = _pad_spatial(x, pads).unfold(dim, k, 1).amax(dim=-1)
        ctx.save_for_backward(x, y)
        ctx.dim, ctx.k, ctx.lo = dim, k, lo
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        dim, lo = ctx.dim, ctx.lo
        gf = g.float()
        acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for t in range(ctx.k):
            s = t - lo  # i = j + t - lo  =>  window j = i - (t - lo)
            ys = _shift(y, dim, s, float("-inf"))
            acc = acc + (x == ys).float() * _shift(gf, dim, s, 0.0)
        return acc.to(x.dtype), None, None
