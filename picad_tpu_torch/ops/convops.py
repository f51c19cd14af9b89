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

The tied-max pooling backward of the JAX package (convops.py:208-268)
comes with the training slice.
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
    """Max pool with TF-SAME *zero* padding, x (N, C, *sp), 1 <= sp <= 3."""
    n = x.ndim - 2
    kernel = _tuple(kernel, n)
    stride = _tuple(stride, n)
    pads = [same_pads(x.shape[2 + i], kernel[i], stride[i]) for i in range(n)]
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[n]
    return pool(_pad_spatial(x, pads), kernel, stride)
