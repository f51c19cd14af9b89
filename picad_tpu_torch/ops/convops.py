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
  order, as XLA's select-and-scatter does (convops.py:198).  That
  backward is `max_pool_bwd`, from the unpadded x (the pool saves x and
  y, not a padded copy): the hand-written kernel csrc/max_pool_bwd.cu on
  a CUDA tensor, one launch a pool (deterministic, unlike torch's atomic
  max_pool3d_with_indices_backward), `max_pool_bwd_plain` on a CPU
  tensor.  `max_pool_bwd.launches` counts kernel launches, and
  nothing else; `launches_by_c` counts the same launches by the pooled
  tensor's channel count, which tells a model's pools apart.  A replay
  of the captured train step (train/graph.py), which calls no wrapper,
  adds what its capture counted.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch
import torch.nn.functional as F

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


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
    pool with the first-maximum backward of `_MaxPoolStrided`."""
    n = x.ndim - 2
    kernel = _tuple(kernel, n)
    stride = _tuple(stride, n)
    if all(s == 1 for s in stride):
        for a in range(n):
            if kernel[a] != 1:
                x = _MaxPoolAxis.apply(x, 2 + a, kernel[a])
        return x
    return _MaxPoolStrided.apply(x, kernel, stride)


class _MaxPoolStrided(torch.autograd.Function):
    """Strided zero-padded max pool: forward F.max_poolNd on the padded
    x (as torch runs it), backward `max_pool_bwd` on the saved x and y
    (no indices kept, and not the padded copy: the backward makes the
    pads itself)."""

    @staticmethod
    def forward(ctx, x, kernel, stride):
        n = x.ndim - 2
        pads = [same_pads(x.shape[2 + i], kernel[i], stride[i]) for i in range(n)]
        y = _POOL[n](_pad_spatial(x, pads), kernel, stride)
        ctx.save_for_backward(x, y)
        ctx.kernel, ctx.stride = kernel, stride
        ctx.lo = tuple(lo for lo, _ in pads)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return max_pool_bwd(x, y, g, ctx.kernel, ctx.stride, ctx.lo), None, None


def _windows(kernel, stride, od):
    """(tap, slice) pairs, taps in scan (row-major) order: the slice of
    the padded input that the tap reads for every window."""
    for tap in itertools.product(*(range(k) for k in kernel)):
        yield (slice(None), slice(None)) + tuple(
            slice(t, t + s * (o - 1) + 1, s) for t, s, o in zip(tap, stride, od))


def _check_pool_bwd(x, y, g, kernel, stride, lo) -> None:
    n = x.ndim - 2
    if not (len(kernel) == len(stride) == len(lo) == n and 1 <= n <= 3
            and tuple(y.shape) == tuple(g.shape) and y.shape[:2] == x.shape[:2]
            and y.ndim == x.ndim and min(kernel) >= 1 and min(stride) >= 1 and min(lo) >= 0):
        raise ValueError(f"max_pool_bwd: x {tuple(x.shape)}, y {tuple(y.shape)}, g "
                         f"{tuple(g.shape)} are not a pool of window {kernel}, stride "
                         f"{stride} over x padded by {lo} below")


def max_pool_bwd_plain(x, y, g, kernel, stride, lo) -> torch.Tensor:
    """Plain torch version of the kernel: x (N, C, *sp), y the pool of x
    zero-padded by `lo` below (and as far as the windows reach above), g
    its gradient -> dx (N, C, *sp) in x's type.  For each tap in scan
    order, the windows whose first maximum it is (equal to y, no earlier
    tap equal) add g to it, in f32 (g rounded to x's type first); the
    pads' share is dropped."""
    _check_pool_bwd(x, y, g, kernel, stride, lo)
    # the padded extent the windows read: (o - 1) * s + k
    ext = [(o - 1) * s + k for o, k, s in zip(y.shape[2:], kernel, stride)]
    xp = _pad_spatial(x, [(l, max(0, e - l - d)) for l, e, d in zip(lo, ext, x.shape[2:])])
    acc_t = torch.float64 if x.dtype == torch.float64 else torch.float32
    gf = g.to(x.dtype).to(acc_t)
    acc = torch.zeros(xp.shape, dtype=acc_t, device=x.device)
    found = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    for win in _windows(kernel, stride, y.shape[2:]):
        sel = (xp[win] == y) & ~found
        found |= sel
        acc[win] += torch.where(sel, gf, 0.0)
    inner = (slice(None), slice(None)) + tuple(slice(l, l + d) for l, d in zip(lo, x.shape[2:]))
    return acc[inner].to(x.dtype)


def _pool_bwd_fn():
    from picad_tpu_torch.ops import _build

    fn = _build.load("max_pool_bwd").picad_max_pool_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def max_pool_bwd(x, y, g, kernel, stride, lo) -> torch.Tensor:
    """The strided pools' backward (`max_pool_bwd_plain`'s function), from
    the unpadded x.

    CPU tensors: the plain version.  CUDA tensors: csrc/max_pool_bwd.cu,
    one launch, or raise."""
    if x.device.type == "cpu" and g.device.type == "cpu":
        return max_pool_bwd_plain(x, y, g, kernel, stride, lo)
    _check_pool_bwd(x, y, g, kernel, stride, lo)
    if x.device.type != "cuda" or y.device != x.device or g.device != x.device:
        raise ValueError(f"max_pool_bwd: tensors on {[str(t.device) for t in (x, y, g)]}; "
                         "the kernel wants all of them on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or y.dtype != x.dtype:
        raise TypeError(f"max_pool_bwd kernel takes f32 or bf16 x and y of one type, not "
                        f"{x.dtype} and {y.dtype}")
    lead = 3 - len(lo)  # a lower rank as leading dims of size 1
    one, zero = (1,) * lead, (0,) * lead
    sp, od = one + tuple(x.shape[2:]), one + tuple(y.shape[2:])
    if max(math.prod(sp), math.prod(od), x.shape[0] * x.shape[1]) > 2**31 - 1:
        raise ValueError("max_pool_bwd kernel: a plane or the count of planes exceeds int32")
    x, y, g = x.contiguous(), y.contiguous(), g.to(x.dtype).contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _pool_bwd_fn()(
            x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(), x.shape[0] * x.shape[1],
            *sp, *od, *(one + tuple(kernel)), *(one + tuple(stride)), *(zero + tuple(lo)),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"max_pool_bwd kernel launch failed: CUDA error {err}")
    max_pool_bwd.launches += 1
    c = x.shape[1]
    max_pool_bwd.launches_by_c[c] = max_pool_bwd.launches_by_c.get(c, 0) + 1
    return dx


max_pool_bwd.launches, max_pool_bwd.launches_by_c = 0, {}


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
