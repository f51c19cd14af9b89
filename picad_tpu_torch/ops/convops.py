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
  the window's gradient.  Each stage is `max_pool_axis` forward (the
  custom op `picad::max_pool_axis`, which torch.export keeps) and
  `max_pool_axis_bwd` backward, on the saved x and y: the hand-written
  kernels of csrc/max_pool_s1.cu on a CUDA tensor, one launch a stage,
  bit for bit their plain versions (`max_pool_axis_plain`,
  `max_pool_axis_bwd_plain`), which run on a CPU tensor.  Both count
  their launches as `max_pool_bwd` does.
- Strided pools keep the joint pool, whose
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


def max_pool_axis_plain(x: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    """Plain torch version of the stride-1 forward: x zero-padded along
    dim by same_pads(size, k, 1), then the max of every k consecutive."""
    lo, hi = same_pads(x.shape[dim], k, 1)
    pads = [(0, 0)] * (x.ndim - 2)
    pads[dim - 2] = (lo, hi)
    return _pad_spatial(x, pads).unfold(dim, k, 1).amax(dim=-1)


def max_pool_axis_bwd_plain(x, y, g, dim: int, k: int) -> torch.Tensor:
    """Plain torch version of the stride-1 backward (the JAX package's
    convops.py:248-265):

        dx[i] = sum over windows j containing i of 1[x[i] == y[j]] g[j],

    k shifted compare-and-add passes in f32, cast to x's type."""
    lo, _ = same_pads(x.shape[dim], k, 1)
    gf = g.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t in range(k):
        s = t - lo  # i = j + t - lo  =>  window j = i - (t - lo)
        ys = _shift(y, dim, s, float("-inf"))
        acc = acc + (x == ys).float() * _shift(gf, dim, s, 0.0)
    return acc.to(x.dtype)


def _axis_geometry(shape, dim: int, k: int, name: str) -> tuple[int, int, int, int]:
    """(outer, L, inner, lo) of a stride-1 stage along dim of a (N, C, *sp)
    tensor, raising on what no stage is."""
    if not (3 <= len(shape) <= 5 and 2 <= dim < len(shape) and k >= 1):
        raise ValueError(f"{name}: no stride-1 pool of window {k} along dim {dim} of a "
                         f"tensor {tuple(shape)} (N, C, 1 to 3 spatial dims)")
    return (math.prod(shape[:dim]), shape[dim], math.prod(shape[dim + 1:]),
            same_pads(shape[dim], k, 1)[0])


def _check_axis_cuda(name: str, *ts: torch.Tensor) -> None:
    if ts[0].device.type != "cuda" or any(t.device != ts[0].device for t in ts):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in ts]}; the kernel "
                         "wants all of them on one CUDA device")
    if ts[0].dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != ts[0].dtype
                                                                 for t in ts):
        raise TypeError(f"{name} kernel takes f32 or bf16 tensors of one type, not "
                        f"{[t.dtype for t in ts]}")
    if any(t.shape != ts[0].shape for t in ts) or ts[0].numel() > 2**31 - 1:
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ts]} differ or exceed "
                         "int32 elements")


def _axis_fns():
    from picad_tpu_torch.ops import _build

    lib = _build.load("max_pool_s1")
    fwd, bwd = lib.picad_max_pool_axis_fwd, lib.picad_max_pool_axis_bwd
    fwd.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _count_axis(fn, c: int) -> None:
    """One launch of fn's kernel, counted in all and for the channels."""
    fn.launches += 1
    fn.launches_by_c[c] = fn.launches_by_c.get(c, 0) + 1


def max_pool_axis(x: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    """One stride-1 stage along dim (`max_pool_axis_plain`'s function),
    through the custom op `picad::max_pool_axis`.

    CPU tensors: the plain version.  CUDA tensors: csrc/max_pool_s1.cu,
    one launch, or raise."""
    _axis_geometry(x.shape, dim, k, "max_pool_axis")
    return max_pool_axis_op(x, dim, k)


@torch.library.custom_op("picad::max_pool_axis", mutates_args=(), device_types="cpu")
def max_pool_axis_op(x: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    """The stage as a named op, so that torch.export keeps the kernel in a
    serving artifact: the plain version on the CPU (below: the kernel on
    the card, the output's shape for a trace).  No flop formula: a pool
    does no multiply-adds (bench/flops.py counts none)."""
    return max_pool_axis_plain(x, dim, k).contiguous()


@max_pool_axis_op.register_fake
def _(x, dim, k):
    return x.new_empty(x.shape)


@max_pool_axis_op.register_kernel("cuda")
def _max_pool_axis_cuda(x: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    outer, size, inner, lo = _axis_geometry(x.shape, dim, k, "max_pool_axis")
    _check_axis_cuda("max_pool_axis", x)
    x = x.contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = _axis_fns()[0](x.data_ptr(), y.data_ptr(), outer, size, inner, k, lo,
                             int(x.dtype == torch.bfloat16),
                             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"max_pool_axis kernel launch failed: CUDA error {err}")
    _count_axis(max_pool_axis, x.shape[1])
    return y


def max_pool_axis_bwd(x, y, g, dim: int, k: int) -> torch.Tensor:
    """The stride-1 stage's backward (`max_pool_axis_bwd_plain`'s
    function), from the stage's x and y.

    CPU tensors: the plain version.  CUDA tensors: csrc/max_pool_s1.cu,
    one launch, or raise."""
    outer, size, inner, lo = _axis_geometry(x.shape, dim, k, "max_pool_axis_bwd")
    if x.device.type == "cpu" and y.device.type == "cpu" and g.device.type == "cpu":
        return max_pool_axis_bwd_plain(x, y, g, dim, k)
    _check_axis_cuda("max_pool_axis_bwd", x, y, g)
    x, y, g = x.contiguous(), y.contiguous(), g.contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return dx
    with torch.cuda.device(x.device):
        err = _axis_fns()[1](x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(), outer,
                             size, inner, k, lo, int(x.dtype == torch.bfloat16),
                             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"max_pool_axis_bwd kernel launch failed: CUDA error {err}")
    _count_axis(max_pool_axis_bwd, x.shape[1])
    return dx


for _fn in (max_pool_axis, max_pool_axis_bwd):
    _fn.launches, _fn.launches_by_c = 0, {}


class _MaxPoolAxis(torch.autograd.Function):
    """Stride-1 zero-padded max pool along one dim, with the JAX
    package's all-ties backward (convops.py:248-265): forward
    `max_pool_axis`, backward `max_pool_axis_bwd` on the saved x and y."""

    @staticmethod
    def forward(ctx, x, dim, k):
        y = max_pool_axis(x, dim, k)
        ctx.save_for_backward(x, y)
        ctx.dim, ctx.k = dim, k
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return max_pool_axis_bwd(x, y, g, ctx.dim, ctx.k), None, None
