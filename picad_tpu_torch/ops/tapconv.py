"""Stride-1 VALID convolution as tap GEMMs: CUDA kernels and plain versions.

Counterpart of picad_tpu/ops/tapconv.py, in the JAX package's layout:
`tap_conv_valid(x, w)` takes x (B, *spatial, Ci) channels-last and
w (*k, Ci, Co) and returns (B, *out, Co) in x's type, any spatial rank.
Flatten x to the canvas rows (B * prod(spatial), Ci) and give tap t its
flat row shift off(t) = sum_d k_d(t) * stride_d; then

    out[m] = sum_t x[base(m) + off(t)] @ W[t]              (K3, forward)
    dx[p]  = sum_t gcan[p - off(t)] @ W[t]^T                (K4, input gradient)
    dW[t]  = sum_m x[base(m) + off(t)] (x) g[m]             (K5, weight gradient)

where m runs over the valid output positions, base(m) is the canvas row
of output position m, and gcan is g zero-embedded in the canvas (the JAX
package's form, tapconv.py:395-440).  Every sum is f32 over products of
inputs rounded to x's type, and only dW leaves the kernel in f32.

It is a `torch.autograd.Function`, differentiable in x and w:
- forward: csrc/tap_conv.cu's K3 on a CUDA tensor, `tap_conv_fwd_plain`
  on a CPU tensor;
- backward: g is rounded to x's type, then K4 and K5 on the card (the
  plain versions on the CPU); dW is cast to w's type, as the JAX
  package's `_tap_bwd` does.  It saves (x, w in x's type), not the output.

Kernels are built with nvcc at first use and bound with ctypes.  On a
CUDA tensor a wrapper launches its kernel or raises: there is no switch,
no shape gate and no fallback.  `tap_conv_fwd.launches`,
`tap_conv_dx.launches` and `tap_conv_dw.launches` count kernel launches,
and nothing else.  The `*_library` functions are cuDNN yardsticks that
chip_smoke.py times beside the kernels; the port never calls them.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import torch
import torch.nn.functional as F

# csrc/tap_conv.cu's modes
_FWD, _DX, _DW = 0, 1, 2
_MAX_RANK = 3  # spatial dims the kernel unravels
_BM = 128  # the kernel's row tile
_INT_MAX = 2**31 - 1


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 accumulation, or f64 for f64 inputs (gradcheck)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _geometry(x_shape, kshape):
    """(spatial dims, kernel dims, out dims) of a VALID conv of x
    (B, *sp, Ci) with w (*k, Ci, Co); raises on mismatched shapes."""
    sp, kd = tuple(x_shape[1:-1]), tuple(kshape[:-2])
    if len(sp) < 1 or len(sp) != len(kd) or x_shape[-1] != kshape[-2]:
        raise ValueError(f"tap_conv_valid wants x (B, *spatial, Ci) and w (*k, Ci, Co) of "
                         f"one rank; got {tuple(x_shape)} and {tuple(kshape)}")
    od = tuple(d - k + 1 for d, k in zip(sp, kd))
    if min(od) < 1:
        raise ValueError(f"tap_conv_valid: kernel {kd} larger than the input {sp}")
    return sp, kd, od


def _taps(kd, od):
    """(tap, window) pairs, taps in row-major order: the window is the
    slice of the input that tap reads for every output position."""
    for tap in itertools.product(*(range(k) for k in kd)):
        yield tap, (slice(None),) + tuple(slice(i, i + o) for i, o in zip(tap, od))


def tap_conv_fwd_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K3: one GEMM per tap over the shifted
    window, summed in f32; w is rounded to x's type first.  (B, *out, Co)
    in x's type."""
    _, kd, od = _geometry(x.shape, w.shape)
    acc = _acc_dtype(x)
    Ci, Co = w.shape[-2], w.shape[-1]
    xa = x.to(acc)
    wa = w.to(x.dtype).to(acc).reshape(-1, Ci, Co)
    out = None
    for t, (_, win) in enumerate(_taps(kd, od)):
        p = xa[win].reshape(-1, Ci) @ wa[t]
        out = p if out is None else out + p
    return out.reshape(x.shape[0], *od, Co).to(x.dtype)


def tap_conv_dx_plain(g: torch.Tensor, w: torch.Tensor, x_shape) -> torch.Tensor:
    """Plain torch version of K4: every tap's g @ W[t]^T added into the
    window it came from, in f32.  g (B, *out, Co) -> dx (B, *sp, Ci) in
    g's type; w is rounded to g's type first."""
    sp, kd, od = _geometry(x_shape, w.shape)
    acc = _acc_dtype(g)
    Ci, Co = w.shape[-2], w.shape[-1]
    ga = g.to(acc).reshape(-1, Co)
    wa = w.to(g.dtype).to(acc).reshape(-1, Ci, Co)
    dx = torch.zeros((x_shape[0], *sp, Ci), dtype=acc, device=g.device)
    for t, (_, win) in enumerate(_taps(kd, od)):
        dx[win] += (ga @ wa[t].T).reshape(x_shape[0], *od, Ci)
    return dx.to(g.dtype)


def tap_conv_dw_plain(x: torch.Tensor, g: torch.Tensor, kshape) -> torch.Tensor:
    """Plain torch version of K5: dW[t] = window(t)^T @ g in f32.
    x (B, *sp, Ci), g (B, *out, Co) in x's type -> (*k, Ci, Co) f32."""
    _, kd, od = _geometry(x.shape, kshape)
    acc = _acc_dtype(x)
    Ci, Co = kshape[-2], kshape[-1]
    xa = x.to(acc)
    ga = g.to(x.dtype).to(acc).reshape(-1, Co)
    dw = torch.stack([xa[win].reshape(-1, Ci).T @ ga for _, win in _taps(kd, od)])
    return dw.reshape(*kd, Ci, Co)


def library_operands(x, w, g=None, channels_last: bool = False):
    """The JAX-layout operands as cuDNN takes them: x (B, Ci, *sp), w (Co,
    Ci, *k), g (B, Co, *out), in channels_last memory when asked (2-D
    and 3-D only).  For the yardsticks below."""
    n = x.ndim - 2
    fmt = ({2: torch.channels_last, 3: torch.channels_last_3d}[n] if channels_last
           else torch.contiguous_format)
    to_cf = (0, n + 1) + tuple(range(1, n + 1))
    xn = x.permute(to_cf).contiguous(memory_format=fmt)
    wn = w.to(x.dtype).permute((n + 1, n) + tuple(range(n))).contiguous(memory_format=fmt)
    gn = None if g is None else g.to(x.dtype).permute(to_cf).contiguous(memory_format=fmt)
    return xn, wn, gn


def tap_conv_fwd_library(xn: torch.Tensor, wn: torch.Tensor) -> torch.Tensor:
    """K3's function as one cuDNN convolution (operands from
    `library_operands`)."""
    return {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[xn.ndim - 2](xn, wn)


def _convolution_backward(gn, xn, wn, mask):
    n = xn.ndim - 2
    return torch.ops.aten.convolution_backward(
        gn, xn, wn, None, [1] * n, [0] * n, [1] * n, False, [0] * n, 1, mask)


def tap_conv_dx_library(gn, xn, wn) -> torch.Tensor:
    """K4's function as cuDNN's data gradient of that convolution."""
    return _convolution_backward(gn, xn, wn, [True, False, False])[0]


def tap_conv_dw_library(gn, xn, wn) -> torch.Tensor:
    """K5's function as cuDNN's weight gradient of that convolution."""
    return _convolution_backward(gn, xn, wn, [False, True, False])[1]


def _kernel_fn():
    from picad_tpu_torch.ops import _build

    fn = _build.load("tap_conv").picad_tap_conv
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    """What the kernels take: one CUDA device, one type (f32 or bf16),
    contiguous 16-byte aligned operands."""
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in ts]}; the kernel "
                         "wants all of them on one CUDA device")
    if ts[0].dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != ts[0].dtype for t in ts):
        raise TypeError(f"{name} kernel takes f32 or bf16 operands of one type, not "
                        f"{[t.dtype for t in ts]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError(f"{name} kernel needs contiguous, 16-byte aligned operands")


def _launch(mode: int, name: str, a, b, out, x_shape, kshape) -> None:
    """Check what csrc/tap_conv.cu cannot take, then launch it on the
    current stream; raises if the launch fails."""
    sp, kd, od = _geometry(x_shape, kshape)
    Ci, Co = kshape[-2], kshape[-1]
    if len(sp) > _MAX_RANK:
        raise ValueError(f"{name} kernel: {len(sp)} spatial dims; it takes 1 to {_MAX_RANK}")
    if Ci % 8 or Co % 8:
        raise ValueError(f"{name} kernel needs Ci % 8 == 0 and Co % 8 == 0, got {Ci}, {Co}")
    B = x_shape[0]
    canvas = B * math.prod(sp)
    ntaps = math.prod(kd)
    if canvas * max(Ci, Co) > _INT_MAX or ntaps * Ci * Co > _INT_MAX:
        raise ValueError(f"{name} kernel: the operands exceed int32 indexing")
    rows = {_FWD: B * math.prod(od), _DX: canvas, _DW: Ci}[mode]
    if -(-rows // _BM) > 65535 or ntaps > 65535:
        raise ValueError(f"{name} kernel: {rows} rows or {ntaps} taps exceed the grid")
    pad = (1,) * (_MAX_RANK - len(sp))  # leading dims of size 1
    with torch.cuda.device(a.device):
        err = _kernel_fn()(
            mode, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            B, Ci, Co, *(pad + sp), *(pad + kd), int(a.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def tap_conv_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K3: x (B, *sp, Ci), w (*k, Ci, Co) -> (B, *out, Co) in x's type.

    CPU tensors: the plain version.  CUDA tensors: the kernel, or raise."""
    _, _, od = _geometry(x.shape, w.shape)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return tap_conv_fwd_plain(x, w)
    wq = w.to(x.dtype)
    _check_cuda("tap_conv_fwd", x, wq)
    out = torch.empty((x.shape[0], *od, w.shape[-1]), dtype=x.dtype, device=x.device)
    _launch(_FWD, "tap_conv_fwd", x, wq, out, x.shape, w.shape)
    tap_conv_fwd.launches += 1
    return out


def tap_conv_dx(g: torch.Tensor, w: torch.Tensor, x_shape) -> torch.Tensor:
    """K4: g (B, *out, Co) -> dx (B, *sp, Ci) in g's type.

    CPU tensors: the plain version.  CUDA tensors: the kernel, or raise."""
    sp, _, od = _geometry(x_shape, w.shape)
    if g.shape != (x_shape[0], *od, w.shape[-1]):
        raise ValueError(f"tap_conv_dx: g {tuple(g.shape)} is not the output of x "
                         f"{tuple(x_shape)} and w {tuple(w.shape)}")
    if g.device.type == "cpu" and w.device.type == "cpu":
        return tap_conv_dx_plain(g, w, x_shape)
    wq = w.to(g.dtype)
    # gcan: g zero-embedded in the canvas (tapconv.py:400-403); rows before
    # the canvas read as zero inside the kernel
    pads = []
    for d, o in zip(reversed(sp), reversed(od)):
        pads += [0, d - o]
    gcan = F.pad(g, [0, 0] + pads)
    _check_cuda("tap_conv_dx", gcan, wq)
    dx = torch.empty((x_shape[0], *sp, w.shape[-2]), dtype=g.dtype, device=g.device)
    _launch(_DX, "tap_conv_dx", gcan, wq, dx, tuple(x_shape), w.shape)
    tap_conv_dx.launches += 1
    return dx


def tap_conv_dw(x: torch.Tensor, g: torch.Tensor, kshape) -> torch.Tensor:
    """K5: x (B, *sp, Ci), g (B, *out, Co) -> dW (*k, Ci, Co) f32.

    CPU tensors: the plain version.  CUDA tensors: the kernel, or raise."""
    _, kd, od = _geometry(x.shape, kshape)
    if g.shape != (x.shape[0], *od, kshape[-1]):
        raise ValueError(f"tap_conv_dw: g {tuple(g.shape)} is not the output of x "
                         f"{tuple(x.shape)} and w {tuple(kshape)}")
    if x.device.type == "cpu" and g.device.type == "cpu":
        return tap_conv_dw_plain(x, g, kshape)
    gq = g.to(x.dtype).contiguous()
    _check_cuda("tap_conv_dw", x, gq)
    dw = torch.empty(tuple(kshape), dtype=torch.float32, device=x.device)
    _launch(_DW, "tap_conv_dw", x, gq, dw, x.shape, kshape)
    tap_conv_dw.launches += 1
    return dw


tap_conv_fwd.launches = 0
tap_conv_dx.launches = 0
tap_conv_dw.launches = 0


class _TapConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        wq = w.to(x.dtype)
        ctx.save_for_backward(x, wq)
        ctx.w_dtype = w.dtype
        return tap_conv_fwd(x, wq)

    @staticmethod
    def backward(ctx, g):
        x, wq = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = tap_conv_dx(g, wq, x.shape) if ctx.needs_input_grad[0] else None
        dw = tap_conv_dw(x, g, wq.shape).to(ctx.w_dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def tap_conv_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 VALID conv, x (B, *spatial, Ci) channels-last and contiguous,
    w (*k, Ci, Co) rounded to x's type -> (B, *out, Co) in x's type;
    differentiable in x and w.

    CPU tensors: the plain versions.  CUDA tensors: K3, K4 and K5, or raise."""
    return _TapConv.apply(x, w)
