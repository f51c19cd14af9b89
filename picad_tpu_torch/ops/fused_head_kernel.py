"""The fused decoder head's composite ConvT: CUDA kernels and plain versions.

`composite_convt(x, Kc)` is the raw composite scatter of
fused_head._raw_fused at d = 3 (picad_tpu/ops/pallas_fused_head.py:
composite_convt):

    out[b, 2i - 2 + tau] += Kc[b, tau, :] . x[b, i, :]     per axis,

a per-sample ConvT(k5, s2, p2, op1) contracted over channels, with no
cropped-plane corrections (fused_head._exact_fused adds those).  It is a
`torch.autograd.Function`:

- forward: the hand-written kernel csrc/composite_convt.cu on a CUDA
  tensor, `composite_convt_plain` on a CPU tensor;
- backward: `composite_convt_bwd`, i.e. csrc/composite_convt_bwd.cu on a
  CUDA tensor and `composite_convt_bwd_plain` on a CPU tensor.  It saves
  only (x, Kc), never the output, so the caller may add into the output
  in place.

Kernels are built with nvcc at first use and bound with ctypes.  On a
CUDA tensor a wrapper launches its kernel or raises: there is no
fallback.  The plain versions are also what the kernels are held against
on the card.  `composite_convt.launches` and `composite_convt_bwd.launches`
count kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import itertools

import torch
import torch.nn.functional as F

# per-axis scatter out[2i - 2 + tau] += z[i, tau], split by output parity
# phi: (tap, input shift) pairs per phase
_PHASE_TAPS = {0: [(0, 1), (2, 0), (4, -1)], 1: [(1, 1), (3, 0)]}
_NTAPS = 125
_TILE = 16  # composite_convt_bwd.cu's (h, w) tile


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 accumulation, or f64 for f64 inputs (gradcheck)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def composite_convt_plain(x: torch.Tensor, Kc: torch.Tensor) -> torch.Tensor:
    """Plain torch version, any rank d = 1..3.

    x (B, *sp, C), Kc (B, *5^d, C) -> (B, *(2 * sp)) f32.  Mirrors the XLA
    formulation of picad_tpu/ops/fused_head.py:154-193: pad x, one GEMM
    into the f32 tap tensor (B, *(sp + 2), 5^d), fold the taps into the
    2^d output phase planes, interleave.  Kc is rounded to x's type first
    and the products are taken in f32 (exact for bf16 operands), so the
    result is the f32-accumulated product of the rounded inputs.
    """
    d = x.ndim - 2
    B, sp, C = x.shape[0], tuple(x.shape[1:-1]), x.shape[-1]
    acc = _acc_dtype(x)
    xp = F.pad(x.to(acc), (0, 0) + (1, 1) * d)  # (B, *(sp + 2), C)
    kf = Kc.to(x.dtype).to(acc).reshape(B, 5**d, C)
    zp = torch.bmm(xp.reshape(B, -1, C), kf.transpose(1, 2))
    zp = zp.reshape(B, *(s + 2 for s in sp), *((5,) * d))

    phases = []
    for phi in itertools.product((0, 1), repeat=d):
        out = torch.zeros((B, *sp), dtype=acc, device=x.device)
        for taps in itertools.product(*[_PHASE_TAPS[p] for p in phi]):
            idx = (
                (slice(None),)
                + tuple(slice(1 + s, 1 + s + sp[a]) for a, (_, s) in enumerate(taps))
                + tuple(t for t, _ in taps)
            )
            out = out + zp[idx]
        phases.append(out)
    out = torch.stack(phases, dim=1).reshape(B, *((2,) * d), *sp)
    # (B, 2, .., 2, s1, .., sd) -> (B, s1, 2, .., sd, 2)
    perm = [0]
    for a in range(d):
        perm += [1 + d + a, 1 + a]
    return out.permute(perm).reshape(B, *(2 * s for s in sp))


def composite_convt_bwd_plain(g: torch.Tensor, x: torch.Tensor, Kc: torch.Tensor):
    """Plain torch backward of composite_convt (picad_tpu/ops/
    pallas_fused_head.py:_composite_bwd, its XLA branch :476-509).

    g (B, 2T, 2H, 2W), x (B, T, H, W, C), Kc (B, 5, 5, 5, C) ->
    (dx (B, T, H, W, C) in x's type, dKc (B, 5, 5, 5, C) f32).  g is
    rounded to x's type first, as the JAX package does.  The tap-gathered
    view G[b, i, tau] = g[b, 2i - 2 + tau] is materialised here (one
    unfold per axis of g zero-padded by 2 below and 1 above); the kernel
    never forms it."""
    B, T, H, W, C = x.shape
    acc = _acc_dtype(x)
    gp = F.pad(g.to(x.dtype).to(acc), (2, 1, 2, 1, 2, 1))  # (B, 2T+3, 2H+3, 2W+3)
    G = gp.unfold(1, 5, 2).unfold(2, 5, 2).unfold(3, 5, 2)  # (B, T, H, W, 5, 5, 5)
    G = G.reshape(B, T * H * W, _NTAPS)
    kf = Kc.to(x.dtype).to(acc).reshape(B, _NTAPS, C)
    dx = torch.bmm(G, kf).reshape(x.shape).to(x.dtype)
    dKc = torch.bmm(G.transpose(1, 2), x.to(acc).reshape(B, T * H * W, C))
    return dx, dKc.reshape(B, 5, 5, 5, C)


def composite_convt_library(x: torch.Tensor, Kc: torch.Tensor) -> torch.Tensor:
    """The same function as ONE grouped F.conv_transpose3d call (groups=B,
    x as (1, B*C, T, H, W), Kc as (B*C, 1, 5, 5, 5), s2 p2 op1).

    This is the library yardstick that chip_smoke.py times beside the
    kernels (its autograd.grad for the backward); the port never calls
    it.  Output in x's type, as cuDNN gives it.
    """
    B, T, H, W, C = x.shape
    xg = x.permute(0, 4, 1, 2, 3).reshape(1, B * C, T, H, W)
    wg = Kc.to(x.dtype).permute(0, 4, 1, 2, 3).reshape(B * C, 1, 5, 5, 5)
    y = F.conv_transpose3d(xg, wg, stride=2, padding=2, output_padding=1, groups=B)
    return y.reshape(B, 2 * T, 2 * H, 2 * W)


def composite_convt_bwd_library(g: torch.Tensor, x: torch.Tensor, Kc: torch.Tensor):
    """Both gradients of `composite_convt_library` from ONE
    aten.convolution_backward call (the cuDNN call its autograd makes),
    g rounded to x's type -> (dx, dKc (B, 5, 5, 5, C)), both in x's type.

    The library yardstick chip_smoke.py times beside the K2 kernel; the
    port never calls it."""
    B, T, H, W, C = x.shape
    xg = x.permute(0, 4, 1, 2, 3).reshape(1, B * C, T, H, W)
    wg = Kc.to(x.dtype).permute(0, 4, 1, 2, 3).reshape(B * C, 1, 5, 5, 5)
    gg = g.to(x.dtype).reshape(1, B, 2 * T, 2 * H, 2 * W)
    dxg, dwg, _ = torch.ops.aten.convolution_backward(
        gg, xg, wg, None, [2, 2, 2], [2, 2, 2], [1, 1, 1], True, [1, 1, 1], B,
        [True, True, False])
    dx = dxg.reshape(B, C, T, H, W).permute(0, 2, 3, 4, 1)
    return dx, dwg.reshape(B, C, 5, 5, 5).permute(0, 2, 3, 4, 1)


def _kernel_fn(name: str, n_ptr: int, n_int: int):
    from picad_tpu_torch.ops import _build

    fn = getattr(_build.load(name), f"picad_{name}")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(name: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    """What both kernels take: one CUDA device, f32 or bf16, C % 8 == 0,
    a contiguous 16-byte aligned x."""
    if x.device.type != "cuda" or any(t.device != x.device for t in others):
        raise ValueError(
            f"{name}: tensors on {[str(t.device) for t in (x, *others)]}; the "
            "kernel wants all of them on one CUDA device"
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel takes f32 or bf16, not {x.dtype}")
    if x.shape[-1] % 8 != 0:
        raise ValueError(f"{name} kernel needs C % 8 == 0, got C={x.shape[-1]}")
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError(f"{name} kernel needs a contiguous, 16-byte aligned x")


def _tap_matrix(x: torch.Tensor, Kc: torch.Tensor) -> torch.Tensor:
    """Kc rounded to x's type as a contiguous, aligned (B, 125, C)."""
    kc = Kc.to(x.dtype).reshape(x.shape[0], _NTAPS, x.shape[-1]).contiguous()
    return kc.clone() if kc.data_ptr() % 16 != 0 else kc  # a fresh allocation is aligned


def _composite_fwd(x: torch.Tensor, Kc: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return composite_convt_plain(x, Kc)
    _check_cuda("composite_convt", x, Kc)
    B, T, H, W, C = x.shape
    if B * T > 65535:
        raise ValueError(f"composite_convt kernel: B*T={B * T} exceeds the grid")
    kc = _tap_matrix(x, Kc)
    out = torch.empty((B, 2 * T, 2 * H, 2 * W), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel_fn("composite_convt", 3, 6)(
            x.data_ptr(), kc.data_ptr(), out.data_ptr(),
            B, T, H, W, C, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_convt kernel launch failed: CUDA error {err}")
    composite_convt.launches += 1
    return out


def composite_convt_bwd(g: torch.Tensor, x: torch.Tensor, Kc: torch.Tensor):
    """Both gradients of composite_convt: g (B, 2T, 2H, 2W), x (B, T, H, W,
    C), Kc (B, 5, 5, 5, C) -> (dx in x's type, dKc f32).

    CPU tensors: the plain version.  CUDA tensors: the K2 kernel, or raise."""
    B, T, H, W, C = x.shape
    if g.shape != (B, 2 * T, 2 * H, 2 * W) or Kc.shape != (B, 5, 5, 5, C):
        raise ValueError(
            f"composite_convt_bwd wants g (B, 2T, 2H, 2W) and Kc (B, 5, 5, 5, C) "
            f"for x {tuple(x.shape)}; got {tuple(g.shape)} and {tuple(Kc.shape)}"
        )
    if x.device.type == "cpu" and g.device.type == "cpu":
        return composite_convt_bwd_plain(g, x, Kc)
    _check_cuda("composite_convt_bwd", x, Kc, g)
    if B > 65535 or H > 16 * 65535:
        raise ValueError(f"composite_convt_bwd kernel: B={B}, H={H} exceed the grid")
    gq = g.to(x.dtype).contiguous()
    kc = _tap_matrix(x, Kc)
    n_tiles = -(-H // _TILE) * -(-W // _TILE)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    partial = torch.empty((B, n_tiles, _NTAPS, C), dtype=torch.float32, device=x.device)
    dkc = torch.empty((B, _NTAPS, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel_fn("composite_convt_bwd", 6, 6)(
            gq.data_ptr(), x.data_ptr(), kc.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dkc.data_ptr(),
            B, T, H, W, C, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_convt_bwd kernel launch failed: CUDA error {err}")
    composite_convt_bwd.launches += 1
    return dx, dkc.reshape(B, 5, 5, 5, C)


class _CompositeConvT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, Kc):
        ctx.save_for_backward(x, Kc)  # not the output: callers add into it
        return _composite_fwd(x, Kc)

    @staticmethod
    def backward(ctx, g):
        x, Kc = ctx.saved_tensors
        dx, dKc = composite_convt_bwd(g, x, Kc)
        return dx, dKc.to(Kc.dtype)


def composite_convt(x: torch.Tensor, Kc: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, W, C) f32 or bf16, contiguous; Kc (B, 5, 5, 5, C),
    rounded to x's type -> (B, 2T, 2H, 2W) f32, differentiable in both.

    CPU tensors: the plain versions.  CUDA tensors: the kernels, or raise."""
    if x.ndim != 5 or Kc.shape != (x.shape[0], 5, 5, 5, x.shape[-1]):
        raise ValueError(
            f"composite_convt wants x (B, T, H, W, C) and Kc (B, 5, 5, 5, C); "
            f"got {tuple(x.shape)} and {tuple(Kc.shape)}"
        )
    if x.device.type != "cpu" and (x.device.type != "cuda" or Kc.device != x.device):
        raise ValueError(
            f"composite_convt: x on {x.device}, Kc on {Kc.device}; the kernel "
            "wants both on one CUDA device"
        )
    return _CompositeConvT.apply(x, Kc)


composite_convt.launches = 0
composite_convt_bwd.launches = 0
