"""The fused decoder head's composite ConvT: CUDA kernel and plain version.

`composite_convt(x, Kc)` is the raw composite scatter of
fused_head._raw_fused at d = 3 (picad_tpu/ops/pallas_fused_head.py:
composite_convt):

    out[b, 2i - 2 + tau] += Kc[b, tau, :] . x[b, i, :]     per axis,

a per-sample ConvT(k5, s2, p2, op1) contracted over channels, with no
cropped-plane corrections (fused_head._exact_fused adds those).

- On a CUDA tensor it launches the hand-written kernel
  csrc/composite_convt.cu (built with nvcc at first use, bound with
  ctypes) or raises: there is no fallback.
- On a CPU tensor it runs `composite_convt_plain`, the same function in
  plain torch, which is also what the kernel is held against on the card.

`composite_convt.launches` counts kernel launches, and nothing else.
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
    f32 = torch.float32
    xp = F.pad(x.to(f32), (0, 0) + (1, 1) * d)  # (B, *(sp + 2), C)
    kf = Kc.to(x.dtype).to(f32).reshape(B, 5**d, C)
    zp = torch.bmm(xp.reshape(B, -1, C), kf.transpose(1, 2))
    zp = zp.reshape(B, *(s + 2 for s in sp), *((5,) * d))

    phases = []
    for phi in itertools.product((0, 1), repeat=d):
        acc = torch.zeros((B, *sp), dtype=f32, device=x.device)
        for taps in itertools.product(*[_PHASE_TAPS[p] for p in phi]):
            idx = (
                (slice(None),)
                + tuple(slice(1 + s, 1 + s + sp[a]) for a, (_, s) in enumerate(taps))
                + tuple(t for t, _ in taps)
            )
            acc = acc + zp[idx]
        phases.append(acc)
    out = torch.stack(phases, dim=1).reshape(B, *((2,) * d), *sp)
    # (B, 2, .., 2, s1, .., sd) -> (B, s1, 2, .., sd, 2)
    perm = [0]
    for a in range(d):
        perm += [1 + d + a, 1 + a]
    return out.permute(perm).reshape(B, *(2 * s for s in sp))


def composite_convt_library(x: torch.Tensor, Kc: torch.Tensor) -> torch.Tensor:
    """The same function as ONE grouped F.conv_transpose3d call (groups=B,
    x as (1, B*C, T, H, W), Kc as (B*C, 1, 5, 5, 5), s2 p2 op1).

    This is the library yardstick that chip_smoke.py times beside the
    kernel; the port never calls it.  Output in x's type, as cuDNN gives it.
    """
    B, T, H, W, C = x.shape
    xg = x.permute(0, 4, 1, 2, 3).reshape(1, B * C, T, H, W)
    wg = Kc.to(x.dtype).permute(0, 4, 1, 2, 3).reshape(B * C, 1, 5, 5, 5)
    y = F.conv_transpose3d(xg, wg, stride=2, padding=2, output_padding=1, groups=B)
    return y.reshape(B, 2 * T, 2 * H, 2 * W)


def _kernel_fn():
    from picad_tpu_torch.ops import _build

    fn = _build.load("composite_convt").picad_composite_convt
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def composite_convt(x: torch.Tensor, Kc: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, W, C) f32 or bf16, contiguous; Kc (B, 5, 5, 5, C),
    rounded to x's type -> (B, 2T, 2H, 2W) f32.

    CPU tensor: the plain version.  CUDA tensor: the kernel, or raise."""
    if x.ndim != 5 or Kc.shape != (x.shape[0], 5, 5, 5, x.shape[-1]):
        raise ValueError(
            f"composite_convt wants x (B, T, H, W, C) and Kc (B, 5, 5, 5, C); "
            f"got {tuple(x.shape)} and {tuple(Kc.shape)}"
        )
    if x.device.type == "cpu":
        return composite_convt_plain(x, Kc)
    if x.device.type != "cuda" or Kc.device != x.device:
        raise ValueError(
            f"composite_convt: x on {x.device}, Kc on {Kc.device}; the kernel "
            "wants both on one CUDA device"
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"composite_convt kernel takes f32 or bf16, not {x.dtype}")
    B, T, H, W, C = x.shape
    if C % 8 != 0:
        raise ValueError(f"composite_convt kernel needs C % 8 == 0, got C={C}")
    if not x.is_contiguous() or x.data_ptr() % 16 != 0:
        raise ValueError("composite_convt kernel needs a contiguous, 16-byte aligned x")
    if B * T > 65535:
        raise ValueError(f"composite_convt kernel: B*T={B * T} exceeds the grid")
    kc = Kc.to(x.dtype).reshape(B, _NTAPS, C).contiguous()
    if kc.data_ptr() % 16 != 0:
        kc = kc.clone()  # a fresh allocation is aligned
    out = torch.empty((B, 2 * T, 2 * H, 2 * W), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            x.data_ptr(), kc.data_ptr(), out.data_ptr(),
            B, T, H, W, C, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_convt kernel launch failed: CUDA error {err}")
    composite_convt.launches += 1
    return out


composite_convt.launches = 0
