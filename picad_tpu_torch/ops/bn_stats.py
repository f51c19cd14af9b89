"""BatchNorm batch statistics per group: CUDA kernel and plain version.

Counterpart of picad_tpu/ops/bn_stats.py.  `group_stats(x, groups)` takes
the port's channels-first BN input x (N, C, *spatial), splits the batch
into `groups` contiguous groups and returns (mean, var), each (G, C) f32,
with var BIASED (/n), the statistic BatchNorm normalizes with.

Numerics: a shifted dual reduction, as the TPU kernel does.  The shift
is the mean of the first min(S, 1024) elements of each group's first
(sample, channel) plane (S = prod(spatial)), so var = E[(x-s)^2] -
E[x-s]^2 keeps two-pass accuracy where E[x^2] - E[x]^2 would cancel.
The shift is a constant of the data: the gradient is the exact analytic
one of (mean, var),

    dx = (g_mean + 2 (x - mean) g_var) / n,

in plain torch (picad_tpu/ops/bn_stats.py:181-191).

- On a CUDA tensor the forward launches csrc/bn_stats.cu (built with
  nvcc at first use, bound with ctypes) or raises: there is no fallback.
- On a CPU tensor it runs `bn_stats_plain`, which the kernel is also
  held against on the card.

`bn_stats.launches` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import math

import torch

SHIFT_N = 1024  # elements of a plane that set its group's shift


def _planes(x: torch.Tensor, groups: int) -> tuple[int, int, int]:
    N, C = x.shape[0], x.shape[1]
    if N % groups:
        raise ValueError(f"group_stats: batch {N} does not split into {groups} groups")
    return N, C, math.prod(x.shape[2:])


def bn_stats_plain(x: torch.Tensor, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: the same shift and the same f32 dual
    reduction as the kernel, summed in torch's order."""
    N, C, S = _planes(x, groups)
    xg = x.reshape(groups, N // groups, C, S)
    shift = xg[:, 0, :, : min(S, SHIFT_N)].float().mean(dim=2)  # (G, C)
    xs = xg.float() - shift[:, None, :, None]
    cnt = (N // groups) * S
    m1 = xs.sum(dim=(1, 3)) / cnt
    m2 = (xs * xs).sum(dim=(1, 3)) / cnt
    return m1 + shift, torch.clamp(m2 - m1 * m1, min=0.0)


def bn_stats_library(x: torch.Tensor, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One torch.var_mean call over the same groups: the library
    yardstick chip_smoke.py times beside the kernel; the port never
    calls it.  Returns (mean, var) like the kernel."""
    N, C, _ = _planes(x, groups)
    xg = x.reshape(groups, N // groups, C, -1).transpose(1, 2).flatten(2)
    var, mean = torch.var_mean(xg, dim=2, unbiased=False)
    return mean, var


def _kernel_fn():
    from picad_tpu_torch.ops import _build

    fn = _build.load("bn_stats").picad_bn_stats
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bn_stats(x: torch.Tensor, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) each (G, C) f32 of x (N, C, *spatial) f32 or bf16.

    CPU tensor: the plain version.  CUDA tensor: the kernel, or raise."""
    N, C, S = _planes(x, groups)
    if x.device.type == "cpu":
        return bn_stats_plain(x, groups)
    if x.device.type != "cuda":
        raise ValueError(f"bn_stats: x on {x.device}; the kernel wants a CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bn_stats kernel takes f32 or bf16, not {x.dtype}")
    if N * C > 2**31 - 1:
        raise ValueError(f"bn_stats kernel: N*C={N * C} planes exceed the grid")
    x = x.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((N, C, 2), **f32)
    shift = torch.empty((groups, C), **f32)
    mean = torch.empty((groups, C), **f32)
    var = torch.empty((groups, C), **f32)
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            x.data_ptr(), part.data_ptr(), shift.data_ptr(), mean.data_ptr(),
            var.data_ptr(), N, C, S, groups, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bn_stats kernel launch failed: CUDA error {err}")
    bn_stats.launches += 1
    return mean, var


bn_stats.launches = 0


class _GroupStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        mean, var = bn_stats(x, groups)
        ctx.save_for_backward(x, mean)
        ctx.groups = groups
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        x, mean = ctx.saved_tensors
        G = ctx.groups
        N, C, S = _planes(x, G)
        n = (N // G) * S
        xg = x.reshape(G, N // G, C, S).float()
        dx = (g_mean[:, None, :, None]
              + 2.0 * (xg - mean[:, None, :, None]) * g_var[:, None, :, None]) / n
        return dx.to(x.dtype).reshape(x.shape), None


def combine_group_stats(means: torch.Tensor, vars_: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased var) of the union of R parts of equal count, from
    each part's (mean, biased var) stacked on dim 0 (R, ...): the
    parallel-variance formula

        mean = mean_r(mean_r),  var = mean_r(var_r) + mean_r((mean_r - mean)^2),

    which cancels nothing, as the shifted reduction above.  Sync-BN
    combines the ranks' K6 results with it (parallel/mesh.global_stats)."""
    mean = means.mean(dim=0)
    return mean, vars_.mean(dim=0) + (means - mean).square().mean(dim=0)


def group_stats(x: torch.Tensor, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable per-group (mean, biased var), each (G, C) f32, of
    x (N, C, *spatial): the kernel's forward, the analytic backward."""
    return _GroupStats.apply(x, groups)
