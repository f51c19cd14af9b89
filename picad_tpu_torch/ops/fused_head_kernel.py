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

In bf16 on the card both kernels run on wgmma, at plans made here and
testable without the card: K1 (csrc/composite_convt.cu) takes the
row-shift operand `fwd_operand(Kc)` (Bop, one gather from a cached index)
at `fwd_plan`'s w-tiles, row blocks and channel groups; K2
(csrc/composite_convt_bwd.cu) builds its G tiles through
`bwd_tap_table` and splits each sample's tiles by `bwd_plan`.  In f32
both run their FP32-core bodies.

Kernels are built with nvcc at first use and bound with ctypes.  On a
CUDA tensor a wrapper launches its kernel or raises: there is no
fallback.  The plain versions are also what the kernels are held against
on the card.  `composite_convt.launches` and `composite_convt_bwd.launches`
count kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# per-axis scatter out[2i - 2 + tau] += z[i, tau], split by output parity
# phi: (tap, input shift) pairs per phase
_PHASE_TAPS = {0: [(0, 1), (2, 0), (4, -1)], 1: [(1, 1), (3, 0)]}
_NTAPS = 125
_TILE = 16  # the f32 K2 body's (h, w) tile
# bf16 K1 (composite_convt.cu's wgmma body): the row-shift decomposition
# (s_t, s_h) in Bop's order: s_h major, so a product takes the 3 s_t of one s_h
_SHIFTS = tuple((st, sh) for sh in (-1, 0, 1) for st in (-1, 0, 1))
_FWD_TILE = 128  # input positions of a w-tile, from w0 - 1
_FWD_OWN = _FWD_TILE - 2  # outputs w' a w-tile owns: [w0, w0 + 126)
_FWD_ROWS = 2  # output rows h' a block owns
_FWD_N = 24  # Bop's columns a shift: (phi_t, phi_h, tau_w), 20 used
_FWD_NT = 3 * _FWD_N  # a product's columns: Bop's 3 s_t at one s_h
_CHUNK = 128  # channels a block: K1's channel group, K2's chunk
_BWD_TILE = 128  # bf16 K2 (composite_convt_bwd.cu's wgmma body): positions (w) a tile


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 accumulation, or f64 for f64 inputs (gradcheck)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _tau(s: int, phi: int):
    """The tap through which input shift s (i = o' + s) reaches output
    phase phi on one axis, or None (_PHASE_TAPS)."""
    return next((t for t, sh in _PHASE_TAPS[phi] if sh == s), None)


@functools.lru_cache(maxsize=None)
def fwd_operand_index() -> np.ndarray:
    """bf16 K1's operand as rows of Kc: int64 (9 * _FWD_N,), entry (shift
    (s_t, s_h), column n = (2 phi_t + phi_h) * 5 + tau_w) = the tap
    tau_t(s_t, phi_t) * 25 + tau_h(s_h, phi_h) * 5 + tau_w, or _NTAPS (a
    zero row) where the shift feeds no phase and in the 4 padding
    columns."""
    idx = np.full((len(_SHIFTS), _FWD_N), _NTAPS, np.int64)
    for si, (st, sh) in enumerate(_SHIFTS):
        for pt, ph, tw in itertools.product((0, 1), (0, 1), range(5)):
            a, b = _tau(st, pt), _tau(sh, ph)
            if a is not None and b is not None:
                idx[si, (2 * pt + ph) * 5 + tw] = a * 25 + b * 5 + tw
    return idx.reshape(-1)


_INDEX: dict = {}  # device -> fwd_operand_index() on it


def fwd_operand(Kc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Bop, bf16 K1's B operand: Kc (B, 5, 5, 5, C) -> (B, 9 * 24, C) in
    `dtype`, Bop[b, shift * 24 + n, c] = Kc[b, fwd_operand_index()[...], c]
    with a zero row for _NTAPS: one gather from an index cached per
    device."""
    B, C = Kc.shape[0], Kc.shape[-1]
    idx = _INDEX.get(Kc.device)
    if idx is None:
        idx = _INDEX[Kc.device] = torch.from_numpy(fwd_operand_index()).to(Kc.device)
    kz = F.pad(Kc.reshape(B, _NTAPS, C).to(dtype), (0, 0, 0, 1))  # row _NTAPS is zero
    return kz[:, idx]


class FwdPlan(NamedTuple):
    """bf16 K1's launch plan (`fwd_plan`)."""

    w_starts: tuple  # each w-tile's first output w'; its input rows start at w' - 1
    rows: int  # R: output rows h' a block owns
    row_blocks: int
    groups: int  # channel groups of _CHUNK, summed in group order when > 1
    blocks: int
    work_ratio: float  # issued multiply-adds over the useful ones


@functools.lru_cache(maxsize=256)
def fwd_plan(B: int, T: int, H: int, W: int, C: int) -> FwdPlan:
    """bf16 K1's plan: w-tiles of _FWD_TILE input positions from w0 - 1
    owning the outputs [w0, w0 + _FWD_OWN), blocks of _FWD_ROWS output rows
    of every frame, channel groups of _CHUNK.  A block loads each x row
    (t, h), h in [h0 - 1, h0 + R] inside x, once per 64-channel chunk, and
    issues a 128 x _FWD_NT x 64 product (the 3 s_t at s_h) for every row h'
    = h - s_h of the block: over all blocks, 3H - 2 products a frame,
    w-tile and chunk."""
    nwt = -(-W // _FWD_OWN)
    row_blocks = -(-H // _FWD_ROWS)
    groups = -(-C // _CHUNK)
    issued = B * nwt * T * (3 * H - 2) * _FWD_NT * _FWD_TILE * 64 * -(-C // 64)
    return FwdPlan(tuple(range(0, W, _FWD_OWN)), _FWD_ROWS, row_blocks, groups,
                   nwt * row_blocks * B * groups, issued / (B * T * H * W * C * _NTAPS))


@functools.lru_cache(maxsize=None)
def bwd_tap_table() -> np.ndarray:
    """bf16 K2's tap table: int32 (125, 3, 2), tap tau -> per axis (t, h,
    w) its (rho, m) with tau_axis = 2m + rho: G[i, tau] is the phase-rho
    plane of g along that axis at index i + m - 1."""
    taps = np.array(list(itertools.product(range(5), repeat=3)), np.int32)
    return np.stack([taps % 2, taps // 2], axis=-1)


class BwdPlan(NamedTuple):
    """bf16 K2's launch plan (`bwd_plan`)."""

    tiles: int  # tiles of a sample: T * w_tiles * H, tile q = (t * w_tiles + wt) * H + h
    w_tiles: int
    chunks: int  # channel chunks of _CHUNK
    splits: int  # S: each sample's tiles in S ranges of `per`, partials summed in order
    per: int
    blocks: int
    work_ratio: float


@functools.lru_cache(maxsize=256)
def bwd_plan(B: int, T: int, H: int, W: int, C: int, sms: int) -> BwdPlan:
    """bf16 K2's plan for `sms` SMs: tiles of _BWD_TILE positions along w
    (h fastest, so a block's next tile reuses 3 of its 5 g rows a frame),
    channel chunks of _CHUNK, and each sample's tiles split into S
    contiguous ranges, S = sms // (B * chunks) so that the blocks fill
    the card once (one block an SM), none empty.  The issued work pads the
    positions to the tile, the taps to 128 and C to the chunk."""
    nwt = -(-W // _BWD_TILE)
    tiles = T * nwt * H
    chunks = -(-C // _CHUNK)
    s = max(1, min(tiles, sms // (B * chunks)))
    per = -(-tiles // s)
    s = -(-tiles // per)
    ratio = nwt * _BWD_TILE / W * 128 / _NTAPS * chunks * _CHUNK / C
    return BwdPlan(tiles, nwt, chunks, s, per, s * chunks * B, ratio)


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
    out = torch.empty((B, 2 * T, 2 * H, 2 * W), dtype=torch.float32, device=x.device)
    ws, rows, groups = None, 0, 0
    if x.dtype == torch.bfloat16:  # the wgmma body at fwd_plan's plan
        plan = fwd_plan(B, T, H, W, C)
        rows, groups = plan.rows, plan.groups
        if B * groups > 65535 or plan.row_blocks > 65535:
            raise ValueError(f"composite_convt kernel: B={B}, H={H}, C={C} exceed the grid")
        kc = fwd_operand(Kc, x.dtype)
        if groups > 1:
            ws = torch.empty((groups, *out.shape), dtype=torch.float32, device=x.device)
    else:
        if B * T > 65535:
            raise ValueError(f"composite_convt kernel: B*T={B * T} exceeds the grid")
        kc = _tap_matrix(x, Kc)
    with torch.cuda.device(x.device):
        err = _kernel_fn("composite_convt", 4, 9)(
            x.data_ptr(), kc.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
            B, T, H, W, C, int(x.dtype == torch.bfloat16), rows, _FWD_OWN, groups,
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
    kc = _tap_matrix(x, Kc)
    if x.dtype == torch.bfloat16:  # the wgmma body at bwd_plan's plan; g rounded inside
        plan = bwd_plan(B, T, H, W, C,
                        torch.cuda.get_device_properties(x.device).multi_processor_count)
        gq = g.to(torch.float32).contiguous()
        gq = gq.clone() if gq.data_ptr() % 16 != 0 else gq
        n_part, tile, chunk, splits, per = plan.splits, _BWD_TILE, _CHUNK, plan.splits, plan.per
    else:
        gq = g.to(x.dtype).contiguous()
        n_part, tile, chunk, splits, per = -(-H // _TILE) * -(-W // _TILE), 0, 0, 0, 0
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    partial = torch.empty((B, n_part, _NTAPS, C), dtype=torch.float32, device=x.device)
    dkc = torch.empty((B, _NTAPS, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernel_fn("composite_convt_bwd", 6, 10)(
            gq.data_ptr(), x.data_ptr(), kc.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), dkc.data_ptr(),
            B, T, H, W, C, int(x.dtype == torch.bfloat16), tile, chunk, splits, per,
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
