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

The kernels' tiles are chosen here (`kernel_tile`) and passed to the
kernel, which refuses a tile it is not built for.  In bf16 on the card,
K3, K4 and K5 run csrc/tap_conv.cu's wgmma bodies, whose index plans are
made here at those tiles: `fwd_split_plan` splits K3's reduction into
groups whose f32 partials a second pass sums in order (so that the
blocks fill the card's SMs), `dx_tap_table` lists, for each row tile of
K4's canvas rows, the taps whose gcan rows can be non-zero there, and
`dw_plan` picks K5's form (the valid-row form for a wide Co; for a
narrow one the canvas form, dW[t] = sum_p x[p] (x) gcan[p - off(t)], whose
x tile serves a group of taps), its tap groups and its split.
`work_ratio` reads the multiply-adds each plan issues over the useful
ones.

Kernels are built with nvcc at first use and bound with ctypes.  On a
CUDA tensor a wrapper launches its kernel or raises: there is no switch,
no shape gate and no fallback.  `tap_conv_fwd.launches`,
`tap_conv_dx.launches` and `tap_conv_dw.launches` count kernel launches,
and nothing else; `launches_by_co` counts the same launches by Co, which
tells a model's convs apart.  The `*_library` functions are cuDNN
yardsticks that chip_smoke.py times beside the kernels; the port never
calls them.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# csrc/tap_conv.cu's modes
_FWD, _DX, _DW = 0, 1, 2
_MAX_RANK = 3  # spatial dims the kernel unravels
_BM = 128  # the row tile of the f32 kernels (rows in grid.y)
_STEP = 64  # the wgmma body's reduction step: (tap, channel) pairs
_DX_BM = 192  # bf16 K4's row tile (three warpgroups): a tap table row each
_SPLIT_WAVES = 8  # narrow K3: blocks an SM
_MAX_SPLIT = 8  # split groups of a wide (one block an SM) tile
_DW_CANVAS_CO = 64  # bf16 K5 takes the canvas form up to this Co
_DW_PAIR_CO = 32  # ... and puts two taps in a B box up to this Co
_DW_BOXES = 4  # ... B boxes (64 columns each) a block
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


def kernel_tile(mode: int, dtype, ci: int, co: int) -> tuple[int, int, int]:
    """(BM, BN, BK) of csrc/tap_conv.cu's block for this call: BM x BN
    outputs (rows x columns), reduction steps of BK.  bf16 K3 and K4 (the
    wgmma body, steps of _STEP): K3 128 x 256, or 64 x 64 when Co <= 64
    (three blocks an SM); K4 _DX_BM rows x an N tile that divides Ci where
    one can (832 = 4 x 208), 64 when Ci <= 64, else 256; K5 128 Ci rows x
    256 columns (Co, or a tap group's columns in the canvas form).  The
    f32 kernels: 128 x 128, or 128 x 32 for at most 32 output columns, in
    steps of 16."""
    if dtype == torch.bfloat16:
        if mode == _FWD:
            return (64, 64, _STEP) if co <= 64 else (128, 256, _STEP)
        if mode == _DX:
            return _DX_BM, (64 if ci <= 64 else 208 if ci % 208 == 0 else 256), _STEP
        return 128, 256, _STEP
    n = ci if mode == _DX else co
    return _BM, (128 if n > 32 else 32), 16


def _fewest_waves(tiles: int, sms: int) -> int:
    """The split count S <= _MAX_SPLIT whose `tiles` x S blocks (one
    block an SM, each 1 / S of a tile's work) take the least time in waves
    on `sms` SMs; the smallest on a tie."""
    return min(range(1, _MAX_SPLIT + 1), key=lambda k: (-(-tiles * k // sms) / k, k))


def fwd_split_plan(rows: int, ci: int, co: int, ntaps: int, sms: int) -> tuple[int, int]:
    """(groups S, steps per group) of bf16 K3's reduction at its tile:
    steps over the flat (tap, ci) index, group z taking steps [z * per,
    ...), none left empty.  Co <= 64 (three blocks an SM): enough groups
    for ~_SPLIT_WAVES blocks on each of the card's `sms` SMs.  Wider (one
    block an SM): the S <= 8 with the fewest waves of blocks on `sms` SMs
    per group, the smallest on a tie (PrimaryCaps' pose conv on 132 SMs:
    100 tiles x 5 at the train shape, 88 x 3 at serving)."""
    bm, bn, bk = kernel_tile(_FWD, torch.bfloat16, ci, co)
    steps = -(-ntaps * ci // bk)
    if steps == 0:
        return 1, 0
    tiles = -(-rows // bm) * -(-co // bn)
    s = -(-_SPLIT_WAVES * sms // tiles) if co <= 64 else _fewest_waves(tiles, sms)
    per = -(-steps // min(steps, s))
    return -(-steps // per), per


class DwPlan(NamedTuple):
    """bf16 K5's launch plan (`dw_plan`)."""

    form: str  # "rows": the valid-row form; "canvas": the canvas form
    tile: tuple[int, int, int]  # kernel_tile's (BM, BN, BK)
    # each block column's taps: the valid-row form ((t,),) for every tap;
    # the canvas form up to _DW_BOXES B boxes of one tap, or of two
    # neighbours in the last kernel dim (t, t + 1) for Co <= _DW_PAIR_CO
    groups: tuple[tuple[tuple[int, ...], ...], ...]
    splits: int  # S: the reduction's steps in S groups, summed in group order
    rows_per_split: int  # positions a split group sums (steps x BK)
    blocks: int


@functools.lru_cache(maxsize=256)
def dw_plan(batch: int, sp: tuple, kd: tuple, ci: int, co: int, sms: int,
            form: str | None = None) -> DwPlan:
    """bf16 K5's plan at its tile, for `sms` SMs (`form` defaults to
    "canvas" up to Co _DW_CANVAS_CO, else "rows").  The valid-row form:
    one block per (Ci tile, Co tile, tap), each summing every valid output
    position, no split (PrimaryCaps' pose conv at the train shape: 7 x 2
    x 81 = 1134 blocks).  The canvas form (Co <= _DW_CANVAS_CO): a B box
    is 64 columns, one tap, or for Co <= _DW_PAIR_CO two taps whose row
    shifts differ by one (t and t + 1 in one row of the last kernel dim; 5
    boxes a row of 9); up to _DW_BOXES consecutive boxes share a block and
    its x tile; the canvas rows split into S groups, S the count with the
    fewest waves of Ci tiles x tap groups x S blocks (one an SM), group z
    taking steps [z * per, (z + 1) * per) with per = ceil(steps / S), as
    the kernel computes it (the act conv at the train shape on 132 SMs: 45
    boxes in 12 groups, 7 x 12 tiles x S 3).  Cached: the wrappers ask for
    it on every launch."""
    tile = bm, bn, bk = kernel_tile(_DW, torch.bfloat16, ci, co)
    ntaps = math.prod(kd)
    ci_tiles = -(-ci // bm)
    form = form or ("canvas" if co <= _DW_CANVAS_CO else "rows")
    if form == "rows":
        steps = -(-batch * math.prod(d - k + 1 for d, k in zip(sp, kd)) // bk)
        return DwPlan(form, tile, tuple(((t,),) for t in range(ntaps)), 1, steps * bk,
                      ci_tiles * -(-co // bn) * ntaps)
    if form != "canvas" or co > _DW_CANVAS_CO:
        raise ValueError(f"dw_plan: no {form!r} form at Co {co}")
    last = kd[-1]
    if co <= _DW_PAIR_CO:
        boxes = [(t, t + 1) if t % last + 1 < last else (t,)
                 for t in range(ntaps) if t % last % 2 == 0]
    else:
        boxes = [(t,) for t in range(ntaps)]
    groups = tuple(tuple(boxes[i:i + _DW_BOXES]) for i in range(0, len(boxes), _DW_BOXES))
    steps = -(-batch * math.prod(sp) // bk)
    tiles = ci_tiles * len(groups)
    splits = 1
    if steps:
        per = -(-steps // min(_fewest_waves(tiles, sms), steps))
        splits = -(-steps // per)
    per = -(-steps // splits)
    return DwPlan(form, tile, groups, splits, per * bk, tiles * splits)


def dw_box_table(plan: DwPlan) -> np.ndarray:
    """The canvas form's box table for csrc/tap_conv.cu: int32 (groups, 1 +
    2 * _DW_BOXES), row i = [count, base tap, second tap or -1, ...] for
    the boxes of group i (-1 past the count)."""
    table = np.full((len(plan.groups), 1 + 2 * _DW_BOXES), -1, np.int32)
    for i, group in enumerate(plan.groups):
        table[i, 0] = len(group)
        for u, box in enumerate(group):
            table[i, 1 + 2 * u:3 + 2 * u] = (box[0], box[1] if len(box) > 1 else -1)
    return table


def dw_workspace_bytes(plan: DwPlan, canvas_rows: int, ci: int, co: int, ntaps: int) -> int:
    """The canvas form's workspace: its B matrix, bf16 (canvas rows + 1 for
    Co <= _DW_PAIR_CO, 64), which csrc/tap_conv.cu lays out from g (for
    two taps a box, row r = [gcan[r - 1], gcan[r]], each padded to 32
    channels), then 256-byte aligned the splits' f32 partials (S, taps,
    Ci, Co) when S > 1."""
    b_bytes = (canvas_rows + (co <= _DW_PAIR_CO)) * 64 * 2
    parts = plan.splits * ntaps * ci * co * 4 if plan.splits > 1 else 0
    return -(-b_bytes // 256) * 256 + parts


def work_ratio(mode: int, batch: int, sp, kd, ci: int, co: int, sms: int) -> float:
    """Multiply-adds the bf16 kernel issues over the useful ones, at its
    tile and plan: K3 pads rows, columns and reduction steps to the tile;
    K4 runs each row tile's listed taps (dx_tap_table); K5 pads Ci to a
    warpgroup's 64 rows (one past Ci issues nothing), the columns to the
    tile (in the canvas form every tap group takes a whole tile) and the
    positions to steps, and the canvas form sums every canvas row
    (dw_plan)."""
    bm, bn, bk = kernel_tile(mode, torch.bfloat16, ci, co)
    od = tuple(d - k + 1 for d, k in zip(sp, kd))
    rows, ntaps = batch * math.prod(od), math.prod(kd)
    useful = rows * ntaps * ci * co

    def pad(n, m):
        return -(-n // m) * m

    if mode == _FWD:
        return pad(rows, bm) * pad(co, bn) * pad(ntaps * ci, bk) / useful
    if mode == _DX:
        table = dx_tap_table(batch, sp, kd, bm)
        return bm * sum(pad(int(n) * co, bk) for n in table[:, 0]) * pad(ci, bn) / useful
    plan = dw_plan(batch, sp, kd, ci, co, sms)
    if plan.form == "rows":
        return pad(ci, 64) * pad(co, bn) * ntaps * pad(rows, bk) / useful
    return pad(ci, 64) * len(plan.groups) * bn * pad(batch * math.prod(sp), bk) / useful


def dx_tap_table(batch: int, sp, kd, bm: int) -> np.ndarray:
    """bf16 K4's tap lists: int32 (tiles, 1 + ntaps), one row per tile of
    bm canvas rows (of B * prod(sp); the kernel's tile is _DX_BM),
    [count, tap, ...] with the taps in row-major order.  A tap is listed
    when the gcan row it reads, p - off(t), is a valid output position
    for some row p of the tile, that is when 0 <= coord_d(p) - k_d(t) <
    o_d in every spatial dim d."""
    od = tuple(d - k + 1 for d, k in zip(sp, kd))
    coords = np.indices(sp).reshape(len(sp), -1).T  # (canvas rows of a sample, rank)
    taps = np.array(list(itertools.product(*(range(k) for k in kd))))  # (ntaps, rank)
    q = coords[:, None, :] - taps[None]
    live = ((q >= 0) & (q < np.array(od))).all(-1)  # (rows of a sample, ntaps)
    rows = batch * len(coords)
    tiles = -(-rows // bm)
    live = np.concatenate([np.tile(live, (batch, 1)),
                           np.zeros((tiles * bm - rows, len(taps)), bool)])
    live = live.reshape(tiles, bm, len(taps)).any(1)
    table = np.zeros((tiles, 1 + len(taps)), np.int32)
    table[:, 0] = live.sum(1)
    for i, row in enumerate(live):
        listed = np.flatnonzero(row)
        table[i, 1:1 + len(listed)] = listed
    return table


_TABLES: dict = {}  # (kind, geometry..., device) -> an index table on that device


def _table_on(device, key: tuple, make) -> torch.Tensor:
    """The int32 table make() returns, copied to `device` once per key."""
    key += (str(device),)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.from_numpy(make()).to(device)
    return t


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
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
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
    """Check what csrc/tap_conv.cu cannot take, pick its tile, make the
    index plans of its bf16 kernels at that tile (K3's f32 partials, K5's
    canvas-form workspace, and K4's tap and K5's box tables, cached per
    geometry and device), then launch it on the current stream; raises if
    the launch fails."""
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
    wgmma = a.dtype == torch.bfloat16  # output rows in grid.x, no limit
    bm, bn, bk = kernel_tile(mode, a.dtype, Ci, Co)
    rows = {_FWD: B * math.prod(od), _DX: canvas, _DW: Ci}[mode]
    if (not wgmma and -(-rows // bm) > 65535) or ntaps > 65535:
        raise ValueError(f"{name} kernel: {rows} rows or {ntaps} taps exceed the grid")
    taps, ws, splits, groups = None, None, 1, 0
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count if wgmma else 0
    if wgmma and mode == _FWD:
        splits, _ = fwd_split_plan(rows, Ci, Co, ntaps, sms)
    elif wgmma and mode == _DX:
        taps = _table_on(a.device, ("dx", B, sp, kd, bm), lambda: dx_tap_table(B, sp, kd, bm))
    elif wgmma:
        plan = dw_plan(B, sp, kd, Ci, Co, sms)
        if plan.form == "canvas":
            taps = _table_on(a.device, ("dw", plan.groups), lambda: dw_box_table(plan))
            groups, splits = len(plan.groups), plan.splits
    if splits > 1 and splits * (rows if mode == _FWD else ntaps * Ci) * Co > _INT_MAX:
        raise ValueError(f"{name} kernel: the split workspace exceeds int32 indexing")
    if mode == _FWD and splits > 1:
        ws = torch.empty((splits, rows, Co), dtype=torch.float32, device=a.device)
    elif groups:  # K5's canvas form: its B matrix and partials
        ws = torch.empty(dw_workspace_bytes(plan, canvas, Ci, Co, ntaps), dtype=torch.uint8,
                         device=a.device)
    pad = (1,) * (_MAX_RANK - len(sp))  # leading dims of size 1
    with torch.cuda.device(a.device):
        err = _kernel_fn()(
            mode, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            B, Ci, Co, *(pad + sp), *(pad + kd), int(a.dtype == torch.bfloat16), bm, bn, bk,
            None if taps is None else taps.data_ptr(), 0 if taps is None else taps.shape[1],
            None if ws is None else ws.data_ptr(), splits, groups,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _gcan(g: torch.Tensor, sp, od) -> torch.Tensor:
    """g (B, *od, Co) zero-embedded in the canvas (B, *sp, Co)
    (tapconv.py:400-403); rows before the canvas read as zero inside the
    kernels."""
    pads = [p for d, o in zip(reversed(sp), reversed(od)) for p in (0, d - o)]
    return F.pad(g, [0, 0] + pads)


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
    _count(tap_conv_fwd, w.shape[-1])
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
    gcan = _gcan(g, sp, od)
    _check_cuda("tap_conv_dx", gcan, wq)
    dx = torch.empty((x_shape[0], *sp, w.shape[-2]), dtype=g.dtype, device=g.device)
    _launch(_DX, "tap_conv_dx", gcan, wq, dx, tuple(x_shape), w.shape)
    _count(tap_conv_dx, w.shape[-1])
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
    _count(tap_conv_dw, kshape[-1])
    return dw


def _count(fn, co: int) -> None:
    """One launch of fn's kernel, counted in all and for its Co."""
    fn.launches += 1
    fn.launches_by_co[co] = fn.launches_by_co.get(co, 0) + 1


for _fn in (tap_conv_fwd, tap_conv_dx, tap_conv_dw):
    _fn.launches, _fn.launches_by_co = 0, {}


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
