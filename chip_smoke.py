#!/usr/bin/env python3
"""Bring-up check of picad_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py [--seed N]

Run from the repository root.  Each phase prints one line, and the first
failure exits non-zero (no phase is caught and passed over):

  1 device  nvidia-smi's name and power limit, and torch's device name.
  2 build   nvcc on every picad_tpu_torch/csrc/*.cu for sm_90a, one
            process per source, all started together; build seconds,
            ptxas's register/spill report, and the count of HGMMA (wgmma)
            instructions in each bf16 kernel of the built libraries, K1
            and K2 (composite_convt, composite_convt_bwd) and K3-K5
            (tap_conv) (cuobjdump -sass; fails if any has none: all five
            run on wgmma).
  3 kernel  each kernel against its plain PyTorch version on the same
            inputs, in bf16 and f32, max error <= 1e-4 * max|plain| (f32
            sums in another order; bf16 outputs also one bf16 ulp):
            composite_convt (K1) and composite_convt_bwd (K2) at the
            serving shape (14, 4, 112, 112, 128), the train shape (16,
            ...), a ragged shape and a wide one (W 300: three w-tiles; C
            136: two channel blocks), with their bf16 plans and work
            ratios (fused_head_kernel.fwd_plan, bwd_plan);
            bn_stats (K6) at the four BN inputs of the train step that take
            it, plus the cancellation-stress input (against float64);
            tap_conv_fwd, tap_conv_dx and tap_conv_dw (K3, K4, K5) at
            PrimaryCaps' pose (Co 512) and act (Co 32) convs, x (B, 28,
            28, 832) with B = 14 (serving) and 16 (train).  Kernel, plain
            and library times and the bound at the train shapes (K3-K5:
            cuDNN in NCHW and channels_last, the faster as library_ms;
            each tap kernel's useful TFLOP/s and its work ratio, the
            multiply-adds its tiles compute over the useful ones, from
            tapconv.work_ratio; K5's plan: form, tile, tap groups, split).
  4 slice   the CapsNet eval forward at 224^2, 24 classes, seeded
            weights, batch 2, f32 with TF32 off: card (CUDA kernel) vs CPU
            (plain version); same argmax class, scores and sigmoid seg
            within 1e-3.
  5 serve   the main path, bf16: ServingModel with clip_batch_size 14,
            predict_clips on 17 clips and predict_video on a 64-frame 224^2
            video, launch counts set to 0 just before and read just after
            (composite_convt must launch once per padded clip batch and
            tap_conv_fwd twice: the pose and act convs);
            finite outputs of the right shapes; warm clips/s; the bf16 vs
            f32 deviation on the same clips.
  6 profile torch.profiler over one warm 14-clip predict_clips: wall
            time, summed device time (kernels, copies, fills), its share
            of the wall, each port kernel's time and the top device
            entries (all of them in chiprun_out/chip_smoke.json).
  7 train-slice  one f32 train step (bn_groups 2, so both views fold
            into one forward; bv, dropout 0) at 96^2, batch 2, TF32 off,
            same seeded weights
            and batch, with every BN on K6: the card (K1-K6) against
            the CPU (their plain versions), inside a noise band the CPU
            measures on itself (N_DRAWS steps after rounding-size weight
            moves: EM routing's cost_std quirk, ROADMAP.md section 3,
            makes an f32 step's gradients that sensitive).  BN running
            stats tight; each loss term within NOISE_K times its band; the
            stable gradients per parameter, the noisy ones by relative L2.
  8 train   the training main path at full width, bf16: the bench
            configuration (bench.py:155-183: CapsNet bn_groups 2, Adam lr
            1e-4 eps 1e-6, bv window 5, wt_cons 0.1, folded views, batch 8 of
            8x224^2 uint8 clips, epoch 12, ramp 0.5), dropout 0.5 from a
            seeded generator, TRAIN_STEPS steps with the launch counts set
            to 0 just before and read just after: K1 and K2 once per step,
            K6 once per BN input of >= 2^22 elements per step, K3, K4 and
            K5 twice per step (the pose and act convs); finite
            losses, every parameter moved; warm step time, clips/s and
            peak memory.
  9 train-profile torch.profiler over one warm train step: wall, device
            time, busy share, each kernel's time and the top entries.
 10 stem    the plain 7^3/s2 stem (Unit3D) against StemS2D, bf16, at the
            train shape (16, 3, 8, 224, 224) and the serving shape (14,
            ...): eval forward and train forward + backward (dW and the BN
            backward; the clip needs no gradient) ms, StemS2D in NCDHW and
            in channels_last_3d; S2D within STEM_RTOL of plain (the eval
            output, and dW and the BN weight's gradient of a train step), and the packed uint8 branch
            against the f32 branch in f32 (TF32 off) within 1e-4 of the
            largest value; the model's default stem must be within
            STEM_CHOICE_SLACK of the fastest.
 11 data    the train step fed by the input pipeline, as bench.py:266-403:
            a DeviceVideoCache on the card from two SyntheticVideoSource(16,
            40 frames of 240x320) (labelled fractions 1 and 0, seeds 1 and
            2); the first card-assembled batch bit-identical to the host
            streaming ClipDataset(device_prep=True) batch of the same seed;
            then DATA_STEPS bf16 train steps through PrefetchLoader with
            make_assembler_put and DATA_STEPS through host streaming with
            pinned prefetch, each with the launch counts set to 0 just
            before and read just after (K1-K6 per step as in phase 8);
            finite losses, e2e clips/s and the median warm step wall of
            each, and which host path (libclip_ops.so or numpy) assembled
            the streaming batches.

Then three lines: nvidia-smi's name and power limit, the kernel table as
one JSON object, and last {"ok": true, "device": {...}}.  The full
results also go to chiprun_out/chip_smoke.json.  Without a CUDA card it
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from picad_tpu_torch.config import LossConfig
from picad_tpu_torch.data.dataset import ClipDataset
from picad_tpu_torch.data.device_cache import (
    DeviceClipDataset,
    DeviceVideoCache,
    make_assembler_put,
)
from picad_tpu_torch.data.loader import PrefetchLoader, SemiSupervisedBatcher
from picad_tpu_torch.data.sources import (
    CachedVideoSource,
    ConcatVideoSource,
    SyntheticVideoSource,
)
from picad_tpu_torch.models import i3d, layers
from picad_tpu_torch.models.capsules import build_capsnet
from picad_tpu_torch.ops import _build, tapconv
from picad_tpu_torch.ops import fused_head_kernel as fhk
from picad_tpu_torch.ops.bn_stats import bn_stats, bn_stats_library, bn_stats_plain
from picad_tpu_torch.ops.fused_head_kernel import (
    composite_convt,
    composite_convt_bwd,
    composite_convt_bwd_library,
    composite_convt_bwd_plain,
    composite_convt_library,
    composite_convt_plain,
)
from picad_tpu_torch.serve.runner import ServingModel
from picad_tpu_torch.train.state import create_train_state
from picad_tpu_torch.train.step import make_train_step

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 / FP32
SERVE_SHAPE = (14, 4, 112, 112, 128)  # the head input at clip batch 14, 224^2
TRAIN_SHAPE = (16, 4, 112, 112, 128)  # ... in the train step: [data; aug] of batch 8
RAGGED_SHAPE = (2, 3, 20, 13, 128)
WIDE_SHAPE = (2, 3, 5, 300, 136)  # K1 and K2 past one w-tile and one 128-channel block
# PrimaryCaps' two 9x9 VALID convs, x (B, 28, 28, 832) -> (B, 20, 20, Co):
# B = 14 serving, 16 in the train step; Co = 512 pose, 32 activation
PCAPS_BATCH = {"serve": 14, "train": 16}
PCAPS_CO = {"pose": 512, "act": 32}
# the train step's BN inputs of >= 2^22 elements (16 = [data; aug] of 8,
# G = 2): Conv3d_1a_7x7, Conv3d_2b_1x1, Conv3d_2c_3x3, Mixed_3c.b1b
BN_SHAPES = [(16, 64, 4, 112, 112), (16, 64, 4, 56, 56), (16, 192, 2, 56, 56),
             (16, 192, 2, 28, 28)]
KERNEL_RTOL = 1e-4  # of max|plain|: f32 accumulation in another order
BF16_ULP = 2.0**-7  # a bf16 output may round to the neighbour of the plain one
TRAIN_CFG = dict(bv=True, n_frames=5, wt_cons=0.1, thresh_epoch=11)  # bench.py:164
TRAIN_EPOCH, TRAIN_RAMP = 12.0, 0.5  # bench.py:182-183
TRAIN_BS, TRAIN_STEPS = 8, 6
# Phase 7 holds the card to the CPU with a noise band the CPU measures on
# itself: N_DRAWS more CPU steps, each after every weight moved by a
# seeded N(0, NOISE_MOVE) relative amount.  EM routing's cost_std quirk
# (ROADMAP.md section 3) makes an f32 train step's gradients upstream of
# the routing, and its class scores, move by percents under such a move,
# with heavy tails, so:
# - the BN running stats are held tight;
# - each loss term within NOISE_K times its band (loss and loss_cls, which
#   the quirk reaches through the class scores, have a band of ~3e-3;
#   loss_seg and loss_consistency one of ~3e-7), or METRIC_RTOL of it;
# - a gradient whose band is below STABLE_BAND (the decoder head's, which
#   K2's dKc feeds) within NOISE_K times its band, per parameter;
# - the other gradients together: their relative L2 distance within
#   GLOBAL_K times the largest of the draws'.
NOISE_MOVE, N_DRAWS = 1e-6, 3
NOISE_K, STABLE_BAND, GRAD_FLOOR, GLOBAL_K = 10.0, 1e-3, 1e-5, 3.0
STATS_TOL = 1e-5  # BN running stats, of the largest entry
METRIC_RTOL = 1e-4  # each loss term, beside the band
SLICE_ATOL = 1e-3  # card vs CPU f32: EM routing's cost_std quirk amplifies
# the summation-order noise of two conv libraries (the port vs op-by-op
# JAX on the CPU: up to 4.3e-4 on the scores over six fixture draws)
STEM_BATCH = {"train": 16, "serve": 14}  # [data; aug] of batch 8; the serving clip batch
STEM_RTOL = 1e-2  # of max|plain|: bf16 products summed in another order, rounded to bf16
STEM_CHOICE_SLACK = 1.10  # the default stem's time over the fastest's, at most
DATA_STEPS = 6  # train steps through each input path in phase 11
DATA_VIDEOS = 2 * TRAIN_BS  # videos per source, as bench.py:270


def phase(n, name, msg):
    print(f"[{n} {name}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


# the bf16 kernels: (library, a fragment of their device function names)
WGMMA_KERNELS = {"K1": ("composite_convt", "composite_convt_wgmma"),
                 "K2": ("composite_convt_bwd", "composite_bwd_wgmma"),
                 "K3": ("tap_conv", "tap_conv_fwd_wgmma"), "K4": ("tap_conv", "tap_conv_dx_wgmma"),
                 "K5": ("tap_conv", "tap_conv_dw_wgmma")}


def hgmma_counts(libs: dict) -> dict:
    """HGMMA (wgmma) instructions in the built libraries' SASS (`libs`:
    name -> path), summed over the functions of each of WGMMA_KERNELS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = dict.fromkeys(WGMMA_KERNELS, 0)
    for lib in sorted({lib for lib, _ in WGMMA_KERNELS.values()}):
        r = subprocess.run([tool, "-sass", str(libs[lib])], capture_output=True, text=True,
                           timeout=120, check=True)
        for fn in r.stdout.split("Function : ")[1:]:
            name = fn.split(None, 1)[0]
            for k, (klib, frag) in WGMMA_KERNELS.items():
                if klib == lib and frag in name:
                    counts[k] += len(re.findall(r"\bHGMMA\b", fn))
    return counts


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over `iters` back-to-back calls, after one
    warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def composite_bound_ms(shape, dtype) -> tuple[float, str]:
    """Least time for composite_convt's work: each input read once, the
    output written once, vs its FLOPs at the card's peak for the type."""
    B, T, H, W, C = shape
    item = torch.finfo(dtype).bits // 8
    nbytes = (B * T * H * W * C + B * 125 * C) * item + B * 8 * T * H * W * 4
    return bound(nbytes, 2 * B * T * H * W * C * 125, dtype)


def check_composite(shape, dtype, seed, timed: bool) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    B, _, _, _, C = shape
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    Kc = (0.05 * torch.randn((B, 5, 5, 5, C), generator=g, device="cuda")).to(dtype)
    out = composite_convt(x, Kc)
    torch.cuda.synchronize()
    ref = composite_convt_plain(x, Kc)
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not (out.shape == ref.shape and err <= KERNEL_RTOL * scale):
        raise AssertionError(
            f"composite_convt {shape} {dtype}: max|kernel - plain| = {err:.3e} "
            f"> {KERNEL_RTOL} * max|plain| = {KERNEL_RTOL * scale:.3e}"
        )
    res = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "max_abs_plain": scale}
    if timed:
        res["kernel_ms"] = cuda_ms(lambda: composite_convt(x, Kc), 20)
        res["plain_ms"] = cuda_ms(lambda: composite_convt_plain(x, Kc), 5)
        res["library_ms"] = cuda_ms(lambda: composite_convt_library(x, Kc), 3)
        res["bound_ms"], res["bound_by"] = composite_bound_ms(shape, dtype)
    return res


# the device names of each port kernel's CUDA functions
KERNEL_FRAGMENTS = {"composite_convt": ("composite_convt_kernel", "composite_convt_wgmma",
                                        "composite_convt_group_sum"),
                    "composite_convt_bwd": ("composite_bwd_kernel", "composite_bwd_wgmma",
                                            "reduce_partials"),
                    "bn_stats": ("plane_sums", "group_finish"),
                    "tap_conv_fwd": ("tap_conv_fwd_",),  # f32, wgmma and split-sum kernels
                    "tap_conv_dx": ("tap_conv_dx_",),
                    "tap_conv_dw": ("tap_conv_dw_",)}
TAP_COUNTERS = (tapconv.tap_conv_fwd, tapconv.tap_conv_dx, tapconv.tap_conv_dw)
COUNTERS = (composite_convt, composite_convt_bwd, bn_stats) + TAP_COUNTERS


def reset_counts() -> None:
    for fn in COUNTERS:
        fn.launches = 0
    for fn in TAP_COUNTERS:
        fn.launches_by_co = {}


def read_counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTERS}


def read_conv_counts() -> dict:
    """Each tap-conv wrapper's launches at PrimaryCaps' pose and act convs,
    as the wrapper counted them by Co."""
    return {fn.__name__: {conv: fn.launches_by_co.get(co, 0) for conv, co in PCAPS_CO.items()}
            for fn in TAP_COUNTERS}


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The larger of the byte time at the HBM rate and the operation
    time at the card's peak for the type, in ms."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref, name) -> float:
    """max|out - ref|, raising past KERNEL_RTOL * max|ref| (plus one bf16
    ulp of each value for a bf16 output)."""
    d = (out.float() - ref.float()).abs()
    tol = KERNEL_RTOL * ref.float().abs().max()
    if ref.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * ref.float().abs()
    if not (out.shape == ref.shape and out.dtype == ref.dtype and bool((d <= tol).all())):
        raise AssertionError(f"{name}: max|kernel - plain| = {d.max().item():.3e} past the "
                             f"tolerance (shape {tuple(out.shape)}, {out.dtype})")
    return d.max().item()


def check_composite_bwd(shape, dtype, seed, timed: bool) -> dict:
    """K2 against its plain backward: dx (x's type) and dKc (f32)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, T, H, W, C = shape
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    Kc = (0.05 * torch.randn((B, 5, 5, 5, C), generator=gen, device="cuda")).to(dtype)
    g = torch.randn((B, 2 * T, 2 * H, 2 * W), generator=gen, device="cuda")
    dx, dKc = composite_convt_bwd(g, x, Kc)
    torch.cuda.synchronize()
    dx_ref, dKc_ref = composite_convt_bwd_plain(g, x, Kc)
    res = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "dx_err": max_err(dx, dx_ref, "composite_convt_bwd dx"),
           "dKc_err": max_err(dKc, dKc_ref, "composite_convt_bwd dKc"),
           "max_abs_dx": dx_ref.float().abs().max().item(),
           "max_abs_dKc": dKc_ref.abs().max().item()}
    if timed:
        res["kernel_ms"] = cuda_ms(lambda: composite_convt_bwd(g, x, Kc), 10)
        res["plain_ms"] = cuda_ms(lambda: composite_convt_bwd_plain(g, x, Kc), 3)
        res["library_ms"] = cuda_ms(lambda: composite_convt_bwd_library(g, x, Kc), 3)
        item = torch.finfo(dtype).bits // 8
        n_x, n_g = B * T * H * W * C, B * 8 * T * H * W
        # g (in x's type), x and Kc read; dx (x's type) and dKc (f32) written
        nbytes = (n_g + 2 * n_x + B * 125 * C) * item + B * 125 * C * 4
        res["bound_ms"], res["bound_by"] = bound(nbytes, 4 * B * T * H * W * C * 125, dtype)
    return res


def check_bn_stats(shape, dtype, seed, timed: bool, groups: int = 2) -> dict:
    """K6 against its plain version: per-group mean and biased var."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (2.0 * torch.randn(shape, generator=gen, device="cuda") + 1.5).to(dtype)
    mean, var = bn_stats(x, groups)
    torch.cuda.synchronize()
    m_ref, v_ref = bn_stats_plain(x, groups)
    res = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "mean_err": max_err(mean, m_ref, "bn_stats mean"),
           "var_err": max_err(var, v_ref, "bn_stats var")}
    if timed:
        res["kernel_ms"] = cuda_ms(lambda: bn_stats(x, groups), 20)
        res["plain_ms"] = cuda_ms(lambda: bn_stats_plain(x, groups), 5)
        res["library_ms"] = cuda_ms(lambda: bn_stats_library(x, groups), 5)
        # x read once, (mean, var) written; sub, add and a multiply-add per element
        nbytes = x.numel() * x.element_size() + 2 * groups * shape[1] * 4
        res["bound_ms"], res["bound_by"] = bound(nbytes, 4 * x.numel(), torch.float32)
    return res


def check_bn_stats_stress(seed) -> dict:
    """|mean| = 100 std per channel: the shifted sums against float64
    two-pass statistics (mean rtol 1e-5, var rtol 2e-4, as the CPU test)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = 100.0 * torch.randn((1, 64, 1, 1, 1), generator=gen, device="cuda")
    x = base + 0.1 * torch.randn((16, 64, 4, 56, 56), generator=gen, device="cuda")
    mean, var = bn_stats(x, 2)
    x64 = x.double().reshape(2, 8, 64, -1).transpose(1, 2).flatten(2)
    m_rel = ((mean.double() - x64.mean(-1)).abs() / x64.mean(-1).abs()).max().item()
    v64 = x64.var(-1, unbiased=False)
    v_rel = ((var.double() - v64).abs() / v64).max().item()
    if not (m_rel <= 1e-5 and v_rel <= 2e-4):
        raise AssertionError(f"bn_stats stress: mean rel {m_rel:.2e}, var rel {v_rel:.2e}")
    return {"mean_rel_err": m_rel, "var_rel_err": v_rel}


TAP_LIBRARY = {  # one cuDNN call each, on the operands of tapconv.library_operands
    "tap_conv_fwd": lambda xn, wn, gn: tapconv.tap_conv_fwd_library(xn, wn),
    "tap_conv_dx": lambda xn, wn, gn: tapconv.tap_conv_dx_library(gn, xn, wn),
    "tap_conv_dw": lambda xn, wn, gn: tapconv.tap_conv_dw_library(gn, xn, wn),
}


TAP_MODES = {"tap_conv_fwd": tapconv._FWD, "tap_conv_dx": tapconv._DX,
             "tap_conv_dw": tapconv._DW}


def dw_plan_summary(batch: int, co: int) -> dict:
    """bf16 K5's plan at PrimaryCaps' shape on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = tapconv.dw_plan(batch, (28, 28), (9, 9), 832, co, sms)
    return {"form": plan.form, "tile": list(plan.tile), "groups": len(plan.groups),
            "max_taps_a_group": max(sum(map(len, g)) for g in plan.groups),
            "splits": plan.splits, "rows_per_split": plan.rows_per_split,
            "blocks": plan.blocks, "sms": sms}


def check_tapconv(batch: int, co: int, dtype, seed: int, timed: bool) -> dict:
    """K3, K4 and K5 against their plain versions at PrimaryCaps' shapes:
    x (batch, 28, 28, 832), w (9, 9, 832, co), g (batch, 20, 20, co).
    Timed: kernel, plain, and cuDNN's time in NCHW and channels_last (the
    faster is library_ms), and the bound from the useful work."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (0.5 * torch.randn((batch, 28, 28, 832), generator=gen, device="cuda")).to(dtype)
    w = (0.01 * torch.randn((9, 9, 832, co), generator=gen, device="cuda")).to(dtype)
    g = torch.randn((batch, 20, 20, co), generator=gen, device="cuda").to(dtype)
    fns = {
        "tap_conv_fwd": (lambda: tapconv.tap_conv_fwd(x, w),
                         lambda: tapconv.tap_conv_fwd_plain(x, w)),
        "tap_conv_dx": (lambda: tapconv.tap_conv_dx(g, w, x.shape),
                        lambda: tapconv.tap_conv_dx_plain(g, w, x.shape)),
        "tap_conv_dw": (lambda: tapconv.tap_conv_dw(x, g, w.shape),
                        lambda: tapconv.tap_conv_dw_plain(x, g, w.shape)),
    }
    res = {"batch": batch, "co": co, "dtype": str(dtype).replace("torch.", "")}
    if dtype == torch.bfloat16:
        res["dw_plan"] = dw_plan_summary(batch, co)
    for name, (kernel, plain) in fns.items():
        out = kernel()
        torch.cuda.synchronize()
        res[name] = {"err": max_err(out, plain(), f"{name} {batch}x28x28x832 -> {co} {dtype}")}
    if timed:
        item = torch.finfo(dtype).bits // 8
        n_x, n_w, n_o = batch * 28 * 28 * 832, 81 * 832 * co, batch * 20 * 20 * co
        flops = 2 * n_o * 81 * 832  # the useful work; the canvas form does more
        nbytes = {"tap_conv_fwd": (n_x + n_w + n_o) * item,  # x, w read; out written
                  "tap_conv_dx": (n_o + n_w + n_x) * item,  # g, w read; dx written
                  "tap_conv_dw": (n_x + n_o) * item + n_w * 4}  # x, g read; f32 dW
        layouts = {"nchw": tapconv.library_operands(x, w, g),
                   "channels_last": tapconv.library_operands(x, w, g, channels_last=True)}
        for name, (kernel, plain) in fns.items():
            r = res[name]
            r["kernel_ms"] = cuda_ms(kernel, 10)
            r["plain_ms"] = cuda_ms(plain, 3)
            r["library_ms_by_layout"] = {
                k: cuda_ms(lambda ops=ops, f=TAP_LIBRARY[name]: f(*ops), 5)
                for k, ops in layouts.items()}
            r["library_ms"] = min(r["library_ms_by_layout"].values())
            r["bound_ms"], r["bound_by"] = bound(nbytes[name], flops, dtype)
            r["useful_tflops"] = flops / r["kernel_ms"] / 1e9
            r["work_ratio"] = tapconv.work_ratio(
                TAP_MODES[name], batch, (28, 28), (9, 9), 832, co,
                torch.cuda.get_device_properties(0).multi_processor_count)
    return res


def synthetic_batch(rng, bs: int, size: int) -> dict:
    """The bench's production sample layout (bench.py:172-180): uint8
    clips, normalized and flipped on the device."""
    return {"data": rng.integers(0, 256, (bs, 8, size, size, 3), dtype=np.uint8),
            "loc_msk": (rng.random((bs, 8, size, size, 1)) > 0.7).astype(np.uint8),
            "action": rng.integers(0, 24, (bs,)).astype(np.int32),
            "label_vid": (np.arange(bs) % 2).astype(np.int32),
            "row_mask": np.ones((bs,), np.float32)}


def _f32_step(device: str, seed: int, batch: dict, move_seed: int | None = None):
    """One f32 train step from the seeded weights -> (metrics, gradients,
    BN buffers) on the host; with `move_seed`, every weight is first
    scaled by (1 + NOISE_MOVE * N(0, 1)) drawn from that seed."""
    state = create_train_state(seed=seed, device=device, compute_dtype=torch.float32,
                               bn_groups=2, dropout_rate=0.0)
    if move_seed is not None:
        gen = torch.Generator().manual_seed(move_seed)
        with torch.no_grad():
            for p in state.model.parameters():
                p.mul_(1.0 + NOISE_MOVE * torch.randn(p.shape, generator=gen).to(p.device))
    step = make_train_step(LossConfig(**TRAIN_CFG), device=device)
    state, metrics = step(state, batch, TRAIN_EPOCH, TRAIN_RAMP)
    model = state.model
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()})


def _rel_max(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a - ref).abs().max() / ref.abs().max()).item()


def _rel_l2(a: dict, ref: dict, names) -> float:
    num = sum(float((a[n] - ref[n]).square().sum()) for n in names)
    return (num / sum(float(ref[n].square().sum()) for n in names)) ** 0.5


def train_step_card_vs_cpu(seed: int = 1, size: int = 96) -> dict:
    """Phase 7: one f32 train step at size^2, batch 2, with every BN on
    K6 (one-pass threshold 0), TF32 off: the card against the CPU, within
    the CPU's own noise band (see NOISE_MOVE)."""
    saved = (layers.BN_ONEPASS_MIN, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    layers.BN_ONEPASS_MIN = 0
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        batch = synthetic_batch(np.random.default_rng(seed), 2, size)
        reset_counts()
        m_card, g_card, s_card = _f32_step("cuda", seed, batch)
        launches = read_counts()
        m_cpu, g_cpu, s_cpu = _f32_step("cpu", seed, batch)
        draws = [_f32_step("cpu", seed, batch, move_seed=k) for k in range(1, N_DRAWS + 1)]
    finally:
        (layers.BN_ONEPASS_MIN, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    n_bn = sum(isinstance(m, layers.TorchBatchNorm) for m in
               build_capsnet(device="cpu", compute_dtype=torch.float32).modules())
    want = {"composite_convt": 1, "composite_convt_bwd": 1, "bn_stats": n_bn,
            "tap_conv_fwd": 2, "tap_conv_dx": 2, "tap_conv_dw": 2}  # pose and act convs
    problems = [f"launches {launches} != {want}"] if launches != want else []

    metrics = {}
    for k, ref in m_cpu.items():
        d = abs(m_card[k] - ref)
        band = max(abs(m[k] - ref) for m, _, _ in draws)
        metrics[k] = {"card": m_card[k], "cpu": ref, "band": band}
        if k != "acc":
            ok = d <= max(NOISE_K * band, METRIC_RTOL * abs(ref))
        else:  # acc: argmax of the class scores, which the quirk moves
            ok = True
        if not ok:
            problems.append(f"metric {k}: card {m_card[k]} cpu {ref} (band {band:.2e})")
    stats_err = max(_rel_max(s_card[n], s_cpu[n]) for n in s_cpu)
    if stats_err > STATS_TOL:
        problems.append(f"BN running stats: {stats_err:.2e} of the largest entry")
    stable, noisy = [], []
    for n, ref in g_cpu.items():
        band = max(_rel_max(g[n], ref) for _, g, _ in draws)
        err = _rel_max(g_card[n], ref)
        (stable if band < STABLE_BAND else noisy).append((n, err, band))
        if band < STABLE_BAND and err > max(NOISE_K * band, GRAD_FLOOR):
            problems.append(f"grad {n}: {err:.2e} of its largest entry, band {band:.2e}")
    names = [n for n, _, _ in noisy]
    l2_card = _rel_l2(g_card, g_cpu, names)
    l2_band = max(_rel_l2(g, g_cpu, names) for _, g, _ in draws)
    if l2_card > GLOBAL_K * l2_band:
        problems.append(f"{len(names)} noisy gradients: relative L2 {l2_card:.2e}, "
                        f"band {l2_band:.2e}")
    return {"ok": not problems, "problems": problems[:20], "launches": launches,
            "metrics": metrics, "stats_max_rel": stats_err,
            "stable_grads": [{"name": n, "err": e, "band": b} for n, e, b in stable],
            "noisy_grads": {"n": len(names), "rel_l2": l2_card, "band_rel_l2": l2_band,
                            "max_err": max(e for _, e, _ in noisy)}}


def train_main_path(seed: int) -> tuple[dict, object]:
    """Phase 8: the bench configuration at full width in bf16 on the card,
    TRAIN_STEPS steps -> (results, a closure that runs one more step)."""
    state = create_train_state(seed=seed, device="cuda", bn_groups=2, dropout_rate=0.5)
    step = make_train_step(LossConfig(**TRAIN_CFG))  # folds: the model has bn_groups 2
    batch = synthetic_batch(np.random.default_rng(47 + seed), TRAIN_BS, 224)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    big_bn = []  # BN inputs that take K6, counted by hooks over the first step
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: big_bn.append(args[0].numel() >= layers.BN_ONEPASS_MIN))
        for m in state.model.modules() if isinstance(m, layers.TorchBatchNorm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    reset_counts()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, TRAIN_EPOCH, TRAIN_RAMP)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            for h in hooks:
                h.remove()
    launches, by_conv = read_counts(), read_conv_counts()
    n_big = sum(big_bn)
    want = {"composite_convt": TRAIN_STEPS, "composite_convt_bwd": TRAIN_STEPS,
            "bn_stats": n_big * TRAIN_STEPS, "tap_conv_fwd": 2 * TRAIN_STEPS,
            "tap_conv_dx": 2 * TRAIN_STEPS, "tap_conv_dw": 2 * TRAIN_STEPS}
    want_by_conv = {fn.__name__: {conv: TRAIN_STEPS for conv in PCAPS_CO} for fn in TAP_COUNTERS}
    moved = sum(not torch.equal(p.detach(), before[n])
                for n, p in state.model.named_parameters())
    finite = all(np.isfinite(v) for m in losses for v in m.values())
    warm_s = float(np.median(times[1:]))
    res = {"launches": launches, "want": want, "launches_by_conv": by_conv,
           "big_bn_per_step": n_big,
           "params_moved": moved, "n_params": len(before), "losses": losses,
           "step_s": times, "warm_step_ms": warm_s * 1e3,
           "clips_per_s": TRAIN_BS / warm_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if not (launches == want and by_conv == want_by_conv and moved == len(before) and finite):
        raise AssertionError(f"train: launches {launches} (want {want}), by conv {by_conv} "
                             f"(want {want_by_conv}), parameters moved "
                             f"{moved}/{len(before)}, losses finite {finite}: {losses}")
    return res, lambda: step(state, batch, TRAIN_EPOCH, TRAIN_RAMP)


def _stem_module(cls, w, dtype=torch.bfloat16):
    m = cls(3, 64, (7, 7, 7), (2, 2, 2), compute_dtype=dtype, bn_groups=2).cuda()
    with torch.no_grad():
        m.conv3d.weight.copy_(w)
    return m


def _within(out, ref, name, rtol=STEM_RTOL) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not (out.shape == ref.shape and err <= rtol * scale):
        raise AssertionError(f"stem {name}: max|s2d - ref| = {err:.3e} > {rtol} * "
                             f"{scale:.3e} (shapes {tuple(out.shape)}, {tuple(ref.shape)})")
    return err


def stem_phase(seed: int) -> dict:
    """Phase 10: the plain stem against StemS2D in both layouts, bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((64, 3, 7, 7, 7), generator=gen, device="cuda") * (3 * 343) ** -0.5
    variants = {"plain": (layers.Unit3D, i3d.S2D_CHANNELS_LAST),
                "s2d_ncdhw": (i3d.StemS2D, False), "s2d_channels_last": (i3d.StemS2D, True)}
    default = "s2d_channels_last" if i3d.S2D_CHANNELS_LAST else "s2d_ncdhw"
    saved = i3d.S2D_CHANNELS_LAST
    res = {"default": default}
    try:
        for use, batch in STEM_BATCH.items():
            clip = torch.randint(0, 256, (batch, 8, 224, 224, 3), generator=gen, device="cuda",
                                 dtype=torch.uint8)
            x = (clip.float() / 255.0).permute(0, 4, 1, 2, 3)  # the model's view of its clips
            r = torch.randn((batch, 64, 4, 112, 112), generator=gen,
                            device="cuda").to(torch.bfloat16)
            row, outs = {}, {}
            for name, (cls, channels_last) in variants.items():
                i3d.S2D_CHANNELS_LAST = channels_last
                m = _stem_module(cls, w)

                def fwd(m=m):
                    with torch.inference_mode():
                        return m.eval()(x)

                def fwd_bwd(m=m):
                    m.train().zero_grad(set_to_none=True)
                    y = m(x)
                    y.backward(r)
                    return y

                fwd_bwd()
                outs[name] = (fwd(), m.conv3d.weight.grad.clone(), m.bn.weight.grad.clone())
                row[name] = {"fwd_ms": cuda_ms(fwd, 10), "fwd_bwd_ms": cuda_ms(fwd_bwd, 10)}
                del m
            for name in ("s2d_ncdhw", "s2d_channels_last"):
                row[name]["errs"] = {
                    part: _within(a, b, f"{name} {use} {part}")
                    for part, a, b in zip(("out", "dW", "d_bn_weight"), outs[name], outs["plain"])}
            # the packed uint8 branch against the f32 branch, both in f32
            # with TF32 off: conv(x, w/255) == conv(x/255, w) up to f32 rounding
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            m = _stem_module(i3d.StemS2D, w, torch.float32).eval()
            with torch.inference_mode():
                row["packed_u8_err"] = _within(m(i3d.s2d_pack(clip).permute(0, 4, 1, 2, 3)), m(x),
                                               "packed uint8 (f32)", KERNEL_RTOL)
            torch.backends.cudnn.allow_tf32 = tf32
            del m
            s2d = ("s2d_ncdhw", "s2d_channels_last")
            row["faster_s2d_layout"] = min(s2d, key=lambda k: row[k]["fwd_bwd_ms"])
            for metric in ("fwd_ms", "fwd_bwd_ms"):
                best = min(row[k][metric] for k in variants)
                if row[default][metric] > STEM_CHOICE_SLACK * best:
                    raise AssertionError(
                        f"stem {use}: the default {default} takes {row[default][metric]:.4f} ms "
                        f"{metric}, the fastest {best:.4f} ms: {row}")
            res[use] = row
    finally:
        i3d.S2D_CHANNELS_LAST = saved
    return res


def _epochs_forever(batcher, first: int = 1):
    e = first
    while True:
        yield from batcher.epoch(e)
        e += 1


def _train_through(loader, step, state, want: dict) -> dict:
    """DATA_STEPS train steps on batches from `loader`, launch counts set
    to 0 just before and read just after; each step's wall includes
    waiting for its batch."""
    times, losses = [], []
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(DATA_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, next(loader), TRAIN_EPOCH, TRAIN_RAMP)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = read_counts()
    warm = times[1:]
    res = {"launches": launches, "step_s": times, "losses": losses,
           "median_step_ms": float(np.median(warm)) * 1e3,
           "e2e_clips_per_s": TRAIN_BS * len(warm) / sum(warm),
           "finite": all(np.isfinite(v) for m in losses for v in m.values())}
    if not (launches == want and res["finite"]):
        raise AssertionError(f"data: launches {launches} (want {want}), losses {losses}")
    return res


def data_phase(seed: int, big_bn: int) -> dict:
    """Phase 11: the bench-configuration train step fed through the
    card-resident video cache and through host streaming."""
    def make_src(labeled, src_seed):
        return SyntheticVideoSource(DATA_VIDEOS, video_len=40, labeled_fraction=labeled,
                                    seed=src_seed)

    t0 = time.perf_counter()
    cache = DeviceVideoCache.build(ConcatVideoSource([make_src(1.0, 1), make_src(0.0, 2)]),
                                   budget_bytes=4 << 30)
    torch.cuda.synchronize()
    res = {"cache_build_s": time.perf_counter() - t0,
           "pool_frames": cache.pool_video.shape[0],
           "pool_mb": (cache.pool_video.numel() + cache.pool_mask.numel()) / 1e6}
    pools = {"pool_video": cache.pool_video, "pool_mask": cache.pool_mask}
    hw = (224, 224)

    def meta_ds(offset):
        return DeviceClipDataset(cache, index_offset=offset, length=DATA_VIDEOS, train=True,
                                 clip_shape=hw)

    def stream_ds(labeled, src_seed):
        return ClipDataset(CachedVideoSource(make_src(labeled, src_seed), capacity_bytes=2 << 30),
                           train=True, clip_shape=hw, device_prep=True)

    kw = dict(batch_size=TRAIN_BS, seed=0, process_index=0, process_count=1)
    cache_batcher = SemiSupervisedBatcher(meta_ds(0), meta_ds(DATA_VIDEOS), workers=2, **kw)
    lab, unl = stream_ds(1.0, 1), stream_ds(0.0, 2)
    stream_batcher = SemiSupervisedBatcher(lab, unl, workers=8, **kw)
    res["host_assembler"] = ("libclip_ops.so" if lab._native is not None and unl._native is not None
                             else "numpy")
    for _ in stream_batcher.epoch(0):  # warm the decode cache, as bench.py does
        pass

    # the first card-assembled batch against the host streaming batch
    assembler = make_assembler_put(pools, hw)
    card_it = iter(PrefetchLoader(cache_batcher.epoch(1), put_fn=assembler))
    host_it = stream_batcher.epoch(1)
    card_batch, host_batch = next(card_it), next(host_it)
    card_it.close()
    host_it.close()
    same = {k: (tuple(card_batch[k].shape) == host_batch[k].shape
                and card_batch[k].dtype == torch.from_numpy(host_batch[k]).dtype
                and np.array_equal(card_batch[k].cpu().numpy(), host_batch[k]))
            for k in host_batch}
    res["first_batch_bit_identical"] = same
    if set(card_batch) != set(host_batch) or not all(same.values()):
        raise AssertionError(f"data: card-assembled batch differs from the host batch: {same}")

    want = {"composite_convt": DATA_STEPS, "composite_convt_bwd": DATA_STEPS,
            "bn_stats": big_bn * DATA_STEPS, "tap_conv_fwd": 2 * DATA_STEPS,
            "tap_conv_dx": 2 * DATA_STEPS, "tap_conv_dw": 2 * DATA_STEPS}
    step = make_train_step(LossConfig(**TRAIN_CFG))
    for path, loader in (
            ("device_cache", PrefetchLoader(_epochs_forever(cache_batcher), put_fn=assembler)),
            ("host_streaming", PrefetchLoader(_epochs_forever(stream_batcher)))):
        state = create_train_state(seed=seed, device="cuda", bn_groups=2, dropout_rate=0.5)
        it = iter(loader)
        try:
            res[path] = _train_through(it, step, state, want)
        finally:
            it.close()
        del state
    res["launches_per_step"] = {k: v // DATA_STEPS for k, v in want.items()}
    return res


def profile_call(fn) -> dict:
    """torch.profiler over one warm call of fn: wall time, the summed
    device time (kernels, copies, fills), its share of the wall, each
    port kernel's time, and the entries with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels, copies and fills on the card (annotations mirrored there excluded)
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)]
    by_name: dict = {}
    for e in device_events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_name.values())
    # which convolution spends it: the cuDNN calls with their input shapes
    convs = sorted(
        ({"op": e.name, "shapes": e.input_shapes[:2], "device_ms": e.device_time_total / 1e3}
         for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("aten::cudnn_")),
        key=lambda c: -c["device_ms"],
    )
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "kernel_ms": {k: sum(ms for name, (ms, _) in top if any(f in name for f in frags))
                      for k, frags in KERNEL_FRAGMENTS.items()},
        "top": [{"name": k, "device_ms": ms, "count": n} for k, (ms, n) in top[:25]],
        "convs": convs[:15],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result", file=sys.stderr)
        return 1
    results: dict = {}

    # 1 device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    results["device"] = {"nvidia_smi": smi, "torch": kind,
                         "torch_version": torch.__version__, "cuda": torch.version.cuda}
    phase(1, "device", f"nvidia-smi: {smi} | torch: {kind} | torch {torch.__version__} "
          f"CUDA {torch.version.cuda}")

    # 2 build
    t0 = time.perf_counter()
    builds = _build.build()
    wall = time.perf_counter() - t0
    ptxas = {b.name: re.findall(r"Used \d+ registers|\d+ bytes spill stores, \d+ bytes spill loads",
                                   b.log) for b in builds}
    hgmma = hgmma_counts({b.name: b.path for b in builds})
    results["build"] = {"wall_s": wall, "per_source_s": {b.name: b.seconds for b in builds},
                        "ptxas": ptxas, "hgmma": hgmma}
    if not all(hgmma.values()):
        raise AssertionError(f"a bf16 kernel without HGMMA (lost wgmma): {hgmma}")
    phase(2, "build", f"{len(builds)} source(s) for sm_90a in {wall:.1f} s: "
          + "; ".join(f"{b.name} {b.seconds:.1f} s {ptxas[b.name]}" for b in builds)
          + f" | HGMMA instructions in the bf16 kernels: {hgmma}, "
          f"{sum(hgmma.values())} in all (K1-K5 each on wgmma)")

    # 3 kernels vs plain
    reset_counts()
    checks = [
        check_composite(SERVE_SHAPE, torch.bfloat16, args.seed, timed=True),
        check_composite(SERVE_SHAPE, torch.float32, args.seed, timed=True),
        check_composite(TRAIN_SHAPE, torch.bfloat16, args.seed, timed=True),
        check_composite(TRAIN_SHAPE, torch.float32, args.seed, timed=False),
    ] + [check_composite(shape, dtype, args.seed + 1, timed=False)
         for shape in (RAGGED_SHAPE, WIDE_SHAPE) for dtype in (torch.bfloat16, torch.float32)]
    bwd = [
        check_composite_bwd(TRAIN_SHAPE, torch.bfloat16, args.seed, timed=True),
        check_composite_bwd(TRAIN_SHAPE, torch.float32, args.seed, timed=True),
    ] + [check_composite_bwd(shape, dtype, args.seed + 1, timed=False)
         for shape in (SERVE_SHAPE, RAGGED_SHAPE, WIDE_SHAPE)
         for dtype in (torch.bfloat16, torch.float32)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k12_plans = {
        "composite_convt": {use: fhk.fwd_plan(*shape)._asdict()
                            for use, shape in (("serve", SERVE_SHAPE), ("train", TRAIN_SHAPE))},
        "composite_convt_bwd": {"train": fhk.bwd_plan(*TRAIN_SHAPE, sms)._asdict(), "sms": sms},
    }
    stats = [check_bn_stats(shape, dtype, args.seed + k, timed=(k == 0))
             for k, shape in enumerate(BN_SHAPES) for dtype in (torch.bfloat16, torch.float32)]
    stress = check_bn_stats_stress(args.seed)
    taps = [check_tapconv(PCAPS_BATCH[use], PCAPS_CO[conv], dtype, args.seed + k,
                          timed=(use == "train" and dtype == torch.bfloat16))
            for k, (use, conv, dtype) in enumerate(itertools.product(
                PCAPS_BATCH, PCAPS_CO, (torch.bfloat16, torch.float32)))]
    results.update(composite_convt=checks, composite_convt_bwd=bwd, bn_stats=stats,
                   bn_stats_stress=stress, tap_conv=taps, composite_plans=k12_plans)
    n_checked = read_counts()

    def timing(c):
        return (f" kernel_ms {c['kernel_ms']:.4f} plain_ms {c['plain_ms']:.4f} library_ms "
                f"{c['library_ms']:.4f} bound_us {1e3 * c['bound_ms']:.1f} ({c['bound_by']})"
                if "kernel_ms" in c else "")

    phase(3, "kernel", "tol 1e-4*max|plain| (+1 bf16 ulp): composite_convt " + "; ".join(
        f"{c['dtype']} {tuple(c['shape'])} err {c['max_abs_err']:.2e}" + timing(c)
        for c in checks) + " | K1 plan: {blocks} blocks of {rows} rows x every frame over "
        "{nwt} w-tile(s), {groups} channel group(s), work ratio {work_ratio:.3f} (train)".format(
            nwt=len(k12_plans["composite_convt"]["train"]["w_starts"]),
            **k12_plans["composite_convt"]["train"])
        + " | composite_convt_bwd " + "; ".join(
        f"{c['dtype']} {tuple(c['shape'])} dx err {c['dx_err']:.2e} (max {c['max_abs_dx']:.2f}) "
        f"dKc err {c['dKc_err']:.2e} (max {c['max_abs_dKc']:.1f})" + timing(c)
        for c in bwd) + " | K2 plan: {tiles} tiles a sample in {splits} splits of {per}, "
        "{blocks} blocks on {sms} SMs, work ratio {work_ratio:.3f} (train)".format(
            sms=sms, **k12_plans["composite_convt_bwd"]["train"])
        + " | bn_stats " + "; ".join(
        f"{c['dtype']} {tuple(c['shape'])} err {max(c['mean_err'], c['var_err']):.2e}"
        + timing(c) for c in stats)
        + f" | bn_stats stress vs float64: mean {stress['mean_rel_err']:.2e} var "
        f"{stress['var_rel_err']:.2e} (rel) | tap_conv (K3/K4/K5) " + "; ".join(
            f"{c['dtype']} B {c['batch']} Co {c['co']} err " + "/".join(
                f"{c[k]['err']:.2e}" for k in TAP_LIBRARY)
            + ("" if "dw_plan" not in c else " K5 plan: {form} form, tile {tile}, {groups} tap "
               "groups (G <= {max_taps_a_group} taps), S {splits} splits of {rows_per_split} "
               "rows, {blocks} blocks on {sms} SMs".format(**c["dw_plan"]))
            + "".join(f" {k}" + timing(c[k]) + f" {c[k]['useful_tflops']:.1f} TFLOP/s useful, "
                      f"work ratio {c[k]['work_ratio']:.3f}"
                      for k in TAP_LIBRARY if "kernel_ms" in c[k])
            for c in taps)
        + f" | launches in this phase {n_checked} | {smi}")

    # 4 the slice, card vs CPU, f32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clips = np.random.default_rng(args.seed).uniform(0, 1, (2, 8, 224, 224, 3)).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = build_capsnet(seed=args.seed, compute_dtype=torch.float32, device=dev)
        with torch.inference_mode():
            seg, scores, _ = model(torch.from_numpy(clips).to(dev))
        outs[dev] = (torch.sigmoid(seg).cpu().numpy(), scores.cpu().numpy())
        del model
    d_seg = float(np.abs(outs["cuda"][0] - outs["cpu"][0]).max())
    d_scores = float(np.abs(outs["cuda"][1] - outs["cpu"][1]).max())
    same_class = bool((outs["cuda"][1].argmax(1) == outs["cpu"][1].argmax(1)).all())
    results["slice_f32_card_vs_cpu"] = {"max_abs_sigmoid_seg": d_seg,
                                        "max_abs_scores": d_scores, "same_argmax": same_class}
    if not (same_class and d_seg <= SLICE_ATOL and d_scores <= SLICE_ATOL):
        raise AssertionError(f"slice card vs CPU: {results['slice_f32_card_vs_cpu']}")
    phase(4, "slice", f"CapsNet eval 224^2 f32 (TF32 off), card vs CPU: argmax equal, "
          f"max|d sigmoid seg| {d_seg:.2e}, max|d scores| {d_scores:.2e} (tol {SLICE_ATOL})")

    # 5 the serving main path at full width, bf16
    rng = np.random.default_rng(args.seed + 2)
    serve_clips = rng.uniform(0, 1, (17, 8, 224, 224, 3)).astype(np.float32)
    video = rng.uniform(0, 1, (64, 224, 224, 3)).astype(np.float32)
    serving = ServingModel.from_state_dict(seed=args.seed, clip_batch_size=14, device="cuda")
    reset_counts()
    seg, scores = serving.predict_clips(serve_clips)
    vid = serving.predict_video(video)
    serve_launches, serve_by_conv = read_counts(), read_conv_counts()
    n_batches = 2 + 1  # 17 clips -> 14 + 3 (padded); 64 frames -> 8 clips (padded)
    ok_shapes = (seg.shape == (17, 8, 224, 224) and scores.shape == (17, 24)
                 and vid["segmentation"].shape == (64, 224, 224, 1)
                 and vid["scores"].shape == (24,))
    finite = all(np.isfinite(a).all() for a in (seg, scores, vid["segmentation"], vid["scores"]))
    want = {"composite_convt": n_batches, "composite_convt_bwd": 0, "bn_stats": 0,
            "tap_conv_fwd": 2 * n_batches, "tap_conv_dx": 0, "tap_conv_dw": 0}
    want_by_conv = {fn.__name__: {conv: n_batches if fn is tapconv.tap_conv_fwd else 0
                                  for conv in PCAPS_CO} for fn in TAP_COUNTERS}
    if not (ok_shapes and finite and serve_launches == want and serve_by_conv == want_by_conv):
        raise AssertionError(f"serve: shapes ok {ok_shapes}, finite {finite}, "
                             f"launches {serve_launches} != {want} or by conv {serve_by_conv} "
                             f"!= {want_by_conv}")
    # warm rate: whole predict_clips calls (host padding and copies included)
    reps, n = 3, 28
    warm = serve_clips[:14].repeat(2, axis=0)
    serving.predict_clips(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        serving.predict_clips(warm)
    clips_per_s = reps * n / (time.perf_counter() - t0)
    # bf16 vs the f32 model on the same clips and weights
    f32 = ServingModel.from_state_dict(seed=args.seed, clip_batch_size=14,
                                       compute_dtype=torch.float32, device="cuda")
    seg32, scores32 = f32.predict_clips(serve_clips)
    del f32
    dev_bf16 = {"max_abs_sigmoid_seg": float(np.abs(seg - seg32).max()),
                "max_abs_scores": float(np.abs(scores - scores32).max()),
                "argmax_agree": float((scores.argmax(1) == scores32.argmax(1)).mean())}
    results["serve_bf16"] = {"launches": serve_launches, "launches_by_conv": serve_by_conv,
                             "padded_batches": n_batches,
                             "clips_per_s_warm": clips_per_s, "bf16_vs_f32": dev_bf16}
    phase(5, "serve", f"ServingModel bf16 clip batch 14: predict_clips 17 -> {seg.shape}, "
          f"predict_video 64 frames -> label {vid['pred_label']}; launches {serve_launches}, "
          f"K3 by conv {serve_by_conv['tap_conv_fwd']} "
          f"(composite_convt = padded batches {n_batches}, tap_conv_fwd twice that); "
          f"warm {clips_per_s:.2f} clips/s ({smi}); bf16 vs f32: {dev_bf16}")

    # 6 where one warm 14-clip serving batch spends its time
    results["profile"] = profile_call(lambda: serving.predict_clips(warm[:14]))
    del serving
    p = results["profile"]
    phase(6, "profile", "one 14-clip predict_clips: " + (
        f"wall {p['wall_ms']:.2f} ms, device {p['device_ms']:.2f} ms "
        f"(busy {p['busy_share']:.3f}); kernels " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in p["kernel_ms"].items() if v)
        + "; top: " + ", ".join(f"{k['name'][:40]} {k['device_ms']:.2f}" for k in p["top"][:5])
        if p["device_ms"] else "device time not measured (the profiler saw no CUDA activity)"))

    # 7 one f32 train step, card vs CPU
    ts = train_step_card_vs_cpu(seed=args.seed + 1, size=96)
    results["train_slice_f32_card_vs_cpu"] = ts
    if not ts["ok"]:
        raise AssertionError(f"train step card vs CPU: {ts['problems']}")
    nz = ts["noisy_grads"]
    phase(7, "train-slice", f"f32 train step 96^2 batch 2 (folded views, bv, every BN on K6, TF32 "
          f"off), card vs CPU: launches {ts['launches']}; losses card/cpu (CPU band) " + ", ".join(
              f"{k} {v['card']:.6f}/{v['cpu']:.6f} ({v['band']:.1e})"
              for k, v in ts["metrics"].items())
          + f"; BN stats {ts['stats_max_rel']:.2e} (tol {STATS_TOL}); "
          f"{len(ts['stable_grads'])} stable gradients, largest error "
          f"{max(g['err'] for g in ts['stable_grads']):.2e}; {nz['n']} noisy gradients: "
          f"relative L2 {nz['rel_l2']:.2e} vs band {nz['band_rel_l2']:.2e}")

    # 8 the training main path at full width, bf16
    tr, one_step = train_main_path(args.seed)
    results["train_bf16"] = tr
    phase(8, "train", f"bench configuration bf16, batch {TRAIN_BS} (2B = {2 * TRAIN_BS}) of "
          f"8x224^2, {TRAIN_STEPS} steps: launches {tr['launches']}, K3-K5 by conv "
          f"{tr['launches_by_conv']} (K6 inputs per step "
          f"{tr['big_bn_per_step']}); loss {tr['losses'][0]['loss']:.4f} -> "
          f"{tr['losses'][-1]['loss']:.4f}; parameters moved {tr['params_moved']}/"
          f"{tr['n_params']}; warm step {tr['warm_step_ms']:.2f} ms = "
          f"{tr['clips_per_s']:.2f} train clips/s; peak memory {tr['peak_mem_gib']:.2f} GiB "
          f"({smi})")

    # 9 where one warm train step spends its time
    results["train_profile"] = tp = profile_call(one_step)
    # the profiler slows the host: the busy share of an unprofiled warm step too
    tp["busy_share_of_warm_step"] = tp["device_ms"] / tr["warm_step_ms"]
    phase(9, "train-profile", "one train step: " + (
        f"wall {tp['wall_ms']:.2f} ms under the profiler, device {tp['device_ms']:.2f} ms "
        f"(busy {tp['busy_share']:.3f}; {tp['busy_share_of_warm_step']:.3f} of the "
        f"unprofiled warm step); kernels " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in tp["kernel_ms"].items())
        + "; top: " + ", ".join(f"{k['name'][:40]} {k['device_ms']:.2f}" for k in tp["top"][:6])
        if tp["device_ms"] else "device time not measured (the profiler saw no CUDA activity)"))

    del one_step  # phase 8's train state
    torch.cuda.empty_cache()

    # 10 the plain stem against the space-to-depth stem
    results["stem"] = st = stem_phase(args.seed)
    phase(10, "stem", "bf16, eval fwd / train fwd+bwd ms: " + "; ".join(
        f"{use} (B {STEM_BATCH[use]}): " + ", ".join(
            f"{k} {st[use][k]['fwd_ms']:.3f}/{st[use][k]['fwd_bwd_ms']:.3f}"
            for k in ("plain", "s2d_ncdhw", "s2d_channels_last"))
        + f", faster S2D layout {st[use]['faster_s2d_layout']}, S2D vs plain err "
        + "/".join(f"{e:.2e}" for e in st[use]["s2d_channels_last"]["errs"].values())
        + f" (tol {STEM_RTOL} * max|plain|), packed uint8 vs f32 branch in f32 "
        f"{st[use]['packed_u8_err']:.2e} (tol {KERNEL_RTOL} * max)"
        for use in STEM_BATCH) + f" | default {st['default']}"
        f" | {smi}")

    # 11 the train step fed by the input pipeline
    results["data"] = dt = data_phase(args.seed, tr["big_bn_per_step"])
    phase(11, "data", f"DeviceVideoCache {dt['pool_frames']} frames ({dt['pool_mb']:.1f} MB) "
          f"built in {dt['cache_build_s']:.2f} s; first card-assembled batch bit-identical to "
          f"the host batch: {all(dt['first_batch_bit_identical'].values())}; "
          + "; ".join(f"{path}: {DATA_STEPS} steps, e2e {dt[path]['e2e_clips_per_s']:.2f} "
                      f"clips/s, median warm step {dt[path]['median_step_ms']:.2f} ms, loss "
                      f"{dt[path]['losses'][0]['loss']:.4f} -> {dt[path]['losses'][-1]['loss']:.4f}"
                      for path in ("device_cache", "host_streaming"))
          + f" (device-resident, phase 8: {tr['clips_per_s']:.2f} clips/s); launches per step "
          f"{dt['launches_per_step']}; host batches assembled by {dt['host_assembler']} | {smi}")

    k1, k2, k6 = checks[2], bwd[0], stats[0]  # bf16 at the train shapes
    k35 = {conv: next(c for c in taps if "kernel_ms" in c["tap_conv_fwd"] and c["co"] == co)
           for conv, co in PCAPS_CO.items()}
    kernels = {"kernels": [
        {"name": "composite_convt", "route": "cuda",
         "source": "picad_tpu_torch/csrc/composite_convt.cu",
         "replaces": "picad_tpu/ops/pallas_fused_head.py:69",
         "launches": tr["launches"]["composite_convt"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "composite_convt_bwd", "route": "cuda",
         "source": "picad_tpu_torch/csrc/composite_convt_bwd.cu",
         "replaces": "picad_tpu/ops/pallas_fused_head.py:217",
         "launches": tr["launches"]["composite_convt_bwd"],
         "max_abs_err": max(k2["dx_err"], k2["dKc_err"]),
         "ms": k2["kernel_ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]},
        {"name": "bn_stats", "route": "cuda", "source": "picad_tpu_torch/csrc/bn_stats.cu",
         "replaces": "picad_tpu/ops/bn_stats.py:108",
         "launches": tr["launches"]["bn_stats"], "max_abs_err": max(k6["mean_err"], k6["var_err"]),
         "ms": k6["kernel_ms"], "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"],
         "bound_by": k6["bound_by"], "library_ms": k6["library_ms"]},
    ] + [  # K3-K5 at the train shape, bf16, at the pose and at the act conv, with
        # the launches the wrapper counted at that conv's Co
        {"name": f"{name}/{conv}", "route": "cuda", "source": "picad_tpu_torch/csrc/tap_conv.cu",
         "replaces": f"picad_tpu/ops/tapconv.py:{line}",
         "launches": tr["launches_by_conv"][name][conv], "max_abs_err": k35[conv][name]["err"],
         "ms": k35[conv][name]["kernel_ms"], "plain_ms": k35[conv][name]["plain_ms"],
         "bound_ms": k35[conv][name]["bound_ms"], "bound_by": k35[conv][name]["bound_by"],
         "library_ms": k35[conv][name]["library_ms"]}
        for conv in PCAPS_CO
        for name, line in (("tap_conv_fwd", 371), ("tap_conv_dx", 421), ("tap_conv_dw", 478))
    ]}
    results["kernels"] = kernels["kernels"]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
