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
            28, 832) with B = 14 (serving) and 16 (train); max_pool_bwd
            (the strided pools' backward, csrc/max_pool_bwd.cu) at the
            train step's three strided pools (POOL_BWD_SHAPES) in bf16
            and f32 and with planted positive ties: f32 bit for bit, bf16
            within one bf16 ulp, and two launches on one input bit for
            bit, timed in both types beside torch's atomic
            max_pool3d_with_indices_backward and a copy_ of the bytes the
            kernel must move; max_pool_axis and max_pool_axis_bwd (the
            stride-1 pools' forward and backward, csrc/max_pool_s1.cu) at
            every stage of the train step's seven stride-1 pools
            (STRIDE1_POOL_SP, batch 16) in bf16 and f32, on post-ReLU x,
            x with planted positive ties and negative x with inf and NaN
            planted in g: each result bit for bit the plain chain
            (compared on the bits), two launches bit for bit, timed in
            bf16 beside the plain chain, the forward's F.max_pool3d on
            the padded x (the backward has no library call: none gives a
            window's gradient to every tied maximum), a copy_ of the bytes
            each kernel must move and the byte bound; then each pool's
            forward + backward and its device operations, through the
            kernels and through the plain chain.  Kernel, plain
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
            (composite_convt must launch once per padded clip batch,
            tap_conv_fwd twice: the pose and act convs, and max_pool_axis
            16 times, once a stride-1 stage, and no pool backward);
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
            K5 twice per step (the pose and act convs), max_pool_bwd
            once per strided pool per step, max_pool_axis and
            max_pool_axis_bwd 16 times each a step, once a stride-1 stage
            (the pool kernels counted apart from the bench's six, by the
            pooled tensor's channels); finite
            losses, every parameter moved; the steps go through the
            graphed step (train/graph.py: the first hooked for the K6
            count and eager, graph.WARMUP warm-ups, one capture, then
            replays), and the same steps from the same seeded state
            through the eager step (make_train_step(...).eager_step)
            must give the same losses, parameters, BN running stats,
            Adam moments and step counts and dropout generator state,
            bit for bit.  The wrappers count the eager calls; a replay
            calls none, so its launches are read in its trace (phase
            9).  The median synchronised step wall of the replays and
            of the eager steps, their clips/s, peak allocated memory,
            and the graph's memory pool (reserved, and allocated in it).
  9 train-profile torch.profiler over one replayed train step and over
            one eager step: wall, device time, busy share, each kernel's
            time and the top entries; the host time of a call (enqueue
            only, the device idle before it) and the busy share of the
            unprofiled synchronised step, replay beside eager.  The
            instances of K1-K6's and the pool kernels' CUDA functions, by
            name, in the replay's trace must equal the eager step's, none
            missing; max_pool_bwd's one function must run once per
            strided pool (3 a step), and max_pool_s1.cu's forward and
            backward functions once a stride-1 stage (16 a step each);
            phase 8's graphed launches are
            its eager calls' counts plus, per replay, what the eager
            step's wrappers count; what a replay adds to the counters
            (utils/profiling.add_launches, for the bench's traced run)
            must be the same.  Phases 11-13 count a replay as
            add_launches does, which this phase holds against the trace.
 10 stem    the plain 7^3/s2 stem (Unit3D) against StemS2D, bf16, at the
            train shape (16, 3, 8, 224, 224) and the serving shape (14,
            ...): eval forward and train forward + backward (dW and the BN
            backward; the clip needs no gradient) ms, StemS2D in NCDHW and
            in channels_last_3d; S2D within STEM_RTOL of plain (the eval
            output, and dW and the BN weight's gradient of a train step), and the packed uint8 branch
            against the f32 branch in f32 (TF32 off) within 1e-4 of the
            largest value; the three stems are timed in turns,
            STEM_ROUNDS rounds, and the model's default stem's median must
            be within STEM_CHOICE_SLACK of the fastest median.
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
 12 bench   both cells of BENCHMARK.json (ucf101_train_bs8,
            ucf101_serve_cb14) through the bench's own functions
            (picad_tpu_torch/bench) at BENCH_LENGTHS, each with its traced
            run: each cell's JSON metric line, then a phase line; every
            metric finite and positive (host synchronisations and GC time
            may be 0), 0 < mfu < 1, each kernel's launches a step or
            batch the kernel table's (K1 1, K2 1, K3-K5 2, K6 4 a train
            step; K1 1, K3 2 a serving batch), and `correct`: the bench's
            check of its own output against a CPU f32 reference
            (picad_tpu_torch/bench/check.py).
 13 trainer the train and evaluate CLIs' entry points at full width,
            bf16, 224^2 (picad_tpu_torch/cli): train_ucf101.main with
            --synthetic --bs 8 --epochs 2 --pf 2 --wt_cons 0.1 --bv
            --n_frames 5 --thresh_epoch 1 --device_cache_gb 2 and
            TRAINER_VIDEOS synthetic videos (4 steps an epoch, 4 val
            videos; the count has no flag, so the smoke sets it in the
            CLIs' argv -> config mapping), with torch's TF32 defaults back
            (phase 4 turns TF32 off); train_ucf101.main again with
            --epochs 3 --resume best_model_train_loss_2 (or val), which
            must restore the epoch, the LR and the scheduler counters and
            run epoch 3 alone, its train steps under
            torch.cuda.set_sync_debug_mode("warn"), the host
            synchronisations counted by site (the metric reads at the
            --pf boundaries); evaluate_ucf101.main --synthetic --split val
            sweeps and prunes the val checkpoints of both runs (f32); then
            train_jhmdb.main for one epoch (21 classes) and
            evaluate_jhmdb.main on its train checkpoint.  Each CLI call
            with the launch counts set to 0 just before and read just
            after, and each epoch's train steps and validation read apart:
            K1-K6 (1, 1, 2, 2, 2, 4) a train step, K1 once and K3 twice a
            validation batch and a padded eval batch, nothing else; each
            train CLI's Trainer steps through the graphed step, captured
            once and replayed after graph.WARMUP eager steps.  Each
            epoch's wall and clips/s, the checkpoint's bytes and its save
            and restore seconds, eval seconds a checkpoint and the
            surviving directories; fails on a non-finite loss, a wrong
            launch count, a resume mismatch or more than two checkpoints
            left after pruning.
 14 data-parallel  the port's data-parallel path (parallel/mesh.py) on
            the one card.  (a) In a process of its own, under torch's
            deterministic algorithms: DP_STEPS bench-configuration bf16
            steps with a one-rank NCCL group (every collective runs)
            against the same steps without a group, and those again: the
            runs without a group bit for bit; the group's run bit for
            bit, or else (recorded, with the gap) the first forward bit
            for bit and the first step's gradients within
            DP_GROUP_GRAD_TOL (in a group the step stays eager with plain
            Adam, without one it takes the fused Adam, so the updates
            may differ by rounding); the operations without a deterministic
            form, one profiled step each way, the gradient average's ms.  (b)
            DP_WORLD gloo ranks on cuda:0 (NCCL refuses two ranks on one
            card), global batch TRAIN_BS: DP_STEPS bf16 steps with the
            same losses and parameters on every rank, K1-K6's launches on
            each rank, the rank step and the gloo gradient all-reduce;
            then an f32 step at 96^2 on phase 7's batch inside phase 7's
            noise band of its card step; then train_ucf101.main
            --num_devices DP_WORLD with both ranks on cuda:0 (`devices`)
            and phase 13's flags for one epoch, and again with --resume
            for epoch 2: each rank's launches counted in its own process,
            the same losses, parameters and run directory on every rank,
            one writer, and each rank resuming the first run's state and
            its own dropout stream.  (c) --eval_dp 2 with both replicas on cuda:0:
            make_sharded_forward bit for bit one replica on the same
            slices (cuDNN deterministic), and evaluate_ucf101.main
            --eval_dp 2 against --eval_dp 1 on one checkpoint.  Launch
            counts set to 0 just before and read just after each part.
 15 artifact the serving artifact (picad_tpu_torch/serve/export.py): the
            bf16 CapsNet of seeded weights exported at clip batch 14,
            224^2, saved and loaded with load_artifact; its graph holds
            one picad.composite_convt, two picad.tap_conv_fwd and 16
            picad.max_pool_axis nodes (K1, K3 and the stride-1 pools'
            forward kept as custom ops); predict_clips on 17 clips and
            predict_video on a 64-frame video through the artifact, the
            launch counts set to 0 just before and read just after (K1
            once, K3 twice and max_pool_axis 16 times a padded batch),
            against the in-process
            ServingModel within ARTIFACT_ATOL with the same classes (bit
            for bit recorded); export and load seconds, the artifact's
            bytes, the warm clips/s of both; then cli.export_model.main
            --verify on phase 13's epoch-2 checkpoint, and python -m
            picad_tpu_torch.tools.parity_eval on a reference-format .pth
            of seeded weights and 2 synthetic videos, first alone and then
            with --reference_line set to the line it printed: PASS.

The timing and profiling helpers (cuda_ms, profile_call, the launch
counters, nvidia_smi_line) are picad_tpu_torch/utils/profiling.py's, which
the bench shares.

Then three lines: nvidia-smi's name and power limit, the kernel table as
one JSON object, and last {"ok": true, "device": {...}}.  The full
results also go to chiprun_out/chip_smoke.json.  Without a CUDA card it
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from picad_tpu_torch.bench import Lengths, load_config, run_cell
from picad_tpu_torch.bench.trace import (
    KERNELS,
    SERVE_LAUNCHES,
    TRAIN_LAUNCHES,
    count_sync_warnings,
)
from picad_tpu_torch.bench.train import (
    cache_pipeline,
    epochs_forever,
    stream_pipeline,
    synthetic_batch,
)
from picad_tpu_torch.checkpoint.manager import CheckpointIO
from picad_tpu_torch.cli import common as cli_common
from picad_tpu_torch.cli import (
    evaluate_jhmdb,
    evaluate_ucf101,
    export_model,
    train_jhmdb,
    train_ucf101,
)
from picad_tpu_torch.config import LossConfig
from picad_tpu_torch.data.dataset import EvalVideoDataset
from picad_tpu_torch.data.loader import PrefetchLoader
from picad_tpu_torch.data.sources import SyntheticVideoSource
from picad_tpu_torch.eval.clips import chunk_video_into_clips
from picad_tpu_torch.models import i3d, layers
from picad_tpu_torch.eval.runner import make_eval_fn, make_padded_forward, make_sharded_forward
from picad_tpu_torch.models.capsules import build_capsnet
from picad_tpu_torch.ops import _build, convops, tapconv
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
from picad_tpu_torch.parallel import mesh
from picad_tpu_torch.serve import ServingModel, load_artifact, save_artifact
from picad_tpu_torch.train.loop import Trainer
from picad_tpu_torch.train import graph
from picad_tpu_torch.train.state import create_train_state
from picad_tpu_torch.train.step import make_train_step
from picad_tpu_torch.utils.profiling import (
    cuda_ms,
    nvidia_smi_line,
    profile_call,
    read_launches,
    reset_launches,
)

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
# the train step's strided max pools (x at the bench's [data; aug] batch 16),
# whose backward is csrc/max_pool_bwd.cu, by the pooled tensor's channels
POOL_BWD_SHAPES = {64: ((16, 64, 4, 112, 112), (1, 3, 3), (1, 2, 2)),  # MaxPool3d_2a
                   192: ((16, 192, 2, 56, 56), (1, 3, 3), (1, 2, 2)),  # MaxPool3d_3a
                   480: ((16, 480, 2, 28, 28), (3, 3, 3), (2, 1, 1))}  # MaxPool3d_4a
POOL_NAMES = {64: "MaxPool3d_2a", 192: "MaxPool3d_3a", 480: "MaxPool3d_4a"}
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
STEM_CHOICE_SLACK = 1.10  # the default stem's median time over the fastest's, at most
STEM_ROUNDS = 5  # rounds of the three stems timed in turns
DATA_STEPS = 6  # train steps through each input path in phase 11
# phase 13: the train CLI's flags, and synthetic_num_videos (no flag)
TRAINER_ARGV = ["--synthetic", "--bs", "8", "--pf", "2", "--wt_cons", "0.1", "--bv",
                "--n_frames", "5", "--thresh_epoch", "1", "--device_cache_gb", "2"]
TRAINER_VIDEOS = 16  # 4 steps an epoch at batch 8, max(16 // 4, 1) = 4 val videos
EVAL_VIDEOS = 8  # the evaluate CLIs' --synthetic source (cli/evaluate_*.py)


def phase(n, name, msg):
    print(f"[{n} {name}] {msg}", flush=True)


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


TAP_COUNTERS = (tapconv.tap_conv_fwd, tapconv.tap_conv_dx, tapconv.tap_conv_dw)


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


POOL_COUNTERS = (convops.max_pool_bwd, convops.max_pool_axis, convops.max_pool_axis_bwd)


def reset_pool_launches() -> None:
    """The pool kernels' counters: apart from utils/profiling's six (the
    bench's kernel table has no row for them)."""
    for fn in POOL_COUNTERS:
        fn.launches, fn.launches_by_c = 0, {}


def pool_launches() -> dict:
    """The pool kernels' launches by the pooled tensor's channels."""
    return {fn.__name__: dict(fn.launches_by_c) for fn in POOL_COUNTERS}


def serve_pool_want(n_batches: int) -> dict:
    """pool_launches() of n_batches eval forwards: each stride-1 stage's
    forward once, no backward."""
    return {"max_pool_bwd": {}, "max_pool_axis": {c: n * n_batches for c, n in
                                                  STRIDE1_BY_C.items()},
            "max_pool_axis_bwd": {}}


def check_pool_bwd(c: int, dtype, seed: int, timed: bool, ties: bool = False) -> dict:
    """max_pool_bwd against its plain version on the pool of POOL_BWD_SHAPES[c]:
    post-ReLU x (with `ties`, rounded to integers, so that equal positive
    maxima share most windows).  f32 bit for bit (both sum in the same
    order), bf16 within one bf16 ulp; two launches on the same input bit
    for bit.  Timed: the kernel, the plain version, torch's own backward
    (max_pool3d_with_indices_backward: atomics, not deterministic; on the
    padded input), a copy_ of the same bytes (x, y and g read, dx
    written: what the card moves at best) and the byte bound."""
    shape, k, s = POOL_BWD_SHAPES[c]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.relu(torch.randn(shape, generator=gen, device="cuda"))
    x = (x.round() if ties else x).to(dtype)
    pads = [convops.same_pads(d, kk, ss) for d, kk, ss in zip(shape[2:], k, s)]
    xp = convops._pad_spatial(x, pads)
    y = F.max_pool3d(xp, k, s)
    g = torch.randn(y.shape, generator=gen, device="cuda").to(dtype)
    args = (x, y, g, k, s, tuple(lo for lo, _ in pads))
    out, again = convops.max_pool_bwd(*args), convops.max_pool_bwd(*args)
    torch.cuda.synchronize()
    ref = convops.max_pool_bwd_plain(*args)
    d = (out.float() - ref.float()).abs()
    tol = BF16_ULP * ref.float().abs() if dtype == torch.bfloat16 else 0.0
    res = {"pool": POOL_NAMES[c], "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "ties": ties, "max_abs_err": d.max().item(), "bitwise_plain": torch.equal(out, ref),
           "bitwise_twice": torch.equal(out, again)}
    if not (res["bitwise_twice"] and bool((d <= tol).all())):
        raise AssertionError(f"max_pool_bwd: {res}")
    if timed:
        res["kernel_ms"] = cuda_ms(lambda: convops.max_pool_bwd(*args), 20)
        res["plain_ms"] = cuda_ms(lambda: convops.max_pool_bwd_plain(*args), 3)
        _, idx = torch.ops.aten.max_pool3d_with_indices(xp, list(k), list(s))
        res["library_ms"] = cuda_ms(lambda: torch.ops.aten.max_pool3d_with_indices_backward(
            g, xp, list(k), list(s), [0] * 3, [1] * 3, False, idx), 20)
        # the copy floor: one flat copy_ of x + y elements moves as many bytes
        # as the kernel must (x, y and g read, dx written)
        src = torch.empty(x.numel() + y.numel(), dtype=dtype, device="cuda")
        dst = torch.empty_like(src)
        res["copy_ms"] = cuda_ms(lambda: dst.copy_(src), 20)
        # x, y and g read once, dx written; a compare and at most an add a window tap
        nbytes = (2 * x.numel() + 2 * y.numel()) * x.element_size()
        res["bound_ms"], res["bound_by"] = bound(nbytes, 2 * y.numel() * math.prod(k),
                                                 torch.float32)
    return res


# the train step's stride-1 max pools (the Inception blocks' branch 3,
# models/i3d.py:146) at the bench's [data; aug] batch 16: Mixed_3b-3c after
# MaxPool3d_3a (T 2, 28^2), Mixed_4b-4f after MaxPool3d_4a (T 1, 28^2)
STRIDE1_POOL_SP = {name: (2, 28, 28) if name.startswith("Mixed_3") else (1, 28, 28)
                   for name in i3d.INCEPTION_SPECS}


COLD_BYTES = 150e6  # operand sets rotated through per timed call: 3x the H100's 50 MB L2


def graph_ms(calls: list, rounds: int = 5) -> float:
    """Device ms of one call of `calls` (closures, each over its own
    operands, so that a call finds them out of L2): warmed up on a side
    stream, captured in one CUDA graph, the graph replayed `rounds` times
    between CUDA events.  The host's dispatch (a custom op's, autograd's)
    then costs no device time, as in the captured train step."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (rounds * len(calls))


def cold_copies(nbytes: float) -> int:
    """Operand sets of `nbytes` that rotate through more than COLD_BYTES."""
    return max(2, math.ceil(COLD_BYTES / nbytes))


def stride1_window(sp) -> tuple:
    return (1, 3, 3) if sp[0] == 1 else (3, 3, 3)  # models/i3d.py:145


def stride1_stages(sp) -> list:
    """(dim, k) of each stage of the pool over sp, as
    convops.max_pool_same_zero_pad runs them."""
    return [(2 + a, k) for a, k in enumerate(stride1_window(sp)) if k != 1]


# csrc/max_pool_s1.cu's launches a forward, by the pooled tensor's channels
# (Mixed_4c-4e share 512): one a stage, 16 in all
STRIDE1_BY_C: dict = {}
for _name, (_cin, _) in i3d.INCEPTION_SPECS.items():
    STRIDE1_BY_C[_cin] = STRIDE1_BY_C.get(_cin, 0) + len(stride1_stages(STRIDE1_POOL_SP[_name]))
STRIDE1_LAUNCHES = sum(STRIDE1_BY_C.values())


def bits(t: torch.Tensor) -> torch.Tensor:
    """t's bits as integers: equal where the values are equal bit for bit
    (a -0.0, a NaN's payload and an inf show)."""
    return t.contiguous().view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


def bit_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[bool, float]:
    """(bit for bit, max |out - ref| where the bits differ)."""
    same = bits(out) == bits(ref)
    d = torch.where(same, 0.0, (out.float() - ref.float()).abs().nan_to_num(float("inf")))
    return bool(same.all()), d.max().item()


def stride1_input(shape, kind: str, gen) -> torch.Tensor:
    """post-ReLU x ("relu"), rounded to integers so that equal positive
    maxima share most windows ("ties"), or negative everywhere so that the
    zero pads win at the borders ("negative")."""
    x = torch.randn(shape, generator=gen, device="cuda")
    if kind == "negative":
        return -(x.abs() + 0.25)
    x = torch.relu(x)
    return x.round() if kind == "ties" else x


def stride1_grad(shape, dtype, planted: bool, gen) -> torch.Tensor:
    """g, with inf, -inf and NaN planted (0 * inf is NaN in both versions)."""
    g = torch.randn(shape, generator=gen, device="cuda")
    if planted:
        flat = g.view(-1)
        flat[::97] = float("inf")
        flat[31::89] = float("-inf")
        flat[57::83] = float("nan")
    return g.to(dtype)


def _stage_library(x, dim: int, k: int):
    """One F.max_pool3d on the F.padded x: the stage's values, torch's call."""
    lo, hi = convops.same_pads(x.shape[dim], k, 1)
    window = tuple(k if d == dim else 1 for d in range(2, 5))
    pads = [(lo, hi) if d == dim else (0, 0) for d in range(2, 5)]
    return F.max_pool3d(convops._pad_spatial(x, pads), window, 1)


def check_pool_s1(name: str, dtype, seed: int, timed: bool) -> dict:
    """csrc/max_pool_s1.cu's forward and backward against their plain
    versions (convops.max_pool_axis_plain, max_pool_axis_bwd_plain) at
    every stage of the stride-1 pool of block `name` at the train shape:
    post-ReLU x, x with planted ties, and negative x with planted inf and
    NaN in g; each result bit for bit the plain version, and two launches
    on one input bit for bit.  Timed (the post-ReLU input, graph_ms: in a
    CUDA graph, operands out of L2): each stage's kernels and plain
    versions, the forward's library call (F.max_pool3d on the padded x),
    a copy_ of the bytes each kernel must move, and the byte bound; and
    the kernels' back-to-back eager calls (cuda_ms), which the host's
    dispatch paces."""
    cin = i3d.INCEPTION_SPECS[name][0]
    sp = STRIDE1_POOL_SP[name]
    shape = (16, cin, *sp)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    res = {"block": name, "shape": list(shape), "window": list(stride1_window(sp)),
           "dtype": str(dtype).replace("torch.", ""), "stages": []}
    for kind in ("relu", "ties", "negative"):
        x = stride1_input(shape, kind, gen).to(dtype)
        for dim, k in stride1_stages(sp):
            g = stride1_grad(shape, dtype, kind == "negative", gen)
            y, y2 = convops.max_pool_axis(x, dim, k), convops.max_pool_axis(x, dim, k)
            dx, dx2 = (convops.max_pool_axis_bwd(x, y, g, dim, k),
                       convops.max_pool_axis_bwd(x, y, g, dim, k))
            torch.cuda.synchronize()
            y_ref = convops.max_pool_axis_plain(x, dim, k)
            dx_ref = convops.max_pool_axis_bwd_plain(x, y_ref, g, dim, k)
            (fwd_ok, fwd_err), (bwd_ok, bwd_err) = bit_err(y, y_ref), bit_err(dx, dx_ref)
            st = {"kind": kind, "dim": dim, "k": k, "fwd_bitwise": fwd_ok, "fwd_err": fwd_err,
                  "bwd_bitwise": bwd_ok, "bwd_err": bwd_err,
                  "twice_bitwise": bool((bits(y) == bits(y2)).all()
                                        and (bits(dx) == bits(dx2)).all()),
                  "bwd_nan": int(dx_ref.isnan().sum())}
            if not (fwd_ok and bwd_ok and st["twice_bitwise"]):
                raise AssertionError(f"max_pool_axis {name} {shape} {dtype}: {st}")
            if timed and kind == "relu":
                n, es = x.numel(), x.element_size()
                # operand sets in turn, each call's out of L2 (graph_ms)
                sets = [{"x": x.clone(), "y": y.clone(), "g": g.clone(),
                         "src": torch.empty(2 * n, dtype=dtype, device="cuda"),
                         "dst": torch.empty(2 * n, dtype=dtype, device="cuda")}
                        for _ in range(cold_copies(3 * n * es))]

                def ms(fn):
                    return graph_ms([functools.partial(fn, o) for o in sets])

                st.update(
                    fwd_ms=ms(lambda o: convops.max_pool_axis(o["x"], dim, k)),
                    fwd_plain_ms=ms(lambda o: convops.max_pool_axis_plain(o["x"], dim, k)),
                    fwd_library_ms=ms(lambda o: _stage_library(o["x"], dim, k)),
                    # x read, y written: a copy_ of x's elements
                    fwd_copy_ms=ms(lambda o: o["dst"][:n].copy_(o["src"][:n])),
                    bwd_ms=ms(lambda o: convops.max_pool_axis_bwd(o["x"], o["y"], o["g"], dim, k)),
                    bwd_plain_ms=ms(lambda o: convops.max_pool_axis_bwd_plain(
                        o["x"], o["y"], o["g"], dim, k)),
                    # x, y and g read, dx written: a copy_ of twice x's elements
                    bwd_copy_ms=ms(lambda o: o["dst"].copy_(o["src"])),
                    # the host-paced reading, back-to-back eager calls (cuda_ms)
                    fwd_eager_ms=cuda_ms(lambda: convops.max_pool_axis(x, dim, k), 20),
                    bwd_eager_ms=cuda_ms(lambda: convops.max_pool_axis_bwd(x, y, g, dim, k), 20))
                del sets
                # a compare a tap forward; a compare, a multiply and an add a tap backward
                st["fwd_bound_ms"], st["fwd_bound_by"] = bound(2 * n * es, k * n, torch.float32)
                st["bwd_bound_ms"], st["bwd_bound_by"] = bound(4 * n * es, 3 * k * n,
                                                               torch.float32)
            res["stages"].append(st)
            x = y_ref  # the next stage pools this one's output, as the model does
    if timed:
        timed_st = [st for st in res["stages"] if "fwd_ms" in st]
        for key in ("fwd_ms", "fwd_plain_ms", "fwd_library_ms", "fwd_copy_ms", "fwd_bound_ms",
                    "bwd_ms", "bwd_plain_ms", "bwd_copy_ms", "bwd_bound_ms", "fwd_eager_ms",
                    "bwd_eager_ms"):
            res[key] = sum(st[key] for st in timed_st)  # the pool's stages, one after the other
        res["fwd_bound_by"], res["bwd_bound_by"] = (timed_st[0]["fwd_bound_by"],
                                                    timed_st[0]["bwd_bound_by"])
    res["fwd_err"] = max(st["fwd_err"] for st in res["stages"])
    res["bwd_err"] = max(st["bwd_err"] for st in res["stages"])
    return res


class _PlainAxis(torch.autograd.Function):
    """A stride-1 stage through the plain chain on the card (the kernels'
    yardstick, never on the port's path)."""

    @staticmethod
    def forward(ctx, x, dim, k):
        y = convops.max_pool_axis_plain(x, dim, k)
        ctx.save_for_backward(x, y)
        ctx.dim, ctx.k = dim, k
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return convops.max_pool_axis_bwd_plain(x, y, g, ctx.dim, ctx.k), None, None


def plain_stride1_pool(x, k):
    for a, kk in enumerate(k):
        if kk != 1:
            x = _PlainAxis.apply(x, 2 + a, kk)
    return x


def time_stride1_pools(seed: int) -> list:
    """Forward + backward of each stride-1 pool of the train step, bf16:
    max_pool_same_zero_pad (csrc/max_pool_s1.cu, one launch a stage each
    way) and the same stages through the plain chain, in this call:
    device ms in a CUDA graph over operands out of L2 (graph_ms), as a
    replay of the train step runs them, and the device operations of one
    eager call in its trace."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    res = []
    for name, (cin, _) in i3d.INCEPTION_SPECS.items():
        sp = STRIDE1_POOL_SP[name]
        k = stride1_window(sp)
        x = torch.relu(torch.randn((16, cin, *sp), generator=gen, device="cuda")).to(
            torch.bfloat16)
        g = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
        sets = [(x.clone().requires_grad_(True), g.clone())
                for _ in range(cold_copies(2 * x.numel() * x.element_size()))]
        row = {"block": name, "shape": [16, cin, *sp], "window": list(k)}
        for tag, pool in (("", lambda t, k=k: convops.max_pool_same_zero_pad(t, k, (1, 1, 1))),
                          ("plain_", lambda t, k=k: plain_stride1_pool(t, k))):
            def fwd_bwd(xs, gs, pool=pool):
                torch.autograd.grad(pool(xs), xs, gs)

            def fwd(xs, gs, pool=pool):
                with torch.no_grad():
                    pool(xs)

            row[tag + "fwd_ms"] = graph_ms([functools.partial(fwd, *ops) for ops in sets])
            row[tag + "fwd_bwd_ms"] = graph_ms([functools.partial(fwd_bwd, *ops) for ops in sets])
            row[tag + "device_ops"] = profile_call(lambda: fwd_bwd(*sets[0]))["device_ops"]
        res.append(row)
    return res


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


def f32_batch(seed: int, size: int) -> dict:
    """Phase 7's batch: 2 rows of size^2 from `seed`."""
    return synthetic_batch(np.random.default_rng(seed), 2, (size, size))


@contextlib.contextmanager
def f32_exact():
    """Every BN on K6 (one-pass threshold 0) and TF32 off, as phase 7."""
    saved = (layers.BN_ONEPASS_MIN, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    layers.BN_ONEPASS_MIN = 0
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (layers.BN_ONEPASS_MIN, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def within_band(got: tuple, ref: tuple, draws: list) -> tuple[list, dict]:
    """(problems, summary) of one f32 step's (metrics, gradients, BN
    buffers) `got` against `ref`, inside the noise band of `draws` (CPU
    steps after rounding-size weight moves, see NOISE_MOVE)."""
    (m_got, g_got, s_got), (m_ref, g_ref, s_ref) = got, ref
    problems, metrics = [], {}
    for k, r in m_ref.items():
        d = abs(m_got[k] - r)
        band = max(abs(m[k] - r) for m, _, _ in draws)
        metrics[k] = {"card": m_got[k], "cpu": r, "band": band}
        # acc: argmax of the class scores, which the quirk moves
        if k != "acc" and d > max(NOISE_K * band, METRIC_RTOL * abs(r)):
            problems.append(f"metric {k}: {m_got[k]} against {r} (band {band:.2e})")
    stats_err = max(_rel_max(s_got[n], s_ref[n]) for n in s_ref)
    if stats_err > STATS_TOL:
        problems.append(f"BN running stats: {stats_err:.2e} of the largest entry")
    stable, noisy = [], []
    for n, r in g_ref.items():
        band = max(_rel_max(g[n], r) for _, g, _ in draws)
        err = _rel_max(g_got[n], r)
        (stable if band < STABLE_BAND else noisy).append((n, err, band))
        if band < STABLE_BAND and err > max(NOISE_K * band, GRAD_FLOOR):
            problems.append(f"grad {n}: {err:.2e} of its largest entry, band {band:.2e}")
    names = [n for n, _, _ in noisy]
    l2_got = _rel_l2(g_got, g_ref, names)
    l2_band = max(_rel_l2(g, g_ref, names) for _, g, _ in draws)
    if l2_got > GLOBAL_K * l2_band:
        problems.append(f"{len(names)} noisy gradients: relative L2 {l2_got:.2e}, "
                        f"band {l2_band:.2e}")
    return problems, {"metrics": metrics, "stats_max_rel": stats_err,
                      "stable_grads": [{"name": n, "err": e, "band": b} for n, e, b in stable],
                      "noisy_grads": {"n": len(names), "rel_l2": l2_got,
                                      "band_rel_l2": l2_band,
                                      "max_err": max(e for _, e, _ in noisy)}}


def train_step_card_vs_cpu(seed: int = 1, size: int = 96, keep: dict | None = None) -> dict:
    """Phase 7: one f32 train step at size^2, batch 2, with every BN on
    K6 (one-pass threshold 0), TF32 off: the card against the CPU, within
    the CPU's own noise band (see NOISE_MOVE).  `keep` receives the
    card's step and the band's draws (phase 14 holds two ranks to them)."""
    with f32_exact():
        batch = f32_batch(seed, size)
        reset_launches()
        card = _f32_step("cuda", seed, batch)
        launches = read_launches()
        cpu = _f32_step("cpu", seed, batch)
        draws = [_f32_step("cpu", seed, batch, move_seed=k) for k in range(1, N_DRAWS + 1)]
    n_bn = sum(isinstance(m, layers.TorchBatchNorm) for m in
               build_capsnet(device="cpu", compute_dtype=torch.float32).modules())
    want = {"composite_convt": 1, "composite_convt_bwd": 1, "bn_stats": n_bn,
            "tap_conv_fwd": 2, "tap_conv_dx": 2, "tap_conv_dw": 2}  # pose and act convs
    problems = [f"launches {launches} != {want}"] if launches != want else []
    band_problems, summary = within_band(card, cpu, draws)
    problems += band_problems
    if keep is not None:
        keep.update(card=card, draws=draws)
    return {"ok": not problems, "problems": problems[:20], "launches": launches, **summary}


def state_snapshot(state) -> dict:
    """Every tensor a train step changes, cloned: the parameters, the BN
    running stats, Adam's moments and step counts, and the dropout
    generator's state."""
    model = state.model
    snap = {f"param {n}": p.detach().clone() for n, p in model.named_parameters()}
    snap.update({f"buffer {n}": b.detach().clone() for n, b in model.named_buffers()})
    for n, p in model.named_parameters():
        snap.update({f"adam {n} {k}": v.detach().clone()
                     for k, v in state.optimizer.state[p].items()})
    snap["generator"] = state.generator.get_state()
    return snap


def snapshot_diff(a: dict, b: dict) -> list:
    """The entries of two state_snapshots that are not bit for bit equal."""
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or not torch.equal(a[k], b[k]))


def run_plan(state, plan, batch, steps: dict) -> list:
    """Each (step, epoch, ramp, lr) of `plan` on `state`: `steps[step]`,
    after with_learning_rate(lr) unless lr is None -> each step's
    metrics on the host."""
    out = []
    for name, epoch, ramp, lr in plan:
        if lr is not None:
            state.with_learning_rate(lr)
        state, m = steps[name](state, batch, epoch, ramp)
        out.append({k: float(v) for k, v in m.items()})
    return out


def graphed_against_eager(plan, batch, *, seed: int, dropout: float) -> dict:
    """`plan` (run_plan's: "graphed" or "eager" steps) from a state of
    `seed`, and every step of it eager from a second state of the same
    seed: the losses and state_snapshots bit for bit or not, and what the
    graphed step did (captures, replays)."""
    cfg = LossConfig(**TRAIN_CFG)
    runs = {}
    for mode in ("graphed", "eager"):
        state = create_train_state(seed=seed, device="cuda", bn_groups=2, dropout_rate=dropout)
        graphed = make_train_step(cfg)
        steps = {"eager": graphed.eager_step,
                 "graphed": graphed if mode == "graphed" else graphed.eager_step}
        losses = run_plan(state, plan, batch, steps)
        torch.cuda.synchronize()
        runs[mode] = (losses, state_snapshot(state), steps["graphed"])
        del state, steps
    (lg, sg, graphed), (le, se, _) = runs["graphed"], runs["eager"]
    differ = snapshot_diff(sg, se)
    return {"bitwise": lg == le and not differ, "differ": differ[:10], "n_tensors": len(se),
            "captures": graphed.captures, "replays": graphed.replays,
            "graphs": len(graphed.graphs), "losses": [m["loss"] for m in lg]}


def host_ms(fn, calls: int = 3) -> float:
    """The median host time of a call of fn (its return, not the
    device's completion), the device idle before each call."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def counter_state() -> dict:
    """The launch counts phase 8 checks, as the wrappers counted them:
    the six, K3-K5 by conv, the strided pools' backward and the stride-1
    pools' forward and backward, each by channels and in all."""
    return {"launches": read_launches(), "by_conv": read_conv_counts(),
            "pool_by_c": dict(convops.max_pool_bwd.launches_by_c),
            "pool": convops.max_pool_bwd.launches,
            "axis_by_c": dict(convops.max_pool_axis.launches_by_c),
            "axis": convops.max_pool_axis.launches,
            "axis_bwd_by_c": dict(convops.max_pool_axis_bwd.launches_by_c),
            "axis_bwd": convops.max_pool_axis_bwd.launches}


def counts_scaled(c, mul: int = 1, div: int = 1):
    """A counter_state's counts times mul over div (exactly, or it fails)."""
    if isinstance(c, dict):
        return {k: counts_scaled(v, mul, div) for k, v in c.items()}
    n, rest = divmod(c * mul, div)
    if rest:
        raise AssertionError(f"{c} launches do not divide by {div}")
    return n


def counts_plus(a, b):
    if isinstance(a, dict):
        return {k: counts_plus(a[k], b[k]) for k in a}
    return a + b


def want_counts(steps: int, n_big: int) -> dict:
    """What `steps` train steps launch (a counter_state)."""
    return {"launches": {"composite_convt": steps, "composite_convt_bwd": steps,
                         "bn_stats": n_big * steps, "tap_conv_fwd": 2 * steps,
                         "tap_conv_dx": 2 * steps, "tap_conv_dw": 2 * steps},
            "by_conv": {fn.__name__: {conv: steps for conv in PCAPS_CO} for fn in TAP_COUNTERS},
            "pool_by_c": {c: steps for c in POOL_BWD_SHAPES},  # each strided pool once a step
            "pool": steps * len(POOL_BWD_SHAPES),
            # each stride-1 stage once a step each way
            "axis_by_c": {c: n * steps for c, n in STRIDE1_BY_C.items()},
            "axis": steps * STRIDE1_LAUNCHES,
            "axis_bwd_by_c": {c: n * steps for c, n in STRIDE1_BY_C.items()},
            "axis_bwd": steps * STRIDE1_LAUNCHES}


def pool_gib(pool) -> tuple[float, float]:
    """The memory a CUDA graph pool holds: its segments' reserved GiB, and
    the GiB of live blocks in them (the graphs' static outputs)."""
    segs = [s for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) == tuple(pool)]
    return (sum(s["total_size"] for s in segs) / 2**30,
            sum(s["allocated_size"] for s in segs) / 2**30)


def train_main_path(seed: int) -> tuple[dict, object, object]:
    """Phase 8: the bench configuration at full width in bf16 on the card,
    TRAIN_STEPS steps through the graphed step and again through the
    eager step from the same seeded state -> (results, a closure that
    replays one more step, a closure that runs one more eager step).

    The eager steps' launches are the wrappers' counts.  The replays'
    are not: a replay calls no wrapper.  Phase 9 (train_profile) counts
    them in a replay's trace and fills in the graphed run's totals."""
    batch = synthetic_batch(np.random.default_rng(47 + seed), TRAIN_BS, (224, 224))
    res, runs = {}, {}
    for mode in ("graphed", "eager"):
        state = create_train_state(seed=seed, device="cuda", bn_groups=2, dropout_rate=0.5)
        # folds: the model has bn_groups 2
        step = make_train_step(LossConfig(**TRAIN_CFG))
        if mode == "eager":
            step = step.eager_step
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        big_bn = []  # BN inputs that take K6, counted by hooks over the first step
        hooks = [m.register_forward_pre_hook(
            lambda mod, args: big_bn.append(args[0].numel() >= layers.BN_ONEPASS_MIN))
            for m in state.model.modules() if isinstance(m, layers.TorchBatchNorm)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        reset_launches()
        reset_pool_launches()
        # graphed: step 1 hooked (eager), the warm-ups (eager), the capture
        # and its replay, then replays; the wrappers count the eager calls
        n_eager = 1 + graph.WARMUP if mode == "graphed" else TRAIN_STEPS
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, TRAIN_EPOCH, TRAIN_RAMP)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                for h in hooks:
                    h.remove()
            if i == n_eager - 1:
                counted = counter_state()
        n_big = sum(big_bn)
        want = want_counts(n_eager, n_big)
        moved = sum(not torch.equal(p.detach(), before[n])
                    for n, p in state.model.named_parameters())
        finite = all(np.isfinite(v) for m in losses for v in m.values())
        warm_s = float(np.median(times[n_eager:] if mode == "graphed" else times[1:]))
        r = res[mode] = {
            "counted": counted, "counted_steps": n_eager, "big_bn_per_step": n_big,
            "params_moved": moved, "n_params": len(before), "losses": losses,
            "step_s": times, "warm_step_ms": warm_s * 1e3, "clips_per_s": TRAIN_BS / warm_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30}
        if mode == "graphed":
            r.update(captures=step.captures, replays=step.replays)
            r["pool_gib"], r["pool_allocated_gib"] = pool_gib(step.pool)
        else:
            r.update(counted)
        if not (counted == want and moved == len(before) and finite):
            raise AssertionError(f"train ({mode}): launches of the {n_eager} eager steps "
                                 f"{counted} (want {want}), parameters moved "
                                 f"{moved}/{len(before)}, losses finite {finite}: {losses}")
        torch.cuda.synchronize()
        runs[mode] = (state, step, state_snapshot(state))
    (gstate, gstep, gsnap), (estate, estep, esnap) = runs["graphed"], runs["eager"]
    differ = snapshot_diff(gsnap, esnap)
    res["graphed_vs_eager"] = {
        "bitwise": res["graphed"]["losses"] == res["eager"]["losses"] and not differ,
        "differ": differ[:10], "n_tensors": len(esnap)}
    g = res["graphed"]
    if (g["captures"], g["replays"]) != (1, TRAIN_STEPS - 1 - graph.WARMUP) \
            or not res["graphed_vs_eager"]["bitwise"]:
        raise AssertionError(f"train: {g['captures']} captures and {g['replays']} replays (want 1 "
                             f"and {TRAIN_STEPS - 1 - graph.WARMUP}); graphed against eager "
                             f"{res['graphed_vs_eager']}, losses {g['losses']} against "
                             f"{res['eager']['losses']}")
    return (res, lambda: gstep(gstate, batch, TRAIN_EPOCH, TRAIN_RAMP),
            lambda: estep(estate, batch, TRAIN_EPOCH, TRAIN_RAMP))


def train_profile(tr: dict, one_step, one_eager) -> dict:
    """Phase 9: torch.profiler over one replay and one eager step of
    phase 8's states (profile_call: three calls each, the last traced),
    the host ms of a call, and the replays' launches.

    A replay calls no wrapper, so its launches are read in its trace: the
    instances of each counted wrapper's CUDA functions by name
    (profile_call's kernel_counts) must equal the eager step's, and none
    may be missing.  A replay then launches what one eager step launches,
    as the wrappers counted that (phase 8's eager run over TRAIN_STEPS);
    phase 8's graphed totals are its eager calls' counts plus that per
    replay.  What a replay adds to the counters (for the bench's traced
    run) must be the same."""
    prof = {}
    for mode, fn, warm_ms in (("replay", one_step, tr["graphed"]["warm_step_ms"]),
                              ("eager", one_eager, tr["eager"]["warm_step_ms"])):
        reset_launches()
        reset_pool_launches()
        p = prof[mode] = profile_call(fn)
        p["counters"] = counts_scaled(counter_state(), div=3)  # a call's, of 3
        # the profiler slows the host: the busy share of an unprofiled warm step too
        p["busy_share_of_warm_step"] = p["device_ms"] / warm_ms
        p["host_ms"] = host_ms(fn)
    per_step = counts_scaled(tr["eager"]["counted"], div=TRAIN_STEPS)
    rk, ek = prof["replay"]["kernel_counts"], prof["eager"]["kernel_counts"]
    missing = sorted(k for k in ek if not ek[k])
    # one CUDA function a strided pool, and one a stride-1 stage each way
    pool_fns = {k: sum(rk.get(k, {}).values())
                for k in ("max_pool_bwd", "max_pool_axis", "max_pool_axis_bwd")}
    want_fns = {"max_pool_bwd": len(POOL_BWD_SHAPES), "max_pool_axis": STRIDE1_LAUNCHES,
                "max_pool_axis_bwd": STRIDE1_LAUNCHES}
    if rk != ek or missing or prof["eager"]["counters"] != per_step or pool_fns != want_fns:
        raise AssertionError(f"train profile: a replay's kernels by name {rk}, an eager step's "
                             f"{ek} (none missing: {missing}; the pool kernels' functions "
                             f"{pool_fns}, want {want_fns}); the eager step's "
                             f"counters {prof['eager']['counters']}, want {per_step}")
    g = tr["graphed"]
    g["replay_counts_from_trace"] = per_step
    g.update(counts_plus(g["counted"], counts_scaled(per_step, mul=g["replays"])))
    want = want_counts(TRAIN_STEPS, g["big_bn_per_step"])
    if {k: g[k] for k in want} != want or prof["replay"]["counters"] != per_step:
        raise AssertionError(f"train: the graphed run's launches {({k: g[k] for k in want})}, "
                             f"want {want}; a replay adds {prof['replay']['counters']} to the "
                             f"counters, its trace shows {per_step}")
    return prof


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
            row, outs, calls = {}, {}, {}
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
                calls[name] = {"fwd_ms": fwd, "fwd_bwd_ms": fwd_bwd}
            # the variants in turns, STEM_ROUNDS rounds; each one's median
            rounds = {name: {metric: [] for metric in calls[name]} for name in variants}
            for _ in range(STEM_ROUNDS):
                for name, (_, channels_last) in variants.items():
                    i3d.S2D_CHANNELS_LAST = channels_last
                    for metric, fn in calls[name].items():
                        rounds[name][metric].append(cuda_ms(fn, 10))
            for name in variants:
                row[name] = {metric: float(np.median(v)) for metric, v in rounds[name].items()}
                row[name]["rounds_ms"] = rounds[name]
            del calls
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


def _train_through(loader, step, state, want: dict) -> dict:
    """DATA_STEPS train steps on batches from `loader`, launch counts set
    to 0 just before and read just after; each step's wall includes
    waiting for its batch."""
    times, losses = [], []
    torch.cuda.synchronize()
    reset_launches()
    for _ in range(DATA_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, next(loader), TRAIN_EPOCH, TRAIN_RAMP)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = read_launches()
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
    card-resident video cache and through host streaming (the bench's
    pipelines, picad_tpu_torch/bench/train.py)."""
    cfg = load_config()
    t0 = time.perf_counter()
    # the cache over the streaming path's own sources, for the bit-identity check
    cache, cache_batcher, assembler = cache_pipeline(cfg, torch.device("cuda"), kind="stream")
    torch.cuda.synchronize()
    res = {"cache_build_s": time.perf_counter() - t0,
           "pool_frames": cache.pool_video.shape[0],
           "pool_mb": (cache.pool_video.numel() + cache.pool_mask.numel()) / 1e6}
    stream_batcher, res["host_assembler"] = stream_pipeline(cfg)
    for _ in stream_batcher.epoch(0):  # warm the decode cache, as bench.py does
        pass

    # the first card-assembled batch against the host streaming batch
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
            ("device_cache", PrefetchLoader(epochs_forever(cache_batcher), put_fn=assembler)),
            ("host_streaming", PrefetchLoader(epochs_forever(stream_batcher)))):
        state = create_train_state(seed=seed, device="cuda", bn_groups=2, dropout_rate=0.5)
        it = iter(loader)
        try:
            res[path] = _train_through(it, step, state, want)
        finally:
            it.close()
        del state
    res["launches_per_step"] = {k: v // DATA_STEPS for k, v in want.items()}
    return res


BENCH_LENGTHS = Lengths(warmup=2, steps=8, sync_steps=8, stream_steps=8, h2d_reps=3,
                       serve_warmup=2, serve_calls=20, trace_calls=1, sync_probe_steps=1,
                       component_iters=3)
BENCH_WANT = {"ucf101_train_bs8": TRAIN_LAUNCHES, "ucf101_serve_cb14": SERVE_LAUNCHES}
BENCH_LINE = {"ucf101_train_bs8": ("train_clips_per_s", "e2e_clips_per_s", "mfu",
                                   "stream_e2e_clips_per_s", "device_ms_per_step", "busy_share",
                                   "host_syncs_per_step"),
              "ucf101_serve_cb14": ("serve_clips_per_s", "batch_ms_p50", "batch_ms_p95", "mfu",
                                    "device_ms_per_batch", "kernel_ms_net_of_copies")}
MAY_BE_ZERO = ("host_syncs_per_step", "gc_ms_per_step")  # none found is a valid reading


@contextlib.contextmanager
def _counted_trainers(sync_probe_epoch: int | None = None):
    """Within: each Trainer's train epochs and validations append the
    launches they made (the counts read before and after) to
    `trainer.launches`, and `restore` records its seconds and what it
    restored in `trainer.restored` (and `_state_digests` of the state it
    restored in `trainer.restored_digests`).  The train steps of epoch
    `sync_probe_epoch` run under torch.cuda.set_sync_debug_mode("warn"),
    their host synchronisations counted by site into `trainer.sync_sites`.
    The CLIs' argv -> config mapping gives the synthetic backend
    TRAINER_VIDEOS videos (the count has no flag)."""
    train_epoch, validate, restore = Trainer.train_epoch, Trainer.validate, Trainer.restore
    to_config = cli_common.args_to_config

    def counts_since(before: dict) -> dict:
        torch.cuda.synchronize()
        return {k: v - before[k] for k, v in read_launches().items()}

    def counted_train_epoch(self, e):
        torch.cuda.synchronize()
        before = read_launches()
        if e == sync_probe_epoch:
            out = []
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _, self.sync_sites = count_sync_warnings(
                    lambda: out.append(train_epoch(self, e)), 1)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            loss = out[0]
        else:
            loss = train_epoch(self, e)
        self.__dict__.setdefault("launches", []).append(
            {"epoch": e, "train": counts_since(before), "steps": self.epoch_stats[-1]["steps"]})
        return loss

    def counted_validate(self, e):
        before = read_launches()
        loss = validate(self, e)
        self.launches[-1].update(val=counts_since(before), val_batches=mesh.steps_lockstep(
            len(self.val_dataset), self.world, self.rank_bs))
        return loss

    def timed_restore(self, path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = restore(self, path)
        torch.cuda.synchronize()
        self.restored = {"seconds": time.perf_counter() - t0, "next_epoch": start,
                         "lr": self.state.learning_rate(), "best": self.scheduler.best,
                         "bad": self.scheduler.num_bad_epochs,
                         "cooldown": self.scheduler.cooldown_counter}
        self.restored_digests = _state_digests(self.state)
        return start

    def few_videos(args, dataset):
        cfg = to_config(args, dataset)
        cfg.data.synthetic_num_videos = TRAINER_VIDEOS
        return cfg

    Trainer.train_epoch, Trainer.validate, Trainer.restore = (
        counted_train_epoch, counted_validate, timed_restore)
    cli_common.args_to_config = few_videos
    try:
        yield
    finally:
        Trainer.train_epoch, Trainer.validate, Trainer.restore = train_epoch, validate, restore
        cli_common.args_to_config = to_config


def _state_digests(state) -> dict:
    """sha256 of a train state's parameters and of its dropout generator."""
    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()

    return {"params": sha(_flat_params(state.model).float()),
            "generator": sha(state.generator.get_state())}


def _train_cli(cli, argv: list, step_want: dict, batch_want: dict,
               sync_probe_epoch: int | None = None) -> tuple[Trainer, list]:
    """One train CLI run, `cli.main(argv)`, with the launch counts set to 0
    just before and read just after -> (its Trainer, the epoch rows).
    Fails unless every epoch made `step_want` launches a train step and
    `batch_want` a validation batch, and nothing else launched."""
    with _counted_trainers(sync_probe_epoch):
        torch.cuda.synchronize()
        reset_launches()
        tr = cli.main(argv)
        torch.cuda.synchronize()
        total = read_launches()
    rows = _check_epochs(tr, step_want, batch_want)
    steps = sum(c["steps"] for c in tr.launches)
    batches = sum(c["val_batches"] for c in tr.launches)
    want = {k: steps * step_want[k] + batches * batch_want[k] for k in step_want}
    if total != want:
        raise AssertionError(f"{cli.__name__} {argv}: launches {total}, want {want} "
                             f"({steps} train steps, {batches} validation batches)")
    ts = tr.train_step  # the Trainer's step: captured once, then replayed
    if not (isinstance(ts, graph.GraphedStep) and ts.captures == 1
            and ts.replays == steps - graph.WARMUP):
        raise AssertionError(f"{cli.__name__} {argv}: the train step {type(ts).__name__} made "
                             f"{getattr(ts, 'captures', 0)} captures and "
                             f"{getattr(ts, 'replays', 0)} replays in {steps} steps, want 1 and "
                             f"{steps - graph.WARMUP}")
    tr.graph_counts = {"captures": ts.captures, "replays": ts.replays}
    return tr, rows


def _check_epochs(tr: Trainer, step_want: dict, batch_want: dict) -> list:
    """Each epoch run: finite losses (metrics.jsonl), K1-K6 `step_want`
    a train step and `batch_want` a validation batch -> the epoch rows."""
    with open(os.path.join(tr.save_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    values = [v for r in records for k, v in r.items() if k not in ("tag", "step", "time")]
    rows = []
    for stats, counts in zip(tr.epoch_stats, tr.launches):
        n, nb = counts["steps"], counts["val_batches"]
        per_step = {k: v / n for k, v in counts["train"].items()}
        per_batch = {k: v / nb for k, v in counts["val"].items()}
        if per_step != step_want or per_batch != batch_want:
            raise AssertionError(f"trainer epoch {stats['epoch']}: launches a step {per_step} "
                                 f"(want {step_want}), a val batch {per_batch} "
                                 f"(want {batch_want})")
        rows.append(dict(stats, launches_a_step=per_step, launches_a_val_batch=per_batch))
    if not (values and np.isfinite(values).all() and len(rows) == len(tr.epoch_stats) > 0):
        raise AssertionError(f"trainer: a non-finite logged metric in {records}")
    return rows


def _eval_batches(n_classes: int) -> int:
    """Padded clip batches (of 14) the evaluate CLIs' synthetic set takes
    a checkpoint."""
    ds = EvalVideoDataset(SyntheticVideoSource(EVAL_VIDEOS, num_classes=n_classes, seed=47))
    return sum(-(-chunk_video_into_clips(v, m)[0].shape[0] // 14) for v, m, _ in ds)


def _sweep(cli, argv: list, ckpt_dir: str, split: str, n_classes: int) -> dict:
    """One evaluate CLI run, launch counts set to 0 just before and read
    just after: K1 once and K3 twice a padded batch, nothing else."""
    before = sorted(d for d in os.listdir(ckpt_dir) if d.startswith(f"best_model_{split}"))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    nb = _eval_batches(n_classes) * len(results)
    want = {"composite_convt": nb, "composite_convt_bwd": 0, "bn_stats": 0,
            "tap_conv_fwd": 2 * nb, "tap_conv_dx": 0, "tap_conv_dw": 0}
    after = sorted(d for d in os.listdir(ckpt_dir) if d.startswith(f"best_model_{split}"))
    if launches != want or len(results) != len(before) or not 0 < len(after) <= 2:
        raise AssertionError(f"sweep {argv}: launches {launches} (want {want}), "
                             f"{len(results)} of {before} evaluated, left {after}")
    return {"checkpoints": before, "surviving": after, "padded_batches": nb,
            "launches_a_batch": {k: v / nb for k, v in launches.items() if v},
            "seconds_a_checkpoint": seconds / len(results),
            "summaries": {os.path.basename(p): {k: r[k] for k in
                                                ("accuracy", "fmAP@0.5", "vmAP@0.5")}
                          for p, r in results.items()}}


def trainer_phase(big_bn: int, tf32_defaults: tuple, keep_dir: str) -> dict:
    """Phase 13: the train and evaluate CLIs' path on the card (see the
    module docstring).  The first run's epoch-2 checkpoint is copied into
    `keep_dir` (phase 15 exports it)."""
    step_want = {"composite_convt": 1, "composite_convt_bwd": 1, "bn_stats": big_bn,
                 "tap_conv_fwd": 2, "tap_conv_dx": 2, "tap_conv_dw": 2}
    batch_want = {"composite_convt": 1, "composite_convt_bwd": 0, "bn_stats": 0,
                  "tap_conv_fwd": 2, "tap_conv_dx": 0, "tap_conv_dw": 0}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    res = {"tf32_defaults": {"matmul": tf32_defaults[0], "cudnn": tf32_defaults[1]}}
    try:
        first, res["ucf101"] = _train_cli(
            train_ucf101, TRAINER_ARGV + ["--epochs", "2", "--save_root", root,
                                          "--exp_id", "ucf101"], step_want, batch_want)
        res["graph"] = {"ucf101": first.graph_counts}
        ckpt = next((os.path.join(first.save_dir, f"best_model_{tag}_loss_2")
                     for tag in ("train", "val")
                     if os.path.isdir(os.path.join(first.save_dir, f"best_model_{tag}_loss_2"))),
                    None)
        if ckpt is None:
            raise AssertionError(f"trainer: no epoch-2 checkpoint in {os.listdir(first.save_dir)}")
        res["kept_checkpoint"] = shutil.copytree(ckpt, os.path.join(keep_dir, os.path.basename(ckpt)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = CheckpointIO().save(os.path.join(root, "timed_save"), first.state)
        save_s = time.perf_counter() - t0
        shutil.rmtree(os.path.join(root, "timed_save"))

        second, res["ucf101_resumed"] = _train_cli(
            train_ucf101, TRAINER_ARGV + ["--epochs", "3", "--save_root", root,
                                          "--exp_id", "ucf101_resumed", "--resume", ckpt],
            step_want, batch_want, sync_probe_epoch=3)
        res["graph"]["ucf101_resumed"] = second.graph_counts
        got = {k: v for k, v in second.restored.items() if k != "seconds"}
        want = {"next_epoch": 3, "lr": first.state.learning_rate(),
                "best": first.scheduler.best, "bad": first.scheduler.num_bad_epochs,
                "cooldown": first.scheduler.cooldown_counter}
        if got != want or [r["epoch"] for r in res["ucf101_resumed"]] != [3]:
            raise AssertionError(f"trainer resume: restored {got}, want {want}; epochs run "
                                 f"{[r['epoch'] for r in res['ucf101_resumed']]}, want [3]")
        res["sync_sites_epoch_3"] = second.sync_sites
        res["checkpoint"] = {"path": os.path.basename(ckpt), "bytes": nbytes, "save_s": save_s,
                             "restore_s": second.restored["seconds"]}
        resumed_val = os.path.join(second.save_dir, "best_model_val_loss_3")
        if os.path.isdir(resumed_val):  # two runs' val checkpoints in one sweep
            shutil.copytree(resumed_val, os.path.join(first.save_dir, "best_model_val_loss_3"))
        res["evaluate_ucf101"] = _sweep(
            evaluate_ucf101, ["--ckpt", first.save_dir, "--synthetic", "--split", "val"],
            first.save_dir, "val", 24)

        jhmdb, res["jhmdb"] = _train_cli(
            train_jhmdb, TRAINER_ARGV + ["--epochs", "1", "--save_root", root,
                                         "--exp_id", "jhmdb"], step_want, batch_want)
        res["graph"]["jhmdb"] = jhmdb.graph_counts
        res["evaluate_jhmdb"] = _sweep(
            evaluate_jhmdb, ["--ckpt", jhmdb.save_dir, "--synthetic", "--split", "train"],
            jhmdb.save_dir, "train", 21)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    return res


def bench_phase(seed: int) -> dict:
    """Phase 12: each bench cell at BENCH_LENGTHS with its traced run ->
    its result line.  Every metric finite and positive (host
    synchronisations and garbage-collection time may be 0), 0 < mfu < 1,
    and each kernel's launches a step or batch the kernel table's (the
    traced run raises otherwise)."""
    cfg = load_config()
    out = {}
    for cell, want in BENCH_WANT.items():
        r = run_cell(cell, cfg, seed=seed, device="cuda", lengths=BENCH_LENGTHS, trace=True)
        bad = {k: r[k] for k in r["units"]
               if not (isinstance(r[k], (int, float)) and np.isfinite(r[k])
                       and (r[k] > 0 or (k in MAY_BE_ZERO and r[k] == 0)))}
        launches = {n: r[f"{k}_launches"] for n, k in KERNELS.items() if n in want}
        if bad or not 0 < r["mfu"] < 1 or launches != want or not r["correct"]:
            raise AssertionError(f"bench {cell}: metrics not finite and positive {bad}, mfu "
                                 f"{r['mfu']}, launches {launches} (want {want}), check "
                                 f"{r['check']}")
        out[cell] = r
    return out


# phase 14: the data-parallel path
DP_STEPS = 3  # full-width bf16 steps in parts (a) and (b)
DP_WORLD = 2  # part (b): two ranks on the one card, over gloo
DP_TIMEOUT_S = 600  # each of the phase's spawns
# part (a): the runs without a group must equal each other bit for bit (the
# strided pools' backward is csrc/max_pool_bwd.cu, deterministic).  The
# group's run is recorded as bit for bit or not; where it is not, its step-1
# gradients must be within DP_GROUP_GRAD_TOL (relative L2) of theirs: 4 times
# the no-group runs' own gap while the pools' backward was torch's atomic
# one (9.52e-3 on an H100 80GB HBM3 at 700 W; PERF_HISTORY.md).  A zero,
# doubled or wrong gradient is O(1).
DP_GROUP_GRAD_TOL = 4.0 * 9.52e-3


def _flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def _flat_grads(model) -> torch.Tensor:
    return torch.cat([p.grad.detach().float().reshape(-1) for p in model.parameters()
                      if p.grad is not None])


def _count_big_bn(model) -> list:
    """Forward pre-hooks noting, per BN input, whether it takes K6; the
    caller removes them (phase 8's count)."""
    seen: list = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].numel() >= layers.BN_ONEPASS_MIN))
        for m in model.modules() if isinstance(m, layers.TorchBatchNorm)]
    return seen, hooks


def _dp_steps(seed: int, batch: dict, steps: int) -> dict:
    """`steps` bf16 train steps at the bench configuration from seeded
    weights: each step's losses, wall (synchronised) and parameters
    after it (a flat copy on the card), the initial parameters and the
    first step's gradients, the launches (set to 0 just before, read
    just after) and the K6 inputs a step."""
    state = create_train_state(seed=seed, device="cuda", bn_groups=2, dropout_rate=0.5)
    step = make_train_step(LossConfig(**TRAIN_CFG))
    big, hooks = _count_big_bn(state.model)
    start = _flat_params(state.model).clone()
    losses, walls, params, grads = [], [], [], None
    torch.cuda.synchronize()
    reset_launches()
    for i in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, batch, TRAIN_EPOCH, TRAIN_RAMP)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in metrics.items()})
        params.append(_flat_params(state.model))
        if i == 0:
            grads = _flat_grads(state.model)
            for h in hooks:
                h.remove()
    return {"losses": losses, "step_s": walls, "params": params, "start": start,
            "grads_step1": grads, "launches": read_launches(), "big_bn_per_step": sum(big),
            "state": state}


def _grad_allreduce_ms(model, reps: int = 3) -> float:
    """Median wall of `all_reduce_grads` over the model's gradients."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.all_reduce_grads(model.parameters())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _step_want(big_bn: int, steps: int) -> dict:
    return {"composite_convt": steps, "composite_convt_bwd": steps, "bn_stats": big_bn * steps,
            "tap_conv_fwd": 2 * steps, "tap_conv_dx": 2 * steps, "tap_conv_dw": 2 * steps}


def _nccl_rank(r, out_dir, seed):
    """Phase 14 (a) in a process of its own: CUBLAS_WORKSPACE_CONFIG is
    read when cuBLAS starts, and torch's deterministic algorithms are a
    process-wide switch.  Their warnings name the operations that have
    no deterministic form."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    batch = synthetic_batch(np.random.default_rng(47 + seed), TRAIN_BS, (224, 224))
    def profiled(run) -> dict:  # one more step, under torch.profiler
        step = make_train_step(LossConfig(**TRAIN_CFG))
        st = run.pop("state")
        p = profile_call(lambda: step(st, batch, TRAIN_EPOCH, TRAIN_RAMP))
        return {k: p[k] for k in ("wall_ms", "device_ms", "busy_share")} | {"model": st.model}

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plain = _dp_steps(seed, batch, DP_STEPS)
        prof_none = profiled(plain)
        del prof_none["model"]
        again = _dp_steps(seed, batch, DP_STEPS)
        del again["state"]
        mesh.initialize_distributed(f"tcp://localhost:{mesh.free_port()}", 1, 0,
                                    device="cuda:0", backend="nccl")
        try:
            group = _dp_steps(seed, batch, DP_STEPS)
            prof_group = profiled(group)
            allreduce_ms = _grad_allreduce_ms(prof_group.pop("model"))
        finally:
            torch.distributed.destroy_process_group()

    def rel_l2(x, y) -> float:
        return float(torch.linalg.vector_norm(x - y) / torch.linalg.vector_norm(y))

    def gap(a, b) -> dict:
        d = [float((x.float() - y.float()).abs().max()) for x, y in zip(a["params"], b["params"])]
        return {"bitwise": all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
                and a["losses"] == b["losses"],
                "same_start": torch.equal(a["start"], b["start"]),
                "first_forward_bitwise": a["losses"][0] == b["losses"][0],
                "grad_rel_l2_step1": rel_l2(a["grads_step1"], b["grads_step1"]),
                # each step's update (parameters after it minus the start)
                "update_rel_l2": [rel_l2(x, y) for x, y in
                                  zip((p - a["start"] for p in a["params"]),
                                      (p - b["start"] for p in b["params"]))],
                "max_abs_param": max(d),
                "max_rel_loss": max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                                    for x, y in zip(a["losses"], b["losses"]))}

    nondeterministic = sorted({str(w.message).split(" does not have a deterministic")[0]
                               for w in caught if "deterministic" in str(w.message)})
    torch.save({"group_vs_none": gap(group, plain), "none_vs_none": gap(again, plain),
                "launches": group["launches"], "launches_none": plain["launches"],
                "big_bn_per_step": plain["big_bn_per_step"],
                "warm_step_ms": {"group": 1e3 * float(np.median(group["step_s"][1:])),
                                 "none": 1e3 * float(np.median(plain["step_s"][1:]))},
                "grad_allreduce_ms": allreduce_ms,
                "profiled_step": {"group": prof_group, "none": prof_none},
                "losses": [m["loss"] for m in group["losses"]],
                "nondeterministic_ops": nondeterministic},
               os.path.join(out_dir, "a.pt"))


def nccl_world_one(seed: int) -> dict:
    """Phase 14 (a): DP_STEPS full-width bf16 steps with a one-rank NCCL
    group active (every collective of the path runs) against the same
    steps without a group, and those again without a group, under torch's
    deterministic algorithms (in a process of its own, `_nccl_rank`)."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # cuBLAS's deterministic setting
    try:
        mesh.launch(_nccl_rank, 1, (out_dir, seed), timeout=DP_TIMEOUT_S)
        res = torch.load(os.path.join(out_dir, "a.pt"), weights_only=False)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        if saved is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved
    res["want"] = want = _step_want(res["big_bn_per_step"], DP_STEPS)
    # the plain runs bit for bit; the group's bit for bit, or the first
    # step's forward (its losses, before any backward) bit for bit and its
    # gradients within DP_GROUP_GRAD_TOL
    g, n = res["group_vs_none"], res["none_vs_none"]
    ok_gap = n["bitwise"] and n["same_start"] and g["same_start"] and (
        g["bitwise"] or (g["first_forward_bitwise"]
                         and g["grad_rel_l2_step1"] <= DP_GROUP_GRAD_TOL))
    if not (ok_gap and res["launches"] == want and res["launches_none"] == want):
        raise AssertionError(f"phase 14 (a): {res}")
    return res


def _dp_rank(r, world, init, out_dir, seed, f32_seed):
    """Phase 14 (b)'s rank r of `world` on cuda:0, over gloo."""
    mesh.initialize_distributed(init, world, r, device="cuda:0", backend="gloo")
    try:
        batch = mesh.local_rows(
            synthetic_batch(np.random.default_rng(47 + seed), TRAIN_BS, (224, 224)), r, world)
        run = _dp_steps(seed, batch, DP_STEPS)
        allreduce_ms = _grad_allreduce_ms(run.pop("state").model)
        digests = [hashlib.sha256(p.cpu().numpy().tobytes()).hexdigest() for p in run["params"]]
        with f32_exact():
            m, g, b = _f32_step("cuda", f32_seed, mesh.local_rows(f32_batch(f32_seed, 96), r,
                                                                   world))
        out = {"losses": run["losses"], "step_s": run["step_s"], "launches": run["launches"],
               "big_bn_per_step": run["big_bn_per_step"], "digests": digests,
               "grad_allreduce_ms": allreduce_ms,
               "f32_digest": hashlib.sha256(torch.cat(
                   [t.reshape(-1) for t in g.values()]).numpy().tobytes()).hexdigest()}
        if r == 0:
            out["f32"] = (m, g, b)
        torch.save(out, os.path.join(out_dir, f"{r}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def two_ranks_one_card(seed: int, f32_seed: int, f32_card: dict) -> dict:
    """Phase 14 (b): DP_WORLD ranks on cuda:0 over gloo (NCCL refuses two
    ranks on one card), global batch TRAIN_BS: DP_STEPS bf16 steps, then
    an f32 step at 96^2 on phase 7's batch, held to phase 7's
    single-process card step within phase 7's noise band."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        t0 = time.perf_counter()
        mesh.launch(_dp_rank, DP_WORLD, (DP_WORLD, f"tcp://localhost:{mesh.free_port()}",
                                         out_dir, seed, f32_seed), timeout=DP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        got = [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
               for r in range(DP_WORLD)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    problems, band = within_band(got[0]["f32"], f32_card["card"], f32_card["draws"])
    want = _step_want(got[0]["big_bn_per_step"], DP_STEPS)
    if any(g["losses"] != got[0]["losses"] for g in got):
        problems.append("the ranks' losses differ")
    if any(g["digests"] != got[0]["digests"] or g["f32_digest"] != got[0]["f32_digest"]
           for g in got):
        problems.append("the ranks' parameters or gradients differ")
    if any(g["launches"] != want for g in got):
        problems.append(f"launches {[g['launches'] for g in got]}, want {want} on each rank")
    finite = all(np.isfinite(v) for g in got for m in g["losses"] for v in m.values())
    if not finite:
        problems.append("a non-finite loss")
    res = {"wall_s": wall, "launches_per_rank": [g["launches"] for g in got], "want": want,
           "big_bn_per_step": got[0]["big_bn_per_step"],
           "launches_a_step_per_rank": {k: v / DP_STEPS for k, v in got[0]["launches"].items()},
           "losses": [m["loss"] for m in got[0]["losses"]],
           "warm_rank_step_ms": [1e3 * float(np.median(g["step_s"][1:])) for g in got],
           "grad_allreduce_ms": [g["grad_allreduce_ms"] for g in got],
           "f32_vs_one_process": band, "problems": problems}
    if problems:
        raise AssertionError(f"phase 14 (b): {problems}")
    return res


_TRAIN_RANK = cli_common._train_rank  # each process's own, before any patch


def _counted_train_rank(out_dir, local_rank, *args):
    """`cli.common._train_rank` in a rank process that train_ucf101.main
    starts in phase 14 (b): the rank's Trainer counted as phase 13 counts
    one (`_counted_trainers`, in this process), the launch counts set to
    0 just before and read just after, and what it recorded saved to
    out_dir/<rank>.pt for the parent to check."""
    with _counted_trainers():
        torch.cuda.synchronize()
        reset_launches()
        tr = _TRAIN_RANK(local_rank, *args)
        torch.cuda.synchronize()
        total = read_launches()
    torch.save({"launches": tr.launches, "total": total, "epoch_stats": tr.epoch_stats,
                "save_dir": tr.save_dir, "restored": getattr(tr, "restored", None),
                "restored_digests": getattr(tr, "restored_digests", None),
                "end": {"digests": _state_digests(tr.state), "lr": tr.state.learning_rate(),
                        "best": tr.scheduler.best, "bad": tr.scheduler.num_bad_epochs,
                        "cooldown": tr.scheduler.cooldown_counter}},
               os.path.join(out_dir, f"{local_rank}.pt"))


def _run_files_problems(run_dir: str) -> list:
    """One writer in a run directory: metrics.jsonl with each (tag, step)
    once and finite values, TensorBoard events of at most one process, and
    nothing else but the checkpoints' files."""
    problems = []
    files = {os.path.relpath(os.path.join(p, f), run_dir)
             for p, _, fs in os.walk(run_dir) for f in fs}
    events = {f for f in files if "tfevents" in f}
    if len({f.split(".")[-2] for f in events}) > 1:
        problems.append(f"events of several processes {sorted(events)}")
    want = {"metrics.jsonl"} | {f"{c}/train_state.pt" for c in os.listdir(run_dir)
                                if c.startswith("best_model_")}
    if files - events != want:
        problems.append(f"files {sorted(files - events)}, want {sorted(want)}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    tags = [(r["tag"], r["step"]) for r in records]
    values = [v for r in records for k, v in r.items() if k not in ("tag", "step", "time")]
    if len(tags) != len(set(tags)) or not (values and np.isfinite(values).all()):
        problems.append(f"metrics.jsonl: {records}")
    return problems


def train_cli_two_ranks(big_bn: int) -> dict:
    """Phase 14 (b), the train CLI: train_ucf101.main --num_devices
    DP_WORLD with both ranks on cuda:0 (`devices`, so over gloo), phase
    13's flags and videos, for one epoch, then again with --resume from
    its epoch-1 checkpoint for epoch 2.  Each rank's launches (set to 0
    just before and read just after, in the rank's process): K1-K6 as a
    rank step of part (b) a train step, K1 once and K3 twice a lockstep
    validation batch, nothing else; the same losses, parameters and
    save_dir on every rank; one writer; and each rank resumes the
    epoch, LR, plateau counters, parameters and its own dropout stream
    that the first run ended with."""
    step_want = _step_want(big_bn, 1)
    batch_want = {"composite_convt": 1, "composite_convt_bwd": 0, "bn_stats": 0,
                  "tap_conv_fwd": 2, "tap_conv_dx": 0, "tap_conv_dw": 0}
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_cli_")
    problems, res, launch = [], {}, mesh.launch

    def run(name: str, extra: list) -> list:
        out = os.path.join(root, "ranks_" + name)
        os.makedirs(out)
        cli_common._train_rank = functools.partial(_counted_train_rank, out)
        mesh.launch = functools.partial(launch, timeout=DP_TIMEOUT_S)  # the CLI's spawn
        try:
            t0 = time.perf_counter()
            with _counted_trainers():  # TRAINER_VIDEOS, in the config the ranks receive
                if train_ucf101.main(TRAINER_ARGV + [
                        "--num_devices", str(DP_WORLD), "--save_root", root, "--exp_id", name,
                        *extra], devices=["cuda:0"] * DP_WORLD) is not None:
                    problems.append(f"{name}: train_main returned a Trainer, not ranks")
            res[name + "_wall_s"] = time.perf_counter() - t0
        finally:
            cli_common._train_rank, mesh.launch = _TRAIN_RANK, launch
        recs = [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
                for r in range(DP_WORLD)]
        for r, rec in enumerate(recs):
            steps = batches = 0
            for c in rec["launches"]:
                per_step = {k: v / c["steps"] for k, v in c["train"].items()}
                per_batch = {k: v / c["val_batches"] for k, v in c["val"].items()}
                if per_step != step_want or per_batch != batch_want:
                    problems.append(f"{name} rank {r} epoch {c['epoch']}: a step {per_step}, "
                                    f"a val batch {per_batch}")
                steps, batches = steps + c["steps"], batches + c["val_batches"]
            want = {k: steps * step_want[k] + batches * batch_want[k] for k in step_want}
            if rec["total"] != want:
                problems.append(f"{name} rank {r}: launches {rec['total']}, want {want}")
        first = recs[0]
        for key, get in (("save_dir", lambda c: c["save_dir"]),
                         ("losses", lambda c: [e["loss"] for e in c["epoch_stats"]]),
                         ("parameters", lambda c: c["end"]["digests"]["params"])):
            if any(get(c) != get(first) for c in recs):
                problems.append(f"{name}: the ranks' {key} differ")
        if not np.isfinite([e["loss"] for e in first["epoch_stats"]]).all():
            problems.append(f"{name}: a non-finite loss")
        if os.listdir(os.path.join(root, name)) != [os.path.basename(first["save_dir"])]:
            problems.append(f"{name}: run directories {os.listdir(os.path.join(root, name))}")
        problems.extend(f"{name}: {p}" for p in _run_files_problems(first["save_dir"]))
        res[name] = {"epochs": [dict(e, launches_a_step={k: v / c["steps"]
                                                         for k, v in c["train"].items()},
                                     launches_a_val_batch={k: v / c["val_batches"]
                                                           for k, v in c["val"].items()})
                                for e, c in zip(first["epoch_stats"], first["launches"])],
                     "launches_per_rank": [c["total"] for c in recs]}
        return recs

    try:
        one = run("dp", ["--epochs", "1"])
        ckpt = os.path.join(one[0]["save_dir"], "best_model_train_loss_1")
        gens = CheckpointIO.load(ckpt).get("rank_generators", [])
        if len(gens) != DP_WORLD or torch.equal(gens[0], gens[1]):
            problems.append(f"the checkpoint holds {len(gens)} rank generators, or equal ones")
        two = run("dp_resumed", ["--epochs", "2", "--resume", ckpt])
        for r, (a, b) in enumerate(zip(one, two)):
            got = {k: v for k, v in (b["restored"] or {}).items() if k != "seconds"}
            want = {"next_epoch": 2} | {k: a["end"][k] for k in ("lr", "best", "bad", "cooldown")}
            if (got != want or b["restored_digests"] != a["end"]["digests"]
                    or [e["epoch"] for e in b["epoch_stats"]] != [2]):
                problems.append(f"rank {r} resumed {got} {b['restored_digests']}, epochs "
                                f"{[e['epoch'] for e in b['epoch_stats']]}; want {want} "
                                f"{a['end']['digests']}, [2]")
        res["restore_s"] = [b["restored"]["seconds"] for b in two]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["problems"] = problems
    if problems:
        raise AssertionError(f"phase 14 (b), the train CLI: {problems}")
    return res


def eval_dp_phase(seed: int) -> dict:
    """Phase 14 (c): --eval_dp 2 with both replicas on cuda:0 (f32, TF32
    off, cuDNN's deterministic algorithms): 17 clips through
    make_sharded_forward, bit for bit one replica's forward on the same
    7-clip slices, and against one replica at clip batch 14 (reported:
    another batch shape sums in another order, and EM routing's cost_std
    amplifies that); then evaluate_ucf101.main at --eval_dp 2 and 1 on
    one checkpoint.  Launch counts set to 0 just before and read just
    after: K1 once and K3 twice a replica's slice of a padded batch."""
    devs = ["cuda:0"] * 2
    clips = np.random.default_rng(seed + 3).uniform(0, 1, (17, 8, 224, 224, 3)).astype(np.float32)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with f32_exact():
            models = [build_capsnet(seed=seed, compute_dtype=torch.float32, device=d)
                      for d in devs]
            reset_launches()
            seg2, sc2 = make_sharded_forward(models, clip_batch_size=14)(clips)
            launches = read_launches()
            one, n = make_eval_fn(models[0]), clips.shape[0]
            rows = -(-n // 14) * 14  # the padded batches' rows, 7 a replica
            padded = np.concatenate([clips, np.zeros((rows - n, *clips.shape[1:]), np.float32)])
            outs = [one(torch.from_numpy(padded[i:i + 7]).cuda()) for i in range(0, rows, 7)]
            seg_s, sc_s = (torch.cat([o[k] for o in outs])[:n].cpu().numpy() for k in (0, 1))
            whole = make_padded_forward(models[0], clip_batch_size=14)
            parts = [whole(clips[i:i + 14]) for i in range(0, n, 14)]
            seg1, sc1 = (np.concatenate([p[k] for p in parts]) for k in (0, 1))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    del models
    nb = 2 * (rows // 14)  # 17 clips: 2 padded batches, each split over 2 replicas
    want = {"composite_convt": nb, "composite_convt_bwd": 0, "bn_stats": 0,
            "tap_conv_fwd": 2 * nb, "tap_conv_dx": 0, "tap_conv_dw": 0}
    fwd = {"bitwise_vs_one_replica_same_slices": bool(
               np.array_equal(seg2, seg_s) and np.array_equal(sc2, sc_s)),
           "vs_one_replica_batch_14": {
               "max_abs_sigmoid_seg": float(np.abs(seg1 - seg2).max()),
               "max_abs_scores": float(np.abs(sc1 - sc2).max()),
               "same_argmax": bool((sc1.argmax(1) == sc2.argmax(1)).all())}}
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_dp_")
    try:
        state = create_train_state(seed=seed, device="cuda", bn_groups=2)
        CheckpointIO().save(os.path.join(root, "best_model_train_loss_1"), state)
        del state
        argv = ["--ckpt", root, "--synthetic", "--split", "train", "--no_prune", "--nan_safe"]
        one = evaluate_ucf101.main(argv)
        reset_launches()
        t0 = time.perf_counter()
        two = evaluate_ucf101.main(argv + ["--eval_dp", "2"], eval_devices=devs)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = read_launches()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cnb = 2 * _eval_batches(24)
    cli_want = {"composite_convt": cnb, "composite_convt_bwd": 0, "bn_stats": 0,
                "tap_conv_fwd": 2 * cnb, "tap_conv_dx": 0, "tap_conv_dw": 0}
    keys = ("accuracy", "fmAP@0.5", "vmAP@0.5", "fmAP@0.2", "vmAP@0.2")
    (p1, r1), (p2, r2) = next(iter(one.items())), next(iter(two.items()))
    summaries = {k: (float(r1[k]), float(r2[k])) for k in keys}
    same = all(np.allclose(a, b, rtol=0, atol=1e-6, equal_nan=True) for a, b in summaries.values())
    res = {"forward": fwd, "launches": launches, "want": want, "cli_launches": cli_launches,
           "cli_want": cli_want, "cli_seconds": cli_s, "summaries_eval_dp_1_2": summaries}
    if not (fwd["bitwise_vs_one_replica_same_slices"] and launches == want
            and cli_launches == cli_want and same and p1 == p2):
        raise AssertionError(f"phase 14 (c): {res}")
    return res


# phase 15: the serving artifact
ARTIFACT_ATOL = 1e-3  # artifact vs the in-process model, sigmoid seg and scores
ARTIFACT_OPS = {"picad.composite_convt.default": 1, "picad.tap_conv_fwd.default": 2,
                "picad.max_pool_axis.default": STRIDE1_LAUNCHES}
PARITY_TIMEOUT_S = 300  # each run of the parity harness


def _parity_run(argv: list) -> subprocess.CompletedProcess:
    """python -m picad_tpu_torch.tools.parity_eval, as a user runs it."""
    return subprocess.run([sys.executable, "-m", "picad_tpu_torch.tools.parity_eval", *argv],
                          capture_output=True, text=True, timeout=PARITY_TIMEOUT_S,
                          cwd=os.path.dirname(os.path.abspath(__file__)))


def _warm_clips_per_s(serving, clips, reps: int = 3) -> float:
    """Whole predict_clips calls on two full batches, warm."""
    serving.predict_clips(clips)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        serving.predict_clips(clips)
    torch.cuda.synchronize()
    return reps * clips.shape[0] / (time.perf_counter() - t0)


def artifact_phase(seed: int, ckpt: str) -> dict:
    """Phase 15: the serving artifact on the card (see the module
    docstring); `ckpt` is the checkpoint phase 13 kept."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_artifact_")
    res: dict = {}
    try:
        model = build_capsnet(seed=seed, device="cuda")  # bf16, seeded weights
        t0 = time.perf_counter()
        out = save_artifact(os.path.join(root, "art"), model, clip_batch_size=14, height=224,
                            width=224)
        res["export_save_s"] = time.perf_counter() - t0
        res["artifact_bytes"] = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        t0 = time.perf_counter()
        art = load_artifact(out)
        res["load_s"] = time.perf_counter() - t0
        targets = [str(n.target) for n in art.program.graph.nodes if n.op == "call_function"]
        res["graph_nodes"] = len(targets)
        res["ops"] = {op: targets.count(op) for op in ARTIFACT_OPS}
        live = ServingModel.from_model(model, clip_batch_size=14)
        rng = np.random.default_rng(seed + 5)
        clips = rng.uniform(0, 1, (17, 8, 224, 224, 3)).astype(np.float32)
        video = rng.uniform(0, 1, (64, 224, 224, 3)).astype(np.float32)
        torch.cuda.synchronize()
        reset_launches()
        reset_pool_launches()
        seg, scores = art.predict_clips(clips)
        vid = art.predict_video(video)
        torch.cuda.synchronize()
        res["launches"], res["pool_launches"] = read_launches(), pool_launches()
        n_batches = 2 + 1  # 17 clips -> 14 + 3 (padded); 64 frames -> 8 clips (padded)
        want = {"composite_convt": n_batches, "composite_convt_bwd": 0, "bn_stats": 0,
                "tap_conv_fwd": 2 * n_batches, "tap_conv_dx": 0, "tap_conv_dw": 0}
        seg_l, scores_l = live.predict_clips(clips)
        vid_l = live.predict_video(video)
        res["max_abs"] = {"sigmoid_seg": float(np.abs(seg - seg_l).max()),
                          "scores": float(np.abs(scores - scores_l).max()),
                          "video_segmentation": float(np.abs(vid["segmentation"]
                                                             - vid_l["segmentation"]).max()),
                          "video_scores": float(np.abs(vid["scores"] - vid_l["scores"]).max())}
        res["bitwise"] = all(np.array_equal(a, b) for a, b in (
            (seg, seg_l), (scores, scores_l), (vid["segmentation"], vid_l["segmentation"])))
        same_classes = (bool((scores.argmax(1) == scores_l.argmax(1)).all())
                        and vid["pred_label"] == vid_l["pred_label"])
        finite = all(np.isfinite(a).all() for a in (seg, scores, vid["segmentation"]))
        warm = clips[:14].repeat(2, axis=0)
        res["clips_per_s_warm"] = {"artifact": _warm_clips_per_s(art, warm),
                                   "in_process": _warm_clips_per_s(live, warm)}
        want_pools = serve_pool_want(n_batches)
        if not (res["ops"] == ARTIFACT_OPS and res["launches"] == want and same_classes
                and res["pool_launches"] == want_pools
                and finite and max(res["max_abs"].values()) <= ARTIFACT_ATOL):
            raise AssertionError(f"artifact: ops {res['ops']} (want {ARTIFACT_OPS}), launches "
                                 f"{res['launches']} (want {want}), pool launches "
                                 f"{res['pool_launches']} (want {want_pools}), same classes "
                                 f"{same_classes}, finite {finite}, {res['max_abs']}")
        del art, live, model
        torch.cuda.empty_cache()

        # the export CLI on the checkpoint phase 13 wrote, with --verify
        t0 = time.perf_counter()
        cli_out = export_model.main(["--ckpt", ckpt, "--out", os.path.join(root, "cli"),
                                     "--compute_dtype", "bf16", "--verify"])
        res["export_cli_s"] = time.perf_counter() - t0
        with open(os.path.join(cli_out, "meta.json")) as f:
            res["export_cli_meta"] = json.load(f)

        # the parity harness on a reference-format .pth of seeded weights
        pth = os.path.join(root, "best_model_train_loss_1.pth")
        torch.save(build_capsnet(seed=seed + 1, compute_dtype=torch.float32,
                                 device="cpu").state_dict(), pth)
        argv = ["--reference_pth", pth, "--synthetic", "2", "--nan_safe"]
        t0 = time.perf_counter()
        first = _parity_run(argv)
        lines = [ln for ln in first.stdout.splitlines() if ln.startswith("Accuracy:")]
        if first.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"parity_eval: rc {first.returncode}\n{first.stdout}\n"
                                 f"{first.stderr[-3000:]}")
        again = _parity_run(argv + ["--reference_line", lines[0]])
        res["parity"] = {"line": lines[0], "rc": again.returncode,
                         "seconds": time.perf_counter() - t0,
                         "verdict": [ln for ln in again.stdout.splitlines()
                                     if ln.startswith("[parity]")]}
        if again.returncode != 0 or "[parity] PASS" not in again.stdout:
            raise AssertionError(f"parity_eval against its own line: {res['parity']}\n"
                                 f"{again.stdout}\n{again.stderr[-3000:]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no result", file=sys.stderr)
        return 1
    results: dict = {}
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

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
    reset_launches()
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
    reset_pool_launches()
    pools = [check_pool_bwd(c, dtype, args.seed + k, timed=True)
             for k, (c, dtype) in enumerate(itertools.product(
                 POOL_BWD_SHAPES, (torch.bfloat16, torch.float32)))]
    pools += [check_pool_bwd(c, torch.bfloat16, args.seed, timed=False, ties=True)
              for c in POOL_BWD_SHAPES]
    s1 = [check_pool_s1(name, dtype, args.seed + k, timed=(dtype == torch.bfloat16))
          for k, (name, dtype) in enumerate(itertools.product(
              i3d.INCEPTION_SPECS, (torch.bfloat16, torch.float32)))]
    n_checked = read_launches() | {fn.__name__: fn.launches for fn in POOL_COUNTERS}
    stride1 = time_stride1_pools(args.seed)
    results.update(composite_convt=checks, composite_convt_bwd=bwd, bn_stats=stats,
                   bn_stats_stress=stress, tap_conv=taps, composite_plans=k12_plans,
                   max_pool_bwd=pools, max_pool_axis=s1, stride1_pools=stride1)

    def timing(c):
        return (f" kernel_ms {c['kernel_ms']:.4f} plain_ms {c['plain_ms']:.4f} library_ms "
                f"{c['library_ms']:.4f}" + (f" copy_ms {c['copy_ms']:.4f}" if "copy_ms" in c
                                            else "")
                + f" bound_us {1e3 * c['bound_ms']:.1f} ({c['bound_by']})"
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
        + " | max_pool_bwd (tol: f32 bit for bit, bf16 1 ulp; twice bit for bit) " + "; ".join(
            f"{c['pool']} {c['dtype']}{' ties' if c['ties'] else ''} err {c['max_abs_err']:.2e} "
            f"(bitwise plain {c['bitwise_plain']})" + timing(c) for c in pools)
        + " | max_pool_axis / max_pool_axis_bwd (csrc/max_pool_s1.cu; tol: every stage bit for "
        "bit the plain chain, relu, ties, negative x with inf/NaN in g; twice bit for bit; a "
        "pool's stages summed, each timed in a CUDA graph over operands out of L2) "
        + "; ".join(
            f"{c['block']} {c['dtype']} {len(c['stages'])} checks"
            + (f" fwd kernel_ms {c['fwd_ms']:.4f} plain_ms {c['fwd_plain_ms']:.4f} library_ms "
               f"{c['fwd_library_ms']:.4f} copy_ms {c['fwd_copy_ms']:.4f} bound_us "
               f"{1e3 * c['fwd_bound_ms']:.1f}; bwd kernel_ms {c['bwd_ms']:.4f} plain_ms "
               f"{c['bwd_plain_ms']:.4f} library none copy_ms {c['bwd_copy_ms']:.4f} bound_us "
               f"{1e3 * c['bwd_bound_ms']:.1f} ({c['bwd_bound_by']}); eager back to back fwd "
               f"{c['fwd_eager_ms']:.4f} bwd {c['bwd_eager_ms']:.4f}" if "fwd_ms" in c else "")
            for c in s1)
        + " | stride-1 pools fwd+bwd (bf16, in a CUDA graph), kernels against the plain chain "
        + "; ".join(
            f"{c['block']} {tuple(c['shape'])} {c['fwd_bwd_ms']:.4f} ms (fwd {c['fwd_ms']:.4f}) "
            f"in {c['device_ops']:.0f} device ops, plain {c['plain_fwd_bwd_ms']:.4f} ms (fwd "
            f"{c['plain_fwd_ms']:.4f}) in {c['plain_device_ops']:.0f}" for c in stride1)
        + f" (in all {sum(c['fwd_bwd_ms'] for c in stride1):.4f} ms in "
        f"{sum(c['device_ops'] for c in stride1):.0f} ops, plain "
        f"{sum(c['plain_fwd_bwd_ms'] for c in stride1):.4f} ms in "
        f"{sum(c['plain_device_ops'] for c in stride1):.0f})"
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
    reset_launches()
    reset_pool_launches()
    seg, scores = serving.predict_clips(serve_clips)
    vid = serving.predict_video(video)
    serve_launches, serve_by_conv = read_launches(), read_conv_counts()
    serve_pools = pool_launches()
    n_batches = 2 + 1  # 17 clips -> 14 + 3 (padded); 64 frames -> 8 clips (padded)
    ok_shapes = (seg.shape == (17, 8, 224, 224) and scores.shape == (17, 24)
                 and vid["segmentation"].shape == (64, 224, 224, 1)
                 and vid["scores"].shape == (24,))
    finite = all(np.isfinite(a).all() for a in (seg, scores, vid["segmentation"], vid["scores"]))
    want = {"composite_convt": n_batches, "composite_convt_bwd": 0, "bn_stats": 0,
            "tap_conv_fwd": 2 * n_batches, "tap_conv_dx": 0, "tap_conv_dw": 0}
    want_by_conv = {fn.__name__: {conv: n_batches if fn is tapconv.tap_conv_fwd else 0
                                  for conv in PCAPS_CO} for fn in TAP_COUNTERS}
    want_pools = serve_pool_want(n_batches)
    if not (ok_shapes and finite and serve_launches == want and serve_by_conv == want_by_conv
            and serve_pools == want_pools):
        raise AssertionError(f"serve: shapes ok {ok_shapes}, finite {finite}, "
                             f"launches {serve_launches} != {want} or by conv {serve_by_conv} "
                             f"!= {want_by_conv} or pools {serve_pools} != {want_pools}")
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
                             "pool_launches": serve_pools,
                             "padded_batches": n_batches,
                             "clips_per_s_warm": clips_per_s, "bf16_vs_f32": dev_bf16}
    phase(5, "serve", f"ServingModel bf16 clip batch 14: predict_clips 17 -> {seg.shape}, "
          f"predict_video 64 frames -> label {vid['pred_label']}; launches {serve_launches}, "
          f"K3 by conv {serve_by_conv['tap_conv_fwd']} "
          f"(composite_convt = padded batches {n_batches}, tap_conv_fwd twice that), pool "
          f"kernels by channels {serve_pools} ({STRIDE1_LAUNCHES} max_pool_axis a batch); "
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
    f32_card: dict = {}
    ts = train_step_card_vs_cpu(seed=args.seed + 1, size=96, keep=f32_card)
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

    # 8 the training main path at full width, bf16: graphed, against eager;
    # 9 where one warm train step spends its time: a replay, and an eager
    # step, whose traces give phase 8 the replays' launches
    tr_both, one_step, one_eager = train_main_path(args.seed)
    results["train_bf16"] = tr_both
    results["train_profile"] = prof = train_profile(tr_both, one_step, one_eager)
    tr, te = tr_both["graphed"], tr_both["eager"]
    ge = tr_both["graphed_vs_eager"]
    phase(8, "train", f"bench configuration bf16, batch {TRAIN_BS} (2B = {2 * TRAIN_BS}) of "
          f"8x224^2, {TRAIN_STEPS} steps through the graphed step ({tr['captures']} capture, "
          f"{tr['replays']} replays): launches {tr['launches']}, K3-K5 by conv "
          f"{tr['by_conv']} (K6 inputs per step "
          f"{tr['big_bn_per_step']}), max_pool_bwd by channels {tr['pool_by_c']}, "
          f"max_pool_axis {tr['axis_by_c']} and max_pool_axis_bwd {tr['axis_bwd_by_c']} (the "
          f"{tr['counted_steps']} eager calls as the wrappers counted them, each replay as its "
          f"trace shows, phase 9); "
          f"loss {tr['losses'][0]['loss']:.4f} -> "
          f"{tr['losses'][-1]['loss']:.4f}; parameters moved {tr['params_moved']}/"
          f"{tr['n_params']}; against the eager step from the same state: bit for bit "
          f"({ge['n_tensors']} tensors and the losses); median replayed step "
          f"{tr['warm_step_ms']:.2f} ms = {tr['clips_per_s']:.2f} train clips/s, eager "
          f"{te['warm_step_ms']:.2f} ms = {te['clips_per_s']:.2f}, each step synchronised (not "
          f"the bench's back-to-back rate, phase 12); peak allocated memory "
          f"{tr['peak_mem_gib']:.2f} GiB graphed (the graph's pool {tr['pool_gib']:.3f} GiB "
          f"reserved, {tr['pool_allocated_gib']:.3f} of it allocated; reserved in all "
          f"{tr['reserved_gib']:.2f}), {te['peak_mem_gib']:.2f} eager ({smi})")
    tp, tq = prof["replay"], prof["eager"]
    phase(9, "train-profile", "one replayed train step: " + (
        f"wall {tp['wall_ms']:.2f} ms under the profiler, device {tp['device_ms']:.2f} ms in "
        f"{tp['device_ops']:.0f} operations (busy {tp['busy_share']:.3f}; "
        f"{tp['busy_share_of_warm_step']:.3f} of the unprofiled synchronised step), host "
        f"{tp['host_ms']:.3f} ms a call; the eager step: wall {tq['wall_ms']:.2f} ms, device "
        f"{tq['device_ms']:.2f} ms in {tq['device_ops']:.0f} operations (busy "
        f"{tq['busy_share']:.3f}; {tq['busy_share_of_warm_step']:.3f}), host "
        f"{tq['host_ms']:.3f} ms a call; the counted wrappers' CUDA functions in a replay's "
        f"trace, the same as in the eager step's: " + ", ".join(
            f"{k} {sum(v.values()):.0f} in {len(v)} names" for k, v in tp["kernel_counts"].items())
        + "; replay kernels " + ", ".join(f"{k} {v:.3f} ms" for k, v in tp["kernel_ms"].items())
        + "".join(f", {k} {tp['counted_ms'][k]:.3f} ms"
                  for k in ("max_pool_bwd", "max_pool_axis", "max_pool_axis_bwd"))
        + "; top: " + ", ".join(f"{k['name'][:40]} {k['device_ms']:.2f}" for k in tp["top"][:6])))

    del one_step, one_eager  # phase 8's train states
    torch.cuda.empty_cache()

    # 10 the plain stem against the space-to-depth stem
    results["stem"] = st = stem_phase(args.seed)
    phase(10, "stem", f"bf16, eval fwd / train fwd+bwd ms, medians of {STEM_ROUNDS} rounds "
          "in turns: " + "; ".join(
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

    # 12 both bench cells through the bench's own functions, shortened
    torch.cuda.empty_cache()
    results["bench"] = bench = bench_phase(args.seed)
    for cell, r in bench.items():
        print(json.dumps(r))
        phase(12, "bench", f"{cell} ({BENCH_LENGTHS}): " + ", ".join(
            f"{k} {r[k]:.4g}" for k in BENCH_LINE[cell]) + "; check against the CPU f32 "
            + ", ".join(f"{k} {v:.3g}" for k, v in r["check"]["readings"].items()
                        if k in r["check"]["limits"]) + "; launches a step or batch "
            + ", ".join(f"{k}_launches {r[k + '_launches']:g}" for k in sorted(
                KERNELS[n] for n in BENCH_WANT[cell])) + f" | {smi}")

    # 13 the train and evaluate CLIs' path
    torch.cuda.empty_cache()
    keep_dir = tempfile.mkdtemp(prefix="chip_smoke_kept_")  # phase 13's checkpoint, for 15
    results["trainer"] = trn = trainer_phase(tr["big_bn_per_step"], tf32_defaults, keep_dir)
    for run in ("ucf101", "ucf101_resumed", "jhmdb"):
        phase(13, "trainer", f"{run}: " + "; ".join(
            f"epoch {r['epoch']}: {r['steps']} steps in {r['seconds']:.2f} s = "
            f"{r['clips_per_s']:.2f} clips/s, loss {r['loss']:.4f}" for r in trn[run])
            + f"; launches a step {trn[run][0]['launches_a_step']}, a val batch "
            f"{trn[run][0]['launches_a_val_batch']}; the graphed step "
            f"{trn['graph'][run]} | {smi}")
    c = trn["checkpoint"]
    phase(13, "trainer", f"checkpoint {c['path']}: {c['bytes']} bytes, save {c['save_s']:.3f} s, "
          f"restore {c['restore_s']:.3f} s; resumed at epoch 3 with the LR and scheduler "
          f"counters of the unbroken run; host synchronisations in epoch 3's train steps "
          f"(4 steps, --pf 2) by site {trn['sync_sites_epoch_3']}; TF32 defaults "
          f"{trn['tf32_defaults']}; phase {trn['seconds']:.1f} s | {smi}")
    for cli in ("evaluate_ucf101", "evaluate_jhmdb"):
        e = trn[cli]
        phase(13, "trainer", f"{cli} (f32): {len(e['checkpoints'])} checkpoint(s) "
              f"{e['checkpoints']}, {e['padded_batches']} padded batches, "
              f"{e['seconds_a_checkpoint']:.2f} s a checkpoint, launches a batch "
              f"{e['launches_a_batch']}; {e['summaries']}; left {e['surviving']} | {smi}")

    # 14 the data-parallel path
    torch.cuda.empty_cache()
    t_dp = time.perf_counter()
    results["nccl_world_one"] = a = nccl_world_one(args.seed)
    phase(14, "data-parallel", "(a) one-rank NCCL group, bench configuration bf16 batch "
          f"{TRAIN_BS}, {DP_STEPS} steps (torch's deterministic algorithms): against no group "
          f"{a['group_vs_none']}, no group against itself {a['none_vs_none']}; operations "
          f"without a deterministic form {a['nondeterministic_ops']}; launches "
          f"{a['launches']}; warm step {a['warm_step_ms']['group']:.2f} ms with the group, "
          f"{a['warm_step_ms']['none']:.2f} ms without; one profiled step with / without "
          f"the group: {a['profiled_step']['group']} / {a['profiled_step']['none']}; gradient "
          f"all-reduce (NCCL, world 1) {a['grad_allreduce_ms']:.3f} ms | {smi}")
    torch.cuda.empty_cache()
    results["two_ranks_one_card"] = b = two_ranks_one_card(args.seed, args.seed + 1, f32_card)
    del f32_card
    band = b["f32_vs_one_process"]
    phase(14, "data-parallel", f"(b) {DP_WORLD} ranks on cuda:0 over gloo, global batch "
          f"{TRAIN_BS} ({TRAIN_BS // DP_WORLD} a rank), bf16, {DP_STEPS} steps: the same losses "
          f"{b['losses']} and parameters on both ranks after every step; launches a step per "
          f"rank {b['launches_a_step_per_rank']} (each rank {b['launches_per_rank']}); warm "
          f"rank step {b['warm_rank_step_ms']} ms (two ranks share the card) against the "
          f"single-card eager step {te['warm_step_ms']:.2f} ms (phase 8); gradient all-reduce "
          f"(gloo, ~192 MB f32) {b['grad_allreduce_ms']} ms a rank; spawn wall "
          f"{b['wall_s']:.1f} s | f32 96^2 step at world 2 against phase 7's card step: "
          f"BN stats {band['stats_max_rel']:.2e}, losses (band) " + ", ".join(
              f"{k} {v['card']:.6f}/{v['cpu']:.6f} ({v['band']:.1e})"
              for k, v in band["metrics"].items())
          + f", noisy gradients relative L2 {band['noisy_grads']['rel_l2']:.2e} vs band "
          f"{band['noisy_grads']['band_rel_l2']:.2e} | {smi}")
    torch.cuda.empty_cache()
    results["train_cli_two_ranks"] = d = train_cli_two_ranks(b["big_bn_per_step"])
    phase(14, "data-parallel", f"(b) train_ucf101.main --num_devices {DP_WORLD} on cuda:0 "
          "twice (gloo), phase 13's flags: " + "; ".join(
              f"{run} epoch {e['epoch']}: {e['steps']} steps in {e['seconds']:.2f} s = "
              f"{e['clips_per_s']:.2f} clips/s, loss {e['loss']:.4f}, launches a rank step "
              f"{e['launches_a_step']}, a val batch {e['launches_a_val_batch']}"
              for run in ("dp", "dp_resumed") for e in d[run]["epochs"])
          + f"; each rank's launches {d['dp']['launches_per_rank']} / "
          f"{d['dp_resumed']['launches_per_rank']}; one writer; both ranks resumed epoch 2 "
          f"with the epoch-1 state (parameters, LR, plateau counters, own dropout stream) in "
          f"{d['restore_s']} s; calls {d['dp_wall_s']:.1f} / {d['dp_resumed_wall_s']:.1f} s "
          f"| {smi}")
    results["eval_dp"] = c = eval_dp_phase(args.seed)
    results["data_parallel_seconds"] = time.perf_counter() - t_dp
    phase(14, "data-parallel", f"(c) --eval_dp 2, both replicas on cuda:0, f32: 17 clips "
          f"against one replica {c['forward']}, launches {c['launches']}; "
          f"evaluate_ucf101.main --eval_dp 2 against --eval_dp 1: {c['summaries_eval_dp_1_2']}, "
          f"launches {c['cli_launches']}, {c['cli_seconds']:.2f} s | phase "
          f"{results['data_parallel_seconds']:.1f} s | {smi}")

    # 15 the serving artifact
    torch.cuda.empty_cache()
    try:
        results["artifact"] = art = artifact_phase(args.seed, trn["kept_checkpoint"])
    finally:
        shutil.rmtree(keep_dir, ignore_errors=True)
    phase(15, "artifact", f"bf16 clip batch 14, 224^2: export + save {art['export_save_s']:.1f} s, "
          f"{art['artifact_bytes']} bytes, load {art['load_s']:.1f} s; graph "
          f"{art['graph_nodes']} calls, custom ops {art['ops']}; predict_clips 17 and "
          f"predict_video 64 frames against the in-process model: max abs {art['max_abs']} "
          f"(tol {ARTIFACT_ATOL}), same classes, bit for bit {art['bitwise']}; launches "
          f"{art['launches']} (3 padded batches); warm clips/s {art['clips_per_s_warm']}; "
          f"export_model --verify on {os.path.basename(trn['kept_checkpoint'])} "
          f"{art['export_cli_s']:.1f} s; parity_eval {art['parity']['line']!r} against itself: "
          f"rc {art['parity']['rc']} {art['parity']['verdict']} ({art['parity']['seconds']:.1f} s)"
          f"; phase {art['seconds']:.1f} s | {smi}")

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
         "launches": tr["by_conv"][name][conv], "max_abs_err": k35[conv][name]["err"],
         "ms": k35[conv][name]["kernel_ms"], "plain_ms": k35[conv][name]["plain_ms"],
         "bound_ms": k35[conv][name]["bound_ms"], "bound_by": k35[conv][name]["bound_by"],
         "library_ms": k35[conv][name]["library_ms"]}
        for conv in PCAPS_CO
        for name, line in (("tap_conv_fwd", 371), ("tap_conv_dx", 421), ("tap_conv_dw", 478))
    ] + [  # the strided pools' backward at each of the train step's pools, bf16
        {"name": f"max_pool_bwd/{c['pool']}", "route": "cuda",
         "source": "picad_tpu_torch/csrc/max_pool_bwd.cu",
         "replaces": "picad_tpu/ops/convops.py:198 (XLA select-and-scatter)",
         "launches": tr["pool_by_c"][ch], "max_abs_err": c["max_abs_err"],
         "ms": c["kernel_ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
         "bound_by": c["bound_by"], "library_ms": c["library_ms"]}
        for ch in POOL_BWD_SHAPES
        for c in pools if "kernel_ms" in c and c["dtype"] == "bfloat16"
        and c["shape"] == list(POOL_BWD_SHAPES[ch][0])
    ] + [  # the stride-1 pools' forward and backward at each pool shape, bf16: the
        # pool's stages summed, with the launches the wrappers counted at its channels
        {"name": f"{fn}/{'Mixed_4c-4e' if c['block'] == 'Mixed_4c' else c['block']}",
         "route": "cuda", "source": "picad_tpu_torch/csrc/max_pool_s1.cu",
         "replaces": "picad_tpu/ops/convops.py:208-268 (_max_pool_axis, jax.custom_vjp)",
         "launches": tr[counts][c["shape"][1]], "max_abs_err": c[f"{d}_err"],
         "ms": c[f"{d}_ms"], "plain_ms": c[f"{d}_plain_ms"], "bound_ms": c[f"{d}_bound_ms"],
         "bound_by": c[f"{d}_bound_by"], "library_ms": c.get(f"{d}_library_ms")}
        for fn, d, counts in (("max_pool_axis", "fwd", "axis_by_c"),
                              ("max_pool_axis_bwd", "bwd", "axis_bwd_by_c"))
        for c in s1 if "fwd_ms" in c and c["block"] not in ("Mixed_4d", "Mixed_4e")
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
