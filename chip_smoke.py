#!/usr/bin/env python3
"""Bring-up check of picad_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py [--seed N]

Run from the repository root.  Each phase prints one line, and the first
failure exits non-zero (no phase is caught and passed over):

  1 device  nvidia-smi's name and power limit, and torch's device name.
  2 build   nvcc on every picad_tpu_torch/csrc/*.cu for sm_90a, one
            process per source, all started together; build seconds and
            ptxas's register/spill report.
  3 kernel  each kernel against its plain PyTorch version on the same
            inputs: composite_convt at the serving shape
            (14, 4, 112, 112, 128) in bf16 and f32 and at a ragged shape;
            max error <= 1e-4 * max|plain| (f32 sums in another order);
            kernel, plain and library (grouped ConvTranspose3d) times and
            the bound.
  4 slice   the CapsNet eval forward at 224^2, 24 classes, seeded
            weights, batch 2, f32 with TF32 off: card (CUDA kernel) vs CPU
            (plain version); same argmax class, scores and sigmoid seg
            within 1e-3.
  5 serve   the main path, bf16: ServingModel with clip_batch_size 14,
            predict_clips on 17 clips and predict_video on a 64-frame 224^2
            video, launch counts set to 0 just before and read just after
            (composite_convt must launch once per padded clip batch);
            finite outputs of the right shapes; warm clips/s; the bf16 vs
            f32 deviation on the same clips.
  6 profile torch.profiler over one warm 14-clip predict_clips: wall
            time, summed device time (kernels, copies, fills), its share
            of the wall, composite_convt's time and the top device
            entries (all of them in chiprun_out/chip_smoke.json).

Then three lines: nvidia-smi's name and power limit, the kernel table as
one JSON object, and last {"ok": true, "device": {...}}.  The full
results also go to chiprun_out/chip_smoke.json.  Without a CUDA card it
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from picad_tpu_torch.models.capsules import build_capsnet
from picad_tpu_torch.ops import _build
from picad_tpu_torch.ops.fused_head_kernel import (
    composite_convt,
    composite_convt_library,
    composite_convt_plain,
)
from picad_tpu_torch.serve.runner import ServingModel

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 / FP32
SERVE_SHAPE = (14, 4, 112, 112, 128)  # the head input at clip batch 14, 224^2
RAGGED_SHAPE = (2, 3, 20, 13, 128)
KERNEL_RTOL = 1e-4  # of max|plain|: f32 accumulation in another order
SLICE_ATOL = 1e-3  # card vs CPU f32: EM routing's cost_std quirk amplifies
# the summation-order noise of two conv libraries (the port vs op-by-op
# JAX on the CPU: up to 4.3e-4 on the scores over six fixture draws)


def phase(n, name, msg):
    print(f"[{n} {name}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


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
    flops = 2 * B * T * H * W * C * 125
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def profile_batch(serving, clips) -> dict:
    """torch.profiler over one warm predict_clips call: wall time, the
    summed device time (kernels, copies, fills), its share of the wall,
    and the entries with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    serving.predict_clips(clips)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        serving.predict_clips(clips)
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
        "composite_convt_ms": sum(ms for name, (ms, _) in top if "composite_convt" in name),
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
    results["build"] = {"wall_s": wall, "per_source_s": {b.name: b.seconds for b in builds},
                        "ptxas": ptxas}
    phase(2, "build", f"{len(builds)} source(s) for sm_90a in {wall:.1f} s: "
          + "; ".join(f"{b.name} {b.seconds:.1f} s {ptxas[b.name]}" for b in builds))

    # 3 kernels vs plain
    launches0 = composite_convt.launches
    checks = [
        check_composite(SERVE_SHAPE, torch.bfloat16, args.seed, timed=True),
        check_composite(SERVE_SHAPE, torch.float32, args.seed, timed=True),
        check_composite(RAGGED_SHAPE, torch.bfloat16, args.seed + 1, timed=False),
        check_composite(RAGGED_SHAPE, torch.float32, args.seed + 1, timed=False),
    ]
    results["composite_convt"] = checks
    n_checked = composite_convt.launches - launches0
    phase(3, "kernel", "composite_convt vs plain, tol 1e-4*max|plain|: " + "; ".join(
        f"{c['dtype']} {tuple(c['shape'])} err {c['max_abs_err']:.2e}"
        + (f" kernel_ms {c['kernel_ms']:.4f} plain_ms {c['plain_ms']:.4f} library_ms "
           f"{c['library_ms']:.4f} bound_us {1e3 * c['bound_ms']:.1f} ({c['bound_by']})"
           if "kernel_ms" in c else "")
        for c in checks) + f"; {n_checked} kernel launches in this phase | {smi}")

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

    # 5 the main path: serving at full width, bf16
    rng = np.random.default_rng(args.seed + 2)
    serve_clips = rng.uniform(0, 1, (17, 8, 224, 224, 3)).astype(np.float32)
    video = rng.uniform(0, 1, (64, 224, 224, 3)).astype(np.float32)
    serving = ServingModel.from_state_dict(seed=args.seed, clip_batch_size=14, device="cuda")
    composite_convt.launches = 0
    seg, scores = serving.predict_clips(serve_clips)
    vid = serving.predict_video(video)
    launches = composite_convt.launches
    n_batches = 2 + 1  # 17 clips -> 14 + 3 (padded); 64 frames -> 8 clips (padded)
    ok_shapes = (seg.shape == (17, 8, 224, 224) and scores.shape == (17, 24)
                 and vid["segmentation"].shape == (64, 224, 224, 1)
                 and vid["scores"].shape == (24,))
    finite = all(np.isfinite(a).all() for a in (seg, scores, vid["segmentation"], vid["scores"]))
    if not (ok_shapes and finite and launches == n_batches):
        raise AssertionError(f"serve: shapes ok {ok_shapes}, finite {finite}, "
                             f"composite_convt launches {launches} != {n_batches}")
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
    dev_bf16 = {"max_abs_sigmoid_seg": float(np.abs(seg - seg32).max()),
                "max_abs_scores": float(np.abs(scores - scores32).max()),
                "argmax_agree": float((scores.argmax(1) == scores32.argmax(1)).mean())}
    results["serve_bf16"] = {"launches": launches, "padded_batches": n_batches,
                             "clips_per_s_warm": clips_per_s, "bf16_vs_f32": dev_bf16}
    phase(5, "serve", f"ServingModel bf16 clip batch 14: predict_clips 17 -> {seg.shape}, "
          f"predict_video 64 frames -> label {vid['pred_label']}; composite_convt launches "
          f"{launches} (= padded batches {n_batches}); warm {clips_per_s:.2f} clips/s "
          f"({smi}); bf16 vs f32: {dev_bf16}")

    # 6 where one warm 14-clip serving batch spends its time
    results["profile"] = profile_batch(serving, warm[:14])
    p = results["profile"]
    phase(6, "profile", "one 14-clip predict_clips: " + (
        f"wall {p['wall_ms']:.2f} ms, device {p['device_ms']:.2f} ms "
        f"(busy {p['busy_share']:.3f}), composite_convt {p['composite_convt_ms']:.3f} ms; "
        "top: " + ", ".join(f"{k['name'][:40]} {k['device_ms']:.2f}" for k in p["top"][:5])
        if p["device_ms"] else "device time not measured (the profiler saw no CUDA activity)"))

    bf = checks[0]
    kernels = {"kernels": [{
        "name": "composite_convt",
        "route": "cuda",
        "source": "picad_tpu_torch/csrc/composite_convt.cu",
        "replaces": "picad_tpu/ops/pallas_fused_head.py:69",
        "launches": launches,
        "max_abs_err": bf["max_abs_err"],
        "ms": bf["kernel_ms"],
        "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"],
        "bound_by": bf["bound_by"],
        "library_ms": bf["library_ms"],
    }]}
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
