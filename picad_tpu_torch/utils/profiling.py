"""Profiling hooks and throughput meters.

Counterpart of picad_tpu/utils/profiling.py: a trace context manager
(torch.profiler, written as a Chrome trace) and a StepTimer reporting
clips/s and clips/s per card.  Beside them, the measuring helpers the
bench (picad_tpu_torch/bench) and chip_smoke.py share: CUDA-event
timing back to back and in a CUDA graph over operands out of L2
(`cuda_ms`, `graph_ms`), a profiled call's device time by kernel, the
kernels' launch counts, a sample's percentile with the samples beyond
it, and nvidia-smi's card line.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import re
import subprocess
import time

import numpy as np
import torch


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace_context(log_dir: str | None):
    """Profile the enclosed steps and write a Chrome trace into `log_dir`
    (no-op if None).  Yields the profiler, or None."""
    if not log_dir:
        yield None
        return
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


class StepTimer:
    """Wall-clock throughput meter: clips/sec and clips/sec/chip.  The
    caller forces the device's completion before `report`."""

    def __init__(self, clips_per_step: int, n_chips: int | None = None):
        self.clips_per_step = clips_per_step
        self.n_chips = torch.cuda.device_count() if n_chips is None else n_chips
        if self.n_chips < 1:
            raise ValueError("StepTimer: no CUDA card to count; pass n_chips")
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    def report(self) -> dict:
        dt = time.perf_counter() - self._t0
        clips = self._steps * self.clips_per_step
        cps = clips / dt if dt > 0 else 0.0
        return {
            "steps": self._steps,
            "seconds": dt,
            "clips_per_sec": cps,
            "clips_per_sec_per_chip": cps / self.n_chips,
        }


def percentile(samples, q: float) -> dict:
    """np.percentile's q-th percentile of `samples` with the sample count
    and how many samples lie above it."""
    a = np.asarray(samples, dtype=np.float64)
    v = float(np.percentile(a, q))
    return {"value": v, "n": int(a.size), "beyond": int((a > v).sum())}


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


def host_launch_us(device: torch.device, n: int = 2000) -> float:
    """The host's microseconds to enqueue one tiny kernel (an in-place add
    on one element), back to back: the pace of a host that launches a
    step's thousands of kernels one by one."""
    x = torch.zeros(1, device=device)
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    t = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    return t / n * 1e6


class GcTimer:
    """Counts the interpreter's garbage collections inside the block and
    the milliseconds they took."""

    def __enter__(self):
        self.ms, self.collections, self._t0 = 0.0, 0, None
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.collections += 1

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


# the device names of each port kernel's CUDA functions
KERNEL_FRAGMENTS = {"composite_convt": ("composite_convt_kernel", "composite_convt_wgmma",
                                        "composite_convt_group_sum"),
                    "composite_convt_bwd": ("composite_bwd_kernel", "composite_bwd_wgmma",
                                            "reduce_partials"),
                    "bn_stats": ("plane_sums", "group_finish"),
                    "tap_conv_fwd": ("tap_conv_fwd_",),  # f32, wgmma and split-sum kernels
                    "tap_conv_dx": ("tap_conv_dx_",),
                    "tap_conv_dw": ("tap_conv_dw_",)}
COPY_PREFIXES = {"htod": "Memcpy HtoD", "dtoh": "Memcpy DtoH"}
# every kernel wrapper that counts its launches, by its CUDA functions'
# names: KERNEL_FRAGMENTS' six, the strided pools' backward (one
# function, a name no torch kernel contains) and the stride-1 pools'
# forward and backward (csrc/max_pool_s1.cu: names no torch kernel, and
# neither the other, contains)
COUNTED_KERNELS = {k: re.compile("|".join(map(re.escape, frags)))
                   for k, frags in KERNEL_FRAGMENTS.items()} | {
    "max_pool_bwd": re.compile(re.escape("picad_pool_bwd")),
    "max_pool_axis": re.compile(re.escape("picad_axis_pool_fwd")),
    "max_pool_axis_bwd": re.compile(re.escape("picad_axis_pool_bwd"))}


def launch_counters() -> tuple:
    """The kernel wrappers, in KERNEL_FRAGMENTS' order: each adds one to
    its `launches` where it launches its kernel, and nowhere else; a
    replay of the captured train step adds what its capture counted
    (`add_launches`)."""
    from picad_tpu_torch.ops import tapconv
    from picad_tpu_torch.ops.bn_stats import bn_stats
    from picad_tpu_torch.ops.fused_head_kernel import composite_convt, composite_convt_bwd

    return (composite_convt, composite_convt_bwd, bn_stats, tapconv.tap_conv_fwd,
            tapconv.tap_conv_dx, tapconv.tap_conv_dw)


def pool_counters() -> tuple:
    """The pool kernels' wrappers, counted apart from launch_counters()'
    six (the bench's kernel table has no row for them): the strided
    pools' backward, the stride-1 pools' forward and backward."""
    from picad_tpu_torch.ops import convops

    return (convops.max_pool_bwd, convops.max_pool_axis, convops.max_pool_axis_bwd)


def launch_state() -> dict:
    """Every count of every wrapper that counts its launches (the six of
    launch_counters() and pool_counters()): {(wrapper, attribute): the int
    `launches`, or a copy of a `launches_by_*` dict}."""
    return {(fn, a): dict(v) if isinstance(v, dict) else v
            for fn in launch_counters() + pool_counters()
            for a, v in vars(fn).items() if a.startswith("launches")}


def launches_between(before: dict, after: dict) -> dict:
    """The counts made from one launch_state() to a later one, the
    counters that moved only."""
    out = {}
    for key, v in after.items():
        if isinstance(v, dict):
            b = before[key]
            d = {k: n - b.get(k, 0) for k, n in v.items() if n != b.get(k, 0)}
        else:
            d = v - before[key]
        if d:
            out[key] = d
    return out


def set_launch_state(state: dict) -> None:
    """Put back the counts of a launch_state()."""
    for (fn, a), v in state.items():
        setattr(fn, a, dict(v) if isinstance(v, dict) else v)


def add_launches(delta: dict) -> None:
    """Add launches_between's counts to the wrappers' (train/graph.py:
    what a captured step's capture counted, at each replay)."""
    for (fn, a), d in delta.items():
        if isinstance(d, dict):
            counts = getattr(fn, a)
            for k, n in d.items():
                counts[k] = counts.get(k, 0) + n
        else:
            setattr(fn, a, getattr(fn, a) + d)


def reset_launches() -> None:
    for fn in launch_counters():
        fn.launches = 0
        if hasattr(fn, "launches_by_co"):
            fn.launches_by_co = {}


def read_launches() -> dict:
    return {fn.__name__: fn.launches for fn in launch_counters()}


def profile_call(fn, calls: int = 1) -> dict:
    """torch.profiler over `calls` warm calls of fn, per call: wall time,
    the summed device time (kernels, copies, fills), its share of the
    wall, the host<->card copies, each port kernel's time, the instances
    of each counted wrapper's CUDA functions by name (`kernel_counts`,
    COUNTED_KERNELS; what a CUDA graph's replay launched, which no
    wrapper counts) and their device ms (`counted_ms`), and the entries
    with the most device time.  fn runs `calls + 2` times: once
    unprofiled, once as the profiler's warm-up step (traced, not kept: a
    window that starts cold can miss its first copies), then the window."""
    from torch.profiler import profile, schedule

    cuda = torch.cuda.is_available()

    def done():
        if cuda:
            torch.cuda.synchronize()

    fn()
    done()
    with profile(activities=_activities(), record_shapes=True,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        done()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        done()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        prof.step()
    # kernels, copies and fills on the card (annotations mirrored there excluded)
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)]
    by_name: dict = {}
    for e in device_events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / calls, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_name.values())
    # which convolution spends it: the cuDNN calls with their input shapes
    convs = sorted(
        ({"op": e.name, "shapes": e.input_shapes[:2],
          "device_ms": e.device_time_total / 1e3 / calls}
         for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("aten::cudnn_")),
        key=lambda c: -c["device_ms"],
    )
    return {
        "calls": calls,
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "device_ops": len(device_events) / calls,
        "copy_ms": {k: sum(ms for name, (ms, _) in top if name.startswith(p))
                    for k, p in COPY_PREFIXES.items()},
        "kernel_ms": {k: sum(ms for name, (ms, _) in top if any(f in name for f in frags))
                      for k, frags in KERNEL_FRAGMENTS.items()},
        "kernel_counts": {k: {name: n / calls for name, (_, n) in top if pat.search(name)}
                          for k, pat in COUNTED_KERNELS.items()},
        "counted_ms": {k: sum(ms for name, (ms, _) in top if pat.search(name))
                       for k, pat in COUNTED_KERNELS.items()},
        "top": [{"name": k, "device_ms": ms, "count": n / calls} for k, (ms, n) in top[:25]],
        "convs": convs[:15],
    }
