"""The port's bench (picad_tpu_torch/bench, utils/profiling.py) on the CPU.

- flops.py: the forward and train-step counts reconcile exactly with
  torch's FlopCounterMode over the port's plain CPU forward and train
  step, for each head and stem implementation, once the terms that differ
  by rule are put in: every padding tap (FlopCounterMode counts what the
  conv over the padded input computes: `run_macs`), the head's
  implementation (the fused form's plain composite over the padded
  canvas, face corrections, kernel composition and bias map, or the
  literal pair of ConvTs) and the S2D stem's 4^3 conv on 24 channels.
  The stem's missing input gradient is the same on both sides.  Each
  useful count is a brute-force count of in-range taps, and the
  full-width K3-K5 and head credits are bench.py's formulas;
- StepTimer is the JAX package's arithmetic and keys;
- the percentile rule and the peak table;
- check.py: the timed path's output against the CPU f32 reference, the
  float8-weight control called wrong, and the argmax-flip rule; the
  replay comparison against stub graphed steps (a one-ulp fault, a call
  that did not replay), and the in-place restore, which keeps every
  address and so the graph key;
- both cells end to end on device="cpu" at a small size, the CLI's
  refusal without a card, and BENCHMARK.json against what the cells print.
"""

import copy
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from picad_tpu.models import capsules as jax_capsules
from picad_tpu.utils.profiling import StepTimer as JaxStepTimer
from picad_tpu_torch.bench import (
    CALL_TAIL_Q,
    CELLS,
    STEP_TAIL_Q,
    Lengths,
    flops,
    load_config,
    run_cell,
)
import picad_tpu_torch.bench as bench_pkg
from picad_tpu_torch.bench import check, repeat
from picad_tpu_torch.bench.check import check_serving, check_train
from picad_tpu_torch.bench.serving import ServeBench
from picad_tpu_torch.bench.trace import (
    H2D_COPIES_PER_BATCH,
    KERNELS,
    PROFILE_WINDOWS,
    SERVE_LAUNCHES,
    TRAIN_LAUNCHES,
    count_sync_warnings,
    host_to_card_copies,
    kept_copies,
)
from picad_tpu_torch.bench.train import TrainBench, synthetic_batch
from picad_tpu_torch.config import LossConfig
from picad_tpu_torch.models import capsules
from picad_tpu_torch.models.capsules import build_capsnet
from picad_tpu_torch.ops.fused_head import fused_decoder_head
from picad_tpu_torch.train.graph import graph_key
from picad_tpu_torch.train.state import create_train_state
from picad_tpu_torch.train.step import make_train_step
from picad_tpu_torch.utils.profiling import (
    COLD_BYTES,
    StepTimer,
    cold_copies,
    percentile,
    trace_context,
)
from tests.test_torch_model import few_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL_KERNELS = ("max_pool_bwd", "max_pool_axis", "max_pool_axis_bwd")
# BENCHMARK.json's bounds before they were measured again with the step as
# one CUDA graph: a bound may only tighten
EARLIER_BOUNDS = {"ucf101_train_bs8": {"train_clips_per_s": 0.40, "e2e_clips_per_s": 0.45,
                                       "mfu": 0.40},
                  "ucf101_serve_cb14": {"serve_clips_per_s": 0.65, "batch_ms_p50": 0.75,
                                        "batch_ms_p95": 0.80, "mfu": 0.65}}
TINY = Lengths(warmup=1, steps=2, sync_steps=2, stream_steps=2, h2d_reps=1, serve_warmup=1,
               serve_calls=2, trace_calls=1, sync_probe_steps=1, component_iters=1)


def small_config(hw: int = 80, batch: int = 2) -> dict:
    cfg = copy.deepcopy(load_config())
    cfg["clip"].update(height=hw, width=hw)
    cfg["train"]["batch_size"] = batch
    cfg["serve"]["clip_batch_size"] = batch
    cfg["data"].update(cache_videos_per_source=4, cache_video_len=24, stream_videos_per_source=4,
                       stream_video_len=24, frame_height=96, frame_width=112,
                       cache_build_workers=2, stream_workers=2)
    return cfg


def _contractions(cfg, batch):
    """The forward's contractions on `batch` clips, and the head's."""
    cs = flops.forward_contractions(cfg, batch)
    return cs, next(c for c in cs if c.name == "head")


def _s2d_stem_flops(cfg, batch):
    """FlopCounterMode's count for StemS2D's conv: 4^3 on 24 channels over
    the packed clip padded (1, 2) -> the plain stem's output."""
    clip = cfg["clip"]
    out = (clip["frames"] // 2) * (clip["height"] // 2) * (clip["width"] // 2)
    return 2 * batch * 24 * 64 * 64 * out


def _plain_stem_flops(cs):
    return 2 * next(c for c in cs if c.name == "Conv3d_1a_7x7").run_macs


class _HeadRecorder:
    """Stands in for fused_decoder_head in the model and keeps its inputs."""

    def __init__(self):
        self.args = None

    def __call__(self, *args):
        self.args = args
        return fused_decoder_head(*args)


def _head_impl_flops(args, backward: bool) -> int:
    """FlopCounterMode's count for fused_decoder_head alone on copies of
    the inputs the model gave it (with their gradients if `backward`)."""
    copies = [a.detach().clone().requires_grad_(a.requires_grad) for a in args]
    with FlopCounterMode(display=False) as fc:
        out = fused_decoder_head(*copies)
        if backward:
            out.backward(torch.ones_like(out))
    return fc.get_total_flops()


def _literal_head_flops(cfg, batch) -> int:
    """upsample4 (ConvT 128 -> 128, k3 s2) and smooth (ConvT 128 -> 1, k3
    s1) as FlopCounterMode counts them: every input against every tap."""
    clip = cfg["clip"]
    sp = (clip["frames"] // 2, clip["height"] // 2, clip["width"] // 2)
    up4, sp8 = flops.conv("up4", batch, 128, 128, sp, (3, 3, 3), (2, 2, 2), (1, 1, 1),
                          transposed=True, output_padding=(1, 1, 1))
    smooth, _ = flops.conv("smooth", batch, 128, 1, sp8, (3, 3, 3), pad=(1, 1, 1),
                           transposed=True)
    return 2 * (up4.run_macs + smooth.run_macs)


@pytest.mark.parametrize("fused_head,s2d_stem", [(True, False), (True, True), (False, False)])
def test_forward_flops_reconcile_with_flop_counter(few_torch_threads, monkeypatch, fused_head,
                                                   s2d_stem):
    cfg, batch = small_config(), 2
    clip = cfg["clip"]
    model = build_capsnet(seed=0, device="cpu", compute_dtype=torch.float32,
                          fused_head=fused_head, s2d_stem=s2d_stem)
    rec = _HeadRecorder()
    monkeypatch.setattr(capsules, "fused_decoder_head", rec)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (batch, clip["frames"], clip["height"], clip["width"], 3), dtype=np.float32))
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        model(x)
    counted = fc.get_total_flops()

    cs, head = _contractions(cfg, batch)
    expected = 2 * sum(c.run_macs for c in cs if c is not head)
    if s2d_stem:
        expected += _s2d_stem_flops(cfg, batch) - _plain_stem_flops(cs)
    expected += (_head_impl_flops(rec.args, backward=False) if fused_head
                 else _literal_head_flops(cfg, batch))
    assert counted == expected  # exact: both sides count integer multiply-adds
    # the count itself knows nothing of the implementation
    assert flops.forward_flops(cfg, batch) == 2 * sum(c.macs for c in cs)
    assert (rec.args is not None) == fused_head


def test_train_step_flops_reconcile_with_flop_counter(few_torch_threads, monkeypatch):
    """One train step (both views folded: 2B clips through the model, the
    backward, Adam): FlopCounterMode counts each contraction's forward,
    its input gradient where the input needs one (not the clip into the
    stem) and its weight gradient; Adam, BN, pools, EM routing, masks
    and losses are elementwise and count nothing on either side."""
    cfg = small_config(batch=1)
    t, clip = cfg["train"], cfg["clip"]
    state = create_train_state(seed=0, device="cpu", compute_dtype=torch.float32,
                               bn_groups=t["bn_groups"], dropout_rate=t["dropout_rate"],
                               s2d_stem=False)  # the plain stem: its count is the rule's
    step = make_train_step(LossConfig(**t["loss"]), device="cpu")
    batch = synthetic_batch(np.random.default_rng(0), t["batch_size"],
                            (clip["height"], clip["width"]))
    rec = _HeadRecorder()
    monkeypatch.setattr(capsules, "fused_decoder_head", rec)
    with FlopCounterMode(display=False) as fc:
        _, m = step(state, batch, float(t["epoch"]), t["ramp"])
    assert all(math.isfinite(float(v)) for v in m.values())
    counted = fc.get_total_flops()

    cs, head = _contractions(cfg, 2 * cfg["train"]["batch_size"])
    expected = 2 * sum(c.run_macs * (1 + c.grads) for c in cs if c is not head)
    expected += _head_impl_flops(rec.args, backward=True)
    assert counted == expected
    assert flops.train_step_flops(cfg) == 2 * sum(c.macs * (1 + c.grads) for c in cs)


def _in_range_pairs(g) -> int:
    """Brute force: the (position, tap) pairs of a conv whose input lies
    inside the tensor, or of a transposed conv whose output does, as the
    sum of the conv of ones with a kernel of ones."""
    d = len(g["sp"])
    ones = torch.ones((1, 1, *g["sp"]), dtype=torch.float64)
    w = torch.ones((1, 1, *g["kernel"]), dtype=torch.float64)
    if g["transposed"]:
        op = tuple(o - ((n - 1) * s - 2 * lo + k)
                   for o, n, s, lo, k in zip(g["out"], g["sp"], g["stride"], g["lo"], g["kernel"]))
        y = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}[d](
            ones, w, stride=g["stride"], padding=g["lo"], output_padding=op)
    else:
        pads = []
        for n, k, s, lo, o in reversed(list(zip(g["sp"], g["kernel"], g["stride"], g["lo"],
                                                g["out"]))):
            pads += [lo, (o - 1) * s + k - n - lo]
        y = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[d](F.pad(ones, pads), w, stride=g["stride"])
    assert tuple(y.shape[2:]) == g["out"]
    return int(y.sum())


@pytest.mark.parametrize("size", ["small", "full"])
def test_useful_multiply_adds_count_in_range_taps(size):
    cfg = small_config() if size == "small" else load_config()
    for c in flops.forward_contractions(cfg, 2):
        if c.geometry is None:
            continue
        g = c.geometry
        assert c.macs == g["batch"] * g["cin"] * g["cout"] * _in_range_pairs(g), c.name
        assert c.macs <= c.run_macs, c.name


def test_full_width_credits_are_bench_py_formulas():
    """bench.py:228-243 with the constants it reads from the JAX package."""
    cfg = load_config()
    H, W = cfg["clip"]["height"], cfg["clip"]["width"]
    fold = 2 * cfg["train"]["batch_size"]
    k = jax_capsules.PrimaryCaps.kernel
    caps, p = jax_capsules.PrimaryCaps.caps_types, jax_capsules.PrimaryCaps.pose_size
    cin, ho = 832, H // 8 - (k - 1)
    credits = {"primary_caps.pose": 3 * 2 * fold * ho * ho * cin * caps * p * p * k * k,
               "primary_caps.a": 3 * 2 * fold * ho * ho * cin * caps * k * k,
               "head": 3 * 2 * (fold * 4 * (H // 2) * (W // 2) * 128) * 125}
    got = {c.name: 2 * c.macs * (1 + c.grads) for c in flops.forward_contractions(cfg, fold)
           if c.name in credits}
    assert got == credits
    assert sum(credits.values()) / 1e12 == pytest.approx(1.485, abs=1e-3)


def test_full_width_counts():
    """The arithmetic PERF.md shows: 2.935 TFLOP a train step, 0.880 a
    14-clip serving batch; the train step is 3x its 16-clip forward less
    the stem's input gradient."""
    cfg = load_config()
    cs = flops.forward_contractions(cfg, 16)
    stem = next(c for c in cs if c.name == "Conv3d_1a_7x7")
    assert flops.train_step_flops(cfg) == 3 * flops.forward_flops(cfg, 16) - 2 * stem.macs
    assert flops.train_step_flops(cfg) == 2_935_229_644_800
    assert flops.serving_flops(cfg) == 879_971_362_816


def test_peak_table():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(ValueError, match="no bf16 peak"):
        flops.peak_flops("NVIDIA A100-SXM4-80GB")


def test_step_timer_is_the_jax_one(monkeypatch):
    """The same tick sequence under one patched clock: the same report."""
    now = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    timers = [StepTimer(8, n_chips=4), JaxStepTimer(8, n_chips=4)]
    for t in timers:
        t.reset()
    for dt, n in ((0.25, 1), (0.5, 3), (1.75, 2)):
        now[0] += dt
        for t in timers:
            t.tick(n)
    ours, ref = (t.report() for t in timers)
    assert ours == ref
    assert ours == {"steps": 6, "seconds": 2.5, "clips_per_sec": 19.2,
                    "clips_per_sec_per_chip": 4.8}


def test_step_timer_counts_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(ValueError, match="n_chips"):
        StepTimer(8)


def test_percentile_rule():
    """Each tail percentile the cells report is the highest of 99, 95, 90
    and 75 that leaves >= 10 samples beyond it at the cells' lengths, and
    `percentile` reports the sample count and the samples beyond."""
    def highest(n):
        return next((q for q in (99, 95, 90, 75) if n * (100 - q) / 100 >= 10), None)

    assert highest(Lengths().sync_steps) == STEP_TAIL_Q == 75
    assert highest(Lengths().serve_calls) == CALL_TAIL_Q == 95
    p = percentile(np.arange(1, 41), STEP_TAIL_Q)
    assert p == {"value": 30.25, "n": 40, "beyond": 10}
    p = percentile(np.arange(1, Lengths().serve_calls + 1), CALL_TAIL_Q)
    assert p["n"] == 600 and p["beyond"] == 30


@pytest.fixture(scope="module")
def cell_results():
    """Both cells end to end on the CPU, with the traced run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return {cell: run_cell(cell, small_config(), seed=0, device="cpu", lengths=TINY,
                               trace=True) for cell in CELLS}
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_cpu(cell_results, cell):
    r = cell_results[cell]
    assert r["correct"] is True and r["device"] == {"type": "cpu"}
    json.loads(json.dumps(r))  # one JSON line
    assert set(r["units"]) <= set(r) and r["counts"]
    assert r["mfu"] is None  # no card, no peak: never a CPU number as a device metric
    if cell == "ucf101_train_bs8":
        assert all(math.isfinite(v) for v in r["losses"].values())
        assert r["train_clips_per_s"] > 0 and r["e2e_clips_per_s"] > 0
        assert r["stream_e2e_clips_per_s"] > 0 and r["host_assembler"] in ("libclip_ops.so",
                                                                           "numpy")
        assert r["device_ms_per_step"] is None and r["host_syncs_per_step"] is None
        assert [r[f"k{i}_launches"] for i in range(1, 7)] == [0.0] * 6  # plain versions
        assert r["step_tflop"] == flops.train_step_flops(small_config()) / 1e12
    else:
        assert r["serve_clips_per_s"] > 0 and r["batch_ms_p50"] <= r[f"batch_ms_p{CALL_TAIL_Q}"]
        assert r["k1_launches"] == r["k3_launches"] == 0.0
    want = TRAIN_LAUNCHES if cell == "ucf101_train_bs8" else SERVE_LAUNCHES
    for k in POOL_KERNELS:  # plain versions here: every wrapper launches no time
        assert r["launches"][k] == 0.0
        if k in want:  # the metrics name the pool kernels the cell's table does
            assert r[f"{k}_launches"] == 0.0 and r[f"{k}_ms"] is None
        else:
            assert f"{k}_launches" not in r["units"] and f"{k}_ms" not in r["units"]
    assert set(r["launches"]) == set(KERNELS)


def test_cpu_train_cell_has_no_replay_readings(cell_results):
    """The CPU step has no graph: the replay readings are None ("not
    measured") and not held, and the memory readings are None too."""
    r = cell_results["ucf101_train_bs8"]
    c = r["check"]
    assert c["readings"]["replayed"] is None and c["readings"]["replay_differs"] is None
    assert not set(check.GRAPH_READINGS) & set(c["limits"])
    assert r["correct"] is True and c["replay_differ"] == []
    assert all(r[k] is None for k in ("peak_reserved_gib", "e2e_peak_reserved_gib",
                                      "graph_pool_gib"))


@pytest.mark.parametrize("cell", CELLS)
def test_cli_refuses_without_a_card(cell):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, "-m", "picad_tpu_torch.bench", "--cell", cell],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "no result" in r.stderr


def test_run_cell_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_cell(CELLS[0], load_config())


def _benchmark():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json():
    bench = _benchmark()
    cells = bench["workloads"]
    assert [c["name"] for c in cells] == list(CELLS)
    for c in cells:
        assert c["chips"] == 1
        assert f"--cell {c['name']}" in c["command"]
        with open(os.path.join(REPO, c["config"])) as f:
            conf = json.load(f)
        assert conf == load_config() and conf["name"] == "capsnet_ucf101_24"
        assert len(conf["source"]) <= 200 and "AKASH2907/pi-consistency" in conf["source"]
        assert conf["assumed"] and len(conf["reduced"]) == 3
        for name, m in c["metrics"].items():
            assert m["unit"] and m["better"] in ("higher", "lower") and 0 < m["bound"] < 1, name
            assert m["bound"] <= EARLIER_BOUNDS[c["name"]][name], name
            assert len(m["spread_in_one_call"]) >= 2, name  # two chip calls or more
            assert m["bound"] == min(repeat.rule_bound(m["spread_in_one_call"]),
                                     EARLIER_BOUNDS[c["name"]][name]), name
        assert set(c["metrics"]) == set(EARLIER_BOUNDS[c["name"]])
        # the traced run's kernels: every kernel of the cell's table, the
        # pool kernels among them (3, 16, 16 a train step; 16 forward a batch)
        layer = c["layer_metrics"]
        train = c["name"] == "ucf101_train_bs8"
        per, want = ("step", TRAIN_LAUNCHES) if train else ("batch", SERVE_LAUNCHES)
        assert [k for k in POOL_KERNELS if k in want] == (list(POOL_KERNELS) if train
                                                         else ["max_pool_axis"])
        for name in want:
            k = KERNELS[name]
            assert layer[f"{k}_ms"]["unit"] == f"ms a {per} ({name})"
            assert layer[f"{k}_launches"]["unit"] == f"launches a {per} ({name})"
        if not train:
            assert layer["h2d_copies"]["unit"] == "host->card copies a batch"
    memory = ("peak_mem_gib", "e2e_peak_mem_gib", "peak_reserved_gib", "e2e_peak_reserved_gib",
              "graph_pool_gib")
    assert set(memory) <= set(cells[0]["layer_metrics"])


@pytest.mark.parametrize("spreads,bound", [([0.164, 0.142], 0.40), ([0.18, 0.188], 0.45),
                                           ([0.292, 0.142], 0.65), ([0.349, 0.116], 0.75),
                                           ([0.353, 0.203], 0.80), ([0.0098, 0.004], 0.10),
                                           ([0.025, 0.0], 0.10), ([0.0251, 0.0], 0.15)])
def test_bound_rule(spreads, bound):
    """Twice the wider spread plus 5 points, rounded up to 0.05: the rule
    gives the bounds first set from spreads of the eager step (the first
    five rows) and from spreads of one percent."""
    assert repeat.rule_bound(spreads) == bound


@pytest.mark.parametrize("cell", CELLS)
def test_benchmark_metrics_are_printed(cell_results, cell):
    spec = next(c for c in _benchmark()["workloads"] if c["name"] == cell)
    r = cell_results[cell]
    named = set(spec["metrics"]) | set(spec["layer_metrics"])
    assert named <= set(r["units"]), named - set(r["units"])
    for name, m in {**spec["metrics"], **spec["layer_metrics"]}.items():
        assert m["unit"] == r["units"][name], name


@pytest.mark.parametrize("cell", CELLS)
def test_check_calls_the_control_wrong(few_torch_threads, cell):
    """check.py's comparison passes the timed objects' own output on the
    CPU (the plain f32 path against itself) and fails the float8-weight
    control through the same comparison."""
    cfg, cpu = small_config(), torch.device("cpu")
    verdicts = {}
    for control in (False, True):
        if cell == "ucf101_train_bs8":
            tb = TrainBench(cfg, seed=0, device=cpu)
            tb.step()
            verdicts[control] = check_train(tb, control)
        else:
            sb = ServeBench(cfg, seed=0, device=cpu, control=control)
            verdicts[control] = check_serving(sb, sb.call(), control)
    sound, ctl = verdicts[False], verdicts[True]
    assert sound["correct"] and not sound["failed"]
    assert all(sound["readings"][k] == 0 for k in sound["limits"])
    assert not ctl["correct"] and ctl["failed"]


@pytest.mark.parametrize("flip_gap,want", [(None, (0.0, 0, 0)), (0.005, (0.0, 1, 0)),
                                            (0.5, (0.0, 1, 1))])
def test_check_excuses_an_argmax_flip_only_at_a_near_tie(flip_gap, want):
    """A clip whose argmax differs is left out of the mask comparison when
    the reference's top-two gap is within the scores limit, and counts as
    unexplained otherwise."""
    limits = check.LIMITS["serve"]
    ref_scores = np.array([[0.1, 0.9, 0.2], [0.3, 0.2, 0.1]])
    scores = ref_scores.copy()
    ref_seg = np.zeros((2, 4))
    seg = ref_seg.copy()
    if flip_gap is not None:  # clip 1 flips to class 1, its mask far off
        ref_scores[1] = [0.3, 0.3 - flip_gap, 0.1]
        scores[1] = [0.3 - flip_gap, 0.3, 0.1]
        seg[1] = 0.5
    r = check.compare_masks_and_scores(seg, scores, ref_seg, ref_scores, limits)
    assert (r["seg_max_abs"], r["flips"], r["unexplained_flips"]) == want
    assert check.verdict(r, limits)["correct"] == (want[2] == 0 and r["scores_max_abs"]
                                                   <= limits["scores_max_abs"])
    seg[0, 0] = 2 * limits["seg_max_abs"]  # a clip that kept its argmax is compared
    r = check.compare_masks_and_scores(seg, scores, ref_seg, ref_scores, limits)
    assert r["seg_max_abs"] == seg[0, 0] and not check.verdict(r, limits)["correct"]


class _StubGraphedStep:
    """A graphed step's interface over the CPU's eager step: `eager_step`,
    `replays`, `captures`.  A call runs the eager step and counts a
    replay, unless `fault` is "not_a_replay"; with fault "ulp" it then
    moves one element of one parameter by one ulp."""

    def __init__(self, eager, fault=None):
        self.eager_step, self.fault = eager, fault
        self.replays = self.captures = 0

    def __call__(self, state, batch, epoch, wt_ramp):
        state, metrics = self.eager_step(state, batch, epoch, wt_ramp)
        if self.fault != "not_a_replay":
            self.replays += 1
        if self.fault == "ulp":
            with torch.no_grad():
                p = next(state.model.parameters()).view(-1)
                p[0] = torch.nextafter(p[0], torch.tensor(math.inf))
        return state, metrics


@pytest.mark.parametrize("fault", [None, "ulp", "not_a_replay"])
def test_replay_check_calls_a_faulty_replay_wrong(few_torch_threads, fault):
    """check_train on a step function with an eager step runs the replay
    comparison: a sound stub reads replayed 1 and replay_differs 0; one
    ulp in one parameter is one tensor that differs; a call that did not
    replay reads replayed 0; either fault is called wrong."""
    tb = TrainBench(small_config(), seed=0, device=torch.device("cpu"))
    tb.step()
    tb.step_fn = _StubGraphedStep(tb.step_fn, fault)
    r = check_train(tb, control=False)
    first = next(n for n, _ in tb.state.model.named_parameters())
    want = {None: (1, 0, []), "ulp": (1, 1, [f"param {first}"]),
            "not_a_replay": (0, 1, [check.NOT_REPLAYED])}
    got = r["readings"]["replayed"], r["readings"]["replay_differs"], r["replay_differ"]
    assert got == want[fault], r
    assert set(check.GRAPH_READINGS) <= set(r["limits"])
    assert r["correct"] == (fault is None), r
    if fault is not None:
        assert r["failed"] == ["replay_differs"], r


def test_restore_keeps_every_address_and_the_graph_key(few_torch_threads):
    """restore_state copies a state_snapshot back into the same tensors:
    every parameter, buffer and Adam moment keeps its data_ptr() (what a
    captured graph reads) and the graph key stays; the values, the
    generator and the step count are the snapshot's again, bit for bit."""
    tb = TrainBench(small_config(), seed=0, device=torch.device("cpu"))
    tb.step()
    st, thresh = tb.state, tb.loss_cfg.thresh_epoch
    live = dict(check._live_tensors(st))
    ptrs = {k: t.data_ptr() for k, t in live.items()}
    assert any(k.startswith("adam ") for k in ptrs) and any(k.startswith("buffer ") for k in ptrs)
    key = graph_key(st, tb.batch, tb.epoch, thresh)
    snap = check.state_snapshot(st)
    tb.step()
    assert check.snapshot_diff(check.state_snapshot(st), snap)  # the step moved the state
    check.restore_state(st, snap)
    assert {k: t.data_ptr() for k, t in check._live_tensors(st)} == ptrs
    assert graph_key(st, tb.batch, tb.epoch, thresh) == key
    assert check.snapshot_diff(check.state_snapshot(st), snap) == []
    del snap["step"]
    with pytest.raises(ValueError, match="other tensors"):
        check.restore_state(st, snap)


def test_verdict_fails_what_was_not_measured():
    limits = {"a": 1.0, "b": 0}
    assert check.verdict({"a": 1.0, "b": 0}, limits)["correct"]
    assert check.verdict({"a": 0.5, "b": 1}, limits)["failed"] == ["b"]
    assert check.verdict({"a": None, "b": 2}, limits)["failed"] == ["a", "b"]
    assert check.verdict({"a": math.nan, "b": 0}, limits)["failed"] == ["a"]


def test_a_step_function_with_no_graph_fails_the_replay_check():
    """On a card a step function that is not graphed (no eager step) is
    one difference, not a reading left unmeasured."""
    r = check.replay_against_eager(None, lambda *a: None, None, 0, 0.0)
    assert r == {"replayed": 0, "replay_differs": 1, "differ": [check.NO_GRAPH]}
    assert not check.verdict({"replay_differs": r["replay_differs"]},
                             {"replay_differs": check.LIMITS["train"]["replay_differs"]})["correct"]


def _copy_profile(counts):
    return {"top": [{"name": "Memcpy HtoD (Pageable -> Device)", "device_ms": 10.0, "count": c}
                    for c in counts] + [{"name": "Memcpy DtoH (Device -> Pageable)",
                                         "device_ms": 1.6, "count": 2.0}]}


@pytest.mark.parametrize("counts,ok", [([1.0], True), ([], False), ([2 / 3], False),
                                       ([1.0, 1.0], False)])
def test_serving_trace_holds_one_host_to_card_copy_a_batch(counts, ok):
    """A serving batch copies its clips to the card once: a profile that
    kept no copy, or another number, in every window raises instead of
    reading h2d_ms short."""
    prof = _copy_profile(counts)
    windows = []

    def profile():
        windows.append(prof)
        return prof

    assert host_to_card_copies(prof) == sum(counts)
    if ok:
        assert kept_copies(profile) == (prof, 1) and len(windows) == 1
    else:
        with pytest.raises(AssertionError, match="host->card copies"):
            kept_copies(profile)
        assert len(windows) == PROFILE_WINDOWS


@pytest.mark.parametrize("dropped", range(PROFILE_WINDOWS))
def test_serving_trace_profiles_again_a_window_that_lost_its_copy(dropped):
    """Windows that kept no copy are dropped, and the first that kept the
    batch's one copy is the one read."""
    profs = [_copy_profile([]) for _ in range(dropped)] + [_copy_profile([1.0])]
    it = iter(profs)
    prof, windows = kept_copies(lambda: next(it))
    assert prof is profs[-1] and windows == dropped + 1


@pytest.mark.parametrize("planted", [None, "jax", "jaxlib.xla_extension", "flax.linen",
                                     "picad_tpu", "picad_tpu.ops.tapconv"])
def test_cli_prints_no_result_with_jax_loaded(monkeypatch, capsys, planted):
    """After the run, a module of JAX or of the JAX package in sys.modules
    makes the command exit non-zero with no JSON line; the port's own
    modules (picad_tpu_torch) are not among them."""
    import types

    from picad_tpu_torch.bench import __main__ as cli

    for m in bench_pkg.reference_modules():  # this test process may hold JAX
        monkeypatch.delitem(sys.modules, m)
    assert bench_pkg.reference_modules({"picad_tpu_torch": 0, "picad_tpu_torch.bench": 0}) == []
    if planted:
        monkeypatch.setitem(sys.modules, planted, types.ModuleType(planted))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cli, "run_cell", lambda *a, **k: {"device": {"nvidia_smi": "card, 1 W"},
                                                          "correct": True})
    rc = cli.main(["--cell", CELLS[0]])
    out = capsys.readouterr()
    if planted:
        assert rc != 0 and "{" not in out.out and planted in out.err
    else:
        assert rc == 0 and json.loads(out.out.strip().splitlines()[-1])["correct"] is True


def test_cli_lengths():
    from picad_tpu_torch.bench.__main__ import parse_lengths

    assert parse_lengths([]) == Lengths()
    got = parse_lengths(["serve_calls=2400", "steps=400"])
    assert (got.serve_calls, got.steps, got.warmup) == (2400, 400, Lengths().warmup)
    for bad in (["serve_calls"], ["calls=3"]):
        with pytest.raises(SystemExit):
            parse_lengths(bad)


def test_sync_warnings_are_counted_by_site():
    """The counter the traced run reads under the CUDA sync debug mode:
    each warning of a synchronising operation, by the line that raised it."""
    def step():
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("something else")

    per_call, sites = count_sync_warnings(step, 3)
    assert per_call == 2.0
    assert list(sites.values()) == [1.0, 1.0]  # one a call from each line
    assert all("test_torch_bench.py" in site for site in sites)


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with trace_context(None) as prof:
        assert prof is None
    with trace_context(str(tmp_path)) as prof:
        torch.ones(8).add_(1)
    (path,) = tmp_path.glob("trace_*.json")
    assert json.loads(path.read_text())["traceEvents"]


@pytest.mark.parametrize("nbytes, want", [(1e6, 150), (50e6, 3), (75e6, 2), (150e6, 2),
                                          (1e9, 2)])
def test_cold_copies_rotate_past_the_l2(nbytes, want):
    """graph_ms's operand sets: enough that one round reads more than
    COLD_BYTES (3x the H100's 50 MB L2), so a call finds its operands out
    of L2, and never fewer than 2."""
    n = cold_copies(nbytes)
    assert n == want
    assert n * nbytes >= COLD_BYTES and (n == 2 or (n - 1) * nbytes < COLD_BYTES)
