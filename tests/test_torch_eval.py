"""The port's eval protocol and checkpoint sweep vs the JAX package's, CPU.

- `VideoMetrics` and `evaluate_dataset` (numpy on the host in both
  packages) give identical summaries on the same inputs: seeded random
  masks, a class with no videos (NaN propagation, and `nan_safe`), and
  IoUs that land exactly on a threshold (the f32 compare of
  picad_tpu/eval/engine.py:69-76);
- `sweep_checkpoints` at 80^2 on `device="cpu"`: which checkpoint
  directories survive the pruning, and the prediction-log files;
- one synthetic video through both packages' eval forwards on the same
  weights (checkpoint/convert.from_jax_variables): the same binary segs,
  clip by clip, a predicted mask that overlaps the actor, the same
  predicted label, and f-mAP and v-mAP within EVAL_MAP_TOL.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from picad_tpu.data.dataset import EvalVideoDataset as JEvalVideoDataset
from picad_tpu.data.sources import SyntheticVideoSource as JSyntheticVideoSource
from picad_tpu.eval import engine as jax_engine
from picad_tpu.eval import metrics as jax_metrics
from picad_tpu.eval.runner import make_padded_forward as j_make_padded_forward
from picad_tpu_torch.checkpoint.convert import from_jax_variables
from picad_tpu_torch.checkpoint.manager import CheckpointIO
from picad_tpu_torch.data.dataset import EvalVideoDataset
from picad_tpu_torch.data.sources import SyntheticVideoSource
from picad_tpu_torch.eval import engine as port_engine
from picad_tpu_torch.eval import metrics as port_metrics
from picad_tpu_torch.eval.runner import make_padded_forward, sweep_checkpoints
from picad_tpu_torch.models.capsules import build_capsnet
from picad_tpu_torch.train.state import create_train_state
from tests.test_torch_model import few_torch_threads, jax_capsnet, pinned_fixture_sd  # noqa: F401
from tests.test_torch_train_step import WELL_EPS, _set_routing_eps

H = 80
# One 24-frame video at 80^2 (4 clips, one padded batch of 4), pinned
# fixture weights, f32: the JAX eval forward jitted, the port's on the
# CPU.  At the production EM-routing eps the two sigmoid segs differed by
# up to 0.34 (5448 pixels on opposite sides of 0.5) and the scores by
# 2.7e-3 against a top-2 margin of 6.6e-3 (EM routing's cost_std noise,
# ROADMAP.md section 3), though fmAP and vmAP came out equal.  At routing
# eps WELL_EPS, where that noise is gone: seg 2.8e-6, scores 3.0e-8, no
# pixel within 4e-6 of 0.5, the same binary segs (46 % of the pixels set,
# frame IoU about 0.2 with the actor), and fmAP and vmAP equal at all 20
# thresholds.
# The bound allows one pixel to cross all the same: it moves one frame's
# hit at one threshold, 1/24 of the video's frames with ground truth.
EVAL_MAP_TOL = 1 / 24


def _summaries_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)  # NaN == NaN here


def _random_updates(seed: int, n_classes: int = 5, videos: int = 12):
    """(label, pred_label, pred_seg, gt_seg) per video: random masks of
    random density, class 3 never present (NaN in the reference mean),
    and two videos whose every frame IoU is exactly 0.15 and 0.5."""
    rng = np.random.default_rng(seed)
    out = []
    for v in range(videos):
        f, h, w = int(rng.integers(3, 9)), 6, 8
        label = int(rng.choice([0, 1, 2, 4]))
        gt = rng.random((f, h, w, 1)) < rng.uniform(0.05, 0.6)
        gt[int(rng.integers(f))] = False  # a frame the protocol skips
        pred = rng.random((f, h, w, 1)) < rng.uniform(0.05, 0.6)
        out.append((label, int(rng.integers(n_classes)), pred, gt))
    for inter, union in ((3, 20), (12, 24)):  # IoU 0.15 and 0.5 on every frame
        gt = np.zeros((4, 5, 5, 1), bool)
        pred = np.zeros_like(gt)
        gt.reshape(4, -1)[:, :union] = True
        pred.reshape(4, -1)[:, :inter] = True
        out.append((1, 1, pred, gt))
    return out


@pytest.mark.parametrize("nan_safe", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_video_metrics_match_jax(seed, nan_safe):
    port, ref = port_engine.VideoMetrics(5), jax_engine.VideoMetrics(5)
    for upd in _random_updates(seed):
        port.update(*upd)
        ref.update(*upd)
    for name in ("n_correct", "n_vids", "n_tot_frames", "frame_ious", "video_ious"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    s = port.summarize(nan_safe=nan_safe)
    _summaries_equal(s, ref.summarize(nan_safe=nan_safe))
    assert np.isnan(s["fmAP@0.5"]) != nan_safe  # class 3 has no videos


def test_threshold_ties_compare_in_f32():
    """IoU 0.15 == threshold index 3 in f32 counts as a hit; the f64
    compare would count it a miss (0.15 > np.float32(0.15) in f64)."""
    m = port_engine.VideoMetrics(2)
    (_, _, pred, gt) = _random_updates(0)[-2]
    m.update(1, 1, pred, gt)
    assert m.frame_ious[1, 3] == 4 and m.frame_ious[1, 4] == 0


def _clip_forward(n_classes: int):
    """A deterministic numpy forward: the bright synthetic actor as the
    seg, class scores from channel means."""

    def forward(clips):
        n = clips.shape[0]
        seg = 1.0 / (1.0 + np.exp(-(clips.mean(-1) - 0.35) * 20.0))
        means = clips.reshape(n, -1, 3).mean(1)  # (n, 3)
        scores = np.stack([means[:, k % 3] * (k + 1) for k in range(n_classes)], 1)
        return seg.astype(np.float32), scores.astype(np.float32)

    return forward


@pytest.mark.parametrize("clip_batch_size,nan_safe", [(4, False), (3, True)])
def test_evaluate_dataset_matches_jax(clip_batch_size, nan_safe):
    kw = dict(video_len=24, height=120, width=160, num_classes=5, seed=4)
    port_ds = EvalVideoDataset(SyntheticVideoSource(4, **kw), clip_shape=(96, 96),
                               return_name=True)
    ref_ds = JEvalVideoDataset(JSyntheticVideoSource(4, **kw), clip_shape=(96, 96),
                               return_name=True)
    logs = [], []
    summaries = [
        eng.evaluate_dataset(_clip_forward(5), ds, n_classes=5, clip_batch_size=clip_batch_size,
                             prediction_log=log, nan_safe=nan_safe)
        for eng, ds, log in ((port_engine, port_ds, logs[0]), (jax_engine, ref_ds, logs[1]))]
    _summaries_equal(*summaries)
    assert logs[0] == logs[1] and len(logs[0]) == 4
    assert summaries[0]["vmAP@0.5"] > 0.5 or np.isnan(summaries[0]["vmAP@0.5"])


def test_scalar_metrics_match_jax():
    rng = np.random.default_rng(3)
    scores, labels = rng.standard_normal((16, 7)), rng.integers(0, 7, 16)
    assert port_metrics.get_accuracy(scores, labels) == jax_metrics.get_accuracy(scores, labels)
    acc = port_metrics.accuracy_torch(torch.from_numpy(scores), torch.from_numpy(labels))
    assert float(acc) == pytest.approx(float(jax_metrics.accuracy_jnp(scores, labels)), abs=0)
    p, t = rng.random((4, 9, 9)), rng.random((4, 9, 9)) > 0.6
    assert port_metrics.get_accuracy2(p, t) == jax_metrics.get_accuracy2(p, t)
    for gt in (t, np.zeros_like(t)):
        a, b = port_metrics.binary_mask_iou(gt, p > 0.5), jax_metrics.binary_mask_iou(gt, p > 0.5)
        assert a == b or (np.isnan(a) and np.isnan(b))


def _video(mask_fraction: float, label: int, name: str):
    """One 16-frame 80^2 video whose mask covers `mask_fraction` of
    every frame."""
    video = np.random.default_rng(label).random((16, H, H, 3)).astype(np.float32)
    mask = np.zeros((16, H, H, 1), np.uint8)
    mask[:, : int(H * mask_fraction)] = 1
    return video, mask, label, name


@pytest.fixture
def tmp_path(tmp_path):
    """The test's tmp_path, emptied afterwards: each checkpoint holds a
    whole model."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _save_checkpoints(tmp_path) -> None:
    """Three train checkpoints whose seg head gives all 0 / all 1 / all 0
    (the smooth conv's bias), and one val checkpoint."""
    io = CheckpointIO()
    state = create_train_state(seed=0, device="cpu", bn_groups=2)
    for epoch, bias in ((1, -30.0), (2, 30.0), (3, -30.0)):
        with torch.no_grad():
            state.model.smooth.bias.fill_(bias)
        io.save(tmp_path / f"best_model_train_loss_{epoch}", state)
    io.save(tmp_path / "best_model_val_loss_1", state)


def test_sweep_checkpoints_prunes_as_the_reference(tmp_path):
    """On masks covering 80 % of each frame the all-1 checkpoint scores
    fmAP@0.5 = vmAP@0.5 = 1 over the present classes.  Over all 24
    classes the reference's np.mean is NaN for every checkpoint, and its
    np.argmax over NaNs keeps the first checkpoint: so does the sweep.
    The val checkpoint is outside the split and untouched."""
    _save_checkpoints(tmp_path)
    dataset = [_video(0.8, 1, "a"), _video(0.8, 2, "b")]
    safe = sweep_checkpoints(str(tmp_path), dataset, split="train", n_classes=24,
                             clip_batch_size=2, prune=False, nan_safe=True, device="cpu")
    assert [os.path.basename(p) for p in safe] == [
        f"best_model_train_loss_{e}" for e in (1, 2, 3)]  # sorted(glob) order
    assert [r["fmAP@0.5"] for r in safe.values()] == [0.0, 1.0, 0.0]
    assert [r["vmAP@0.5"] for r in safe.values()] == [0.0, 1.0, 0.0]
    results = sweep_checkpoints(str(tmp_path), dataset, split="train", n_classes=24,
                                clip_batch_size=2, log_predictions=True, device="cpu")
    assert all(np.isnan(r["fmAP@0.5"]) and np.isnan(r["vmAP@0.5"]) for r in results.values())
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["best_model_train_loss_1", "best_model_val_loss_1"]
        + [f"{kind}_pred_best_model_train_loss_{e}.txt"
           for kind in ("correct", "incorrect") for e in (1, 2, 3)])
    for e in (1, 2, 3):
        lines = []
        for kind in ("correct", "incorrect"):
            with open(tmp_path / f"{kind}_pred_best_model_train_loss_{e}.txt") as f:
                lines += f.read().splitlines()
        assert sorted(line.split()[0] for line in lines) == ["a", "b"]
        assert sorted(line.split()[1] for line in lines) == ["label=1", "label=2"]


def test_sweep_checkpoints_keeps_the_best_fmap_and_vmap(tmp_path):
    _save_checkpoints(tmp_path)
    results = sweep_checkpoints(str(tmp_path), [_video(0.8, 1, "a")], split="train",
                                n_classes=24, clip_batch_size=2, nan_safe=True, device="cpu")
    assert len(results) == 3
    assert sorted(os.listdir(tmp_path)) == ["best_model_train_loss_2", "best_model_val_loss_1"]
    assert sweep_checkpoints(str(tmp_path), [], split="test", device="cpu") == {}


def test_one_video_through_both_eval_forwards(jax_capsnet_80, monkeypatch):
    import picad_tpu.models.capsules as jax_capsules
    import picad_tpu_torch.models.capsules as port_capsules

    _set_routing_eps(monkeypatch, WELL_EPS, ((jax_capsules, "em_routing"),
                                             (port_capsules, "em_routing")))
    j_model, variables = jax_capsnet_80
    kw = dict(video_len=24, height=120, width=160, num_classes=24, seed=11)
    port_ds = EvalVideoDataset(SyntheticVideoSource(1, **kw), clip_shape=(H, H))
    ref_ds = JEvalVideoDataset(JSyntheticVideoSource(1, **kw), clip_shape=(H, H))
    model = build_capsnet(from_jax_variables(jax.tree.map(np.asarray, variables)),
                          compute_dtype=torch.float32, device="cpu")
    runs, segs = {}, {"port": [], "jax": []}
    for name, fwd, ds in (
            ("port", make_padded_forward(model, clip_batch_size=4), port_ds),
            ("jax", j_make_padded_forward(j_model, variables, clip_batch_size=4), ref_ds)):
        log = []
        runs[name] = (port_engine.evaluate_dataset(_recording(fwd, segs[name]), ds, n_classes=24,
                                                   clip_batch_size=4, prediction_log=log,
                                                   nan_safe=True), log)
    (port, port_log), (ref, ref_log) = runs["port"], runs["jax"]
    # the predicted mask overlaps the actor: hits past the 0.0 threshold
    assert ref["fmAP"][1:].max() > 0 and ref["vmAP"][1:].max() > 0
    assert len(segs["port"]) == len(segs["jax"]) == 1
    for row, (a, b) in enumerate(zip(segs["port"][0], segs["jax"][0])):
        assert 0 < (b >= 0.5).mean() < 1
        np.testing.assert_array_equal(a >= 0.5, b >= 0.5, err_msg=f"clip {row}")
    assert [r["pred"] for r in port_log] == [r["pred"] for r in ref_log]
    assert port["accuracy"] == ref["accuracy"]
    np.testing.assert_allclose(port["fmAP"], ref["fmAP"], rtol=0, atol=EVAL_MAP_TOL)
    np.testing.assert_allclose(port["vmAP"], ref["vmAP"], rtol=0, atol=EVAL_MAP_TOL)


def _recording(forward, segs: list):
    """`forward`, appending each call's sigmoid seg to `segs`."""

    def recorded(clips):
        seg, scores = forward(clips)
        segs.append(np.asarray(seg))
        return seg, scores

    return recorded


@pytest.fixture(scope="module")
def jax_capsnet_80():
    return jax_capsnet(pinned_fixture_sd(), h=H)
