"""--eval_dp in the port (eval/runner.py make_sharded_forward): replicas
of the eval model on several devices in one process, each clip batch
split over them.  Eval mode has no cross-sample reduction, so the split
forward must give the one-device outputs; mirrors tests/test_eval_dp.py
with two replicas on ["cpu", "cpu"].
"""

import os
import shutil

import numpy as np
import pytest
import torch

from picad_tpu_torch.checkpoint.manager import CheckpointIO
from picad_tpu_torch.cli import evaluate_jhmdb, evaluate_ucf101
from picad_tpu_torch.eval.runner import (
    make_padded_forward,
    make_sharded_forward,
    replica_devices,
    sweep_checkpoints,
)
from picad_tpu_torch.models.capsules import build_capsnet
from picad_tpu_torch.train.state import create_train_state
from tests.test_torch_model import few_torch_threads, pinned_fixture_sd  # noqa: F401

H = 80
CPUS = ["cpu", "cpu"]


@pytest.fixture
def tmp_path(tmp_path):
    """The test's tmp_path, emptied afterwards: a checkpoint holds a whole model."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def replicas():
    sd = pinned_fixture_sd()
    return [build_capsnet(sd, compute_dtype=torch.float32, device=d) for d in CPUS]


@pytest.mark.parametrize("n", [4, 3, 1, 5])  # full, ragged, minimal, two batches
def test_eval_dp_matches_one_device(replicas, n):
    single = make_padded_forward(replicas[0], clip_batch_size=4)
    split = make_sharded_forward(replicas, clip_batch_size=4)
    clips = np.random.default_rng(5).random((n, 8, H, H, 3), dtype=np.float32)
    # the one-device forward a padded batch at a time, as the eval engine calls it
    parts = [single(clips[i:i + 4]) for i in range(0, n, 4)]
    seg_a, sc_a = (np.concatenate([p[k] for p in parts]) for k in (0, 1))
    seg_b, sc_b = split(clips)
    assert seg_a.shape == seg_b.shape == (n, 8, H, H) and sc_b.shape == (n, 24)
    np.testing.assert_array_equal(seg_a, seg_b)
    np.testing.assert_array_equal(sc_a, sc_b)


def test_eval_dp_gates(replicas):
    """As picad_tpu/eval/runner.py: 0/1 is one device, more than the
    visible devices or an indivisible clip batch raise."""
    assert replica_devices(0, "cpu") is None and replica_devices(1, "cpu") is None
    assert replica_devices(2, "cpu", CPUS) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="visible devices"):
        replica_devices(10_000, "cpu")
    with pytest.raises(ValueError, match="replica devices"):
        replica_devices(3, "cpu", CPUS)
    with pytest.raises(ValueError, match="divide"):
        make_sharded_forward(replicas, clip_batch_size=3)
    for cli in (evaluate_ucf101, evaluate_jhmdb):
        with pytest.raises(ValueError, match="visible devices"):
            cli.main(["--ckpt", ".", "--synthetic", "--eval_dp", "2"], device="cpu")


def _video(label: int, name: str):
    """One 16-frame 80^2 video whose mask covers 80 % of every frame."""
    video = np.random.default_rng(label).random((16, H, H, 3)).astype(np.float32)
    mask = np.zeros((16, H, H, 1), np.uint8)
    mask[:, : int(H * 0.8)] = 1
    return video, mask, label, name


def test_sweep_with_eval_dp_equals_one_device(tmp_path):
    """Two checkpoints swept at --eval_dp 2 on two CPU replicas: the
    summaries of the one-device sweep, then the pruning to the best."""
    io = CheckpointIO()
    state = create_train_state(seed=0, device="cpu", bn_groups=2)
    for epoch, bias in ((1, -30.0), (2, 30.0)):
        with torch.no_grad():
            state.model.smooth.bias.fill_(bias)
        io.save(tmp_path / f"best_model_train_loss_{epoch}", state)
    dataset = [_video(1, "a"), _video(2, "b")]
    kw = dict(split="train", n_classes=24, clip_batch_size=2, prune=False, nan_safe=True,
              device="cpu")
    one = sweep_checkpoints(str(tmp_path), dataset, **kw)
    two = sweep_checkpoints(str(tmp_path), dataset, eval_dp=2, eval_devices=CPUS,
                            **dict(kw, prune=True))
    assert list(one) == list(two)
    for path in one:
        for k, v in one[path].items():
            np.testing.assert_array_equal(np.asarray(two[path][k]), np.asarray(v), err_msg=k)
    assert [r["fmAP@0.5"] for r in two.values()] == [0.0, 1.0]
    assert sorted(os.listdir(tmp_path)) == ["best_model_train_loss_2"]
