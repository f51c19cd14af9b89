"""picad_tpu_torch stands alone: no JAX, no picad_tpu, no build at import,
and its entry points run on the CUDA card unless asked for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from picad_tpu_torch._device import resolve_device
from picad_tpu_torch.cli import (
    evaluate_jhmdb,
    evaluate_ucf101,
    export_model,
    train_jhmdb,
    train_ucf101,
)
from picad_tpu_torch.config import LossConfig, TrainConfig
from picad_tpu_torch.data.device_cache import DeviceVideoCache, make_assembler_put
from picad_tpu_torch.data.loader import PrefetchLoader
from picad_tpu_torch.data.sources import SyntheticVideoSource
from picad_tpu_torch.eval.runner import sweep_checkpoints
from picad_tpu_torch.models.capsules import CapsNet, build_capsnet
from picad_tpu_torch.serve import ServingModel, load_artifact
from picad_tpu_torch.tools import parity_eval
from picad_tpu_torch.train.loop import Trainer
from picad_tpu_torch.train.state import create_train_state
from picad_tpu_torch.train.step import make_train_step, make_val_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_CHECK = """
import importlib, pkgutil, subprocess, sys

def _refuse(*args, **kwargs):
    raise AssertionError(f"a process was started: {args!r}")

subprocess.Popen = _refuse  # nvcc included: nothing may build at import

import picad_tpu_torch
names = [m.name for m in pkgutil.walk_packages(picad_tpu_torch.__path__,
                                               "picad_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")

import torch
from picad_tpu_torch.ops import _build, convops, tapconv
from picad_tpu_torch.ops.fused_head_kernel import composite_convt
out = composite_convt(torch.zeros(1, 2, 3, 4, 8), torch.zeros(1, 5, 5, 5, 8))
assert out.shape == (1, 4, 6, 8) and composite_convt.launches == 0
# the custom ops of the serving artifact are registered at import, and their
# CPU implementations build nothing
assert torch.ops.picad.composite_convt(torch.zeros(1, 2, 3, 4, 8),
                                       torch.zeros(1, 5, 5, 5, 8)).shape == (1, 4, 6, 8)
out = torch.ops.picad.tap_conv_fwd(torch.zeros(1, 3, 3, 8), torch.zeros(2, 2, 8, 8))
assert out.shape == (1, 2, 2, 8) and tapconv.tap_conv_fwd.launches == 0
x = torch.rand(1, 2, 3, 6, 6, requires_grad=True)
convops.max_pool_same_zero_pad(x, (1, 3, 3), (1, 2, 2)).sum().backward()
assert x.grad.shape == x.shape and convops.max_pool_bwd.launches == 0
assert not _build._LIBS

trainer_slice = {
    "picad_tpu_torch.config", "picad_tpu_torch.objectives.ramp_ups",
    "picad_tpu_torch.train.state", "picad_tpu_torch.train.step",
    "picad_tpu_torch.utils.logging", "picad_tpu_torch.checkpoint.manager",
    "picad_tpu_torch.eval.metrics", "picad_tpu_torch.eval.engine",
    "picad_tpu_torch.eval.runner", "picad_tpu_torch.train.loop",
    "picad_tpu_torch.cli.common", "picad_tpu_torch.cli.train_ucf101",
    "picad_tpu_torch.cli.train_jhmdb", "picad_tpu_torch.cli.evaluate_ucf101",
    "picad_tpu_torch.cli.evaluate_jhmdb"}
assert trainer_slice <= set(names), trainer_slice - set(names)  # imported above

import torch.distributed as dist

parallel_slice = {"picad_tpu_torch.parallel", "picad_tpu_torch.parallel.mesh"}
assert parallel_slice <= set(names), parallel_slice - set(names)  # imported above
assert not dist.is_initialized()  # no process group at import

artifact_slice = {
    "picad_tpu_torch.serve.export", "picad_tpu_torch.cli.export_model",
    "picad_tpu_torch.tools", "picad_tpu_torch.tools.parity_eval",
    "picad_tpu_torch.tools.smoke_gif", "picad_tpu_torch.utils.visualize",
    "picad_tpu_torch.objectives.losses", "picad_tpu_torch.models.i3d"}
assert artifact_slice <= set(names), artifact_slice - set(names)  # imported above

foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "picad_tpu", "tools", "cv2", "matplotlib", "imageio"))
assert not foreign, foreign  # nor OpenCV, matplotlib or imageio: the card's machine has none
print(len(names))
"""


def test_package_and_chip_smoke_import_no_jax_and_build_nothing():
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHECK],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    pkg = Path(REPO, "picad_tpu_torch")  # two levels: the root and its subpackages
    n_files = len(list(pkg.glob("*.py"))) + len(list(pkg.glob("*/*.py")))
    assert int(r.stdout.split()[-1]) == n_files - 1  # every module but the root


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_capsnet()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingModel.from_state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(LossConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_val_step(LossConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceVideoCache.build(SyntheticVideoSource(1, video_len=4, height=96, width=96))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrefetchLoader(iter([]))
    pools = {"pool_video": torch.zeros(1, 8, 8, 3, dtype=torch.uint8),
             "pool_mask": torch.zeros(1, 8, 8, 1, dtype=torch.uint8)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_assembler_put(pools, (8, 8))
    cfg = TrainConfig(bs=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, labeled_dataset=None, unlabeled_dataset=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_checkpoints(".", [])
    for cli in (train_ucf101, train_jhmdb):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--synthetic", "--bs", "2"])
    for cli in (evaluate_ucf101, evaluate_jhmdb):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["--ckpt", ".", "--synthetic"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_artifact(".")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_model.main(["--ckpt", ".", "--out", "."])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parity_eval.main(["--reference_pth", "missing.pth", "--synthetic", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_parameter_names_are_the_reference_keys():
    from tests.sd_fixtures import fake_capsnet_state_dict

    keys = set(CapsNet().state_dict())
    assert keys == set(fake_capsnet_state_dict())
    assert not any(k.endswith("num_batches_tracked") for k in keys)


def test_train_mode_waits_for_the_training_slice():
    """The training slice is in: the train-mode forward (nn.Module starts
    in train mode) runs with labels and returns finite outputs, and asks
    for the labels it needs."""
    model = CapsNet().init_weights(torch.Generator().manual_seed(0))
    assert model.training
    clip = torch.rand(2, 8, 80, 80, 3, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="classification and concat_labels"):
        model(clip)
    seg, scores, feat = model(clip, torch.tensor([3, 5]), torch.tensor([1.0, 0.0]), 12, 11,
                              generator=torch.Generator().manual_seed(2))
    assert seg.shape == (2, 8, 80, 80) and scores.shape == (2, 24) and feat.shape == (2, 4, 24)
    assert all(bool(torch.isfinite(t).all()) for t in (seg, scores, feat))
    assert seg.grad_fn is not None
