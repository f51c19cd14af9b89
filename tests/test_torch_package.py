"""picad_tpu_torch stands alone: no JAX, no picad_tpu, no build at import,
and its entry points run on the CUDA card unless asked for the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from picad_tpu_torch._device import resolve_device
from picad_tpu_torch.config import LossConfig
from picad_tpu_torch.data.device_cache import DeviceVideoCache, make_assembler_put
from picad_tpu_torch.data.loader import PrefetchLoader
from picad_tpu_torch.data.sources import SyntheticVideoSource
from picad_tpu_torch.models.capsules import CapsNet, build_capsnet
from picad_tpu_torch.serve.runner import ServingModel
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
from picad_tpu_torch.ops import _build
from picad_tpu_torch.ops.fused_head_kernel import composite_convt
out = composite_convt(torch.zeros(1, 2, 3, 4, 8), torch.zeros(1, 5, 5, 5, 8))
assert out.shape == (1, 4, 6, 8) and composite_convt.launches == 0
assert not _build._LIBS

foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "picad_tpu", "cv2"))
assert not foreign, foreign  # cv2 too: the card's machine has no OpenCV
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
