"""The port's reference-checkpoint parity harness
(picad_tpu_torch/tools/parity_eval.py) against the JAX tool's
(tools/parity_eval.py): line parsing and formatting on the same strings,
a full fake checkpoint from tests/sd_fixtures.py, and the whole harness on
synthetic videos on the CPU (no real media or `.pth` are in the
repository, so the plumbing is what is testable); the cases of
tests/test_parity_eval.py."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from picad_tpu_torch.tools import parity_eval as port  # noqa: E402
from tests.sd_fixtures import fake_capsnet_state_dict  # noqa: E402
from tests.test_torch_model import few_torch_threads  # noqa: E402,F401
from tools import parity_eval as jax_tool  # noqa: E402

UCF_LINE = "Accuracy: 0.8731 IoU/fmap/vmap 0.2 0.7123 0.6989 0.5 0.5231 0.5012"
JHMDB_LINE = "Accuracy: 0.9 0.2 0.8 0.75 0.5 0.6 0.55"


def _fake_pth(path, **kw):
    sd = fake_capsnet_state_dict(scale=0.05, **kw)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    return str(path), sd


@pytest.mark.parametrize("line,dataset", [(UCF_LINE, "ucf101"), (JHMDB_LINE, "jhmdb"),
                                          ("Accuracy: 1e-3 0.2 0 1 0.5 -0.0 0.25", "jhmdb")])
def test_parse_matches_the_jax_tool(line, dataset):
    assert port.parse_reference_line(line, dataset) == jax_tool.parse_reference_line(line, dataset)


@pytest.mark.parametrize("line", ["Accuracy: 0.9 0.3 0.8 0.75 0.5 0.6 0.55",
                                  "Accuracy: 0.9 0.2 0.8", UCF_LINE + " 0.1"])
def test_parse_rejects_what_the_jax_tool_rejects(line):
    with pytest.raises(ValueError) as want:
        jax_tool.parse_reference_line(line, "ucf101")
    with pytest.raises(ValueError) as got:
        port.parse_reference_line(line, "ucf101")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dataset", ["ucf101", "jhmdb"])
def test_format_matches_the_jax_tool_and_roundtrips(dataset):
    summary = {"accuracy": 0.25, "fmAP@0.2": 0.51234, "vmAP@0.2": np.float64(0.5),
               "fmAP@0.5": 0.3333333333333333, "vmAP@0.5": 0.0}
    line = port.reference_format_line(summary, dataset)
    assert line == jax_tool.reference_format_line(summary, dataset)
    back = port.parse_reference_line(line, dataset)
    for k, v in back.items():
        assert v == pytest.approx(summary[k], abs=1e-12), k
    assert ("IoU/fmap/vmap" in line) == (dataset == "ucf101")


def test_load_state_full_checkpoint(tmp_path):
    """The reference keys fill the whole f32 CapsNet; keys it does not
    hold are dropped; a partial checkpoint raises without --rgb_charades
    and loads over it with one."""
    from picad_tpu_torch.models.capsules import CapsNet

    path, sd = _fake_pth(tmp_path / "best_model_train_loss_3.pth")
    model = CapsNet(num_classes=24)
    port.load_state(port.parse_args(["--reference_pth", path]), model)
    own = model.state_dict()
    assert set(own) == set(sd)
    for k in ("conv1.Conv3d_1a_7x7.conv3d.weight", "smooth.weight",
              "conv1.Mixed_4f.b0.bn.running_mean", "conv_caps.weights"):
        np.testing.assert_array_equal(own[k].numpy(), sd[k])
    assert float(own["conv1.Conv3d_1a_7x7.conv3d.weight"].abs().sum()) > 0

    partial = {k: v for k, v in sd.items() if not k.startswith("conv1.")}
    torch.save({k: torch.from_numpy(v) for k, v in partial.items()}, tmp_path / "p.pth")
    with pytest.raises(SystemExit, match="needs --rgb_charades"):
        port.load_state(port.parse_args(["--reference_pth", str(tmp_path / "p.pth")]),
                        CapsNet(num_classes=24))
    i3d = {k[len("conv1."):]: torch.from_numpy(v) for k, v in sd.items()
           if k.startswith("conv1.")}
    i3d["Mixed_5b.b0.conv3d.weight"] = torch.zeros(256, 832, 1, 1, 1)  # a full I3D's
    torch.save(i3d, tmp_path / "rgb_charades.pt")
    model = CapsNet(num_classes=24)
    port.load_state(port.parse_args(["--reference_pth", str(tmp_path / "p.pth"),
                                     "--rgb_charades", str(tmp_path / "rgb_charades.pt")]),
                    model)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def test_parity_eval_end_to_end(tmp_path, capsys):
    """The whole harness on a fake .pth and 2 synthetic videos at 96^2 on
    the CPU: its own line fed back as --reference_line is a PASS (exit
    0), a perturbed one a FAIL (exit 1) with the field flagged."""
    path, _ = _fake_pth(tmp_path / "best_model_train_loss_3.pth")
    base = ["--reference_pth", path, "--synthetic", "2", "--input_hw", "96",
            "--clip_batch_size", "4", "--nan_safe"]  # 2 videos < 24 classes: NaN mAPs
    assert port.main(base, device="cpu") == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Accuracy:")][-1]
    assert "nan" not in line
    assert port.main(base + ["--reference_line", line], device="cpu") == 0
    assert "[parity] PASS" in capsys.readouterr().out
    toks = line.split()
    toks[1] = "0.99999" if toks[1] != "0.99999" else "0.5"  # the accuracy field only
    assert port.main(base + ["--reference_line", " ".join(toks)], device="cpu") == 1
    out = capsys.readouterr().out
    assert "MISMATCH" in out and "[parity] FAIL" in out
