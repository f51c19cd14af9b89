"""The port's serving artifact (picad_tpu_torch/serve/export.py), CPU f32:
the cases of tests/test_serve.py on the CapsNet itself, the custom ops
that keep K1, K3 and the stride-1 pools' forward in the graph, the
export CLI, and the port's
artifact against the JAX package's on the same weights.

One artifact of the pinned fixture's CapsNet at 80^2, clip batch 2, is
exported for the module (~8 s on the CPU host).  EM routing runs at
eps 1e-4 in both packages throughout the module: at its production 1e-8
the reference's cost_std quirk turns the summation-order difference of
a jitted JAX forward into ~2e-3 on the class scores (ROADMAP.md section
3; tests/test_torch_serve.py), which would hide what the artifacts
compute.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import picad_tpu.models.capsules as jax_capsules
import picad_tpu_torch.models.capsules as port_capsules
from picad_tpu.serve.export import load_artifact as jax_load_artifact
from picad_tpu.serve.export import save_artifact as jax_save_artifact
from picad_tpu_torch.eval.engine import evaluate_dataset
from picad_tpu_torch.eval.runner import make_padded_forward
from picad_tpu_torch.models.capsules import build_capsnet
from picad_tpu_torch.ops import fused_head_kernel as fhk
from picad_tpu_torch.ops import tapconv
from picad_tpu_torch.serve import ServingModel, load_artifact, save_artifact
from tests.test_torch_model import (  # noqa: F401
    SCORES_TOL,
    SEG_TOL,
    few_torch_threads,
    jax_capsnet,
    pinned_fixture_sd,
)

H = 80
CB = 2
OPS = {"picad.composite_convt.default": 1, "picad.tap_conv_fwd.default": 2,
       "picad.max_pool_axis.default": 16}  # 7 stride-1 pools: 2 x 3 + 5 x 2 stages
WELL_EPS = 1e-4  # EM routing eps at which cost_std is well conditioned


@pytest.fixture(scope="module", autouse=True)
def well_conditioned_routing():
    mp = pytest.MonkeyPatch()
    for mod in (jax_capsules, port_capsules):
        fn = mod.em_routing
        mp.setattr(mod, "em_routing", lambda *a, _fn=fn, **k: _fn(*a, **{**k, "eps": WELL_EPS}))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def sd():
    return pinned_fixture_sd()


@pytest.fixture(scope="module")
def model(sd):
    return build_capsnet(sd, device="cpu")


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("serve_export") / "artifact")
    save_artifact(out, model, clip_batch_size=CB, height=H, width=H,
                  extra_meta={"test": True})
    yield out
    shutil.rmtree(out, ignore_errors=True)


@pytest.fixture(scope="module")
def serving(artifact):
    return load_artifact(artifact, device="cpu")


@pytest.fixture(scope="module")
def live(model):
    return ServingModel.from_model(model, clip_batch_size=CB, height=H, width=H)


def _clips(n, seed):
    return np.random.default_rng(seed).random((n, 8, H, H, 3), dtype=np.float32)


@pytest.mark.parametrize("n", [1, 3])
def test_roundtrip_matches_live_model(serving, live, n):
    """Ragged (1 < CB) and several batches (3 = one full and one padded):
    the artifact gives the live model's outputs (the same CPU ops, the
    custom ops' plain versions) at tests/test_serve.py's tolerance."""
    seg, scores = serving.predict_clips(_clips(n, seed=n))
    ref_seg, ref_scores = live.predict_clips(_clips(n, seed=n))
    assert seg.shape == (n, 8, H, H) and scores.shape == (n, 24)
    np.testing.assert_allclose(seg, ref_seg, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-6, atol=1e-6)


def test_artifact_layout_and_meta(artifact, serving):
    assert sorted(os.listdir(artifact)) == ["meta.json", "model.pt2"]
    with open(os.path.join(artifact, "meta.json")) as f:
        meta = json.load(f)
    assert meta["format_version"] == 1
    assert meta["clip_batch_size"] == CB and meta["depth"] == 8
    assert meta["height"] == meta["width"] == H
    assert meta["device"] == "cpu" and meta["num_classes"] == 24
    assert meta["compute_dtype"] == "f32" and meta["torch_version"] == torch.__version__
    assert meta["test"] is True
    assert serving.meta == meta and serving.input_shape == (CB, 8, H, H, 3)


def test_graph_keeps_the_kernels_as_named_ops(serving):
    targets = [str(n.target) for n in serving.program.graph.nodes if n.op == "call_function"]
    assert {op: targets.count(op) for op in OPS} == OPS
    assert not any("picad" in t and t not in OPS for t in targets)


def _with_meta(tmp_path, artifact, **changes):
    """An artifact directory holding only a changed meta.json: the gates
    raise before the program is read."""
    with open(os.path.join(artifact, "meta.json")) as f:
        meta = json.load(f)
    meta.update(changes)
    out = tmp_path / "changed"
    out.mkdir()
    (out / "meta.json").write_text(json.dumps(meta))
    return str(out)


def test_format_version_gate(tmp_path, artifact):
    with pytest.raises(ValueError, match="format"):
        load_artifact(_with_meta(tmp_path, artifact, format_version=999), device="cpu")


def test_device_gate(tmp_path, artifact):
    """An artifact runs on the device type it was traced on and nowhere
    else; nothing falls back."""
    with pytest.raises(ValueError, match="traced on 'cuda'"):
        load_artifact(_with_meta(tmp_path, artifact, device="cuda"), device="cpu")
    with pytest.raises(ValueError, match="traced on 'cpu'"):
        load_artifact(artifact, device="meta")


def test_predict_clips_shape_gate(serving):
    with pytest.raises(ValueError, match="clip shape"):
        serving.predict_clips(np.zeros((2, 8, 96, 96, 3), np.float32))


def test_predict_video_stitches_like_the_live_model(serving, live):
    """41 frames (not a multiple of depth * f_skip = 16): every frame's
    segmentation and the video class, from the artifact as from the
    live model."""
    rng = np.random.default_rng(12)
    video = rng.random((41, H, H, 3), dtype=np.float32)
    got, want = serving.predict_video(video), live.predict_video(video)
    assert got["segmentation"].shape == (41, H, H, 1) and got["scores"].shape == (24,)
    np.testing.assert_allclose(got["segmentation"], want["segmentation"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6, atol=1e-6)
    assert got["pred_label"] == want["pred_label"] == int(np.argmax(got["scores"]))


def test_artifact_drives_eval_protocol(serving, model):
    """predict_clips is the eval engine's forward_fn: the full f-mAP /
    v-mAP protocol on the artifact gives the live padded forward's
    summary."""
    rng = np.random.default_rng(11)
    dataset = []
    for i in range(3):
        f = 20 + 7 * i
        video = rng.random((f, H, H, 3)).astype(np.float32)
        mask = (rng.random((f, H, H, 1)) > 0.4).astype(np.float32)
        dataset.append((video, mask, i % 24))
    kw = dict(n_classes=24, clip_batch_size=CB, nan_safe=True)
    got = evaluate_dataset(serving.predict_clips, dataset, **kw)
    want = evaluate_dataset(make_padded_forward(model, clip_batch_size=CB), dataset, **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-8, err_msg=k)
    assert 0.0 <= got["vmAP@0.5"] <= 1.0


def test_cpu_custom_ops_are_the_plain_versions():
    """The ops' CPU implementations are the plain versions bit for bit
    and launch nothing; their fake implementations give the output's
    shape and type without computing it."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, 6, 5, 16)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 5, 5, 5, 16)).astype(np.float32))
    xt = torch.from_numpy(rng.standard_normal((2, 11, 12, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 4, 24, 16)).astype(np.float32))
    before = (fhk.composite_convt.launches, tapconv.tap_conv_fwd.launches)
    out = torch.ops.picad.composite_convt(x, kc)
    assert torch.equal(out, fhk.composite_convt_plain(x, kc))
    assert torch.equal(torch.ops.picad.tap_conv_fwd(xt, w), tapconv.tap_conv_fwd_plain(xt, w))
    assert before == (fhk.composite_convt.launches, tapconv.tap_conv_fwd.launches)
    fake = torch.ops.picad.composite_convt(x.to("meta"), kc.to("meta"))
    assert fake.shape == out.shape and fake.dtype == torch.float32
    fake = torch.ops.picad.tap_conv_fwd(xt.to("meta"), w.to("meta"))
    assert fake.shape == (2, 9, 9, 16) and fake.dtype == torch.float32


def test_export_cli_verifies_a_port_checkpoint(tmp_path, capsys):
    """cli.export_model.main on a checkpoint written by the port's
    CheckpointIO, --device cpu --verify: the artifact reloads and matches
    the live model at rtol 1e-4, atol 1e-5."""
    from picad_tpu_torch.checkpoint.manager import CheckpointIO
    from picad_tpu_torch.cli import export_model
    from picad_tpu_torch.train.state import create_train_state

    state = create_train_state(seed=3, device="cpu", compute_dtype=torch.float32)
    ckpt = str(tmp_path / "best_model_train_loss_1")
    CheckpointIO().save(ckpt, state)
    del state
    out = export_model.main(["--ckpt", ckpt, "--out", str(tmp_path / "art"), "--hw", str(H),
                             "--clip_batch_size", str(CB), "--device", "cpu", "--verify"])
    assert "Verified" in capsys.readouterr().out
    with open(os.path.join(out, "meta.json")) as f:
        meta = json.load(f)
    assert meta["source_checkpoint"] == ckpt and meta["device"] == "cpu"
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_artifact_matches_the_jax_artifact(sd, serving, tmp_path):
    """The JAX package's artifact (picad_tpu.serve, pure-XLA chain,
    jitted) on the same pinned weights and clips, within the model
    parity tolerances of tests/test_torch_model.py."""
    m, variables = jax_capsnet(sd, h=H)
    out = jax_save_artifact(str(tmp_path / "jax"), m, variables, clip_batch_size=CB,
                            height=H, width=H, platforms=("cpu",))
    clips = _clips(3, seed=21)
    seg_j, scores_j = jax_load_artifact(out).predict_clips(clips)
    seg, scores = serving.predict_clips(clips)
    np.testing.assert_allclose(scores, scores_j, **SCORES_TOL)
    np.testing.assert_allclose(seg, seg_j, **SEG_TOL)
    assert (scores.argmax(1) == scores_j.argmax(1)).all()
