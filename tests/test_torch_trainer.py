"""The port's Trainer vs the JAX package's, and its checkpoints, on the CPU.

- One epoch (2 steps) plus validation through the JAX `Trainer` and the
  port's at 80^2, batch 2, f32, dropout 0, bv window 5, on the same
  synthetic datasets (both packages' `build_train_datasets`) and the same
  weights: the pinned fixture in the JAX trainer's state, carried across
  with checkpoint/convert.from_jax_variables.  EM routing runs at
  WELL_EPS in both (tests/test_torch_train_step.py: at the production
  eps its cost_std noise moves an f32 step's losses by up to 2.6e-2).
  The validation set holds a video whose actor the predicted mask
  overlaps, and the val steps' binary segs are compared row by row.
- Through the train CLI's entry point (train_ucf101.main, device="cpu"):
  a 2-epoch run and a `--resume` run to epoch 3 equal an unbroken 3-epoch
  run bit for bit: parameters, BN running stats, Adam's moments, the
  dropout generator, the LR and the scheduler counters; no loader thread
  left.
- Scripted losses through the port's `Trainer.fit` and through the JAX
  package's ReduceLROnPlateau + BestCheckpointPolicy: the same LR at
  every epoch, the same surviving checkpoints, and a resume mid-plateau
  that drops the LR at the same epoch as the unbroken run.
- `_load_pretrained_i3d` loads a reference-format I3D state dict by key
  and raises on a truncated or foreign one.
"""

import copy
import dataclasses
import glob
import json
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import picad_tpu.models.capsules as jax_capsules
import picad_tpu.train.loop as jax_loop
import picad_tpu_torch.models.capsules as port_capsules
from picad_tpu.checkpoint.manager import BestCheckpointPolicy as JBestCheckpointPolicy
from picad_tpu.cli.common import args_to_config as j_args_to_config
from picad_tpu.cli.common import build_parser as j_build_parser
from picad_tpu.cli.common import build_train_datasets as j_build_train_datasets
from picad_tpu.train.optimizer import ReduceLROnPlateau as JReduceLROnPlateau
from picad_tpu.train.state import TrainState as JTrainState
from picad_tpu_torch.checkpoint.convert import from_jax_variables, load_reference_state_dict
from picad_tpu_torch.cli import common as cli_common
from picad_tpu_torch.cli import train_jhmdb, train_ucf101
from picad_tpu_torch.cli.common import args_to_config, build_parser, build_train_datasets
from picad_tpu_torch.train.loop import Trainer
from picad_tpu_torch.train.state import TrainState
from picad_tpu_torch.train.step import global_grad_norm
from tests.sd_fixtures import fake_i3d_state_dict
from tests.test_torch_model import few_torch_threads, jax_capsnet, pinned_fixture_sd  # noqa: F401
from tests.test_torch_train_step import WELL_EPS, _set_routing_eps

H = 80
# Measured (torch on 2 threads): the first step's metrics 2.2e-5
# relative at most (loss_consistency; loss 8.2e-6); the epoch's mean
# loss 8.2e-4 (its consistency term 2.9e-3: step 2 starts from each
# package's own first Adam update); the val loss 2.3e-5; the val IoU
# 0.07740 vs 0.07743 (4.0e-4); the val step's binary segs differ in 94
# and 95 of each row's 51200 pixels (each package's weights after its
# two Adam steps put a few pixels on the other side of 0.5); the same
# accuracies.
FIRST_STEP_RTOL = 1e-4  # each metric of the first step, relative
EPOCH_RTOL = 2e-2  # the epoch's mean losses, the val loss and the val IoU, relative
VAL_SOURCE_VIDEOS = 8  # -> 2 val videos; the first's clip has no actor (NaN IoU, skipped)
VAL_SEG_PIXELS = 200  # of a val row's 51200 binary seg pixels that may differ


def _argv(save_root, epochs: int, *extra) -> list[str]:
    return ["--synthetic", "--bs", "2", "--epochs", str(epochs), "--pf", "1", "--lr", "1e-4",
            "--wt_cons", "0.1", "--compute_dtype", "float32", "--workers", "2",
            "--save_root", str(save_root), "--exp_id", "t", *extra]


def _shrink(cfg, videos: int, dropout: float):
    cfg.data.clip_height = cfg.data.clip_width = H
    cfg.data.synthetic_num_videos = videos  # `videos` steps an epoch at bs 2
    cfg.model.dropout_rate = dropout
    return cfg


def _jsonl(save_dir) -> list[dict]:
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _loader_threads() -> list[str]:
    return [t.name for t in threading.enumerate() if t.name == "PrefetchLoader"]


@pytest.fixture
def tmp_path(tmp_path):
    """The test's tmp_path, emptied afterwards: each checkpoint holds a
    whole model and Adam's moments."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def jax_fixture_state(monkeypatch):
    """The JAX Trainer's initial state holds the pinned fixture weights
    (merged into jax.eval_shape zeros, not an eager init)."""
    _, variables = jax_capsnet(pinned_fixture_sd(), h=H)

    def create(model, optimizer, *, rng, sample_input_shape):
        params = jax.tree.map(jnp.asarray, variables["params"])
        return JTrainState(
            params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
            opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32),
            rng=jax.random.split(rng, 3)[2], epoch=jnp.zeros((), jnp.int32),
            sched_best=jnp.asarray(jnp.inf, jnp.float32),
            sched_bad=jnp.zeros((), jnp.int32), sched_cooldown=jnp.zeros((), jnp.int32))

    monkeypatch.setattr(jax_loop, "create_train_state", create)


def _val_dataset(build, cfg, **kw):
    """The validation set of VAL_SOURCE_VIDEOS synthetic videos (the
    train streams keep their 2)."""
    cfg = copy.deepcopy(cfg)
    cfg.data.synthetic_num_videos = VAL_SOURCE_VIDEOS
    return build(cfg, **kw)[2]


def _capture_val_segs(trainer, to_numpy) -> list:
    """Wrap the trainer's val step: each call's binary seg, on the host."""
    segs, step = [], trainer.val_step

    def val_step(*args):
        seg_bin, metrics = step(*args)
        segs.append(to_numpy(seg_bin))
        return seg_bin, metrics

    trainer.val_step = val_step
    return segs


def test_one_epoch_matches_the_jax_trainer(tmp_path, monkeypatch, jax_fixture_state):
    _set_routing_eps(monkeypatch, WELL_EPS, ((jax_capsules, "em_routing"),
                                             (port_capsules, "em_routing")))
    argv = _argv(tmp_path / "jax", 1, "--bv", "--n_frames", "5")
    j_cfg = _shrink(j_args_to_config(j_build_parser("ucf101").parse_args(argv), "ucf101"), 2, 0.0)
    j_lab, j_unl, _ = j_build_train_datasets(j_cfg)
    jtr = jax_loop.Trainer(j_cfg, labeled_dataset=j_lab, unlabeled_dataset=j_unl,
                           val_dataset=_val_dataset(j_build_train_datasets, j_cfg))
    j_segs = _capture_val_segs(jtr, np.asarray)
    sd = from_jax_variables(jax.device_get(
        {"params": jtr.state.params, "batch_stats": jtr.state.batch_stats}))

    argv[argv.index("--save_root") + 1] = str(tmp_path / "port")
    cfg = _shrink(args_to_config(build_parser("ucf101").parse_args(argv), "ucf101"), 2, 0.0)
    assert dataclasses.asdict(cfg) == dict(dataclasses.asdict(j_cfg), save_root=cfg.save_root)
    lab, unl, _ = build_train_datasets(cfg, device="cpu")
    val = _val_dataset(build_train_datasets, cfg, device="cpu")
    tr = Trainer(cfg, labeled_dataset=lab, unlabeled_dataset=unl, val_dataset=val, device="cpu")
    load_reference_state_dict(tr.state.model, sd)
    segs = _capture_val_segs(tr, lambda t: t.cpu().numpy())

    jtr.fit()
    tr.fit()
    ref, got = _jsonl(jtr.save_dir), _jsonl(tr.save_dir)
    assert [(r["tag"], r["step"], sorted(r)) for r in got] == \
        [(r["tag"], r["step"], sorted(r)) for r in ref]  # the same tags, steps and keys
    by_tag = {}
    for g, r in zip(got, ref):
        by_tag.setdefault(g["tag"], []).append((g, r))
    (g1, r1), (g2, r2) = by_tag["train/loss"]  # step 1; the mean of steps 1 and 2
    for k in ("loss", "loss_seg", "loss_cls", "loss_consistency"):
        assert g1[k] == pytest.approx(r1[k], rel=FIRST_STEP_RTOL), k
        assert g2[k] == pytest.approx(r2[k], rel=EPOCH_RTOL), k
    assert by_tag["train/acc"][0][0]["acc"] == by_tag["train/acc"][0][1]["acc"]
    ((gv, rv),) = by_tag["val"]
    assert gv["loss"] == pytest.approx(rv["loss"], rel=EPOCH_RTOL)
    assert rv["iou"] > 0.05  # the second val video's actor overlaps the predicted mask
    assert gv["iou"] == pytest.approx(rv["iou"], rel=EPOCH_RTOL)
    ((seg,), (j_seg,)) = segs, j_segs  # one val batch of 2 videos
    assert seg.shape == j_seg.shape == (2, 8, H, H) and 0 < j_seg.mean() < 1
    for row, (a, b) in enumerate(zip(seg, j_seg)):
        assert np.count_nonzero(a != b) <= VAL_SEG_PIXELS, row
    assert gv["acc"] == rv["acc"]
    assert tr.epoch_stats[0]["steps"] == 2 and np.isfinite(tr.epoch_stats[0]["loss"])
    assert sorted(os.path.basename(p) for p in glob.glob(f"{tr.save_dir}/best_model_*")) == \
        sorted(os.path.basename(p) for p in glob.glob(f"{jtr.save_dir}/best_model_*"))


@pytest.fixture
def small_cli_runs(monkeypatch):
    """The train CLIs' argv -> config mapping at the test's size: 80^2, one
    step an epoch, dropout 0.5 (the generator's state matters), pose_size
    2 (20.6M parameters: a checkpoint with Adam's moments is 250 MB)."""
    to_config = cli_common.args_to_config

    def small(args, dataset):
        cfg = _shrink(to_config(args, dataset), 1, 0.5)
        cfg.model.pose_size = 2
        return cfg

    monkeypatch.setattr(cli_common, "args_to_config", small)


def _train_main(save_root, epochs: int, *extra) -> Trainer:
    """train_ucf101.main on the CPU: the pseudo-label gate switching at
    epoch 2, --watch on."""
    return train_ucf101.main(_argv(save_root, epochs, "--thresh_epoch", "2", "--lr", "1e-3",
                                   "--watch", *extra), device="cpu")


def _full_state(tr: Trainer) -> dict:
    s = tr.state
    return {"model": s.model.state_dict(), "optimizer": s.optimizer.state_dict(),
            "generator": s.generator.get_state(), "counts": (s.step, s.epoch),
            "sched": (s.sched_best, s.sched_bad, s.sched_cooldown, s.learning_rate()),
            "scheduler": vars(tr.scheduler)}


def _assert_same(a, b, path="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path  # bit for bit
    else:
        assert a == b, path


def test_resume_equals_an_unbroken_run(tmp_path, small_cli_runs):
    """No --bv, whose ramp exp_rampup(epochs) depends on the run's epoch
    count in both packages."""
    threads_before = _loader_threads()
    unbroken = _train_main(tmp_path / "unbroken", 3)
    first = _train_main(tmp_path / "first", 2)
    assert _loader_threads() == threads_before == []
    ckpt = os.path.join(first.save_dir, "best_model_train_loss_2")
    assert os.path.isdir(ckpt), os.listdir(first.save_dir)

    resumed = _train_main(tmp_path / "resumed", 3, "--resume", ckpt)
    assert [r["epoch"] for r in resumed.epoch_stats] == [3]
    _assert_same(_full_state(resumed), _full_state(unbroken))
    assert _loader_threads() == []

    tail = [{k: v for k, v in r.items() if k != "time"} for r in _jsonl(unbroken.save_dir)
            if r["step"] >= 3 and r["tag"] != "params_norms"]
    assert [{k: v for k, v in r.items() if k != "time"} for r in _jsonl(resumed.save_dir)
            if r["tag"] != "params_norms"] == tail
    tags = {r["tag"] for r in _jsonl(unbroken.save_dir)}
    assert tags == {"train/loss", "train/acc", "train/grad", "params_norms", "val"}
    grads = [r["grad_norm"] for r in _jsonl(unbroken.save_dir) if r["tag"] == "train/grad"]
    assert len(grads) == 3 and all(np.isfinite(grads)) and min(grads) > 0


def test_train_jhmdb_main_trains_and_checkpoints(tmp_path, small_cli_runs):
    """train_jhmdb.main on the CPU: 21 classes, one epoch with validation,
    its metrics and its checkpoints.  With --synthetic the stream flags are
    the source's own, as in the JAX package: only the JHMDB source forces
    them (picad_tpu/train/loop.py:141)."""
    tr = train_jhmdb.main(_argv(tmp_path, 1), device="cpu")
    assert tr.cfg.model.num_classes == 21 and tr.cfg.keep_all_after_epoch == 4
    assert not tr.batcher.force_stream_flags
    assert tr.state.model.state_dict()["conv_caps.beta_a"].shape == (21,)
    assert [(r["epoch"], r["steps"]) for r in tr.epoch_stats] == [(1, 1)]
    assert {r["tag"] for r in _jsonl(tr.save_dir)} == {"train/loss", "train/acc", "val"}
    assert all(np.isfinite(v) for r in _jsonl(tr.save_dir) for k, v in r.items()
               if k not in ("tag", "step", "time"))
    assert sorted(p for p in os.listdir(tr.save_dir) if p.startswith("best_model_")) == \
        ["best_model_train_loss_1", "best_model_val_loss_1"]


def test_global_grad_norm_is_the_l2_of_every_gradient():
    m = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    m(torch.ones(5, 4)).square().sum().backward()
    flat = torch.cat([p.grad.reshape(-1) for p in m.parameters()]).double()
    assert float(global_grad_norm(m.parameters())) == pytest.approx(float(flat.norm()),
                                                                    rel=1e-6)


TRAIN_LOSS = {1: 1.0, 2: 0.9, 3: 0.8, 4: 0.85, 5: 0.85, 6: 0.8, 7: 0.9, 8: 0.7, 9: 0.75}
VAL_LOSS = {1: 2.0, 2: 1.5, 3: 1.7, 4: 1.4, 5: 1.45, 6: 1.3, 7: 1.35, 8: 1.35, 9: 1.2}
PATIENCE = 2


def _jax_scripted(save_dir, keep_all: int) -> tuple[list, list]:
    """The JAX Trainer.fit's scheduler and checkpoint order
    (picad_tpu/train/loop.py:383-397) over the scripted losses, a tiny
    dict as the state -> (each epoch's LR, the surviving checkpoints)."""
    sched = JReduceLROnPlateau(1e-4, patience=PATIENCE)
    policies = [JBestCheckpointPolicy(save_dir, tag, keep_all) for tag in ("val", "train")]
    lrs = []
    for e in sorted(TRAIN_LOSS):
        lrs.append(sched.lr)
        sched.step(TRAIN_LOSS[e])
        state = {"w": np.zeros((3,), np.float32), "epoch": np.asarray(e, np.int32)}
        policies[0].maybe_save(e, VAL_LOSS[e], state)
        policies[1].maybe_save(e, TRAIN_LOSS[e], state)
    return lrs + [sched.lr], sorted(os.listdir(save_dir))


def _scripted_trainer(save_root, keep_all: int, epochs: int = 9) -> tuple[Trainer, list]:
    """A port Trainer whose epochs return the scripted losses and whose
    state is a tiny TrainState -> (the trainer, the LR at each epoch's start)."""
    argv = _argv(save_root, epochs)
    cfg = _shrink(args_to_config(build_parser("ucf101").parse_args(argv), "ucf101"), 1, 0.0)
    cfg.optim.plateau_patience = PATIENCE
    cfg.keep_all_after_epoch = keep_all
    lab, unl, val = build_train_datasets(cfg, device="cpu")
    tr = Trainer(cfg, labeled_dataset=lab, unlabeled_dataset=unl, val_dataset=val, device="cpu")
    lin = torch.nn.Linear(3, 1)
    tr.state = TrainState(lin, torch.optim.Adam(lin.parameters(), lr=1e-4, eps=1e-6),
                          torch.Generator().manual_seed(0))
    lrs = []

    def train_epoch(e):
        lrs.append(tr.state.learning_rate())
        return TRAIN_LOSS[e]

    tr.train_epoch = train_epoch
    tr.validate = VAL_LOSS.__getitem__
    return tr, lrs


@pytest.mark.parametrize("keep_all", [4, 20])  # JHMDB-21 and UCF101-24
def test_scripted_plateau_and_retention_match_jax(tmp_path, keep_all):
    j_lrs, j_kept = _jax_scripted(str(tmp_path / "jax"), keep_all)
    tr, lrs = _scripted_trainer(tmp_path / "port", keep_all)
    tr.fit()
    assert lrs + [tr.state.learning_rate()] == j_lrs
    assert j_lrs[-1] < j_lrs[0]  # the plateau did reduce the LR
    kept = sorted(p for p in os.listdir(tr.save_dir) if p.startswith("best_model_"))
    assert kept == j_kept

    # resume mid-plateau (epoch 4: one bad epoch) in fresh objects
    first, _ = _scripted_trainer(tmp_path / "first", keep_all, epochs=4)
    first.fit()
    assert first.scheduler.num_bad_epochs == 1
    resumed, resumed_lrs = _scripted_trainer(tmp_path / "resumed", keep_all)
    start = resumed.restore(os.path.join(first.save_dir, "best_model_val_loss_4"))
    assert start == 5 and resumed.scheduler.num_bad_epochs == 1
    resumed.fit(start)
    assert resumed_lrs + [resumed.state.learning_rate()] == j_lrs[4:]


def test_load_pretrained_i3d(tmp_path):
    sd = {k: torch.from_numpy(v) for k, v in fake_i3d_state_dict().items()}
    assert len(sd) == 225
    path = tmp_path / "rgb_charades.pt"
    torch.save(sd, path)
    argv = _argv(tmp_path, 1, "--pretrained_i3d_path", str(path))
    cfg = _shrink(args_to_config(build_parser("ucf101").parse_args(argv), "ucf101"), 1, 0.0)
    lab, unl, val = build_train_datasets(cfg, device="cpu")
    tr = Trainer(cfg, labeled_dataset=lab, unlabeled_dataset=unl, val_dataset=val, device="cpu")
    own = tr.state.model.state_dict()
    for k, v in sd.items():
        assert torch.equal(own[f"conv1.{k}"], v), k
    truncated = dict(sd)
    truncated.pop("Mixed_4f.b3b.bn.running_var")
    torch.save(truncated, tmp_path / "truncated.pt")
    with pytest.raises(ValueError, match="only 224 tensors"):
        tr._load_pretrained_i3d(str(tmp_path / "truncated.pt"))
    torch.save({"fc.weight": torch.zeros(2, 2)}, tmp_path / "foreign.pt")
    with pytest.raises(ValueError, match="0 matching"):
        tr._load_pretrained_i3d(str(tmp_path / "foreign.pt"))
