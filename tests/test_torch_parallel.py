"""The port's data-parallel path (parallel/mesh.py) on the CPU: two gloo
ranks, each a spawned process with one torch thread, against one process
that holds the whole global batch, and against the JAX package.

- Sync-BN: a train-mode TorchBatchNorm at bn_groups 2 on each rank's
  rows, through K6's plain version (BN_ONEPASS_MIN = 0) and through the
  two-pass form, and `global_stats` of `group_stats` alone: the values,
  gradients and running stats of the single process on the concatenated
  batch.
- The global losses: `compute_losses` (bv and gv, Dice and IoU) with a
  ragged row_mask split unevenly, one rank all padding: every rank's
  metrics are the global batch's, and each rank's input gradients are
  `world` times the single process's (the autograd all-reduce sums the
  ranks' identical upstream gradients; the gradient average divides it
  out).
- One train step at world 2 (80^2, 2 rows a rank, fold_flip, bv, dropout
  0, routing eps WELL_EPS): the same loss and parameters on both ranks,
  and the single process's step on the concatenated batch, and the JAX
  package's, within the bounds below; with the encoder rematerialized
  (its BN collectives rerun inside the backward) the same step again.
- The batcher's strided shards: disjoint, covering, and as many steps as
  the JAX package's batcher for the same n, hosts and host batch.
- The train CLI with --num_devices 2: a one-epoch run then --resume
  equals an unbroken two-epoch run bit for bit, and only rank 0 writes.
"""

import functools
import glob
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from picad_tpu.data.loader import SemiSupervisedBatcher as JBatcher
from picad_tpu_torch.checkpoint.manager import CheckpointIO
from picad_tpu_torch.cli import common as cli_common
from picad_tpu_torch.cli import train_ucf101
from picad_tpu_torch.data.loader import SemiSupervisedBatcher
from picad_tpu_torch.ops.bn_stats import group_stats
from picad_tpu_torch.parallel import mesh
from tests import torch_parallel_ranks as ranks
from tests.test_torch_model import few_torch_threads, pinned_fixture_sd  # noqa: F401
from tests.test_torch_train_step import (
    BV,
    GRAD_L2_TOL,
    STATS_TOL,
    WELL_EPS,
    WELL_METRIC_RTOL,
    _jax_step,
    _l2,
    _rel,
    _run_jax,
    _set_routing_eps,
)
import picad_tpu.models.capsules as jax_capsules

WORLD = 2
H = 80
# World 2 against one process on the concatenated batch (f32; the ranks
# combine per-rank statistics and sum per-rank partial sums, so only the
# rounding differs).  Measured on this step (torch on 1 thread a rank,
# 2 in the test): metrics 7.5e-7 relative; gradients 1.0e-2 relative L2
# at most (over all of them 6.0e-3); parameters after Adam 2.3e-4; BN
# running stats 1.4e-7.  That is the step's own rounding noise: the one
# process against itself at 1 and at 2 threads differs by 4.1e-3, 2.0e-3,
# 1.9e-4 and 1.1e-7 (the stride-1 pools' ties, ReLU gates and EM routing
# carry a last-bit change to ~1e-2 of a gradient, and Adam's first update,
# lr * g / (|g| + eps), to a sign).  So 1e-4 on the parameters is below
# what one process meets against itself, and they are held at 5e-4.
LOSS_RTOL = 1e-5  # every metric of the step, relative
GRAD_L2 = 3e-2  # each averaged gradient, relative L2 (a missing or extra x WORLD is 0.5)
PARAM_L2 = 5e-4  # each parameter after the Adam update, relative L2
STATS_L2 = 1e-6  # each BN running statistic, relative L2
REMAT_L2 = 1e-6  # the rematerialized encoder's gradients against the stored one's
BN_TOL = 1e-5  # sync-BN values and gradients, of the largest entry (2.5e-6 measured)


@pytest.fixture
def tmp_path(tmp_path):
    """The test's tmp_path, emptied afterwards: each checkpoint holds a
    whole model and Adam's moments."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _near(a, b, tol):
    """max |a - b| within tol of the largest |b|."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float((a - b).abs().max()) <= tol * float(b.abs().max())


def _bn_payload():
    rng = np.random.default_rng(3)  # 2 rows of each of the 2 views a rank
    x = (rng.standard_normal((2 * 2 * WORLD, 6, 2, 5, 7)) * 3 + 40).astype(np.float32)
    return {"x": x, "dy": rng.standard_normal(x.shape).astype(np.float32), "groups": 2}


def _loss_payload():
    """8 rows at 8 x 12 x 12: rank 0 holds rows 0-4 (four real), rank 1
    rows 5-7, all padding."""
    rng = np.random.default_rng(5)
    seg = (rng.standard_normal((8, 8, 12, 12)) * 2).astype(np.float32)
    return {"seg": seg, "flip": (seg + rng.standard_normal(seg.shape)).astype(np.float32),
            "scores": rng.random((8, 24), dtype=np.float32),
            "seg_gt": (rng.random(seg.shape) > 0.6).astype(np.float32),
            "action": rng.integers(0, 24, 8), "flags": np.array([1, 0, 1, 1, 0, 0, 0, 0], np.float32),
            "row_mask": np.array([1, 1, 0, 1, 1, 0, 0, 0], np.float32), "splits": [0, 5, 8]}


def _step_batch():
    rng = np.random.default_rng(21)
    n = 2 * WORLD
    return {"data": rng.integers(0, 256, (n, 8, H, H, 3), dtype=np.uint8),
            "loc_msk": (rng.random((n, 8, H, H, 1)) > 0.7).astype(np.uint8),
            "action": np.array([3, 11, 5, 0], np.int32),
            "label_vid": np.array([1, 0, 0, 1], np.int32),
            "row_mask": np.ones(n, np.float32)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Every rank-side computation of this file in ONE spawn of WORLD
    ranks (sync-BN, the losses, one train step on the pinned fixture),
    while this process takes the same step on the concatenated batch and
    the JAX package's step: {"ranks": [...], "single": ..., "jax": ...}."""
    d = tmp_path_factory.mktemp("world2")
    sd_file = str(d / "sd.pt")
    sd = pinned_fixture_sd()
    torch.save(sd, sd_file)
    batch = _step_batch()
    payloads = {"sync_bn": _bn_payload(), "losses": _loss_payload(),
                "train_step": {"sd_file": sd_file, "batch": batch, "loss_cfg": BV,
                               "epoch": 12.0, "eps": WELL_EPS}}
    with ThreadPoolExecutor(1) as pool, pytest.MonkeyPatch.context() as mp:
        spawned = pool.submit(ranks.run_ranks, "all", WORLD, d, payloads)
        _set_routing_eps(mp, WELL_EPS, ((jax_capsules, "em_routing"),))
        jax_ref = _run_jax(*_jax_step(sd, BV), batch, 12.0)
        mp.undo()
        single = ranks.train_step(sd, batch, BV, 12.0, WELL_EPS)
        results = {"ranks": spawned.result(), "single": single, "jax": jax_ref}
    shutil.rmtree(d, ignore_errors=True)  # the weights and the ranks' results
    return results


# ---- sync-BN ----------------------------------------------------------


@pytest.mark.parametrize("path", ["onepass", "twopass"])
def test_sync_bn_equals_the_global_batch(world2, path):
    """Each rank holds 2 rows of each of the 2 views (bn_groups 2)."""
    p = _bn_payload()
    got = [g["sync_bn"][path] for g in world2["ranks"]]
    xt = torch.from_numpy(p["x"])
    ref = ranks.sync_bn(xt, torch.from_numpy(p["dy"]), 2, 0 if path == "onepass" else 1 << 62)
    mean, var = group_stats(xt, 2)  # no group: global_stats is the identity
    assert torch.equal(ref["mean"], mean) and torch.equal(ref["var"], var)
    for key in ("y", "dx"):
        assert _near(ranks.from_views([g[key] for g in got]), ref[key], BN_TOL), key
    for key in ("dweight", "dbias"):  # each rank holds its rows' share
        assert _near(got[0][key] + got[1][key], ref[key], BN_TOL), key
    for key in ("mean", "var", "running_mean", "running_var"):
        assert torch.equal(got[0][key], got[1][key]), key
        assert _near(got[0][key], ref[key], BN_TOL), key
    # the stats' probe loss is the same global value on both ranks, so
    # the all-reduce's adjoint hands each rank WORLD times its gradient
    assert _near(ranks.from_views([g["dx_stats"] for g in got]), WORLD * ref["dx_stats"],
                 BN_TOL)


# ---- the global losses ------------------------------------------------


@pytest.mark.parametrize("loc", ["dice", "iou"])
def test_global_losses_with_a_ragged_uneven_split(world2, loc):
    p = _loss_payload()
    t = {k: torch.from_numpy(v) for k, v in p.items() if k != "splits"}
    ref = ranks.losses(t["seg"], t["flip"], t["scores"], t["seg_gt"], t["action"].long(),
                       t["flags"], t["row_mask"])[loc]
    got = [g["losses"][loc] for g in world2["ranks"]]
    assert got[0]["metrics"] == got[1]["metrics"]  # the same global values on both ranks
    for k, v in ref["metrics"].items():
        assert got[0]["metrics"][k] == pytest.approx(v, rel=LOSS_RTOL, abs=1e-7), k
    assert ref["metrics"]["loss_consistency"] > 0 and ref["metrics"]["loss_cls"] != 0
    for i in range(3):  # seg, flip, scores: WORLD x the single process's
        whole = torch.cat([g["grads"][i] for g in got])
        assert _near(whole, WORLD * ref["grads"][i], LOSS_RTOL), i
    assert torch.count_nonzero(got[1]["grads"][0]) == 0  # rank 1 holds only padding


# ---- one train step ---------------------------------------------------


def test_train_step_world2_matches_one_process_and_jax(world2):
    """Both ranks: the same metrics and, after the step, the same
    parameters and running stats.  Against one process on the
    concatenated batch: metrics LOSS_RTOL, the averaged gradients
    GRAD_L2, parameters PARAM_L2 and BN stats STATS_L2.  Against the JAX
    package's step on that batch: test_torch_train_step.py's bounds at
    WELL_EPS."""
    r0, r1 = (g["train_step"] for g in world2["ranks"])
    assert r0["metrics"] == r1["metrics"]
    assert r0["same_on_all_ranks"] and r1["same_on_all_ranks"]
    batch = _step_batch()
    # the ranks' rows in rank order are the global batch
    for k, v in batch.items():
        assert np.array_equal(np.concatenate([mesh.local_rows(v, r, WORLD)
                                              for r in range(WORLD)]), v)
    mt, gt, pt, bt = world2["single"]
    for k, v in mt.items():
        assert r0["metrics"][k] == pytest.approx(v, rel=LOSS_RTOL), k
    assert set(r0["grads"]) == set(gt) and len(gt) == 158
    for name, g in gt.items():
        assert _l2(r0["grads"][name].numpy(), g.numpy()) <= GRAD_L2, name
    for got, ref, tol in ((r0["params"], pt, PARAM_L2), (r0["buffers"], bt, STATS_L2)):
        for name, v in ref.items():
            assert _l2(got[name].numpy(), v.numpy()) <= tol, name

    # the rematerialized encoder at world 2: the same step (its reruns'
    # collectives matched on both ranks), BN running stats updated once
    rm = r0["remat"]
    assert rm["metrics"] == r0["metrics"]
    for name, g in r0["grads"].items():
        assert _l2(rm["grads"][name].numpy(), g.numpy()) <= REMAT_L2, name
    for name, b in r0["buffers"].items():
        assert torch.equal(rm["buffers"][name], b), name

    mj, jax_tree = world2["jax"]
    for k, v in mj.items():
        assert abs(r0["metrics"][k] - v) <= WELL_METRIC_RTOL * abs(v), (k, r0["metrics"][k], v)
    for name, g in r0["grads"].items():
        assert _l2(g.numpy(), jax_tree[name]) <= GRAD_L2_TOL, name
    for name, b in r0["buffers"].items():
        ref = jax_tree[name]
        assert _rel(b.numpy(), ref, float(np.abs(ref).max())) <= STATS_TOL, name


# ---- the batcher's shards ---------------------------------------------


class _Indexed:
    """A dataset whose samples are their own index."""

    def __init__(self, n: int, src: int):
        self.n, self.src = n, src

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.int64(i), "src": np.int64(self.src), "action": np.int32(0),
                "label_vid": np.int32(self.src == 0)}


def _unlabelled_steps(batcher) -> list[set]:
    steps = []
    for b in batcher.epoch(3):
        real = (b["row_mask"] == 1) & (b["src"] == 1)
        steps.append(set(b["idx"][real].tolist()))
    return steps


@pytest.mark.parametrize("n", [1, 7, 16, 23])
@pytest.mark.parametrize("hosts,per_host,bs", [(1, 2, 4), (1, 2, 8), (1, 4, 8), (2, 2, 4)])
def test_batcher_shards_are_disjoint_and_step_with_jax(n, hosts, per_host, bs):
    """Rank r of P*N draws its strided shard at bs/N rows: as many steps
    as the JAX batcher on each of P hosts at bs; every unlabelled video
    once an epoch; on one host each step holds the JAX step's videos."""
    world = hosts * per_host
    kw = dict(seed=4, workers=1)
    port = [SemiSupervisedBatcher(_Indexed(5, 0), _Indexed(n, 1), batch_size=bs // per_host,
                                  process_index=r, process_count=world, **kw)
            for r in range(world)]
    jax_b = [JBatcher(_Indexed(5, 0), _Indexed(n, 1), batch_size=bs, process_index=p,
                      process_count=hosts, **kw) for p in range(hosts)]
    steps = {b.steps_per_epoch() for b in port}
    assert steps == {b.steps_per_epoch() for b in jax_b}
    ranks_steps = [_unlabelled_steps(b) for b in port]
    assert {len(s) for s in ranks_steps} == steps
    seen = [i for s in ranks_steps for step in s for i in step]
    assert sorted(seen) == list(range(n))  # disjoint and covering
    if hosts == 1:
        union = [set().union(*(s[k] for s in ranks_steps)) for k in range(steps.pop())]
        assert union == _unlabelled_steps(jax_b[0])


# ---- the train CLI over two ranks ---------------------------------------


@pytest.mark.parametrize("devices,backend", [
    (["cpu", "cpu"], "gloo"), (["cuda:0", "cuda:0"], "gloo"), (["cuda:0", "cpu"], "gloo"),
    (["cuda:0", "cuda:1"], "nccl"), (["cuda:0"], "nccl")])
def test_rank_devices_and_their_backend(devices, backend):
    """The rank devices a caller lists: --num_devices must count as many
    (0 = as many), and the ranks take NCCL only when each has a card of
    its own (NCCL refuses two ranks on one card)."""
    want = [torch.device(d) for d in devices]
    assert mesh.backend_for(devices) == backend
    assert mesh.host_devices(0, "cpu", devices) == want
    assert mesh.host_devices(len(devices), "cpu", devices) == want
    with pytest.raises(ValueError, match="rank devices"):
        mesh.host_devices(len(devices) + 1, "cpu", devices)
    assert mesh.host_devices(0, "cpu") == [torch.device("cpu")]
    assert mesh.host_devices(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="rank devices"):  # before any rank starts
        train_ucf101.main(["--synthetic", "--bs", "4", "--num_devices", "3"], device="cpu",
                          devices=devices)


@pytest.fixture
def small_cli_runs(monkeypatch, tmp_path):
    """The CLI's config at the test's size (80^2, 2 synthetic videos, so
    one step an epoch at 2 rows a rank and a one-video validation set
    that leaves rank 1 an all-pad step; dropout 0.5, pose_size 2), every
    checkpoint kept.  The launcher hands this config to the ranks.

    TensorBoard's writer imports TensorFlow wherever it finds it, which
    takes ~18 s on the CPU host in every fresh rank process; a spawned
    rank starts from this process's sys.path, so a `tensorflow` that
    refuses to import, first on it while the ranks start, sends their
    writer to TensorBoard's own stub (events are written either way)."""
    shadow = tmp_path / "no_tensorflow"
    (shadow / "tensorflow").mkdir(parents=True)
    (shadow / "tensorflow" / "__init__.py").write_text(
        'raise ImportError("TensorFlow is kept out of the test\'s rank processes")\n')
    monkeypatch.syspath_prepend(str(shadow))
    to_config = cli_common.args_to_config

    def small(args, dataset):
        cfg = to_config(args, dataset)
        cfg.data.clip_height = cfg.data.clip_width = H
        cfg.data.synthetic_num_videos = 2
        cfg.model.dropout_rate, cfg.model.pose_size = 0.5, 2
        cfg.keep_all_after_epoch = 0
        return cfg

    monkeypatch.setattr(cli_common, "args_to_config", small)
    # the CLI's spawn gets its own limit too
    monkeypatch.setattr(mesh, "launch",
                        functools.partial(mesh.launch, timeout=ranks.RANK_TIMEOUT_S))


def _cli(save_root, epochs: int, *extra):
    return train_ucf101.main(
        ["--synthetic", "--bs", "4", "--num_devices", str(WORLD), "--epochs", str(epochs),
         "--pf", "1", "--lr", "1e-3", "--wt_cons", "0.1", "--thresh_epoch", "2",
         "--compute_dtype", "float32", "--workers", "1", "--save_root", str(save_root),
         "--exp_id", "t", *extra], device="cpu")


def _run_dir(root) -> str:
    (d,) = glob.glob(os.path.join(str(root), "t", "*"))
    return d


def test_two_rank_cli_resume_equals_an_unbroken_run(small_cli_runs, tmp_path):
    """`train_ucf101.main --num_devices 2`: resuming the epoch-1
    checkpoint for epoch 2 gives the unbroken run's epoch-2 checkpoint
    bit for bit (both ranks' dropout streams included) and its epoch-2
    log lines; rank 0 alone writes."""
    assert _cli(tmp_path / "unbroken", 2) is None  # the ranks ran in their own processes
    run = _run_dir(tmp_path / "unbroken")
    ckpt1 = os.path.join(run, "best_model_train_loss_1")
    _cli(tmp_path / "resumed", 2, "--resume", ckpt1)
    resumed = _run_dir(tmp_path / "resumed")

    a = CheckpointIO.load(os.path.join(run, "best_model_train_loss_2"))
    b = CheckpointIO.load(os.path.join(resumed, "best_model_train_loss_2"))
    assert len(a["rank_generators"]) == WORLD
    assert not torch.equal(*a["rank_generators"])  # each rank its own stream
    _assert_same(a, b)

    def log(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]

    first = log(run)
    tags = [(r["tag"], r["step"]) for r in first]
    assert len(tags) == len(set(tags))  # one writer
    assert {t for t, _ in tags} == {"train/loss", "train/acc", "val"}
    assert log(resumed) == [r for r in first if r["step"] >= 2]
    for d in (run, resumed):
        files = {os.path.relpath(os.path.join(p, f), d)
                 for p, _, fs in os.walk(d) for f in fs}
        events = {f for f in files if "tfevents" in f}
        assert len({f.split(".")[-2] for f in events}) <= 1, events  # one writing process
        assert files - events == {"metrics.jsonl"} | {
            f"{c}/train_state.pt" for c in os.listdir(d) if c.startswith("best_model_")}


def _assert_same(a, b, path="ckpt"):
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
