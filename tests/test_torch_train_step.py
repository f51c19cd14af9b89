"""The port's train step vs the JAX package's, and both vs float64, CPU.

The whole step runs at 80^2, batch 2, bn_groups=2 (both views folded
into one forward, the JAX package's fold_flip), the bidirectional
cyclic-variance consistency (bv, window 5) and dropout 0, on the pinned
fixture weights (tests/test_torch_model.py), in f32:

- the JAX package's jitted step, with an optimizer that hands back the
  raw gradients;
- the port's step on the CPU (the plain versions of K1, K2 and K6);
- a float64 reference: the torch oracle's two train-mode forwards
  (tests/torch_oracle.py, the reference's literal two-forward order) and
  the port's loss assembly in float64 (held against the JAX package's
  by test_loss_assembly_matches_jax below).

Two things stand between the f32 steps and float64:

- The stride-1 max pools' tie rule.  The JAX package sends a window's
  gradient to every tied maximum, one 1-D stage per axis
  (picad_tpu/ops/convops.py:248-265), and ReLU zeros tie often; the
  oracle's F.max_pool3d sends it to one index.  Upstream of those pools
  the oracle's gradient is another function's: on these inputs both f32
  steps landed 0.6 to 16 times its largest entry away from it.  So the
  float64 reference takes the JAX package's rule (`_pool_all_ties`).
- EM routing's cost_std sums over C before squaring (ROADMAP.md section
  3): at the production eps 1e-8 it divides by the f32 rounding noise
  of a sum that is zero in exact arithmetic.  Every f32 gradient upstream
  of the routing, and the class scores, carry that noise: the JAX step's
  gradients land up to 0.27 relative L2 from float64 and its loss_cls
  8.8 % (the port's 0.03 and 0.09 %).  At routing eps 1e-4 the noise is
  gone and both f32 steps agree with float64 and with each other to the
  few percent that f32 ties and ReLU gates leave.

So the step is held twice: at the production eps, no farther from
float64 than the JAX package is (with a margin) and within GRAD_L2_TOL
where JAX is nearer, which a zero, sign-flipped or doubled gradient
fails; and with routing eps WELL_EPS in all three implementations, every
gradient within GRAD_L2_TOL of float64 and of the JAX step.  What the
noise does not reach, the BN running stats, is held tight in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import picad_tpu.models.capsules as jax_capsules
import picad_tpu_torch.models.capsules as port_capsules
from picad_tpu.checkpoint.torch_convert import (
    convert_capsnet_state_dict,
    merge_into_variables,
)
from picad_tpu.config import LossConfig as JLossConfig
from picad_tpu.models.capsules import CapsNet as JaxCapsNet
from picad_tpu.train.state import TrainState as JTrainState
from picad_tpu.train.step import make_train_step as j_make_train_step
from picad_tpu_torch.checkpoint.convert import from_jax_variables
from picad_tpu_torch.config import LossConfig
from picad_tpu_torch.train.state import create_train_state
from picad_tpu_torch.train.step import compute_losses, make_train_step
from tests import torch_oracle
from tests.test_torch_model import few_torch_threads, pinned_fixture_sd  # noqa: F401

H, B = 80, 2
BV = dict(bv=True, n_frames=5, wt_cons=0.1, thresh_epoch=11)
WELL_EPS = 1e-4  # EM routing eps at which cost_std is well conditioned
# Measured at this seed, relative L2 distance of a gradient to float64,
# largest over the 158 parameters (port / JAX):
#   production eps, epoch 12: 3.1e-2 / 2.7e-1;
#   WELL_EPS: 2.0e-2 / 1.3e-2, and 1.7e-2 between the port and JAX.
# Metrics at the production eps, relative to float64: loss 2.7e-4 /
# 2.6e-2, loss_cls 8.9e-4 / 8.8e-2, loss_consistency 2.7e-5 / 7.1e-4,
# loss_seg 2.0e-6 / 1.3e-4; at WELL_EPS at most 1e-5 for both.
# BN running stats, of the largest entry: 4.1e-7 / 2.7e-7.
METRIC_RTOL = 2e-3  # of the float64 value, every metric
WELL_METRIC_RTOL = 1e-4  # ... at WELL_EPS, also between the port and JAX
FARTHER_THAN_JAX = 2.0  # the port's distance to float64 over JAX's, at most
GRAD_L2_TOL = 6e-2  # relative L2 of a gradient: 3x the largest measured
STATS_TOL = 2e-6  # BN running stats, of the largest entry
FOLD_GRAD_L2 = 1e-4  # folded vs two forwards, relative L2 of a gradient (2.6e-6 measured)

_oracle_maxpool = torch_oracle._maxpool_same


def _pool_axis_all_ties(x, dim, k):
    """Stride-1 zero-padded max pool along one dim whose backward sends
    each window's gradient to every tied maximum."""
    lo = (k - 1) // 2
    pad = [0, 0] * (x.ndim - 2)
    pad[2 * (x.ndim - 1 - dim)], pad[2 * (x.ndim - 1 - dim) + 1] = lo, k - 1 - lo
    win = F.pad(x, pad).unfold(dim, k, 1)
    y = win.detach().amax(-1)
    tied = (win.detach() == y.unsqueeze(-1)).to(x.dtype)
    return y + ((win - win.detach()) * tied).sum(-1)


def _pool_all_ties(x, kernel, stride):
    """The oracle's TF-SAME zero-padded max pool with the JAX package's
    gradient: stride-1 pools as one all-ties stage per axis, strided
    pools unchanged."""
    if any(s != 1 for s in stride):
        return _oracle_maxpool(x, kernel, stride)
    for a, k in enumerate(kernel):
        if k > 1:
            x = _pool_axis_all_ties(x, 2 + a, k)
    return x


@pytest.fixture
def jax_tie_rule(monkeypatch):
    monkeypatch.setattr(torch_oracle, "_maxpool_same", _pool_all_ties)


def _set_routing_eps(monkeypatch, eps, modules):
    """EM routing at `eps` in each (module, name): every caller reaches
    it through its module's global."""
    for mod, name in modules:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, **k: _fn(*a, **{**k, "eps": eps}))


ALL_ROUTINGS = ((jax_capsules, "em_routing"), (port_capsules, "em_routing"),
                (torch_oracle, "em_routing_torch"))


def _batch():
    rng = np.random.default_rng(21)
    return {
        "data": rng.integers(0, 256, (B, 8, H, H, 3), dtype=np.uint8),
        "loc_msk": (rng.random((B, 8, H, H, 1)) > 0.7).astype(np.uint8),
        "action": np.array([3, 11], np.int32),
        "label_vid": np.array([1, 0], np.int32),  # one labelled, one not
        "row_mask": np.ones(B, np.float32),
    }


def _grad_capture():
    """An optax transformation whose state after one update is the raw
    gradient tree (and whose update leaves the parameters alone)."""
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


def _jax_step(sd, loss_cfg):
    """(jitted JAX train step with fold_flip, its initial state)."""
    m = JaxCapsNet(num_classes=24, dropout_rate=0.0, bn_groups=2)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: m.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 8, H, H, 3)),
        jnp.zeros((1,), jnp.int32), jnp.ones((1,)), 0, 0, False))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats, _ = convert_capsnet_state_dict(sd)
    variables = merge_into_variables(variables, params, stats)
    capture = _grad_capture()
    state = JTrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=capture.init(variables["params"]), step=jnp.zeros((), jnp.int32),
        rng=key, epoch=jnp.zeros((), jnp.int32), sched_best=jnp.asarray(jnp.inf),
        sched_bad=jnp.zeros((), jnp.int32), sched_cooldown=jnp.zeros((), jnp.int32))
    step = jax.jit(j_make_train_step(m, capture, JLossConfig(**loss_cfg), fold_flip=True))
    return step, state


def _run_jax(j_step, j_state, batch, epoch):
    """(metrics, gradients and new BN running stats under reference keys)."""
    new, mj = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()},
                     jnp.asarray(epoch), jnp.asarray(0.5))
    tree = from_jax_variables({"params": jax.tree.map(np.asarray, new.opt_state),
                               "batch_stats": jax.tree.map(np.asarray, new.batch_stats)})
    return {k: float(v) for k, v in mj.items()}, tree


def _run_port(sd, batch, epoch, bn_groups=2):
    """(metrics, gradients, BN running stats) of one port step."""
    state = create_train_state(state_dict=sd, device="cpu", compute_dtype=torch.float32,
                               bn_groups=bn_groups, dropout_rate=0.0)
    state, mt = make_train_step(LossConfig(**BV), device="cpu")(state, batch, epoch, 0.5)
    assert state.step == 1
    return ({k: float(v) for k, v in mt.items()},
            {n: p.grad.numpy() for n, p in state.model.named_parameters()},
            {n: b.numpy() for n, b in state.model.named_buffers()})


def _float64_reference(sd, batch, epoch, loss_cfg):
    """(metrics, gradients, BN running stats) of the step in float64."""
    t = {}
    for k, v in sd.items():
        a = torch.from_numpy(np.asarray(v)).double()
        t[k] = a.clone() if k.endswith(("running_mean", "running_var")) else a.requires_grad_()
    img = (torch.from_numpy(batch["data"]).double() / 255.0).permute(0, 4, 1, 2, 3)
    action = torch.from_numpy(batch["action"]).long()
    flags = torch.from_numpy(batch["label_vid"]).double()
    seg1, scores = torch_oracle.capsnet_train_forward(img, t, action, flags, epoch,
                                                      loss_cfg["thresh_epoch"])
    seg2, _ = torch_oracle.capsnet_train_forward(torch.flip(img, dims=[4]), t, action, flags,
                                                 epoch, loss_cfg["thresh_epoch"])
    seg_gt = torch.from_numpy(batch["loc_msk"][..., 0]).double()
    total, metrics = compute_losses(seg1[:, 0], seg2[:, 0], scores, seg_gt, action, flags,
                                    torch.ones(B, dtype=torch.float64), LossConfig(**loss_cfg),
                                    0.5)
    total.backward()
    grads = {k: v.grad.numpy() for k, v in t.items() if v.grad is not None}
    stats = {k: v.numpy() for k, v in t.items() if k.endswith(("running_mean", "running_var"))}
    return {k: float(v.detach()) for k, v in metrics.items()}, grads, stats


def _rel(a, b, scale):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / scale)


def _l2(a, ref):
    """Relative L2 distance of a (array or dict of arrays) to ref."""
    if isinstance(ref, dict):
        num = sum(float(np.square(np.asarray(a[k]) - ref[k]).sum()) for k in ref)
        return (num / sum(float(np.square(v).sum()) for v in ref.values())) ** 0.5
    return float(np.linalg.norm(np.asarray(a) - ref) / np.linalg.norm(ref))


def _check_stats(port_stats, s64, jax_tree):
    for name, b in port_stats.items():
        scale = float(np.abs(s64[name]).max())
        assert _rel(b, s64[name], scale) <= STATS_TOL, name
        assert _rel(b, jax_tree[name], scale) <= STATS_TOL, name


@pytest.fixture(scope="module")
def jax_bv_step():
    sd = pinned_fixture_sd()
    return sd, _jax_step(sd, BV)


@pytest.mark.parametrize("epoch", [12.0, 1.0])  # pseudo-label gate on / off
def test_train_step_matches_jax_against_float64(jax_bv_step, jax_tie_rule, epoch):
    """At the production routing eps: metrics and gradients no farther
    from float64 than the JAX step's (x FARTHER_THAN_JAX, or within
    GRAD_L2_TOL), per parameter and over all of them; BN stats tight."""
    sd, (j_step, j_state) = jax_bv_step
    batch = _batch()
    m64, g64, s64 = _float64_reference(sd, batch, epoch, BV)
    mj, jax_tree = _run_jax(j_step, j_state, batch, epoch)
    mt, gt, st = _run_port(sd, batch, epoch)

    assert mt["acc"] == mj["acc"] == m64["acc"]
    for k in ("loss", "loss_seg", "loss_cls", "loss_consistency"):
        d_port, d_jax = abs(mt[k] - m64[k]), abs(mj[k] - m64[k])
        assert d_port <= METRIC_RTOL * abs(m64[k]), (k, mt[k], m64[k])
        assert d_port <= max(FARTHER_THAN_JAX * d_jax, 1e-6 * abs(m64[k])), (k, d_port, d_jax)

    assert set(gt) == set(g64) and len(g64) == 158  # every parameter has its gradient
    for name, ref in g64.items():
        e_port, e_jax = _l2(gt[name], ref), _l2(jax_tree[name], ref)
        assert e_port <= max(FARTHER_THAN_JAX * e_jax, GRAD_L2_TOL), (name, e_port, e_jax)
    e_port, e_jax = _l2(gt, g64), _l2(jax_tree, g64)
    assert e_port <= max(FARTHER_THAN_JAX * e_jax, GRAD_L2_TOL), ("all", e_port, e_jax)
    _check_stats(st, s64, jax_tree)


def test_train_step_matches_jax_well_conditioned(jax_tie_rule, monkeypatch):
    """With EM routing at WELL_EPS in all three steps: every metric and
    every gradient held to float64 and to the JAX step directly."""
    _set_routing_eps(monkeypatch, WELL_EPS, ALL_ROUTINGS)
    sd, batch = pinned_fixture_sd(), _batch()
    m64, g64, s64 = _float64_reference(sd, batch, 12.0, BV)
    mj, jax_tree = _run_jax(*_jax_step(sd, BV), batch, 12.0)  # traced at WELL_EPS
    mt, gt, st = _run_port(sd, batch, 12.0)

    for k, ref in m64.items():
        for got in (mt[k], mj[k]):
            assert abs(got - ref) <= WELL_METRIC_RTOL * abs(ref), (k, mt[k], mj[k], ref)
    assert set(gt) == set(g64) and len(g64) == 158
    for name, ref in g64.items():
        assert _l2(gt[name], ref) <= GRAD_L2_TOL, (name, _l2(gt[name], ref))
        assert _l2(gt[name], jax_tree[name]) <= GRAD_L2_TOL, (name, _l2(gt[name], jax_tree[name]))
    _check_stats(st, s64, jax_tree)


def test_folded_step_matches_two_forwards(monkeypatch):
    """bn_groups=2 (both views in one 2B forward) against bn_groups=1
    (two forwards, the reference's order): the same metrics, gradients
    and BN running stats, routing at WELL_EPS."""
    _set_routing_eps(monkeypatch, WELL_EPS, [(port_capsules, "em_routing")])
    sd, batch = pinned_fixture_sd(), _batch()
    m2, g2, s2 = _run_port(sd, batch, 12.0, bn_groups=2)
    m1, g1, s1 = _run_port(sd, batch, 12.0, bn_groups=1)
    for k, v in m1.items():
        assert abs(m2[k] - v) <= 1e-5 * abs(v), (k, m2[k], v)
    for name, g in g1.items():
        assert _l2(g2[name], g) <= FOLD_GRAD_L2, (name, _l2(g2[name], g))
    for name, b in s1.items():
        assert _rel(s2[name], b, float(np.abs(b).max())) <= STATS_TOL, name


# ------------------------------------------------------- loss assembly


class _GivenOutputs:
    """Stands in for the JAX CapsNet: apply returns the seg logits and
    class scores held in its params, so that JAX differentiates the loss
    assembly alone."""

    def apply(self, variables, data, *args, mutable=(), rngs=None):
        p = variables["params"]
        return (p["seg"], p["scores"], None), {"batch_stats": variables["batch_stats"]}


LOSS_CFGS = {
    "neither": dict(),
    "bv": dict(bv=True, n_frames=5),
    "gv": dict(gv=True, lower_thresh=0.2, upper_thresh=0.8),
    "both": dict(bv=True, n_frames=3, gv=True, bv_wt=0.4, gv_wt=0.6),
}


@pytest.mark.parametrize("name", list(LOSS_CFGS))
def test_loss_assembly_matches_jax(name):
    """Losses, metrics and the gradients of seg and scores of the folded
    [data; aug] batch, with a ragged row_mask (row 2 is padding), one
    unlabelled row, and stopped gradients through every mask."""
    cfg = dict(LOSS_CFGS[name], wt_cons=0.3)
    rng = np.random.default_rng(30)
    b, T, h, w, C = 3, 8, 6, 5, 24
    seg = (rng.standard_normal((2 * b, T, h, w)) * 2).astype(np.float32)
    scores = rng.uniform(0.3, 0.7, (2 * b, C)).astype(np.float32)
    batch = {"data": rng.integers(0, 256, (b, T, h, w, 3), dtype=np.uint8),
             "loc_msk": (rng.random((b, T, h, w, 1)) > 0.6).astype(np.uint8),
             "action": np.array([4, 7, 0], np.int32),
             "label_vid": np.array([1, 0, 1], np.int32),
             "row_mask": np.array([1, 1, 0], np.float32)}

    params = {"seg": jnp.asarray(seg), "scores": jnp.asarray(scores)}
    capture = _grad_capture()
    j_state = JTrainState(
        params=params, batch_stats={}, opt_state=capture.init(params),
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0),
        epoch=jnp.zeros((), jnp.int32), sched_best=jnp.asarray(jnp.inf),
        sched_bad=jnp.zeros((), jnp.int32), sched_cooldown=jnp.zeros((), jnp.int32))
    j_step = j_make_train_step(_GivenOutputs(), capture, JLossConfig(**cfg), fold_flip=True)
    new, mj = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()},
                     jnp.asarray(3.0), jnp.asarray(0.7))

    seg_t = torch.from_numpy(seg).requires_grad_()
    scores_t = torch.from_numpy(scores).requires_grad_()
    seg_gt = torch.from_numpy(batch["loc_msk"][..., 0]).float()
    action = torch.from_numpy(batch["action"]).long()
    flags = torch.from_numpy(batch["label_vid"]).float()
    total, mt = compute_losses(seg_t[:b], seg_t[b:], scores_t[:b], seg_gt, action, flags,
                               torch.from_numpy(batch["row_mask"]), LossConfig(**cfg), 0.7)
    g_seg, g_scores = torch.autograd.grad(total, (seg_t, scores_t))

    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k].detach()), float(mj[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    # f32 sums over a few thousand elements in other orders
    np.testing.assert_allclose(g_seg.numpy(), np.asarray(new.opt_state["seg"]),
                               rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(g_scores.numpy(), np.asarray(new.opt_state["scores"]),
                               rtol=1e-4, atol=1e-8)
    assert not g_seg[2].any() and not g_seg[b + 2].any()  # the padded row


class _GivenEvalOutputs:
    """The eval-mode stand-in: the JAX val step's apply call (no mutable
    collections) and the port's model call both return fixed outputs."""

    def __init__(self, seg, scores):
        self.seg, self.scores = seg, scores

    def apply(self, variables, data, *args):
        return jnp.asarray(self.seg), jnp.asarray(self.scores), None

    def eval(self):
        return self

    def __call__(self, data):
        return torch.from_numpy(self.seg), torch.from_numpy(self.scores), None


def test_val_step_matches_jax():
    """The validation step's losses, accuracy and binarized seg over a
    ragged batch (row 1 is padding), on the same model outputs."""
    from types import SimpleNamespace

    from picad_tpu.train.step import make_val_step as j_make_val_step
    from picad_tpu_torch.train.step import make_val_step

    rng = np.random.default_rng(31)
    b, T, h, w = 3, 8, 6, 5
    seg = (rng.standard_normal((b, T, h, w)) * 2).astype(np.float32)
    scores = rng.uniform(0.3, 0.7, (b, 24)).astype(np.float32)
    batch = {"data": rng.integers(0, 256, (b, T, h, w, 3), dtype=np.uint8),
             "loc_msk": (rng.random((b, T, h, w, 1)) > 0.6).astype(np.uint8),
             "action": np.array([int(scores[0].argmax()), 7, 0], np.int32)}
    row_mask = np.array([1, 0, 1], np.float32)
    stand_in = _GivenEvalOutputs(seg, scores)
    seg_j, mj = j_make_val_step(stand_in, JLossConfig())(
        SimpleNamespace(params={}, batch_stats={}),
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(row_mask))
    seg_t, mt = make_val_step(LossConfig(), device="cpu")(
        SimpleNamespace(model=stand_in), batch, row_mask)
    np.testing.assert_array_equal(seg_t.numpy(), np.asarray(seg_j))
    assert set(mt) == set(mj) and float(mt["acc"]) == float(mj["acc"]) == 0.5
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, atol=1e-7, err_msg=k)
