"""The graphed train step's host side, on the CPU (train/graph.py).

CUDA graphs exist only on a card, so the capture and the replay are
tested in tests/test_torch_cuda.py and chip_smoke.py phase 8.  Here:

- `graph_key`: what changes it (the batch's shapes, dtypes, keys and
  device, the thresh_epoch branch, the dropout rates, bn_groups, the
  encoder's activation checkpoint, the backend switches and the packed
  prep, the identity and addresses of the state's parts), what makes the
  step stay eager (a hook, a process group), and what leaves it alone
  (wt_ramp, lr, epoch on the same side of thresh_epoch, a new batch of
  the same layout);
- `GraphedStep`'s dispatch, with the capture and the replay stubbed:
  WARMUP eager calls a key, then one capture and replays, at most
  MAX_GRAPHS graphs, the eager step for a key of None;
- the eager step fed the ramp and the learning rate as 0-d tensors (as
  the graphed step feeds them): the same losses, gradients, BN running
  stats and update as the float path, bit for bit, and the loss assembly
  held against the JAX package's as tests/test_torch_train_step.py holds
  it;
- the fused Adam with a tensor lr (train/optimizer.py): with_learning_rate
  and load_state_dict fill its live tensors in place, and its state_dict
  loads into a plain Adam (bench/check.py's CPU reference, checkpoints);
- the launch counters' snapshot, difference and addition.
"""

import copy
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picad_tpu.config import LossConfig as JLossConfig
from picad_tpu.train.state import TrainState as JTrainState
from picad_tpu.train.step import make_train_step as j_make_train_step
from picad_tpu_torch.config import LossConfig
from picad_tpu_torch.models import layers
from picad_tpu_torch.ops import convops, tapconv
from picad_tpu_torch.ops.fused_head_kernel import composite_convt
from picad_tpu_torch.parallel import mesh
from picad_tpu_torch.train import graph
from picad_tpu_torch.train import step as port_step
from picad_tpu_torch.train.optimizer import FusedAdam, make_optimizer
from picad_tpu_torch.train.state import TrainState, create_train_state
from picad_tpu_torch.train.step import compute_losses, make_train_step
from picad_tpu_torch.utils import profiling
from tests.test_torch_model import few_torch_threads, pinned_fixture_sd  # noqa: F401
from tests.test_torch_train_step import LOSS_CFGS, _GivenOutputs, _grad_capture

H, B = 80, 2
BV = dict(bv=True, n_frames=5, wt_cons=0.1, thresh_epoch=11)
# the fused Adam's update against plain Adam's, relative L2 over all the
# parameters: 1.5e-6 measured (one f32 rounding of p - update apart); a
# zero, doubled or sign-flipped update is O(1)
ADAM_UPDATE_L2 = 1e-5


def _batch(b=B, seed=21):
    rng = np.random.default_rng(seed)
    return {"data": rng.integers(0, 256, (b, 8, H, H, 3), dtype=np.uint8),
            "loc_msk": (rng.random((b, 8, H, H, 1)) > 0.7).astype(np.uint8),
            "action": rng.integers(0, 24, (b,)).astype(np.int32),
            "label_vid": (np.arange(b) % 2).astype(np.int32),
            "row_mask": np.ones(b, np.float32)}


# ------------------------------------------------------------- the key


class _Tiny(torch.nn.Module):
    """Stands in for the CapsNet where only the attributes the key reads
    matter."""

    def __init__(self):
        super().__init__()
        self.enc = torch.nn.Linear(3, 4)
        self.bn = layers.TorchBatchNorm(4)
        self.drop_enc, self.drop_dec = layers.Dropout3d(0.5), layers.Dropout3d(0.5)
        self.bn_groups, self.dropout_rate, self.remat_encoder = 2, 0.5, False


def _tiny_state():
    model = _Tiny()
    return TrainState(model, make_optimizer(model.parameters(), 1e-4),
                      torch.Generator().manual_seed(0))


def _key(state, batch=None, epoch=12.0):
    return graph.graph_key(state, _batch() if batch is None else batch, epoch,
                           BV["thresh_epoch"])


def _restore_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32, layers.BN_ONEPASS_MIN,
             port_step._PACKED_PREP)

    def restore():
        (torch.backends.cuda.matmul.allow_tf32, layers.BN_ONEPASS_MIN,
         port_step._PACKED_PREP) = saved
    return restore


def _bigger_batch(state):
    return _batch(b=4)


def _float_clips(state):
    b = _batch()
    return dict(b, data=b["data"].astype(np.float32) / 255)


def _no_row_mask(state):
    b = _batch()
    del b["row_mask"]
    return b


def _an_aug_view(state):
    b = _batch()
    return dict(b, aug_data=b["data"][:, :, :, ::-1].copy())


def _on_another_device(state):
    return {k: torch.from_numpy(v).to("meta") for k, v in _batch().items()}


def _thresh_crossed(state):
    return 1.0  # epoch below thresh_epoch: the all-ones pseudo-label mask


def _set(obj_attr, value):
    def change(state):
        obj, attr = obj_attr(state)
        setattr(obj, attr, value)
    return change


def _moved_parameter(state):
    p = next(state.model.parameters())
    p.data = p.data.clone()


def _new_optimizer(state):
    state.optimizer = make_optimizer(state.model.parameters(), 1e-4)


def _new_generator(state):
    state.generator = torch.Generator().manual_seed(0)


def _tf32_flag(state):
    torch.backends.cuda.matmul.allow_tf32 = not torch.backends.cuda.matmul.allow_tf32


def _bn_threshold(state):
    layers.BN_ONEPASS_MIN = 0


def _packed_prep(state):
    port_step._PACKED_PREP = not port_step._PACKED_PREP


# each: (a change of the batch returning the batch, or of the epoch returning
# a float, or of the state returning None)
KEY_CHANGES = {
    "batch size": _bigger_batch,
    "clip dtype": _float_clips,
    "row_mask absent": _no_row_mask,
    "aug_data present": _an_aug_view,
    "batch device": _on_another_device,
    "thresh_epoch branch": _thresh_crossed,
    "dropout_rate": _set(lambda s: (s.model, "dropout_rate"), 0.0),
    "drop_enc.rate": _set(lambda s: (s.model.drop_enc, "rate"), 0.0),
    "drop_dec.rate": _set(lambda s: (s.model.drop_dec, "rate"), 0.0),
    "bn_groups": _set(lambda s: (s.model, "bn_groups"), 1),
    "remat_encoder": _set(lambda s: (s.model, "remat_encoder"), True),
    "parameter address": _moved_parameter,
    "optimizer": _new_optimizer,
    "generator": _new_generator,
    "TF32": _tf32_flag,
    "BN one-pass threshold": _bn_threshold,
    "packed prep": _packed_prep,
}


@pytest.mark.parametrize("change", list(KEY_CHANGES))
def test_graph_key_changes_with(change):
    state, restore = _tiny_state(), _restore_flags()
    before = _key(state)
    try:
        out = KEY_CHANGES[change](state)
        if isinstance(out, dict):
            after = _key(state, batch=out)
        elif isinstance(out, float):
            after = _key(state, epoch=out)
        else:
            after = _key(state)
    finally:
        restore()
    assert before is not None and after is not None and after != before


def _forward_hook(state):
    return state.model.register_forward_hook(lambda *a: None)


def _submodule_pre_hook(state):
    return state.model.bn.register_forward_pre_hook(lambda *a: None)


def _backward_hook(state):
    return state.model.enc.register_full_backward_hook(lambda *a: None)


def _parameter_hook(state):
    return next(state.model.parameters()).register_hook(lambda g: g)


def _post_accumulate_hook(state):
    return next(state.model.parameters()).register_post_accumulate_grad_hook(lambda p: None)


def _global_hook(state):
    return torch.nn.modules.module.register_module_forward_hook(lambda *a: None)


EAGER_CAUSES = {"forward hook": _forward_hook, "submodule pre-hook": _submodule_pre_hook,
                "backward hook": _backward_hook, "parameter hook": _parameter_hook,
                "post-accumulate hook": _post_accumulate_hook, "global hook": _global_hook}


@pytest.mark.parametrize("cause", list(EAGER_CAUSES))
def test_graph_key_is_none_under_a_hook(cause):
    """A replay would fire no hook: a hooked model takes the eager step,
    and takes the graph again once the hook is gone."""
    state = _tiny_state()
    before = _key(state)
    handle = EAGER_CAUSES[cause](state)
    try:
        assert _key(state) is None
    finally:
        handle.remove()
    assert _key(state) == before


@pytest.mark.parametrize("case", ["process group", "remat"])
def test_graph_key_is_none_in_a_process_group_or_with_remat(monkeypatch, case):
    """A process group keeps the step eager; the encoder's activation
    checkpoint no longer does (it reads no generator state): it takes a
    key of its own."""
    state = _tiny_state()
    plain = _key(state)
    assert plain is not None
    if case == "process group":
        monkeypatch.setattr(mesh, "is_active", lambda: True)
        assert _key(state) is None
    else:
        state.model.remat_encoder = True
        remat = _key(state)
        assert remat is not None and remat != plain


@pytest.mark.parametrize("model", ["tiny", "capsnet"])
def test_graph_key_keeps_no_model_alive(model):
    """The key's per-model cache of modules and tensors holds no
    reference to the model: a state that goes out of use frees its model
    and its parameters, whose addresses the key read."""
    state = (_tiny_state() if model == "tiny"
             else create_train_state(seed=0, device="cpu", bn_groups=2))
    assert _key(state) is not None
    refs = [weakref.ref(state.model), weakref.ref(next(state.model.parameters()))]
    del state
    gc.collect()
    assert [r() for r in refs] == [None, None]


def test_graph_key_holds_across_what_a_replay_reads_from_tensors():
    """wt_ramp is no argument of the key; the learning rate, an epoch on
    the same side of thresh_epoch, a new batch of the same layout and the
    batch as tensors leave the key as it is."""
    state = _tiny_state()
    key = _key(state)
    state.with_learning_rate(3e-5)
    assert _key(state, epoch=13.5) == _key(state, epoch=12) == key
    assert _key(state, batch=_batch(seed=5)) == key
    assert _key(state, batch={k: torch.from_numpy(v) for k, v in _batch().items()}) == key
    assert _key(state, batch=dict(_batch(), index=np.arange(3))) == key  # not read by the step


# ---------------------------------------------------- GraphedStep's dispatch


class _StubbedGraphs(graph.GraphedStep):
    """GraphedStep with the capture and replay recorded, not run."""

    def __init__(self):
        self.log = []
        super().__init__(self._eager, None, lambda state: None, BV["thresh_epoch"],
                         torch.device("cpu"))

    def _eager(self, state, batch, epoch, wt_ramp):
        self.log.append("eager")
        return state, {}

    def _on_capture_stream(self, fn, *args):
        self.log.append("warm")
        return fn(*args)

    def _capture(self, key, state, batch, epoch):
        if len(self.graphs) >= graph.MAX_GRAPHS:
            self.graphs.popitem(last=False)
        self.graphs[key] = ("graph", len(self.graphs))
        self._seen.pop(key, None)
        self.log.append("capture")
        return self.graphs[key]

    def _replay(self, g, state, batch, wt_ramp):
        self.log.append("replay")
        return state, {}


def test_graphed_step_warms_captures_and_replays_per_key():
    state, step = _tiny_state(), _StubbedGraphs()
    for _ in range(graph.WARMUP + 3):
        step(state, _batch(), 12.0, 0.5)
    want = ["warm", "eager"] * graph.WARMUP + ["capture", "replay"] + ["replay"] * 2
    assert step.log == want
    step.log.clear()
    step(state, _batch(), 1.0, 0.5)  # the other side of thresh_epoch: a key of its own
    assert step.log == ["warm", "eager"]
    step.log.clear()
    handle = state.model.register_forward_hook(lambda *a: None)
    step(state, _batch(), 12.0, 0.5)  # hooked: the eager step, on the caller's stream
    handle.remove()
    step(state, _batch(), 12.0, 0.5)
    assert step.log == ["eager", "replay"]


def test_graphed_step_keeps_at_most_max_graphs():
    state, step = _tiny_state(), _StubbedGraphs()
    for b in range(1, graph.MAX_GRAPHS + 2):  # one batch size a key
        for _ in range(graph.WARMUP + 1):
            step(state, _batch(b=b), 12.0, 0.5)
    assert step.log.count("capture") == graph.MAX_GRAPHS + 1
    assert len(step.graphs) == graph.MAX_GRAPHS
    assert _key(state, batch=_batch(b=1)) not in step.graphs  # the least recently used went


def test_make_train_step_is_eager_on_the_cpu():
    step = make_train_step(LossConfig(**BV), device="cpu")
    assert not isinstance(step, graph.GraphedStep)


# -------------------------------------- the ramp and the lr as tensors


def _fused_adam(params, lr):
    """The card's optimizer on the CPU: FusedAdam with its 0-d lr tensor
    (torch's capturable update exists only on a card)."""
    return FusedAdam(params, lr=torch.tensor(lr, dtype=torch.float32), eps=1e-6, fused=True)


def _step_state(sd, fused: bool, lr: float = 2e-4):
    state = create_train_state(state_dict=sd, device="cpu", compute_dtype=torch.float32,
                               bn_groups=2, dropout_rate=0.0, lr=lr)
    if fused:
        state.optimizer = _fused_adam(state.model.parameters(), lr)
    return state


def _one_step(state, batch, wt_ramp):
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, m = make_train_step(LossConfig(**BV), device="cpu")(state, batch, 12.0, wt_ramp)
    return ({k: v.item() for k, v in m.items()},
            {n: p.grad.clone() for n, p in state.model.named_parameters()},
            {n: b.clone() for n, b in state.model.named_buffers()},
            {n: p.detach() - before[n] for n, p in state.model.named_parameters()},
            {n: p.detach().clone() for n, p in state.model.named_parameters()})


def _equal(a: dict, b: dict) -> list:
    return [k for k in a if not torch.equal(a[k], b[k])]


def test_tensor_ramp_and_lr_give_the_float_path_bit_for_bit():
    """One step at 80^2, batch 2, f32, dropout 0, ramp 0.3 (not exact in
    f32), the fused Adam at lr 2e-4: fed the ramp as a 0-d f64 tensor and
    the lr as the 0-d f32 tensor the graphed step reads, against the float
    path.  Metrics, gradients and BN running stats bit for bit the float
    path's (the CPU's plain Adam); the update bit for bit the fused Adam's
    at the same lr as a float; and against plain Adam, whose update rounds
    in another order, within ADAM_UPDATE_L2."""
    sd, batch = pinned_fixture_sd(), _batch()
    ramp = 0.3
    plain = _one_step(_step_state(sd, fused=False), batch, ramp)
    fused_state = _step_state(sd, fused=True)
    lr = fused_state.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
    tensors = _one_step(fused_state, batch, torch.tensor(ramp, dtype=torch.float64))
    assert plain[0] == tensors[0]
    for a, b, what in zip(plain[1:3], tensors[1:3], ("grads", "BN stats")):
        assert not _equal(a, b), (what, _equal(a, b)[:5])
    float_lr = _step_state(sd, fused=False)
    float_lr.optimizer = torch.optim.Adam(float_lr.model.parameters(), lr=lr.item(), eps=1e-6,
                                          fused=True)
    fused_float = _one_step(float_lr, batch, ramp)
    assert not _equal(fused_float[3], tensors[3]) and not _equal(fused_float[4], tensors[4])
    num = sum(float((tensors[3][n] - u).double().square().sum()) for n, u in plain[3].items())
    den = sum(float(u.double().square().sum()) for u in plain[3].values())
    assert (num / den) ** 0.5 <= ADAM_UPDATE_L2, (num / den) ** 0.5


@pytest.mark.parametrize("name", list(LOSS_CFGS))
def test_loss_assembly_with_a_tensor_ramp_matches_jax(name):
    """test_torch_train_step.py's loss-assembly check with the ramp a 0-d
    f64 tensor: the JAX package's losses and gradients, and the float
    path's bit for bit."""
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

    def port(ramp):
        seg_t = torch.from_numpy(seg).requires_grad_()
        scores_t = torch.from_numpy(scores).requires_grad_()
        total, mt = compute_losses(
            seg_t[:b], seg_t[b:], scores_t[:b],
            torch.from_numpy(batch["loc_msk"][..., 0]).float(),
            torch.from_numpy(batch["action"]).long(), torch.from_numpy(batch["label_vid"]).float(),
            torch.from_numpy(batch["row_mask"]), LossConfig(**cfg), ramp)
        return mt, torch.autograd.grad(total, (seg_t, scores_t))

    mt, (g_seg, g_scores) = port(torch.tensor(0.7, dtype=torch.float64))
    mf, grads_f = port(0.7)
    assert set(mt) == set(mj)
    for k in mj:
        assert torch.equal(mt[k], mf[k]), k
        np.testing.assert_allclose(float(mt[k].detach()), float(mj[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert torch.equal(g_seg, grads_f[0]) and torch.equal(g_scores, grads_f[1])
    np.testing.assert_allclose(g_seg.numpy(), np.asarray(new.opt_state["seg"]),
                               rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(g_scores.numpy(), np.asarray(new.opt_state["scores"]),
                               rtol=1e-4, atol=1e-8)


# ------------------------------------------------ the fused Adam's tensors


def _params(seed=0, n=3):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(5, 3, generator=g)) for _ in range(n)]


def _steps(opt, params, n=3):
    for i in range(n):
        for p in params:
            p.grad = torch.sin(p.detach() * (i + 1))
        opt.step()


def test_with_learning_rate_fills_a_tensor_lr_in_place():
    state = _tiny_state()
    state.optimizer = _fused_adam(state.model.parameters(), 1e-4)
    lr = state.optimizer.param_groups[0]["lr"]
    state.with_learning_rate(3e-5)
    assert state.optimizer.param_groups[0]["lr"] is lr
    assert lr.item() == np.float32(3e-5) and state.learning_rate() == lr.item()


def test_fused_state_dict_loads_into_plain_adam():
    """bench/check.py loads the card optimizer's state_dict into a CPU
    Adam: the plain form (float lr, fused off, CPU steps), and the same
    next update as the fused optimizer's."""
    pa, pb = _params(), _params()
    fused = _fused_adam(pa, 1e-3)
    _steps(fused, pa)
    sd = fused.state_dict()
    group = sd["param_groups"][0]
    assert isinstance(group["lr"], float) and not group["fused"] and not group["capturable"]
    assert all(s["step"].device.type == "cpu" and s["step"].item() == 3
               for s in sd["state"].values())
    assert fused.state[pa[0]]["step"] is not sd["state"][0]["step"]  # the live one untouched
    for p, q in zip(pb, pa):
        p.data.copy_(q.data)
    plain = torch.optim.Adam(pb, lr=5.0, eps=1e-6)
    plain.load_state_dict(copy.deepcopy(sd))
    _steps(fused, pa, 1)
    _steps(plain, pb, 1)
    for p, q in zip(pa, pb):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7)


def test_load_state_dict_fills_the_live_tensors():
    """A resume (checkpoint/manager.py) loads into the fused optimizer in
    place: its lr tensor, moments and step counts keep their storage,
    where a captured graph reads them, and take the loaded values."""
    pa, pb = _params(), _params(seed=1)
    fused = _fused_adam(pa, 1e-3)
    _steps(fused, pa)
    live = {"lr": fused.param_groups[0]["lr"]}
    live.update({(i, k): v for i, p in enumerate(pa) for k, v in fused.state[p].items()})
    other = torch.optim.Adam(pb, lr=2e-4, eps=1e-6)
    _steps(other, pb, 5)
    fused.load_state_dict(other.state_dict())
    group = fused.param_groups[0]
    assert group["lr"] is live["lr"] and live["lr"].item() == np.float32(2e-4)
    assert group["fused"] and isinstance(fused, FusedAdam)
    for (i, k), v in ((k, v) for k, v in live.items() if k != "lr"):
        assert fused.state[pa[i]][k] is v, (i, k)
        assert torch.equal(v.float(), other.state[pb[i]][k].float()), (i, k)
    _steps(fused, pa, 1)
    assert all(fused.state[p]["step"].item() == 6 for p in pa)


# ------------------------------------------------------ the launch counters


def test_launch_state_difference_and_addition():
    saved = profiling.launch_state()
    try:
        before = profiling.launch_state()
        composite_convt.launches += 1
        tapconv.tap_conv_fwd.launches += 2
        tapconv.tap_conv_fwd.launches_by_co[512] = tapconv.tap_conv_fwd.launches_by_co.get(
            512, 0) + 2
        convops.max_pool_bwd.launches_by_c[64] = convops.max_pool_bwd.launches_by_c.get(64, 0) + 1
        after = profiling.launch_state()
        delta = profiling.launches_between(before, after)
        assert delta == {(composite_convt, "launches"): 1,
                         (tapconv.tap_conv_fwd, "launches"): 2,
                         (tapconv.tap_conv_fwd, "launches_by_co"): {512: 2},
                         (convops.max_pool_bwd, "launches_by_c"): {64: 1}}
        profiling.set_launch_state(before)
        assert profiling.launch_state() == before
        profiling.add_launches(delta)
        profiling.add_launches(delta)
        twice = profiling.launches_between(before, profiling.launch_state())
        assert twice == {k: ({c: 2 * n for c, n in v.items()} if isinstance(v, dict) else 2 * v)
                         for k, v in delta.items()}
    finally:
        profiling.set_launch_state(saved)
