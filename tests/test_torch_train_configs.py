"""The JAX package's other train configurations on the port, CPU.

chip_smoke.py phase 16 runs them at full width on the card, graphed;
here, at 80^2, batch 2, f32, on the pinned fixture weights:

- the whole train step with the gradient-smoothness mask (`gv`, the
  reference's second published run, with the flags as the CLIs map
  --gv) and with both masks (`bv+gv`), against the JAX package's step
  with the same flags and both against float64, as
  tests/test_torch_train_step.py holds the bench's bv step: no farther
  from float64 than JAX is;
- the rematerialised encoder (`remat_encoder`): its checkpoint reads no
  generator state (a CUDA graph capture forbids the read), and its
  backward runs the encoder's whole forward again (every BN and every
  stride-1 pool stage twice a step: on the card K6 and max_pool_axis
  launch twice as often), with the plain step's losses.
"""

import numpy as np
import pytest
import torch

from picad_tpu_torch.config import LossConfig
from picad_tpu_torch.models import layers
from picad_tpu_torch.ops import convops
from picad_tpu_torch.train.state import create_train_state
from picad_tpu_torch.train.step import make_train_step
from tests.test_torch_model import few_torch_threads, pinned_fixture_sd  # noqa: F401
from tests.test_torch_train_step import (  # noqa: F401
    FARTHER_THAN_JAX,
    GRAD_L2_TOL,
    METRIC_RTOL,
    _batch,
    _check_stats,
    _float64_reference,
    _jax_step,
    _l2,
    _run_jax,
    jax_tie_rule,
)

# as the CLIs map --gv (no confidence clamps, gv_wt 0.5) and --bv --gv
CONFIGS = {"gv": dict(gv=True, wt_cons=0.1, thresh_epoch=11),
           "bv+gv": dict(bv=True, n_frames=5, gv=True, bv_wt=0.5, gv_wt=0.5, wt_cons=0.1,
                         thresh_epoch=11)}
EPOCH = 12.0  # past thresh_epoch: the pseudo-label branch


def _run_port(sd, batch, cfg, **model_kwargs):
    """(metrics, gradients, BN running stats) of one port step."""
    state = create_train_state(state_dict=sd, device="cpu", compute_dtype=torch.float32,
                               bn_groups=2, dropout_rate=0.0, **model_kwargs)
    state, mt = make_train_step(LossConfig(**cfg), device="cpu")(state, batch, EPOCH, 0.5)
    return ({k: float(v) for k, v in mt.items()},
            {n: p.grad.numpy() for n, p in state.model.named_parameters()},
            {n: b.numpy() for n, b in state.model.named_buffers()})


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mask_configs_match_jax_against_float64(few_torch_threads, jax_tie_rule, name):
    """At the production routing eps: every metric within METRIC_RTOL of
    float64 and no farther from it than the JAX step's (x
    FARTHER_THAN_JAX); every gradient, and all of them together, no
    farther than JAX's (x FARTHER_THAN_JAX, or within GRAD_L2_TOL); BN
    running stats tight."""
    cfg, sd, batch = CONFIGS[name], pinned_fixture_sd(), _batch()
    m64, g64, s64 = _float64_reference(sd, batch, EPOCH, cfg)
    mj, jax_tree = _run_jax(*_jax_step(sd, cfg), batch, EPOCH)
    mt, gt, st = _run_port(sd, batch, cfg)

    assert mt["acc"] == mj["acc"] == m64["acc"]
    for k in ("loss", "loss_seg", "loss_cls", "loss_consistency"):
        d_port, d_jax = abs(mt[k] - m64[k]), abs(mj[k] - m64[k])
        assert d_port <= METRIC_RTOL * abs(m64[k]), (k, mt[k], m64[k])
        assert d_port <= max(FARTHER_THAN_JAX * d_jax, 1e-6 * abs(m64[k])), (k, d_port, d_jax)

    assert set(gt) == set(g64) and len(g64) == 158
    for pname, ref in g64.items():
        e_port, e_jax = _l2(gt[pname], ref), _l2(jax_tree[pname], ref)
        assert e_port <= max(FARTHER_THAN_JAX * e_jax, GRAD_L2_TOL), (pname, e_port, e_jax)
    e_port, e_jax = _l2(gt, g64), _l2(jax_tree, g64)
    assert e_port <= max(FARTHER_THAN_JAX * e_jax, GRAD_L2_TOL), ("all", e_port, e_jax)
    _check_stats(st, s64, jax_tree)


def test_remat_step_reads_no_generator_state(few_torch_threads, monkeypatch):
    """The encoder's checkpoint neither saves nor restores a generator's
    state (the encoder draws no random numbers; a capture forbids the
    read): the remat step runs with torch.get_rng_state raising, and
    gives the plain step's metrics and gradients."""
    sd, batch = pinned_fixture_sd(), _batch()
    m0, g0, _ = _run_port(sd, batch, CONFIGS["bv+gv"])

    def no_read(*args, **kwargs):
        raise AssertionError("the step read the generator's state")

    monkeypatch.setattr(torch, "get_rng_state", no_read)
    m1, g1, _ = _run_port(sd, batch, CONFIGS["bv+gv"], remat_encoder=True)
    assert m1 == m0
    for n, g in g0.items():
        np.testing.assert_array_equal(g1[n], g, err_msg=n)


def test_remat_backward_runs_the_encoder_forward_again(few_torch_threads, monkeypatch):
    """Every BN of the model lies in the encoder, and with remat_encoder
    the backward calls each once more, and each stride-1 pool stage's
    forward once more: 45 BNs and 16 stages a plain step, 90 and 32 with
    remat (the card's K6 and max_pool_axis launches double), the stages'
    backward 16 either way."""
    calls = {"bn": 0, "fwd": 0, "bwd": 0}

    def counted(key, fn):
        def call(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(convops, "max_pool_axis_plain",
                        counted("fwd", convops.max_pool_axis_plain))
    monkeypatch.setattr(convops, "max_pool_axis_bwd_plain",
                        counted("bwd", convops.max_pool_axis_bwd_plain))
    batch = _batch()
    got = {}
    for remat in (False, True):
        state = create_train_state(seed=0, device="cpu", compute_dtype=torch.float32,
                                   bn_groups=2, dropout_rate=0.0, remat_encoder=remat)
        bns = [m for m in state.model.modules() if isinstance(m, layers.TorchBatchNorm)]
        assert len(bns) == 45 and all(any(m is b for m in state.model.conv1.modules())
                                      for b in bns)
        for m in bns:
            m.register_forward_pre_hook(lambda *a: calls.__setitem__("bn", calls["bn"] + 1))
        calls.update(bn=0, fwd=0, bwd=0)
        _, metrics = make_train_step(LossConfig(**CONFIGS["gv"]), device="cpu")(
            state, batch, EPOCH, 0.5)
        got[remat] = (dict(calls), {k: float(v) for k, v in metrics.items()})
    assert got[False][0] == {"bn": 45, "fwd": 16, "bwd": 16}
    assert got[True][0] == {"bn": 90, "fwd": 32, "bwd": 16}
    assert got[True][1] == got[False][1]
