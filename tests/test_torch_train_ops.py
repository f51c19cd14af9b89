"""The training slice's ops in the port vs the JAX package, CPU.

Same numpy inputs (seeded) through both packages; the JAX side runs its
Pallas kernels in interpret mode where it has them (K2, K6), as its own
tests do on the CPU, and at the `highest` matmul precision that
tests/conftest.py sets.  Layouts differ (the port is channels-first with
torch-layout weights inside its models), so each test transposes the
same numpy arrays for each side.  Tolerances are stated beside each
test; the default OPS_ATOL covers f32 summation-order differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from picad_tpu.models import layers as jlayers
from picad_tpu.objectives import losses as jlosses
from picad_tpu.objectives import ramp_ups as jramps
from picad_tpu.ops import bn_stats as jbn
from picad_tpu.ops import convops as jconv
from picad_tpu.ops import fused_head as jfused
from picad_tpu.ops import masks as jmasks
from picad_tpu.ops.em_routing import em_routing as j_em_routing
from picad_tpu.train import optimizer as joptim
from picad_tpu_torch.models import layers as tlayers
from picad_tpu_torch.objectives import losses as tlosses
from picad_tpu_torch.objectives import ramp_ups as tramps
from picad_tpu_torch.ops import bn_stats as tbn
from picad_tpu_torch.ops import convops as tconv
from picad_tpu_torch.ops import fused_head as tfused
from picad_tpu_torch.ops import masks as tmasks
from picad_tpu_torch.ops.em_routing import em_routing as t_em_routing
from picad_tpu_torch.ops.fused_head_kernel import (
    composite_convt,
    composite_convt_bwd,
    composite_convt_bwd_plain,
)
from picad_tpu_torch.train import optimizer as toptim
from tests.test_torch_model import few_torch_threads  # noqa: F401

OPS_ATOL = 1e-5  # f32 summation-order differences only


def _cl_to_cf(a):  # (N, *sp, C) -> (N, C, *sp)
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


def _cf_to_cl(a):
    return np.moveaxis(np.asarray(a), 1, -1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- K2


def _bwd_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    B, T, H, W, C = shape
    x = rng.standard_normal(shape).astype(np.float32)
    Kc = (rng.standard_normal((B, 5, 5, 5, C)) * 0.1).astype(np.float32)
    g = rng.standard_normal((B, 2 * T, 2 * H, 2 * W)).astype(np.float32)
    return g, x, Kc


# f32 sums over 125 taps (dx) or every position (dKc, values up to ~1e2)
# in other orders
COMPOSITE_TOL = dict(rtol=1e-5, atol=5e-5)


def test_composite_bwd_plain_matches_pallas_interpret():
    """The plain backward vs the TPU kernel K2 itself, in interpret mode."""
    from picad_tpu.ops.pallas_fused_head import _composite_bwd_impl, kernel_matrix

    g, x, Kc = _bwd_inputs((1, 2, 32, 8, 128), seed=0)
    dx_j, dk_j = _composite_bwd_impl(jnp.asarray(g), jnp.asarray(x),
                                     kernel_matrix(jnp.asarray(Kc)), interpret=True)
    before = composite_convt_bwd.launches
    dx, dKc = composite_convt_bwd(_t(g), _t(x), _t(Kc))  # CPU: the plain version
    assert composite_convt_bwd.launches == before
    assert dx.dtype == torch.float32 and dKc.shape == Kc.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **COMPOSITE_TOL)
    np.testing.assert_allclose(dKc.numpy().reshape(1, 125, 128),
                               np.asarray(dk_j)[:, :125], **COMPOSITE_TOL)


@pytest.mark.parametrize("shape", [(2, 3, 32, 12, 16), (1, 1, 32, 5, 8)])
def test_composite_bwd_plain_matches_jax_vjp(shape):
    """vs jax.vjp of the JAX composite_convt (its XLA backward branch)."""
    from picad_tpu.ops.pallas_fused_head import composite_convt as j_convt

    g, x, Kc = _bwd_inputs(shape, seed=1)
    _, vjp = jax.vjp(lambda a, k: j_convt(a, k, True), jnp.asarray(x), jnp.asarray(Kc))
    dx_j, dKc_j = vjp(jnp.asarray(g))
    xt, kt = _t(x).requires_grad_(True), _t(Kc).requires_grad_(True)
    dx, dKc = torch.autograd.grad(composite_convt(xt, kt), (xt, kt), _t(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **COMPOSITE_TOL)
    np.testing.assert_allclose(dKc.numpy(), np.asarray(dKc_j), **COMPOSITE_TOL)


def test_composite_convt_gradcheck_f64():
    """The autograd.Function (plain forward and backward on the CPU)
    against finite differences, in float64."""
    g, x, Kc = _bwd_inputs((1, 2, 3, 2, 3), seed=2)
    xt = _t(x).double().requires_grad_(True)
    kt = _t(Kc).double().requires_grad_(True)
    assert torch.autograd.gradcheck(composite_convt, (xt, kt))


def test_composite_bwd_rounds_g_to_x_type():
    """bf16 x: g is rounded to bf16 first and dx returns in bf16, as the
    JAX backward does (pallas_fused_head.py:463)."""
    g, x, Kc = _bwd_inputs((1, 2, 4, 3, 8), seed=3)
    xb = _t(x).bfloat16()
    dx, dKc = composite_convt_bwd_plain(_t(g), xb, _t(Kc))
    dx_r, dKc_r = composite_convt_bwd_plain(_t(g).bfloat16().float(), xb.float(),
                                            _t(Kc).bfloat16().float())
    assert dx.dtype == torch.bfloat16 and dKc.dtype == torch.float32
    torch.testing.assert_close(dx, dx_r.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(dKc, dKc_r, rtol=0, atol=0)


# ------------------------------------------------------- the fused head


HEAD_GRAD_ATOL = 1e-4  # f32, gradients summed over up to 40*24*125 taps


def test_fused_head_gradients_match_jax():
    """Every input's gradient of the fused head, dropout on: both get the
    same numpy drop_scale (Bernoulli(keep)/keep of shape (B, M))."""
    rng = np.random.default_rng(4)
    B, T, H, W, C, M = 2, 3, 20, 12, 16, 8
    x = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    k1 = (rng.standard_normal((3, 3, 3, C, M)) * 0.1).astype(np.float32)
    b4 = rng.standard_normal(M).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, 3, M, 1)) * 0.1).astype(np.float32)
    bs = rng.standard_normal(1).astype(np.float32)
    drop = (rng.random((B, M)) < 0.5).astype(np.float32) / 0.5
    w = rng.standard_normal((B, 2 * T, 2 * H, 2 * W)).astype(np.float32)

    def jloss(x, k1, b4, k2, bs):
        return jnp.sum(jfused.fused_decoder_head(x, k1, b4, k2, bs, jnp.asarray(drop)) * w)

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(a) for a in (x, k1, b4, k2, bs)))
    ins = [_t(x), _t(np.moveaxis(k1, (3, 4), (0, 1))), _t(b4),
           _t(np.moveaxis(k2, (3, 4), (0, 1))), _t(bs)]
    for a in ins:
        a.requires_grad_(True)
    out = tfused.fused_decoder_head(*ins, _t(drop))
    gt = torch.autograd.grad((out * _t(w)).sum(), ins)
    ref = [np.asarray(gj[0]), np.moveaxis(np.asarray(gj[1]), (3, 4), (0, 1)),
           np.asarray(gj[2]), np.moveaxis(np.asarray(gj[3]), (3, 4), (0, 1)),
           np.asarray(gj[4])]
    for name, got, want in zip(("x", "k1", "b4", "k2", "bs"), gt, ref):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, atol=HEAD_GRAD_ATOL * scale,
                                   rtol=0, err_msg=name)


# ---------------------------------------------------------------- K6


def _jax_stats(x_cf, groups):
    xj = jnp.asarray(_cf_to_cl(x_cf))
    return jbn.group_stats(xj, groups, True)


@pytest.mark.parametrize("groups", [1, 2])
def test_bn_stats_plain_matches_pallas_interpret(groups):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((4, 8, 3, 16, 16)) * 2.0 + 1.5).astype(np.float32)
    mean_j, var_j = _jax_stats(x, groups)
    before = tbn.bn_stats.launches
    mean, var = tbn.bn_stats(_t(x), groups)
    assert tbn.bn_stats.launches == before
    assert mean.shape == var.shape == (groups, 8)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=1e-5, atol=OPS_ATOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=1e-5, atol=OPS_ATOL)


def test_bn_stats_cancellation_stress():
    """|mean| = 100 std (tests/test_bn_stats.py's stress case): the port's
    shift keeps it at two-pass accuracy, like the Pallas kernel."""
    rng = np.random.default_rng(6)
    base = rng.standard_normal((1, 8, 1, 1, 1)).astype(np.float32) * 100.0
    x = base + 0.1 * rng.standard_normal((4, 8, 4, 32, 32)).astype(np.float32)
    mean_j, var_j = _jax_stats(x, 2)
    mean, var = tbn.bn_stats(_t(x), 2)
    x64 = x.astype(np.float64).reshape(2, 2, 8, -1).transpose(0, 2, 1, 3).reshape(2, 8, -1)
    np.testing.assert_allclose(mean.numpy(), x64.mean(-1), rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), x64.var(-1), rtol=2e-4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=2e-4)


def test_group_stats_gradients_match_pallas_vjp():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 8, 2, 16, 16)) + 3.0).astype(np.float32)
    wm, wv = rng.standard_normal((2, 2, 8)).astype(np.float32)

    def jloss(xj):
        mean, var = jbn.group_stats(xj, 2, True)
        return jnp.sum(mean * wm) + jnp.sum(var * wv) + jnp.sum(mean * var)

    gj = _cl_to_cf(np.asarray(jax.grad(jloss)(jnp.asarray(_cf_to_cl(x)))))
    xt = _t(x).requires_grad_(True)
    mean, var = tbn.group_stats(xt, 2)
    (gt,) = torch.autograd.grad((mean * _t(wm)).sum() + (var * _t(wv)).sum()
                                + (mean * var).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), gj, atol=1e-6, rtol=1e-4)


# ------------------------------------------------------- train-mode BN


@pytest.mark.parametrize("onepass", [True, False])
@pytest.mark.parametrize("groups", [1, 2])
def test_batchnorm_train_matches_jax(monkeypatch, groups, onepass):
    """Train-mode BN: output, running stats after the per-group EMA, and
    the gradients of x, scale and bias.  onepass=True lowers both
    packages' one-pass threshold to 0 (the shifted stats: K6's plain
    version here, the JAX package's subsample-shift form there)."""
    thresh = 0 if onepass else 1 << 40
    monkeypatch.setattr(jlayers, "_BN_ONEPASS_MIN", thresh)
    monkeypatch.setattr(tlayers, "BN_ONEPASS_MIN", thresh)
    rng = np.random.default_rng(8)
    C = 6
    x = (rng.standard_normal((4, C, 3, 8, 8)) * 1.5 + 2.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    rmean = rng.standard_normal(C).astype(np.float32) * 0.1
    rvar = rng.uniform(0.5, 2.0, C).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    bn_j = jlayers.TorchBatchNorm(stats_groups=groups)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(rmean), "var": jnp.asarray(rvar)}}

    def jloss(params, xj):
        y, mut = bn_j.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            xj, use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(_cf_to_cl(w))), (y, mut["batch_stats"])

    (_, (y_j, stats_j)), (gp_j, gx_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(_cf_to_cl(x)))

    bn = tlayers.TorchBatchNorm(C, stats_groups=groups).train()
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(rmean))
        bn.running_var.copy_(_t(rvar))
    xt = _t(x).requires_grad_(True)
    y = bn(xt)
    gx, gs, gb = torch.autograd.grad((y * _t(w)).sum(), (xt, bn.weight, bn.bias))

    np.testing.assert_allclose(_cf_to_cl(y.detach()), np.asarray(y_j), atol=OPS_ATOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats_j["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats_j["var"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_cf_to_cl(gx), np.asarray(gx_j), atol=1e-4)
    np.testing.assert_allclose(gs.numpy(), np.asarray(gp_j["scale"]), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gp_j["bias"]), rtol=1e-4, atol=1e-3)


def test_dropout3d_zeroes_whole_channels_and_rescales():
    """Train-mode Dropout3d: every (sample, channel) map is either all
    zero or x / keep; the mask comes from the generator given; eval is
    the identity."""
    d = tlayers.Dropout3d(0.25).train()
    x = torch.rand(3, 40, 2, 4, 5) + 0.5
    y = d(x, torch.Generator().manual_seed(0))
    kept = (y != 0).flatten(2)
    assert bool((kept.all(-1) | (~kept).all(-1)).all())  # whole maps
    torch.testing.assert_close(y[y != 0], (x / 0.75)[y != 0])
    assert 0.5 < kept.all(-1).float().mean().item() < 0.95
    torch.testing.assert_close(d(x, torch.Generator().manual_seed(0)), y)
    assert torch.equal(d.eval()(x), x)


# ------------------------------------------------------------- pools


@pytest.mark.parametrize(
    "k,s",
    [((3, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 1, 1)),  # separable, all-ties backward
     ((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (2, 1, 1))],  # joint, first maximum
)
def test_max_pool_tied_backward_matches_jax(k, s):
    """Inputs drawn from {0, 1, 2} tie in almost every window: the stride-1
    pools send each window's gradient to every tied maximum, and the
    strided pools to the first maximum in scan order (XLA's
    select-and-scatter on the CPU), as in the JAX package."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 3, (2, 3, 6, 7, 4)).astype(np.float32)  # (N, T, H, W, C)
    y_j, vjp = jax.vjp(lambda a: jconv.max_pool_same_zero_pad(a, k, s), jnp.asarray(x))
    g = rng.standard_normal(y_j.shape).astype(np.float32)
    (gx_j,) = vjp(jnp.asarray(g))
    xt = _t(_cl_to_cf(x)).requires_grad_(True)
    y = tconv.max_pool_same_zero_pad(xt, k, s)
    (gx,) = torch.autograd.grad(y, xt, _t(_cl_to_cf(g)))
    np.testing.assert_array_equal(_cf_to_cl(y.detach()), np.asarray(y_j))
    np.testing.assert_allclose(_cf_to_cl(gx), np.asarray(gx_j), atol=1e-6)


# -------------------------------------------------------- EM routing


# EM routing at its production eps = 1e-8: the reference's cost_std sums
# over C before squaring, so it is sqrt(S^2 / C + eps) with S pure f32
# rounding noise of the size of sqrt(eps) here.  The activations, and
# above all the gradient of a_in, then carry that noise: between the two
# f32 implementations on these inputs, a_in's gradient differs by 31 %
# (one iteration) and 13 % (three) of its largest entry, v's and
# beta_u's by 3e-3 and 2e-3, beta_a's by 5e-5.  At eps = 1e-4 the noise
# no longer reaches cost_std and the packages agree to 2e-5: that is
# where the arithmetic is held tight.
EM_GRAD_TOL = {1e-4: 5e-5, 1e-8: 1e-2}  # of each gradient's largest entry


@pytest.mark.parametrize("iters,eps", [(1, 1e-4), (3, 1e-4), (3, 1e-8)])
def test_em_routing_gradients_match_jax(iters, eps):
    """EM routing is autograd-clean: the gradients of mu and a_out with
    respect to v, a_in, beta_u and beta_a match JAX's (a_in's only at
    eps = 1e-4, see EM_GRAD_TOL)."""
    rng = np.random.default_rng(10)
    b, Bi, C, psize = 4, 8, 5, 16
    ins = [rng.standard_normal((b, Bi, C, psize)).astype(np.float32),
           rng.uniform(0, 1, (b, Bi, 1)).astype(np.float32),
           rng.standard_normal((C, psize)).astype(np.float32),
           rng.standard_normal(C).astype(np.float32)]
    w_mu = rng.standard_normal((b, 1, C, psize)).astype(np.float32)
    w_a = rng.standard_normal((b, C)).astype(np.float32) * 1e3

    def jloss(*a):
        mu, a_out = j_em_routing(*a, iters=iters, eps=eps)
        return jnp.sum(mu * w_mu) + jnp.sum(a_out * w_a)

    gj = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in ins))
    ts = [_t(a).requires_grad_(True) for a in ins]
    mu, a_out = t_em_routing(*ts, iters=iters, eps=eps)
    gt = torch.autograd.grad((mu * _t(w_mu)).sum() + (a_out * _t(w_a)).sum(), ts)
    for name, got, want in zip(("v", "a_in", "beta_u", "beta_a"), gt, gj):
        if name == "a_in" and eps < 1e-4:
            continue
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, err_msg=name,
                                   atol=EM_GRAD_TOL[eps] * np.abs(want).max())


# ---------------------------------------------- masks, losses, ramps


@pytest.mark.parametrize("window,sig", [(3, False), (5, False), (5, True)])
def test_cyclic_variance_matches_jax(window, sig):
    rng = np.random.default_rng(11)
    p, f = rng.standard_normal((2, 2, 8, 6, 5)).astype(np.float32) * 3
    ref = jmasks.pixelwise_cyclic_variance(jnp.asarray(p), jnp.asarray(f),
                                           window=window, use_sigmoid=sig)
    out = tmasks.pixelwise_cyclic_variance(_t(p), _t(f), window=window, use_sigmoid=sig)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OPS_ATOL)
    assert float(out.min()) == 0.0 and float(out.max()) <= 1.0


@pytest.mark.parametrize("lo,hi", [(None, None), (0.2, 0.8)])
def test_pixelwise_gradient_matches_jax(lo, hi):
    rng = np.random.default_rng(12)
    p = rng.standard_normal((2, 8, 6, 5)).astype(np.float32) * 3
    ref = jmasks.pixelwise_gradient(jnp.asarray(p), conf_thresh_lower=lo, conf_thresh_upper=hi)
    out = tmasks.pixelwise_gradient(_t(p), conf_thresh_lower=lo, conf_thresh_upper=hi)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=OPS_ATOL)
    np.testing.assert_allclose(tmasks.temporal_gradient(_t(p), 1).numpy(),
                               np.gradient(p, axis=1), atol=1e-6)
    const = tmasks._minmax_normalize(torch.full((1, 2, 2, 2), 3.0), (1, 2, 3))
    assert torch.equal(const, torch.zeros_like(const))  # the +1e-7 guard


def test_weighted_mse_outer_matches_jax():
    """The gv consistency loss in its O(B) form, with and without a
    ragged row_mask (the step's supervised losses are checked with the
    whole loss assembly, tests/test_torch_train_step.py)."""
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((4, 8, 6, 5)).astype(np.float32) * 2
    other = rng.standard_normal((4, 8, 6, 5)).astype(np.float32)
    weight = rng.uniform(0, 1, (4, 8, 6, 5)).astype(np.float32)
    row_mask = np.array([1, 0, 1, 1], np.float32)
    for rm in (None, row_mask):
        got = tlosses.weighted_mse_outer(_t(logits), _t(other), _t(weight),
                                         None if rm is None else _t(rm))
        want = jlosses.weighted_mse_outer(logits, other, weight,
                                          None if rm is None else jnp.asarray(rm))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-7)


def test_ramps_match_jax():
    pairs = [(tramps.exp_rampup(n), jramps.exp_rampup(n)) for n in (1, 12, 30, 80)]
    for t, j in pairs:
        for e in (-1, 0, 1, 2.5, 7, 11, 29.9, 30, 36, 40, 55):
            assert t(e) == j(e), (t, e)


# ---------------------------------------------------------- optimizer


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_steps_match_optax(weight_decay):
    """Three steps of the port's optimizer (torch Adam / AdamW, eps 1e-6)
    vs the JAX package's optax one on the same gradients."""
    rng = np.random.default_rng(14)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    opt_j = joptim.make_optimizer(1e-2, weight_decay=weight_decay)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    sj = opt_j.init(pj)
    pt = {k: torch.nn.Parameter(_t(v.copy())) for k, v in p0.items()}
    opt_t = toptim.make_optimizer(pt.values(), 1e-2, weight_decay=weight_decay)
    for g in grads:
        upd, sj = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in pt.items():
            p.grad = _t(g[k])
        opt_t.step()
    for k in p0:
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_reduce_lr_on_plateau_matches_jax():
    t, j = toptim.ReduceLROnPlateau(1e-3, patience=2, cooldown=1), \
        joptim.ReduceLROnPlateau(1e-3, patience=2, cooldown=1)
    for m in (5.0, 4.0, 4.0, 4.1, 4.0, 3.9999, 4.2, 4.3, 4.4, 4.5, 1.0):
        assert t.step(m) == j.step(m)
        assert (t.best, t.num_bad_epochs, t.cooldown_counter) == \
            (j.best, j.num_bad_epochs, j.cooldown_counter)
