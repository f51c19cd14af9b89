"""Port ops (picad_tpu_torch.ops) vs the JAX ops on the same arrays, CPU f32.

The JAX side runs at the `highest` matmul precision tests/conftest.py
sets; the port runs torch's CPU kernels in f32.  Layouts differ (the port
is channels-first with torch-layout weights inside its models), so each
test transposes the same numpy arrays for each side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picad_tpu.ops import convops as jconv
from picad_tpu.ops import fused_head as jfused
from picad_tpu.ops.em_routing import em_routing as j_em_routing
from picad_tpu_torch.ops import convops as tconv
from picad_tpu_torch.ops import fused_head as tfused
from picad_tpu_torch.ops.em_routing import em_routing as t_em_routing
from picad_tpu_torch.ops.fused_head_kernel import (
    composite_convt,
    composite_convt_library,
    composite_convt_plain,
)
from tests.test_torch_model import few_torch_threads  # noqa: F401

OPS_ATOL = 1e-5  # f32 convolution/reduction order differences only


def _cl_to_cf(a):  # (N, *sp, C) -> (N, C, *sp)
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


def _cf_to_cl(a):
    return np.moveaxis(np.asarray(a), 1, -1)


@pytest.mark.parametrize(
    "sp,k,stride,padding",
    [
        ((5, 17, 15), (7, 7, 7), (2, 2, 2), "SAME"),  # the stem, odd sizes
        ((3, 9, 8), (3, 3, 3), (2, 1, 1), "SAME"),
        ((12, 11), (9, 9), (1, 1), "VALID"),  # PrimaryCaps
        ((7, 6), (3, 3), (1, 1), 1),  # conv28
    ],
)
def test_conv_nd_matches_jax(sp, k, stride, padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *sp, 5)).astype(np.float32)
    w = rng.standard_normal((*k, 5, 6)).astype(np.float32) * 0.1  # (*k, I, O)
    ref = jconv.conv_nd(jnp.asarray(x), jnp.asarray(w), stride, padding)
    w_t = np.ascontiguousarray(np.moveaxis(w, (-1, -2), (0, 1)))  # (O, I, *k)
    out = tconv.conv_nd(torch.from_numpy(_cl_to_cf(x)), torch.from_numpy(w_t),
                        stride, padding)
    np.testing.assert_allclose(_cf_to_cl(out), np.asarray(ref), atol=OPS_ATOL)


@pytest.mark.parametrize(
    "sp,k,stride,padding,op",
    [((2, 7, 6), (3, 3, 3), 2, 1, 1), ((4, 5), (9, 9), 1, 0, 0)],
)
def test_conv_transpose_nd_matches_jax(sp, k, stride, padding, op):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *sp, 4)).astype(np.float32)
    w = rng.standard_normal((*k, 4, 3)).astype(np.float32) * 0.1  # (*k, I, O)
    ref = jconv.conv_transpose_nd(jnp.asarray(x), jnp.asarray(w), stride, padding, op)
    w_t = np.ascontiguousarray(np.moveaxis(w, (-2, -1), (0, 1)))  # (I, O, *k)
    out = tconv.conv_transpose_nd(torch.from_numpy(_cl_to_cf(x)),
                                  torch.from_numpy(w_t), stride, padding, op)
    np.testing.assert_allclose(_cf_to_cl(out), np.asarray(ref), atol=OPS_ATOL)


@pytest.mark.parametrize(
    "k,s", [((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (2, 1, 1)), ((3, 3, 3), (1, 1, 1))]
)
def test_max_pool_same_zero_pad_matches_jax(k, s):
    """Negative inputs: zero padding (not -inf) shows at the borders."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 9, 8, 4)).astype(np.float32) - 0.5
    ref = np.asarray(jconv.max_pool_same_zero_pad(jnp.asarray(x), k, s))
    out = _cf_to_cl(tconv.max_pool_same_zero_pad(torch.from_numpy(_cl_to_cf(x)), k, s))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=OPS_ATOL)
    assert (ref == 0).any()  # a border window saw only padding and negatives


@pytest.mark.parametrize("iters", [1, 3])
def test_em_routing_matches_jax(iters):
    """One iteration: port == JAX to OPS_ATOL.  Three iterations: the
    reference's cost_std quirk (sum over C before the square, so the std
    is ~sqrt(eps) plus f32 rounding noise) amplifies summation order, and
    two f32 implementations differ by ~5e-5 on mu and ~3e-4 on a_out at
    this shape; each is that far from float64.  So there the port must be
    no farther from the float64 oracle than the JAX package is."""
    from tests.test_em_routing import oracle

    rng = np.random.default_rng(3)
    b, Bi, C, psize = 8, 32, 24, 16
    v = rng.standard_normal((b, Bi, C, psize)).astype(np.float32)
    a = rng.uniform(0, 1, (b, Bi, 1)).astype(np.float32)
    bu = rng.standard_normal((C, psize)).astype(np.float32)
    ba = rng.standard_normal(C).astype(np.float32)
    mu_j, a_j = j_em_routing(*(jnp.asarray(t) for t in (v, a, bu, ba)), iters=iters)
    mu_t, a_t = t_em_routing(*(torch.from_numpy(t) for t in (v, a, bu, ba)), iters=iters)
    assert a_t.dtype == torch.float32
    mu_j, a_j, mu_t, a_t = (np.asarray(t) for t in (mu_j, a_j, mu_t, a_t))
    if iters == 1:
        np.testing.assert_allclose(mu_t, mu_j, atol=OPS_ATOL)
        np.testing.assert_allclose(a_t, a_j, atol=OPS_ATOL)
        return
    mu64, a64 = oracle(*(t.astype(np.float64) for t in (v, a, bu, ba)), iters=iters)
    for port, ref_jax, exact in ((mu_t, mu_j, mu64), (a_t, a_j, a64)):
        err_port = np.abs(port - exact).max()
        err_jax = np.abs(ref_jax - exact).max()
        assert err_port <= 1.5 * err_jax + OPS_ATOL, (err_port, err_jax)


def test_em_routing_bf16_keeps_f32_activation_chain():
    """Mixed precision: mu in the vote type, a_out always f32 and close to
    the all-f32 routing (bf16 votes carry ~3 significant digits, which the
    cost_std quirk amplifies to ~1.5e-3 here)."""
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.standard_normal((4, 32, 5, 16)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0, 1, (4, 32, 1)).astype(np.float32))
    bu, ba = torch.zeros(5, 16), torch.zeros(5)
    mu, a_out = t_em_routing(v.bfloat16(), a.bfloat16(), bu, ba)
    assert mu.dtype == torch.bfloat16 and a_out.dtype == torch.float32
    _, a_ref = t_em_routing(v, a, bu, ba)
    np.testing.assert_allclose(a_out.numpy(), a_ref.numpy(), atol=5e-3)


COMPOSITE_ATOL = 5e-5  # f32 sums of 125 taps x 128 channels in other orders


def _composite_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    B, T, H, W, C = shape
    x = rng.standard_normal(shape).astype(np.float32)
    Kc = (rng.standard_normal((B, 5, 5, 5, C)) * 0.1).astype(np.float32)
    return x, Kc


def test_composite_convt_plain_matches_pallas_interpret():
    """The plain version vs the TPU kernel itself, run in Pallas interpret
    mode, and vs the grouped-ConvT library yardstick."""
    from picad_tpu.ops.pallas_fused_head import composite_convt as pallas_convt

    x, Kc = _composite_inputs((1, 2, 32, 8, 128), seed=5)
    ref = np.asarray(pallas_convt(jnp.asarray(x), jnp.asarray(Kc), True))
    xt, kt = torch.from_numpy(x), torch.from_numpy(Kc)
    out = composite_convt_plain(xt, kt)
    assert out.shape == (1, 4, 64, 16) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=COMPOSITE_ATOL)
    np.testing.assert_allclose(composite_convt_library(xt, kt).numpy(), ref,
                               atol=COMPOSITE_ATOL)


@pytest.mark.parametrize("shape", [(2, 3, 20, 13, 16), (1, 1, 5, 7, 8)])
def test_composite_convt_cpu_wrapper_is_plain_raw_fused(shape):
    """On a CPU tensor the wrapper runs the plain version (no launch
    counted); it equals the JAX _raw_fused XLA formulation at ragged
    shapes, T = 1 included."""
    x, Kc = _composite_inputs(shape, seed=6)
    B, C = shape[0], shape[-1]
    M = 4
    rng = np.random.default_rng(7)
    k1 = (rng.standard_normal((3, 3, 3, C, M)) * 0.2).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, 3, M, 1)) * 0.2).astype(np.float32)
    drop = (rng.random((B, M)) > 0.4).astype(np.float32) * 2.0
    ref = np.asarray(jfused._raw_fused(*(jnp.asarray(t) for t in (x, k1, k2, drop))))
    P = tfused.compose_transpose_kernels(
        torch.from_numpy(np.moveaxis(k1, (3, 4), (0, 1)).copy()),
        torch.from_numpy(np.moveaxis(k2, (3, 4), (0, 1)).copy()),
    )
    Kc_t = torch.einsum("cmtuv,bm->btuvc", P, torch.from_numpy(drop))
    before = composite_convt.launches
    out = composite_convt(torch.from_numpy(x), Kc_t)
    assert composite_convt.launches == before
    np.testing.assert_allclose(out.numpy(), ref, atol=COMPOSITE_ATOL)


def test_composite_convt_rejects_other_devices_and_shapes():
    x = torch.zeros((1, 2, 4, 4, 8), device="meta")
    with pytest.raises(ValueError):
        composite_convt(x, torch.zeros((1, 5, 5, 5, 8), device="meta"))
    with pytest.raises(ValueError):
        composite_convt(torch.zeros((1, 2, 4, 4, 8)), torch.zeros((1, 125, 8)))


def _head_inputs(B=2, T=3, H=20, W=12, C=16, M=8, seed=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    k1 = (rng.standard_normal((3, 3, 3, C, M)) * 0.1).astype(np.float32)
    b4 = rng.standard_normal(M).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, 3, M, 1)) * 0.1).astype(np.float32)
    bs = rng.standard_normal(1).astype(np.float32)
    drop = (rng.random((B, M)) > 0.5).astype(np.float32) * 2.0
    return x, k1, b4, k2, bs, drop


HEAD_ATOL = 1e-4


def test_fused_decoder_head_matches_jax_and_literal_chain():
    x, k1, b4, k2, bs, drop = _head_inputs()
    ref = np.asarray(jfused.fused_decoder_head(
        *(jnp.asarray(t) for t in (x, k1, b4, k2, bs, drop))))
    k1_t = torch.from_numpy(np.moveaxis(k1, (3, 4), (0, 1)).copy())  # (C, M, 3,3,3)
    k2_t = torch.from_numpy(np.moveaxis(k2, (3, 4), (0, 1)).copy())  # (M, 1, 3,3,3)
    b4_t, bs_t, drop_t = (torch.from_numpy(t) for t in (b4, bs, drop))
    out = tfused.fused_decoder_head(torch.from_numpy(x), k1_t, b4_t, k2_t, bs_t, drop_t)
    assert out.shape == (2, 6, 40, 24)
    np.testing.assert_allclose(out.numpy(), ref, atol=HEAD_ATOL)

    # the literal chain the fusion replaces, in the port's own ops
    xc = torch.from_numpy(_cl_to_cf(x))
    y = tconv.conv_transpose_nd(xc, k1_t, 2, 1, 1) + b4_t.view(1, -1, 1, 1, 1)
    y = y * drop_t[:, :, None, None, None]
    lit = tconv.conv_transpose_nd(y, k2_t, 1, 1, 0)[:, 0] + bs_t
    np.testing.assert_allclose(out.numpy(), lit.numpy(), atol=HEAD_ATOL)


def test_smooth_bias_map_matches_jax():
    _, _, _, k2, _, _ = _head_inputs()
    ref = np.asarray(jfused.smooth_bias_map(jnp.asarray(k2), (6, 12, 10)))
    k2_t = torch.from_numpy(np.moveaxis(k2, (3, 4), (0, 1)).copy())
    out = tfused.smooth_bias_map(k2_t, (6, 12, 10))
    np.testing.assert_allclose(out.numpy(), ref, atol=OPS_ATOL)
