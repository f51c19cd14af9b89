"""The stride-1 max pools (picad_tpu_torch/ops/convops.py: _MaxPoolAxis,
max_pool_axis, max_pool_axis_bwd) against the JAX package's separable
pool and its all-ties backward (picad_tpu/ops/convops.py:148-268), CPU.

Every comparison is bit for bit (tolerance 0), in f32 and in bf16: both
packages take the same maximum, and sum a window's taps in the same f32
order before the one rounding to x's type.  The inputs tie in almost
every window (drawn from {0, 1, 2}), or are negative (the zero pads are
the maximum at the borders), and g holds planted inf and NaN (0 * inf is
NaN in both).  On a CPU tensor the wrappers run their plain versions and
launch nothing; csrc/max_pool_s1.cu is held to those plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picad_tpu.ops import convops as jconv
from picad_tpu_torch.ops import convops as tconv
from tests.test_torch_model import few_torch_threads  # noqa: F401

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the model's two stride-1 windows (models/i3d.py:145), at T 1 and 2
WINDOWS = [(3, 3, 3), (1, 3, 3)]


def _input(kind: str, shape, seed: int) -> np.ndarray:
    """f32 values every dtype holds exactly: {0, 1, 2} (ties), or negative
    multiples of 1/8 (the pads win at the borders)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(0, 3, shape).astype(np.float32)
    return -(rng.integers(1, 40, shape).astype(np.float32) / 8.0)


def _cotangent(shape, seed: int, planted: bool) -> np.ndarray:
    g = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if planted:
        flat = g.reshape(-1)
        flat[::7] = np.inf
        flat[3::11] = -np.inf
        flat[5::13] = np.nan
    return g


def _cf(a: np.ndarray, dtype) -> torch.Tensor:
    """channels-last numpy (f32) -> channels-first torch in dtype."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))).to(dtype)


def _cl(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _jax_f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("planted", [False, True])
@pytest.mark.parametrize("kind", ["ties", "negative"])
@pytest.mark.parametrize("t", [1, 2])
@pytest.mark.parametrize("k", WINDOWS)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_stride1_pool_and_gradient_match_jax_bit_for_bit(dt, k, t, kind, planted):
    """max_pool_same_zero_pad's forward and gradient through autograd
    against the JAX package's and jax.vjp's: equal arrays, NaN where
    NaN (tolerance 0)."""
    jdt, tdt = DTYPES[dt]
    shape = (2, t, 7, 6, 3)  # (N, T, H, W, C)
    x = _input(kind, shape, seed=t + len(kind))
    g = _cotangent(shape, seed=5, planted=planted)
    y_j, vjp = jax.vjp(lambda a: jconv.max_pool_same_zero_pad(a, k, (1, 1, 1)),
                       jnp.asarray(x, jdt))
    (gx_j,) = vjp(jnp.asarray(g, jdt))
    xt = _cf(x, tdt).requires_grad_(True)
    y = tconv.max_pool_same_zero_pad(xt, k, (1, 1, 1))
    (gx,) = torch.autograd.grad(y, xt, _cf(g, tdt))
    assert y.dtype == gx.dtype == tdt
    np.testing.assert_array_equal(_cl(y), _jax_f32(y_j))
    np.testing.assert_array_equal(_cl(gx), _jax_f32(gx_j))
    if kind == "negative":
        assert (_jax_f32(y_j) == 0).any()  # a border window's maximum is a pad


@pytest.mark.parametrize("k", [2, 3, 4, 5])
@pytest.mark.parametrize("dim", [2, 3, 4])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_one_stage_plain_versions_match_jax_bit_for_bit(dt, dim, k):
    """max_pool_axis_plain and max_pool_axis_bwd_plain (the kernels'
    plain versions) along each axis, at even windows too (pads lo = (k -
    1) // 2 below, one more above), against the JAX package's
    _max_pool_axis and its custom_vjp backward; ties and planted inf/NaN
    in g."""
    jdt, tdt = DTYPES[dt]
    shape = (2, 4, 5, 6, 3)
    x = _input("ties", shape, seed=dim * 10 + k)
    g = _cotangent(shape, seed=k, planted=True)
    axis = dim - 1  # channels-last axis of the same spatial dim
    y_j, vjp = jax.vjp(lambda a: jconv._max_pool_axis(a, axis, k, 1), jnp.asarray(x, jdt))
    (gx_j,) = vjp(jnp.asarray(g, jdt))
    xt, gt = _cf(x, tdt), _cf(g, tdt)
    y = tconv.max_pool_axis_plain(xt, dim, k)
    gx = tconv.max_pool_axis_bwd_plain(xt, y, gt, dim, k)
    np.testing.assert_array_equal(_cl(y), _jax_f32(y_j))
    np.testing.assert_array_equal(_cl(gx), _jax_f32(gx_j))
    # the custom op and the backward's wrapper are the plain versions on the CPU
    assert torch.equal(torch.ops.picad.max_pool_axis(xt, dim, k), y)
    torch.testing.assert_close(tconv.max_pool_axis_bwd(xt, y, gt, dim, k), gx, rtol=0, atol=0,
                               equal_nan=True)


def test_gradient_by_hand_every_tie_gets_the_window():
    """x = [2, 2, 0, 1] along W, window 3, pads one zero each side: y = [2,
    2, 2, 1]; x[0] is the maximum of windows 0 and 1, x[1] of windows 0, 1
    and 2, x[3] of window 3; x[2] of none."""
    x = torch.tensor([2.0, 2.0, 0.0, 1.0]).reshape(1, 1, 4).requires_grad_(True)
    y = tconv.max_pool_same_zero_pad(x, (3,), (1,))
    assert y.detach().reshape(-1).tolist() == [2.0, 2.0, 2.0, 1.0]
    g = torch.tensor([1.0, 10.0, 100.0, 1000.0]).reshape(1, 1, 4)
    (gx,) = torch.autograd.grad(y, x, g)
    assert gx.reshape(-1).tolist() == [11.0, 111.0, 0.0, 1000.0]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("dim,k", [(2, 3), (3, 3), (4, 3), (4, 2)])
def test_custom_op_passes_opcheck(dt, dim, k):
    """picad::max_pool_axis: schema, fake (meta) implementation and
    tracing, as torch.library.opcheck tests them."""
    x = _cf(_input("ties", (2, 3, 5, 4, 3), seed=dim), DTYPES[dt][1])
    torch.library.opcheck(torch.ops.picad.max_pool_axis.default, (x, dim, k))


class _Branch(torch.nn.Module):
    """An Inception branch 3 in small: stride-1 pool, then a 1x1x1 conv."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv3d(3, 2, 1)

    def forward(self, x):
        return self.conv(tconv.max_pool_same_zero_pad(x, (3, 3, 3), (1, 1, 1)))


def test_export_keeps_the_pool_op_and_equals_eager():
    """torch.export of a module with a stride-1 pool keeps one
    picad.max_pool_axis node a stage, and the exported program gives the
    eager module's output bit for bit."""
    torch.manual_seed(0)
    m = _Branch().eval()
    x = _cf(_input("ties", (2, 2, 6, 5, 3), seed=3), torch.float32)
    with torch.no_grad():
        ep = torch.export.export(m, (x,), strict=False)
        targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
        assert targets.count("picad.max_pool_axis.default") == 3
        assert torch.equal(ep.module()(x), m(x))


def test_cpu_wrappers_launch_nothing_and_refuse_what_no_stage_is():
    counters = [(fn, fn.launches, dict(fn.launches_by_c))
                for fn in (tconv.max_pool_axis, tconv.max_pool_axis_bwd)]
    x = _cf(_input("ties", (2, 2, 5, 4, 3), seed=1), torch.float32).requires_grad_(True)
    y = tconv.max_pool_same_zero_pad(x, (3, 3, 3), (1, 1, 1))
    torch.autograd.grad(y, x, torch.ones_like(y))
    for fn, n, by_c in counters:
        assert (fn.launches, fn.launches_by_c) == (n, by_c)
    with pytest.raises(ValueError, match="no stride-1 pool"):
        tconv.max_pool_axis(x.detach(), 1, 3)  # the channel dim
    with pytest.raises(ValueError, match="no stride-1 pool"):
        tconv.max_pool_axis_bwd(x.detach(), y.detach(), y.detach(), 5, 3)
