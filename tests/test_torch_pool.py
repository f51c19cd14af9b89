"""The strided max pools' backward (picad_tpu_torch/ops/convops.py:
_MaxPoolStrided, max_pool_bwd) against the JAX package's select-and-scatter
gradient and torch's own first-max gradient, CPU f32.

Each window's gradient goes to its first maximum in scan order; the
pads are zeros that count in the windows and keep their share.  The
inputs are random, post-ReLU (many zeros tie with the pads) and random
with planted equal positive maxima.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from picad_tpu.ops import convops as jconv
from picad_tpu_torch.ops import convops as tconv
from tests.test_torch_model import few_torch_threads  # noqa: F401

# the four strided pools of the I3D (MaxPool3d_2a, _3a, _4a, _5a): the first
# two share a geometry at different widths
POOLS = {
    "2a": ((1, 3, 3), (1, 2, 2), 4),
    "3a": ((1, 3, 3), (1, 2, 2), 6),
    "4a": ((3, 3, 3), (2, 1, 1), 5),
    "5a": ((2, 2, 2), (2, 2, 2), 3),
}
SIZES = {"even": (4, 8, 10), "odd": (5, 7, 9)}
# f32: the two backwards add the same terms in another order (XLA scatters
# the windows in order, the gather sums an element's windows by its offset)
RTOL = 1e-6


def _input(kind: str, c: int, sp, seed: int) -> np.ndarray:
    """(N, *sp, C) channels-last."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *sp, c)).astype(np.float32)
    if kind == "relu":
        x = np.maximum(x, 0.0)
    elif kind == "ties":
        # equal positive maxima: the largest value planted at several places
        # of one window, and everywhere on a stripe
        peak = np.float32(x.max() + 1.0)
        x[:, :2, :2, :2] = peak
        x[:, :, 3, :] = peak
        x[:, -1, -1, -2:] = peak
    return x


def _cf(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _cl(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _torch_pool(x: np.ndarray, k, s, g: np.ndarray):
    xt = _cf(x).requires_grad_(True)
    y = tconv.max_pool_same_zero_pad(xt, k, s)
    (gx,) = torch.autograd.grad(y, xt, _cf(g))
    return y, gx


@pytest.mark.parametrize("kind", ["random", "relu", "ties"])
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("pool", list(POOLS))
def test_strided_pool_backward_matches_jax(pool, size, kind):
    k, s, c = POOLS[pool]
    x = _input(kind, c, SIZES[size], seed=len(pool + size + kind))
    y_j, vjp = jax.vjp(lambda a: jconv.max_pool_same_zero_pad(a, k, s), jnp.asarray(x))
    g = np.random.default_rng(7).standard_normal(y_j.shape).astype(np.float32)
    (gx_j,) = vjp(jnp.asarray(g))
    y, gx = _torch_pool(x, k, s, g)
    np.testing.assert_array_equal(_cl(y), np.asarray(y_j))  # the forward is the same
    gx_j = np.asarray(gx_j)
    np.testing.assert_allclose(_cl(gx), gx_j, rtol=RTOL, atol=RTOL * np.abs(gx_j).max())


@pytest.mark.parametrize("kind", ["random", "relu", "ties"])
@pytest.mark.parametrize("pool", list(POOLS))
def test_strided_pool_backward_matches_torch_first_max(pool, kind):
    """torch's own F.max_pool3d gradient on the zero-padded input (its CPU
    kernel keeps the first maximum in scan order), cut back to x."""
    k, s, c = POOLS[pool]
    x = _input(kind, c, SIZES["odd"], seed=3)
    xt = _cf(x).requires_grad_(True)
    pads = [tconv.same_pads(d, kk, ss) for d, kk, ss in zip(xt.shape[2:], k, s)]
    y_ref = F.max_pool3d(tconv._pad_spatial(xt, pads), k, s)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(y_ref.shape).astype(np.float32))
    (gx_ref,) = torch.autograd.grad(y_ref, xt, g)
    y, gx = _torch_pool(x, k, s, np.moveaxis(g.numpy(), 1, -1))
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(gx, gx_ref, rtol=RTOL, atol=RTOL * gx_ref.abs().max().item())


def test_first_maximum_and_the_pads_by_hand():
    """x (3, 3) in a (1, 3, 3)/(1, 2, 2) pool: SAME pads one zero row and
    column on each side, so the four windows start at padded (0, 0),
    (0, 2), (2, 0), (2, 2).  The three 5s tie in window (0, 0), whose
    gradient goes to the first, x[0, 0]; windows (0, 1) and (1, 0) find
    their first 5 at x[0, 1] and x[1, 0]; window (1, 1) holds only
    negative values and pads, so its maximum is a pad, whose share is
    dropped."""
    x = torch.tensor([[5.0, 5.0, -1.0], [5.0, -2.0, -3.0], [-4.0, -5.0, -6.0]])
    xt = x.reshape(1, 1, 1, 3, 3).clone().requires_grad_(True)
    y = tconv.max_pool_same_zero_pad(xt, (1, 3, 3), (1, 2, 2))
    torch.testing.assert_close(y.reshape(2, 2), torch.tensor([[5.0, 5.0], [5.0, 0.0]]))
    g = torch.tensor([[1.0, 10.0], [100.0, 1000.0]]).reshape(1, 1, 1, 2, 2)
    (gx,) = torch.autograd.grad(y, xt, g)
    want = torch.tensor([[1.0, 10.0, 0.0], [100.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    torch.testing.assert_close(gx.reshape(3, 3), want, rtol=0, atol=0)


def test_cpu_backward_launches_nothing_and_takes_f64():
    before = tconv.max_pool_bwd.launches
    x = torch.rand((1, 2, 3, 6, 5), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda t: tconv.max_pool_same_zero_pad(t, (3, 3, 3), (2, 1, 1)), (x,))
    assert tconv.max_pool_bwd.launches == before
    with pytest.raises(ValueError, match="not a pool"):
        tconv.max_pool_bwd(torch.zeros(1, 1, 4, 4, 4), torch.zeros(1, 1, 2, 2, 2),
                           torch.zeros(1, 1, 3, 3, 3), (2, 2, 2), (2, 2, 2), (0, 0, 0))


# the train step's three strided pools (models/i3d.py:48-50) at reduced batch,
# channels and size: odd H (a low pad along H), and W 17, 22 and 10, which
# leave a ragged tail of the kernel's 16-byte vectors
TRAIN_POOLS = {"2a": ((1, 3, 3), (1, 2, 2), 4, 4), "3a": ((1, 3, 3), (1, 2, 2), 6, 2),
               "4a": ((3, 3, 3), (2, 1, 1), 5, 3)}


@pytest.mark.parametrize("kind", ["relu", "ties"])
@pytest.mark.parametrize("w", [17, 22, 10])
@pytest.mark.parametrize("pool", list(TRAIN_POOLS))
def test_plain_backward_from_unpadded_x_matches_jax(pool, w, kind):
    """max_pool_bwd_plain(x, y, g, kernel, stride, lo), the kernel's
    plain version on the unpadded x and the low pads, against jax.grad of
    the JAX package's max_pool_same_zero_pad; the pads count in the
    windows and their share is dropped."""
    k, s, c, t = TRAIN_POOLS[pool]
    x = _input(kind, c, (t, 9, w), seed=w + len(pool + kind))
    y_j, vjp = jax.vjp(lambda a: jconv.max_pool_same_zero_pad(a, k, s), jnp.asarray(x))
    g = np.random.default_rng(w).standard_normal(y_j.shape).astype(np.float32)
    (gx_j,) = vjp(jnp.asarray(g))
    lo = tuple(tconv.same_pads(d, kk, ss)[0] for d, kk, ss in zip((t, 9, w), k, s))
    assert lo[1] == 1 and lo[2] == (w % 2 if s[2] == 2 else 1)
    gx = tconv.max_pool_bwd_plain(_cf(x), _cf(np.asarray(y_j)), _cf(g), k, s, lo)
    gx_j = np.asarray(gx_j)
    np.testing.assert_allclose(_cl(gx), gx_j, rtol=RTOL, atol=RTOL * np.abs(gx_j).max())
