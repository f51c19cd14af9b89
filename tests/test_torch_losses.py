"""The port's public loss functions (picad_tpu_torch/objectives) against
the JAX package's (picad_tpu/objectives), the same numpy inputs, CPU f32;
the cases of tests/test_losses.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import picad_tpu.objectives as jobj
import picad_tpu_torch.objectives as tobj

RNG_SEED = 4
RTOL = 1e-5  # f32 sums over a few hundred elements, in another order


def _rng(name: str):
    return np.random.default_rng([RNG_SEED, len(name)])


def _both(fn_name: str, *arrays, **kw):
    j = getattr(jobj, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    t = getattr(tobj, fn_name)(*(torch.from_numpy(a) for a in arrays), **kw)
    return j, t


@pytest.mark.parametrize("margins", [{}, {"m_min": 0.1, "m_max": 0.5}])
@pytest.mark.parametrize("b", [1, 6])
def test_spread_loss_matches_jax(b, margins):
    rng = _rng("spread")
    x = rng.standard_normal((b, 24)).astype(np.float32)
    t = rng.integers(0, 24, (b,)).astype(np.int64)
    (lj, aj), (lt, at) = _both("spread_loss", x, t, **margins)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=RTOL)


@pytest.mark.parametrize("fn", ["dice_loss", "iou_loss", "bce_with_logits"])
def test_segmentation_losses_match_jax(fn):
    rng = _rng(fn)
    logits = (rng.standard_normal((2, 8, 6, 6)) * 3).astype(np.float32)
    targets = (rng.uniform(size=(2, 8, 6, 6)) > 0.5).astype(np.float32)
    j, t = _both(fn, logits, targets)
    np.testing.assert_allclose(float(t), float(j), rtol=RTOL)
    if fn == "iou_loss":
        assert 0.0 <= float(t) <= 1.0


def test_dice_and_iou_take_their_smoothing():
    rng = _rng("smooth")
    logits = rng.standard_normal((2, 8, 4, 4)).astype(np.float32)
    targets = (rng.uniform(size=(2, 8, 4, 4)) > 0.5).astype(np.float32)
    for fn in ("dice_loss", "iou_loss"):
        j, t = _both(fn, logits, targets, smooth=0.5)
        np.testing.assert_allclose(float(t), float(j), rtol=RTOL)


@pytest.mark.parametrize("broadcast", [False, True])
def test_weighted_mse_loss_matches_jax(broadcast):
    """Equal shapes, and the gv path's broadcast of a (B, T, H, W) weight
    against a (B, 1, T, H, W) difference (main_ucf101.py:130-132)."""
    rng = _rng("wmse")
    shape = (3, 1, 8, 4, 4) if broadcast else (2, 8, 4, 4)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    w = rng.uniform(size=(3, 8, 4, 4) if broadcast else shape).astype(np.float32)
    j, t = _both("weighted_mse_loss", a, b, w)
    np.testing.assert_allclose(float(t), float(j), rtol=RTOL)


def test_weighted_mse_loss_equal_weights_is_mse():
    rng = _rng("mse")
    a = rng.standard_normal((2, 8, 4, 4)).astype(np.float32)
    b = rng.standard_normal((2, 8, 4, 4)).astype(np.float32)
    t = tobj.weighted_mse_loss(torch.from_numpy(a), torch.from_numpy(b),
                               torch.ones(2, 8, 4, 4))
    ref = torch.nn.functional.mse_loss(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(float(t), float(ref), rtol=RTOL)


def test_capsule_margin_loss_matches_jax():
    rng = _rng("margin")
    labels = np.eye(24, dtype=np.float32)[rng.integers(0, 24, (5,))]
    classes = rng.uniform(size=(5, 24)).astype(np.float32)
    j, t = _both("capsule_margin_loss", labels, classes)
    np.testing.assert_allclose(float(t), float(j), rtol=RTOL)


def test_public_names_match_the_jax_package():
    names = ("bce_with_logits", "capsule_margin_loss", "dice_loss", "iou_loss",
             "spread_loss", "weighted_mse_loss", "cosine_rampdown", "exp_rampdown",
             "exp_rampup", "exp_warmup", "linear_rampup", "pseudo_rampup")
    for name in names:
        assert callable(getattr(jobj, name)) and callable(getattr(tobj, name)), name
    x = torch.randn(4, 24, requires_grad=True)
    loss, absloss = tobj.spread_loss(x, torch.tensor([0, 3, 5, 23]))
    loss.backward()  # differentiable, as the reference's is
    assert x.grad is not None and absloss.shape == ()
