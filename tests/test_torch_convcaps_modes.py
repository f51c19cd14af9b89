"""The port's ConvCaps modes (K=(1,1), general K, w_shared class capsules,
coor_add) against the JAX package's ConvCaps, the same weights carried
across, CPU f32; the cases of tests/test_convcaps_modes.py.

EM routing runs at eps 1e-4 here: at its production 1e-8 the reference's
cost_std quirk makes the activations f32 rounding noise (ROADMAP.md
section 3; tests/test_torch_train_ops.py holds the routing itself at
both), which would hide the modes' arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picad_tpu.models.capsules import ConvCaps as JaxConvCaps
from picad_tpu_torch.models.capsules import ConvCaps
from tests.test_torch_model import few_torch_threads  # noqa: F401

EPS = 1e-4
ATOL = 2e-5  # the well-conditioned routing: two f32 implementations agree to ~1e-6


def _input(b, h, w, Bi=4, P=2, seed=0):
    rng = np.random.default_rng(seed)
    c = Bi * (P * P + 1)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    # activations live in the last Bi channels; squash into (0, 1)
    x[..., Bi * P * P:] = 1 / (1 + np.exp(-x[..., Bi * P * P:]))
    return x


def _pair(x, **kw):
    """(JAX output, port output) on the JAX module's initial weights."""
    jm = JaxConvCaps(eps=EPS, **kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(np.asarray, v["params"])
    tm = ConvCaps(kw["in_caps"], kw["out_caps"], kw["pose_size"], eps=EPS,
                  **{k: kw[k] for k in ("kernel", "stride", "coor_add", "w_shared")
                     if k in kw})
    tm.load_state_dict({"beta_u": torch.from_numpy(p["beta_u"]),
                        "beta_a": torch.from_numpy(p["beta_a"]),
                        "weights": torch.from_numpy(p["weights"])[None]})
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    return np.asarray(jm.apply(v, jnp.asarray(x))), out, v["params"]["weights"].shape


def test_conv_caps_1x1_matches_jax():
    j, t, _ = _pair(_input(2, 5, 5), in_caps=4, out_caps=3, pose_size=2)
    assert t.shape == (2, 5, 5, 3 * 4 + 3)
    acts = t[..., 12:]
    assert (acts >= 0).all() and (acts <= 1).all()
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("kernel,stride,hw", [((3, 3), (2, 2), (7, 7)),
                                              ((3, 3), (1, 1), (5, 6)),
                                              ((2, 3), (1, 2), (6, 7))])
def test_conv_caps_general_k_matches_jax(kernel, stride, hw):
    """KxK patches routed jointly in patch-major order (the correct order,
    not the reference's dead-code scramble)."""
    j, t, wshape = _pair(_input(2, *hw, seed=1), in_caps=4, out_caps=3, pose_size=2,
                         kernel=kernel, stride=stride)
    oh = (hw[0] - kernel[0]) // stride[0] + 1
    ow = (hw[1] - kernel[1]) // stride[1] + 1
    assert wshape == (kernel[0] * kernel[1] * 4, 3, 2, 2)
    assert t.shape == (2, oh, ow, 3 * 4 + 3)
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("coor_add", [False, True])
def test_class_caps_w_shared_matches_jax(coor_add):
    x = _input(2, 3, 3, seed=2)
    j, t, wshape = _pair(x, in_caps=4, out_caps=6, pose_size=2, w_shared=True,
                         coor_add=coor_add)
    assert wshape == (4, 6, 2, 2) and t.shape == (2, 6)  # activations only
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_class_caps_coord_add_changes_votes():
    x = torch.from_numpy(_input(2, 3, 3, seed=3))
    a = ConvCaps(4, 6, 2, w_shared=True)
    with torch.no_grad():
        for p in a.parameters():
            p.normal_(generator=torch.Generator().manual_seed(5))
        b = ConvCaps(4, 6, 2, w_shared=True, coor_add=True)
        b.load_state_dict(a.state_dict())
        assert not torch.allclose(a(x), b(x))


def test_capsnet_keeps_the_1x1_layer():
    from picad_tpu_torch.models.capsules import CapsNet

    caps = CapsNet().conv_caps
    assert caps.kernel == (1, 1) and not caps.w_shared and not caps.coor_add
    assert caps.weights.shape == (1, 32, 24, 4, 4)
