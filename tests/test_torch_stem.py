"""The port's space-to-depth stem vs the JAX package's, and vs the plain
stem, CPU f32.

StemS2D computes the 7^3/s2 SAME conv on 3 channels as a 4^3/s1 conv on
24 packed channels with the plain stem's parameters (models/i3d.py).
Both packages run the same numpy weights and clips; the tolerance is
tests/test_stem_s2d.py's (rtol/atol 1e-4), and the packed uint8 branch
is held as tests/test_packed_prep.py holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picad_tpu.models.i3d import StemS2D as JaxStemS2D
from picad_tpu_torch.models import i3d as port_i3d
from picad_tpu_torch.models.capsules import build_capsnet
from picad_tpu_torch.models.i3d import StemS2D, s2d_pack
from picad_tpu_torch.models.layers import Unit3D
from picad_tpu_torch.serve.runner import ServingModel
from tests.test_torch_model import SCORES_TOL, few_torch_threads, pinned_fixture_sd  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_stem_s2d.py
PACKED_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_packed_prep.py


def _weights(seed, cout=64):
    """JAX-layout stem variables with non-trivial BN parameters and stats."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "kernel": (0.05 * rng.standard_normal((7, 7, 7, 3, cout))).astype(np.float32),
            "bn": {"scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                   "bias": (0.1 * rng.standard_normal(cout)).astype(np.float32)},
        },
        "batch_stats": {"bn": {"mean": (0.1 * rng.standard_normal(cout)).astype(np.float32),
                               "var": rng.uniform(0.5, 2.0, cout).astype(np.float32)}},
    }


def _port_stem(variables, cls=StemS2D, bn_groups=1):
    p, s = variables["params"], variables["batch_stats"]
    cout = p["kernel"].shape[-1]
    m = cls(3, cout, (7, 7, 7), (2, 2, 2), bn_groups=bn_groups)
    m.load_state_dict({
        "conv3d.weight": torch.from_numpy(p["kernel"].transpose(4, 3, 0, 1, 2).copy()),
        "bn.weight": torch.from_numpy(p["bn"]["scale"]),
        "bn.bias": torch.from_numpy(p["bn"]["bias"]),
        "bn.running_mean": torch.from_numpy(s["bn"]["mean"]),
        "bn.running_var": torch.from_numpy(s["bn"]["var"]),
    })
    return m


def _cf(x):  # channels-last numpy -> channels-first tensor
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 4, 1, 2, 3)


def _cl(y):  # channels-first tensor -> channels-last numpy
    return y.detach().permute(0, 2, 3, 4, 1).numpy()


@pytest.mark.parametrize("train,bn_groups", [(False, 1), (True, 1), (True, 2)])
def test_stem_s2d_matches_jax(train, bn_groups):
    """Output (and in train mode the running stats) against the JAX
    StemS2D on the same weights and clip."""
    v = _weights(0)
    x = np.random.default_rng(1).standard_normal((2, 8, 32, 32, 3)).astype(np.float32)
    stem = JaxStemS2D(64, bn_groups=bn_groups)
    if train:
        y_ref, mut = stem.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    else:
        y_ref = stem.apply(v, jnp.asarray(x), False)
    port = _port_stem(v, bn_groups=bn_groups).train(train)
    y = port(_cf(x))
    assert y.shape == (2, 64, 4, 16, 16)
    np.testing.assert_allclose(_cl(y), np.asarray(y_ref), **TOL)
    if train:
        bn = mut["batch_stats"]["bn"]
        np.testing.assert_allclose(port.bn.running_mean.numpy(), np.asarray(bn["mean"]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(port.bn.running_var.numpy(), np.asarray(bn["var"]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("channels_last", [True, False])
def test_stem_s2d_matches_plain_stem_forward_and_dw(monkeypatch, channels_last):
    """S2D against the port's plain Unit3D stem in train mode (bn_groups
    2): the output, dW and the BN parameters' gradients, in both layouts
    of the S2D conv."""
    monkeypatch.setattr(port_i3d, "S2D_CHANNELS_LAST", channels_last)
    v = _weights(2)
    x = _cf(np.random.default_rng(3).uniform(0, 1, (4, 8, 32, 24, 3)).astype(np.float32))
    r = torch.randn((4, 64, 4, 16, 12), generator=torch.Generator().manual_seed(4))
    outs = []
    for cls in (Unit3D, StemS2D):
        m = _port_stem(v, cls, bn_groups=2).train()
        y = m(x)
        (y * r).sum().backward()
        outs.append((y.detach(), m.conv3d.weight.grad, m.bn.weight.grad, m.bn.bias.grad,
                     m.bn.running_mean, m.bn.running_var))
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4 * float(a.abs().max()))


def test_stem_s2d_odd_dims_take_the_plain_conv():
    """Odd T, H or W: the JAX package falls back to the plain stem
    (picad_tpu/models/i3d.py:238); the port's StemS2D does the same."""
    v = _weights(5)
    x = _cf(np.random.default_rng(6).standard_normal((1, 7, 18, 17, 3)).astype(np.float32))
    plain, s2d = _port_stem(v, Unit3D).eval(), _port_stem(v).eval()
    assert torch.equal(s2d(x), plain(x))


def test_stem_uint8_branch_matches_jax():
    """The packed uint8 branch (/255 folded into the kernel) against the
    JAX one, and against the port's own f32 branch on x/255."""
    v = _weights(7, cout=8)
    x = np.random.default_rng(8).integers(0, 256, (2, 8, 16, 16, 3), dtype=np.uint8)
    packed = s2d_pack(torch.from_numpy(x)).numpy()
    assert packed.shape == (2, 4, 8, 8, 24) and packed.dtype == np.uint8
    y_jax = JaxStemS2D(8).apply(v, jnp.asarray(packed), False)
    port = _port_stem(v).eval()
    y = port(_cf(packed))
    np.testing.assert_allclose(_cl(y), np.asarray(y_jax), **TOL)
    y_f32 = port(_cf(x.astype(np.float32) / 255.0))
    np.testing.assert_allclose(_cl(y), _cl(y_f32), **PACKED_TOL)
    with pytest.raises(ValueError, match="24 channels"):
        port(_cf(x))


def test_serving_forward_with_either_stem():
    """A ServingModel forward with s2d_stem True and False from the same
    weights: the same function, so the same class and scores within the
    port-vs-JAX score tolerance (tests/test_torch_model.py)."""
    sd = pinned_fixture_sd()
    clips = np.random.default_rng(9).uniform(0, 1, (2, 8, 80, 80, 3)).astype(np.float32)
    outs = []
    for s2d in (True, False):
        model = build_capsnet(sd, device="cpu", s2d_stem=s2d)
        assert isinstance(model.conv1.Conv3d_1a_7x7, StemS2D) == s2d
        seg, scores = ServingModel.from_model(model, clip_batch_size=2, height=80,
                                              width=80).predict_clips(clips)
        outs.append((seg, scores))
    (seg_s, sc_s), (seg_p, sc_p) = outs
    assert seg_s.shape == (2, 8, 80, 80) and sc_s.shape == (2, 24)
    np.testing.assert_array_equal(sc_s.argmax(1), sc_p.argmax(1))
    np.testing.assert_allclose(sc_s, sc_p, **SCORES_TOL)
    np.testing.assert_allclose(seg_s, seg_p, rtol=1e-3, atol=1e-3)
