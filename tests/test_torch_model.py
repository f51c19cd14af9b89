"""The port's CapsNet eval forward vs the JAX CapsNet, same weights, CPU f32.

Both packages load tests/sd_fixtures.fake_capsnet_state_dict: the JAX
model through convert_capsnet_state_dict + merge_into_variables (built
from jax.eval_shape and zeros, not an eager init), the port through
load_state_dict on the reference keys.  Same (2, 8, 96, 96, 3) clip.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picad_tpu.checkpoint.torch_convert import (
    convert_capsnet_state_dict,
    merge_into_variables,
)
from picad_tpu.models.capsules import CapsNet as JaxCapsNet
from picad_tpu_torch.checkpoint.convert import from_jax_variables
from picad_tpu_torch.models.capsules import CapsNet, build_capsnet
from tests import sd_fixtures

H = 96
# The JAX reference runs op by op (jax.disable_jit).  Jitted, XLA's fused
# EM-routing reductions sum in another order, and the reference's cost_std
# quirk (see test_torch_ops.py) amplifies that: on the pinned fixture
# JAX-jit differs from op-by-op JAX by 9.2e-4 on the scores and 2.4e-3 on
# the seg logits, and from the port by about as much.  Measured port vs
# op-by-op JAX on the pinned fixture (torch on 2 threads): scores 6.9e-5
# (top-2 class margin 3.5e-3), seg logits (values up to 8.3) 3.8e-4.  Both
# bounds are tighter than tests/test_model_parity.py's (scores rtol 5e-3
# atol 5e-4, seg rtol 5e-2 atol 5e-3).
SCORES_TOL = dict(rtol=1e-3, atol=1e-4)
SEG_TOL = dict(rtol=1e-2, atol=3e-3)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The suite runs in several worker processes that share the host's
    cores; torch's default of one thread per core then oversubscribes
    them.  Two threads per module keep the port's forwards fast and
    their summation order fixed; the count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_capsnet(sd, h=H):
    """(JAX CapsNet, variables with sd merged in) without an eager init."""
    m = JaxCapsNet(num_classes=24)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: m.init(
            {"params": key, "dropout": key},
            jnp.zeros((1, 8, h, h, 3), jnp.float32),
            jnp.zeros((1,), jnp.int32),
            jnp.ones((1,), jnp.float32),
            0,
            0,
            False,
        )
    )
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats, _ = convert_capsnet_state_dict(sd)
    return m, merge_into_variables(variables, params, stats)


def jax_eval_forward(m, variables, img):
    """The JAX eval call (dummy action 500), op by op: ~35 s at 96^2."""
    b = img.shape[0]
    with jax.disable_jit():
        seg, scores, _ = m.apply(variables, jnp.asarray(img),
                                 jnp.full((b,), 500, jnp.int32),
                                 jnp.zeros((b,), jnp.float32), 0, 0, False)
    return np.asarray(seg), np.asarray(scores)


def pinned_fixture_sd():
    """fake_capsnet_state_dict(scale=0.05) with the same weights in every
    process.  sd_fixtures seeds each Unit3D from hash(prefix), which
    Python salts per process, and EM routing's cost_std quirk makes the
    f32 deviation between two implementations depend strongly on the
    weights: over six salts the port-vs-JAX seg error ranged 3.5e-4 to
    4.6e-3.  A stable hash of the prefix pins one draw."""
    sd_fixtures.hash = lambda s: zlib.crc32(s.encode())
    try:
        return sd_fixtures.fake_capsnet_state_dict(scale=0.05)
    finally:
        del sd_fixtures.hash


@pytest.fixture(scope="module")
def fixture_sd():
    return pinned_fixture_sd()


@pytest.fixture(scope="module")
def jax_model(fixture_sd):
    return jax_capsnet(fixture_sd)


@pytest.fixture(scope="module")
def clip():
    return np.random.default_rng(11).uniform(0, 1, (2, 8, H, H, 3)).astype(np.float32)


def test_capsnet_eval_forward_matches_jax(fixture_sd, jax_model, clip):
    m, variables = jax_model
    seg_j, scores_j = jax_eval_forward(m, variables, clip)

    model = build_capsnet(fixture_sd, device="cpu")
    assert model.compute_dtype == torch.float32
    with torch.inference_mode():
        seg_t, scores_t, feat = model(torch.from_numpy(clip))
    assert seg_t.shape == (2, 8, H, H) and scores_t.shape == (2, 24)
    assert feat.shape == (2, 16, 24)
    np.testing.assert_array_equal(scores_t.numpy().argmax(1), scores_j.argmax(1))
    np.testing.assert_allclose(scores_t.numpy(), scores_j, **SCORES_TOL)
    np.testing.assert_allclose(seg_t.numpy(), seg_j, **SEG_TOL)


def test_fused_head_matches_literal_chain_in_model(fixture_sd, clip):
    """fused_head=True (the kernel's path) vs the literal ConvT chain,
    both in the port, same weights."""
    x = torch.from_numpy(clip)
    with torch.inference_mode():
        seg_f, scores_f, _ = build_capsnet(fixture_sd, device="cpu")(x)
        seg_l, scores_l, _ = build_capsnet(fixture_sd, device="cpu", fused_head=False)(x)
    np.testing.assert_array_equal(scores_f.numpy(), scores_l.numpy())
    np.testing.assert_allclose(seg_f.numpy(), seg_l.numpy(), atol=1e-4)


def test_from_jax_variables_round_trips_the_fixture(fixture_sd, jax_model):
    _, variables = jax_model
    back = from_jax_variables(jax.tree.map(np.asarray, variables))
    assert set(back) == set(fixture_sd)
    for k, v in fixture_sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_seeded_weights_are_reproducible_and_finite():
    """init_weights draws from the generator it is given: one seed, one
    model; the forward on it is finite."""
    model = build_capsnet(seed=3, device="cpu")
    a = model.state_dict()
    b = build_capsnet(seed=3, device="cpu").state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    other = CapsNet().init_weights(torch.Generator().manual_seed(4))
    assert not torch.equal(a["conv_caps.weights"], other.conv_caps.weights)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 8, 80, 80, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        seg, scores, _ = model(x)
    assert torch.isfinite(seg).all() and torch.isfinite(scores).all()
