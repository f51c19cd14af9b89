"""The port's I3D past Mixed_4f (MaxPool3d_5a_2x2, Mixed_5b, Mixed_5c) and
its logits head against the JAX package's InceptionI3d / I3DLogitsHead, on
the same weights, CPU f32, eval mode.  The weights go from the port to
JAX through the JAX converter (reference keys -> flax) and back through
the port's (checkpoint/convert.i3d_key_mapping)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picad_tpu.checkpoint.torch_convert import convert_i3d_backbone
from picad_tpu.models.i3d import I3DLogitsHead as JaxHead
from picad_tpu.models.i3d import InceptionI3d as JaxI3d
from picad_tpu_torch.checkpoint.convert import from_jax_variables, i3d_key_mapping
from picad_tpu_torch.models.i3d import I3DLogitsHead, InceptionI3d
from picad_tpu_torch.models.layers import TorchBatchNorm
from tests.test_torch_model import few_torch_threads  # noqa: F401

# f32 through the encoder's convolutions and BNs: the two packages sum in
# another order
RTOL = 1e-4


def _seeded(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random weights of the right scale: conv kernels N(0, 1/fan_in),
    BN affine and running stats near identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim > 1:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=g)
            elif name.endswith("bn.weight"):
                p.uniform_(0.5, 1.5, generator=g)
            else:
                p.normal_(0.0, 0.1, generator=g)
        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model.eval()


def _cl(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


@pytest.fixture(scope="module")
def port_i3d():
    return _seeded(InceptionI3d(final_endpoint="Mixed_5c"), seed=1)


@pytest.fixture(scope="module")
def jax_variables(port_i3d):
    sd = {k: v.numpy() for k, v in port_i3d.state_dict().items()}
    params, stats, n = convert_i3d_backbone(sd)
    assert n == len(sd) == 285  # 57 Unit3Ds x 5 tensors, Mixed_5b and 5c included
    return {"params": params["conv1"], "batch_stats": stats["conv1"]}


def test_mixed_5c_matches_jax(port_i3d, jax_variables):
    x = np.random.default_rng(4).uniform(0, 1, (2, 8, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        out, out56, out112 = port_i3d(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    j_out, j56, j112 = jax.jit(lambda v, a: JaxI3d(final_endpoint="Mixed_5c").apply(
        v, a, False))(jax_variables, jnp.asarray(x))
    assert out.shape == (2, 1024, 1, 4, 4)  # MaxPool3d_5a: T 1 -> 1, 8 -> 4
    for got, want in ((out, j_out), (out56, j56), (out112, j112)):
        want = np.asarray(want)
        np.testing.assert_allclose(_cl(got), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_tail_keys_convert_back(port_i3d, jax_variables):
    """The port's converter maps the JAX tree back to the reference keys,
    Mixed_5b and 5c included, bit for bit."""
    sd = from_jax_variables({"params": {"conv1": jax_variables["params"]},
                             "batch_stats": {"conv1": jax_variables["batch_stats"]}},
                            i3d_key_mapping(tail=True))
    own = port_i3d.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)


def test_logits_head_matches_jax():
    """avg pool (2, 7, 7) VALID + 1x1x1 conv with bias, spatially
    squeezed; the port keeps the reference's (B, classes, T') layout, JAX
    its channels-last (B, T', classes)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 7, 7, 1024)).astype(np.float32)
    head = _seeded(I3DLogitsHead(1024, num_classes=10), seed=2)
    w, b = head.conv3d.weight.detach().numpy(), head.conv3d.bias.detach().numpy()
    variables = {"params": {"logits": {"kernel": np.transpose(w, (2, 3, 4, 1, 0)), "bias": b}}}
    want = np.asarray(JaxHead(num_classes=10).apply(variables, jnp.asarray(x), False))
    with torch.no_grad():
        got = head(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
    assert got.shape == (2, 10, 2) and want.shape == (2, 2, 10)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, rtol=1e-5, atol=1e-5)


def test_logits_endpoint_is_the_head_on_mixed_5c(port_i3d):
    """final_endpoint="Logits" builds the whole classifier (the reference
    keys `logits.conv3d.*` beside Mixed_5c's) and runs the head on the
    Mixed_5c output; 32 frames at 112^2 leave it the (2, 7, 7) window."""
    full = InceptionI3d(final_endpoint="Logits", num_classes=10)
    assert set(full.state_dict()) == set(port_i3d.state_dict()) | {
        "logits.conv3d.weight", "logits.conv3d.bias"}
    full.load_state_dict({**port_i3d.state_dict(),
                          **{f"logits.{k}": v for k, v in
                             _seeded(I3DLogitsHead(1024, 10), 3).state_dict().items()}})
    full.eval()
    x = torch.rand((1, 3, 32, 112, 112), generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        logits, _, _ = full(x)
        feat, _, _ = port_i3d(x)
        assert feat.shape == (1, 1024, 2, 7, 7)
        want = full.logits(feat)
    assert logits.shape == (1, 10, 1)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)


def test_head_dropout_in_train_mode():
    head = I3DLogitsHead(8, num_classes=3, dropout_rate=0.5)
    with torch.no_grad():
        head.conv3d.weight.fill_(1.0)
    x = torch.ones((4, 8, 2, 7, 7))
    with torch.no_grad():
        a = head.train()(x, torch.Generator().manual_seed(0))
        b = head.train()(x, torch.Generator().manual_seed(0))
        c = head.eval()(x)
    torch.testing.assert_close(a, b)
    torch.testing.assert_close(c, torch.full((4, 3, 1), 8.0))
    assert not torch.equal(a, c)


def test_default_endpoint_stays_mixed_4f():
    m = InceptionI3d()
    assert m.final_endpoint == "Mixed_4f" and not hasattr(m, "Mixed_5b")
    with pytest.raises(ValueError, match="final_endpoint"):
        InceptionI3d(final_endpoint="Mixed_6a")
