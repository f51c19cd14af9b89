"""The port's packed uint8 prep and encoder remat, CPU.

- `s2d_pack_u8` and `flip_packed_w` are bit-exact against the JAX
  package's (picad_tpu/train/step.py:83-102), and the flip commutes with
  the packing exactly (tests/test_packed_prep.py);
- `prepare_views` takes the packed branch exactly where the JAX one does
  and returns the same views;
- a whole train step through the packed branch against the f32-prep
  step, at tests/test_packed_step.py's tolerances (the differences are
  f32 reassociation, conv(x, w/255) vs conv(x/255, w), amplified by EM
  routing's cost_std quirk);
- `remat_encoder=True` against False: the same losses, gradients and BN
  running stats (one running-stat update per forward, as JAX's nn.remat).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picad_tpu.train import step as jax_step
from picad_tpu_torch.config import LossConfig
from picad_tpu_torch.train import step as port_step
from picad_tpu_torch.train.state import create_train_state
from tests.test_torch_model import few_torch_threads  # noqa: F401

H, B = 80, 2
CFG = dict(bv=True, n_frames=5, wt_cons=0.1)
# epoch below thresh_epoch, as tests/test_packed_step.py: argmax
# pseudo-label flips would let the two trajectories legitimately diverge
EPOCH, RAMP = 5.0, 0.5


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _batch(seed=11):
    rng = np.random.default_rng(seed)
    return {
        "data": rng.integers(0, 256, (B, 8, H, H, 3), dtype=np.uint8),
        "loc_msk": (rng.random((B, 8, H, H, 1)) > 0.7).astype(np.uint8),
        "action": rng.integers(0, 24, (B,)).astype(np.int32),
        "label_vid": (np.arange(B) % 2).astype(np.int32),
    }


def test_pack_and_flip_bit_exact_vs_jax():
    x = _u8((2, 8, 16, 12, 3), 0)
    p = port_step.s2d_pack_u8(torch.from_numpy(x))
    p_jax = np.asarray(jax_step.s2d_pack_u8(jnp.asarray(x)))
    assert p.dtype == torch.uint8 and p.shape == (2, 4, 8, 6, 24)
    np.testing.assert_array_equal(p.numpy(), p_jax)
    f = port_step.flip_packed_w(p)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jax_step.flip_packed_w(jnp.asarray(p_jax))))
    # the flip commutes with the packing exactly
    flipped_then_packed = port_step.s2d_pack_u8(torch.from_numpy(x[:, :, :, ::-1].copy()))
    assert torch.equal(f, flipped_then_packed)


def test_prepare_views_packed_branch_matches_jax(monkeypatch):
    monkeypatch.setattr(port_step, "_PACKED_PREP", True)
    monkeypatch.setattr(jax_step, "_PACKED_PREP", True)
    data = _u8((2, 8, 16, 16, 3), 1)
    msk = (np.random.default_rng(2).random((2, 8, 16, 16, 1)) > 0.5).astype(np.uint8)
    d, a, seg = port_step.prepare_views({"data": data, "loc_msk": msk}, torch.device("cpu"))
    dj, aj, segj = jax_step.prepare_views({"data": jnp.asarray(data), "loc_msk": jnp.asarray(msk)})
    assert d.dtype == torch.uint8 and d.shape == (2, 4, 8, 8, 24)
    for port, ref in ((d, dj), (a, aj), (seg, segj)):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))

    # the reference f32 layout, and odd dims, keep the unpacked views
    f32 = {"data": data.astype(np.float32) / 255.0,
           "aug_data": data[:, :, :, ::-1].astype(np.float32) / 255.0, "loc_msk": msk}
    d2, _, _ = port_step.prepare_views(f32, torch.device("cpu"))
    assert d2.dtype == torch.float32 and d2.shape == (2, 8, 16, 16, 3)
    odd = {"data": data[:, :7], "loc_msk": msk[:, :7]}
    d3, a3, _ = port_step.prepare_views(odd, torch.device("cpu"))
    assert d3.dtype == torch.float32 and torch.equal(a3, torch.flip(d3, dims=[3]))


def test_prepare_views_packed_prep_is_off_by_default():
    assert port_step._PACKED_PREP is False
    d, a, _ = port_step.prepare_views({"data": _u8((1, 8, 16, 16, 3), 3),
                                       "loc_msk": np.zeros((1, 8, 16, 16, 1), np.uint8)},
                                      torch.device("cpu"))
    assert d.dtype == torch.float32 and d.shape == (1, 8, 16, 16, 3)


def _step(batch, *, packed=False, remat=False, monkeypatch=None):
    monkeypatch.setattr(port_step, "_PACKED_PREP", packed)
    state = create_train_state(seed=0, device="cpu", compute_dtype=torch.float32, bn_groups=2,
                               dropout_rate=0.0, remat_encoder=remat)
    step = port_step.make_train_step(LossConfig(**CFG), device="cpu")
    state, metrics = step(state, batch, EPOCH, RAMP)
    model = state.model
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad for n, p in model.named_parameters()},
            {n: b for n, b in model.named_buffers()},
            {n: p.detach() for n, p in model.named_parameters()})


def test_packed_step_matches_f32_prep(monkeypatch):
    """tests/test_packed_step.py on the port: every metric within 2.5e-2
    (loss_cls 7.5e-2) relative, the BN running stats within rtol 5e-3,
    and the conv_caps beta_a parameter after the Adam step within rtol
    5e-3."""
    batch = _batch()
    m0, _, bs0, p0 = _step(batch, packed=False, monkeypatch=monkeypatch)
    m1, _, bs1, p1 = _step(batch, packed=True, monkeypatch=monkeypatch)
    for k in m0:
        rel = 7.5e-2 if k == "loss_cls" else 2.5e-2
        assert m1[k] == pytest.approx(m0[k], rel=rel, abs=1e-4), (k, m0[k], m1[k])
    for n in bs0:
        np.testing.assert_allclose(bs1[n].numpy(), bs0[n].numpy(), rtol=5e-3, atol=1e-4,
                                   err_msg=n)
    np.testing.assert_allclose(p1["conv_caps.beta_a"].numpy(), p0["conv_caps.beta_a"].numpy(),
                               rtol=5e-3, atol=1e-5)


def test_remat_encoder_matches_plain_step(monkeypatch):
    """The checkpointed encoder recomputes the same activations on the
    CPU, so the losses, every gradient and every BN running stat are the
    plain step's, bit for bit: a second running-stat update in the
    recompute would move the stats by momentum * (batch - running)."""
    batch = _batch(12)
    m0, g0, bs0, _ = _step(batch, monkeypatch=monkeypatch)
    m1, g1, bs1, _ = _step(batch, remat=True, monkeypatch=monkeypatch)
    assert m1 == m0
    for n in g0:
        assert torch.equal(g1[n], g0[n]), n
    for n in bs0:
        assert torch.equal(bs1[n], bs0[n]), n
