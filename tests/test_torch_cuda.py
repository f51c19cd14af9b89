"""The port's CUDA kernels on the card, held against their plain versions.

Every test here is marked `cuda` and asks the `card` fixture for the
device, which skips without one: a CUDA kernel has no CPU mode.  On the
card, from the repository root:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(`--noconftest`: tests/conftest.py imports JAX, which the port's machine
need not have; nothing here uses it.)
"""

import numpy as np
import pytest
import torch

from picad_tpu_torch.models.capsules import build_capsnet
from picad_tpu_torch.ops.bn_stats import bn_stats, bn_stats_plain, group_stats
from picad_tpu_torch.ops.fused_head_kernel import (
    composite_convt,
    composite_convt_bwd,
    composite_convt_bwd_plain,
    composite_convt_plain,
)

pytestmark = pytest.mark.cuda

KERNEL_RTOL = 1e-4  # of max|plain|: f32 sums of the same products in another order
BF16_ULP = 2.0**-7  # dx in bf16: the two f32 sums may round to neighbouring bf16 values
SLICE_ATOL = 1e-3  # card vs CPU f32, as chip_smoke.py states


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    """f32 convolutions and matmuls in full f32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [
        (1, 1, 1, 1, 8),  # a single input position: every border masked
        (2, 3, 20, 13, 128),  # ragged tiles in H and W
        (1, 2, 17, 33, 24),  # C not a multiple of 16
        (3, 1, 16, 16, 8),  # T = 1
        (1, 5, 7, 40, 136),  # odd T, C > 128
    ],
)
def test_composite_convt_kernel_matches_plain(card, shape, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    B, C = shape[0], shape[-1]
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    Kc = (0.1 * torch.randn((B, 5, 5, 5, C), generator=g, device=card)).to(dtype)
    before = composite_convt.launches
    out = composite_convt(x, Kc)
    torch.cuda.synchronize()
    assert composite_convt.launches == before + 1
    ref = composite_convt_plain(x, Kc)
    assert out.shape == ref.shape and out.dtype == torch.float32
    err = (out - ref).abs().max().item()
    assert err <= KERNEL_RTOL * ref.abs().max().item(), err


def test_composite_convt_kernel_refuses_what_it_cannot_take(card):
    x = torch.zeros((1, 2, 4, 4, 16), device=card)
    Kc = torch.zeros((1, 5, 5, 5, 16), device=card)
    before = composite_convt.launches
    with pytest.raises(TypeError):
        composite_convt(x.half(), Kc.half())
    with pytest.raises(ValueError, match="C % 8"):
        composite_convt(x[..., :12].contiguous(), Kc[..., :12])
    with pytest.raises(ValueError, match="contiguous"):
        composite_convt(x.transpose(2, 3), Kc)
    with pytest.raises(ValueError, match="one CUDA device"):
        composite_convt(x, Kc.cpu())
    assert composite_convt.launches == before


def test_capsnet_eval_on_card_matches_cpu(card, no_tf32):
    """The whole eval forward at 96^2, f32, seeded weights: the card (with
    the kernel) against the CPU (with the plain version)."""
    clip = np.random.default_rng(1).uniform(0, 1, (2, 8, 96, 96, 3)).astype(np.float32)
    outs = {}
    for dev in (card, torch.device("cpu")):
        model = build_capsnet(seed=1, compute_dtype=torch.float32, device=dev)
        before = composite_convt.launches
        with torch.inference_mode():
            seg, scores, _ = model(torch.from_numpy(clip).to(dev))
        assert composite_convt.launches == before + (dev.type == "cuda")
        outs[dev.type] = torch.sigmoid(seg).cpu().numpy(), scores.cpu().numpy()
    np.testing.assert_array_equal(outs["cuda"][1].argmax(1), outs["cpu"][1].argmax(1))
    np.testing.assert_allclose(outs["cuda"][0], outs["cpu"][0], atol=SLICE_ATOL)
    np.testing.assert_allclose(outs["cuda"][1], outs["cpu"][1], atol=SLICE_ATOL)


def test_capsnet_bf16_on_card_is_finite(card):
    """The production compute type, the default on the card."""
    model = build_capsnet(seed=2, device=card)
    assert model.compute_dtype == torch.bfloat16
    clip = torch.rand((2, 8, 96, 96, 3), device=card)
    with torch.inference_mode():
        seg, scores, _ = model(clip)
    assert seg.dtype == scores.dtype == torch.float32
    assert torch.isfinite(seg).all() and torch.isfinite(scores).all()


def _composite_bwd_inputs(card, shape, dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    B, T, H, W, C = shape
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    Kc = 0.1 * torch.randn((B, 5, 5, 5, C), generator=g, device=card)
    gout = torch.randn((B, 2 * T, 2 * H, 2 * W), generator=g, device=card)
    return gout, x, Kc


def assert_close_to_plain(out, ref, name):
    """f32: within KERNEL_RTOL * max|plain|.  bf16: within one bf16 ulp of
    each plain value on top of that."""
    assert out.shape == ref.shape and out.dtype == ref.dtype, name
    d = (out.float() - ref.float()).abs()
    tol = KERNEL_RTOL * ref.float().abs().max().item()
    if ref.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * ref.float().abs()
    assert bool((d <= tol).all()), (name, d.max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [
        (1, 1, 1, 1, 8),  # one input position
        (2, 3, 20, 13, 128),  # ragged tiles in H and W
        (1, 2, 17, 33, 24),  # C not a multiple of 32
        (3, 1, 16, 16, 8),  # T = 1
        (1, 5, 7, 40, 136),  # odd T, C > 128
    ],
)
def test_composite_convt_bwd_kernel_matches_plain(card, shape, dtype):
    gout, x, Kc = _composite_bwd_inputs(card, shape, dtype)
    before = composite_convt_bwd.launches
    dx, dKc = composite_convt_bwd(gout, x, Kc)
    torch.cuda.synchronize()
    assert composite_convt_bwd.launches == before + 1
    dx_ref, dKc_ref = composite_convt_bwd_plain(gout, x, Kc)
    assert_close_to_plain(dx, dx_ref, "dx")
    assert_close_to_plain(dKc, dKc_ref, "dKc")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_composite_convt_on_card(card, dtype):
    """Gradients reach x and Kc through the kernel (the backward is K2).
    f32: equal to autograd of the plain forward.  bf16: equal to the
    plain backward, which rounds g to bf16 first as the JAX package does
    (autograd of the plain forward would not)."""
    gout, x, Kc = _composite_bwd_inputs(card, (2, 3, 20, 13, 64), dtype, seed=1)
    x.requires_grad_(True)
    Kc.requires_grad_(True)
    before = composite_convt_bwd.launches
    out = composite_convt(x, Kc)
    assert out.grad_fn is not None
    dx, dKc = torch.autograd.grad(out, (x, Kc), gout)
    assert composite_convt_bwd.launches == before + 1
    if dtype == torch.float32:
        dx_ref, dKc_ref = torch.autograd.grad(composite_convt_plain(x, Kc), (x, Kc), gout)
    else:
        dx_ref, dKc_ref = composite_convt_bwd_plain(gout, x.detach(), Kc.detach())
    assert_close_to_plain(dx, dx_ref, "dx")
    assert_close_to_plain(dKc, dKc_ref, "dKc")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,groups",
    [
        ((4, 8, 3, 17, 9), 2),  # S = 459: the scalar path
        ((2, 16, 2, 28, 28), 1),  # S % 8 == 0: 16-byte loads
        ((6, 24, 1, 5, 5), 3),  # S < 1024: the shift is the whole plane
        ((4, 64, 4, 40, 40), 2),
    ],
)
def test_bn_stats_kernel_matches_plain(card, shape, groups, dtype):
    g = torch.Generator(device=card).manual_seed(2)
    x = (2.0 * torch.randn(shape, generator=g, device=card) + 1.5).to(dtype)
    before = bn_stats.launches
    mean, var = bn_stats(x, groups)
    torch.cuda.synchronize()
    assert bn_stats.launches == before + 1
    m_ref, v_ref = bn_stats_plain(x, groups)
    assert mean.shape == var.shape == (groups, shape[1])
    torch.testing.assert_close(mean, m_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(var, v_ref, rtol=1e-4, atol=1e-6)


def test_bn_stats_kernel_cancellation_stress(card):
    """|mean| = 100 std: the shifted sums keep two-pass accuracy (against
    float64 two-pass statistics)."""
    g = torch.Generator(device=card).manual_seed(3)
    base = 100.0 * torch.randn((1, 8, 1, 1, 1), generator=g, device=card)
    x = base + 0.1 * torch.randn((4, 8, 4, 32, 32), generator=g, device=card)
    mean, var = bn_stats(x, 2)
    x64 = x.double().reshape(2, 2, 8, -1).transpose(1, 2).flatten(2)
    torch.testing.assert_close(mean.double(), x64.mean(-1), rtol=1e-5, atol=0)
    torch.testing.assert_close(var.double(), x64.var(-1, unbiased=False), rtol=2e-4, atol=0)


def test_group_stats_backward_on_card(card):
    g = torch.Generator(device=card).manual_seed(4)
    x = (torch.randn((4, 8, 2, 16, 16), generator=g, device=card) + 3.0).requires_grad_(True)
    mean, var = group_stats(x, 2)
    loss = (mean * var).sum() + mean.square().sum()
    (dx,) = torch.autograd.grad(loss, x)
    xg = x.reshape(2, 2, 8, -1)
    m2 = xg.mean(dim=(1, 3))
    v2 = (xg - m2[:, None, :, None]).square().mean(dim=(1, 3))
    (dx_ref,) = torch.autograd.grad((m2 * v2).sum() + m2.square().sum(), x)
    torch.testing.assert_close(dx, dx_ref, rtol=1e-4, atol=1e-6)


def test_train_step_on_card_matches_cpu(card, no_tf32):
    """One f32 train step at 96^2, bs 2, folded views, bv, dropout 0, same
    weights and batch: the card (K1, K2, and K6 for every BN, with the
    one-pass threshold at 0) against the CPU (the plain versions)."""
    from chip_smoke import train_step_card_vs_cpu

    res = train_step_card_vs_cpu(seed=1, size=96)
    assert res["ok"], res
