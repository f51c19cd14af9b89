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

from picad_tpu_torch.models.capsules import PrimaryCaps, build_capsnet
from picad_tpu_torch.ops import fused_head_kernel, tapconv
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
        (1, 2, 3, 300, 136),  # W > 128: three w-tiles in bf16; two channel groups
        (1, 1, 2, 130, 264),  # W just past one w-tile; three channel groups
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


def _nan_guarded(t: torch.Tensor, guard: int = 4096) -> torch.Tensor:
    """A copy of t inside a buffer whose `guard` elements on either side
    are NaN: a kernel that reads past t poisons its sums."""
    buf = torch.full((t.numel() + 2 * guard,), float("nan"), dtype=t.dtype, device=t.device)
    view = buf[guard:guard + t.numel()].view(t.shape)
    view.copy_(t)
    return view


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
        (1, 2, 3, 300, 136),  # W > 128: three tiles a row in bf16; two channel chunks
        (2, 1, 2, 129, 8),  # W just past one tile
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
def test_composite_convt_kernels_are_deterministic(card, dtype):
    """Two launches of K1 and of K2 at the train shape give the same bits:
    every output written once, K2's dKc partials summed in a fixed order,
    no atomics."""
    gout, x, Kc = _composite_bwd_inputs(card, (16, 4, 112, 112, 128), dtype, seed=3)
    outs = [composite_convt(x, Kc) for _ in range(2)]
    grads = [composite_convt_bwd(gout, x, Kc) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]), "K1"
    assert torch.equal(grads[0][0], grads[1][0]), "K2 dx"
    assert torch.equal(grads[0][1], grads[1][1]), "K2 dKc"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 20, 13, 128), (1, 2, 3, 300, 24)])
def test_composite_convt_kernels_read_nothing_outside_their_operands(card, shape, dtype):
    """x, Kc and g between NaN guards: the kernels must read zeros, not
    memory, for w = -1, w >= W, taps past 125 (K2's Kc map) and g outside
    its planes."""
    gout, x, Kc = _composite_bwd_inputs(card, shape, dtype, seed=4)
    Kc = Kc.to(dtype)
    xg, kg, gg = _nan_guarded(x), _nan_guarded(Kc), _nan_guarded(gout)
    out = composite_convt(xg, kg)
    dx, dKc = composite_convt_bwd(gg, xg, kg)
    torch.cuda.synchronize()
    ref = composite_convt_plain(x, Kc)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= KERNEL_RTOL * ref.abs().max().item()
    dx_ref, dKc_ref = composite_convt_bwd_plain(gout, x, Kc)
    assert_close_to_plain(dx, dx_ref, "dx")
    assert_close_to_plain(dKc, dKc_ref, "dKc")


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_composite_convt_kernel_refuses_a_plan_it_is_not_built_for(card, monkeypatch, kernel):
    """bf16 K1 at 4 rows a block, bf16 K2 with splits that miss tiles:
    the kernel launches nothing and the wrapper raises."""
    gout, x, Kc = _composite_bwd_inputs(card, (2, 3, 20, 13, 16), torch.bfloat16)
    if kernel == "fwd":
        plan = fused_head_kernel.fwd_plan
        monkeypatch.setattr(fused_head_kernel, "fwd_plan", lambda *a: plan(*a)._replace(rows=4))
        fn, args = composite_convt, (x, Kc)
    else:
        plan = fused_head_kernel.bwd_plan
        monkeypatch.setattr(fused_head_kernel, "bwd_plan",
                            lambda *a: plan(*a)._replace(splits=1, per=1))
        fn, args = composite_convt_bwd, (gout, x, Kc)
    before = fn.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fn(*args)
    assert fn.launches == before


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


TAP_CASES = [
    ((1, 9, 9, 8), (9, 9, 8, 8)),  # a single output position
    ((2, 10, 9, 24), (3, 5, 24, 16)),  # ragged canvas, kh != kw, Ci != Co, Ci % 32 != 0
    ((3, 13, 11, 40), (9, 9, 40, 32)),  # ragged canvas, Co = 32 (the act conv's tile)
    ((2, 28, 28, 64), (9, 9, 64, 512)),  # Co = 512 (the pose conv's width)
    ((1, 4, 8, 9, 8), (3, 3, 3, 8, 8)),  # rank 3
    ((2, 30, 16), (7, 16, 8)),  # rank 1
]


# bf16 K3's split path (Co <= 64) at ragged row counts, and K4's tap table
# over several 192-row tiles
SPLIT_CASES = [
    ((14, 28, 28, 832), (9, 9, 832, 32)),  # the act conv at the serving batch: 5600 rows
    ((2, 13, 11, 24), (5, 3, 24, 16)),  # Co 16, small ragged canvas, kh != kw
    ((3, 12, 10, 40), (3, 3, 40, 64)),  # Co 64, the widest split tile
]
DX_TABLE_CASES = [
    ((2, 6, 12, 10, 16), (3, 5, 3, 16, 24)),  # rank 3, kh != kw: 8 tiles
    ((2, 20, 18, 32), (5, 3, 32, 64)),  # kh != kw, Co % 64 == 0 (W by TMA): 4 tiles
    ((2, 9, 10, 96), (3, 3, 96, 16)),  # Ci 96: K4's 256-wide N tile
]
# bf16 K5's two forms (tapconv.dw_plan): the canvas form for Co <= 64 (B
# boxes of two taps up to Co 32, else one; tap groups; split), the
# valid-row form above; ragged Ci tiles, and reductions (valid or canvas
# rows) that are not a multiple of the 64-row step
DW_CASES = [
    ((2, 30, 16), (7, 16, 8)),  # rank 1, Co 8: two taps a box, 24 of each's 32 columns past Co
    ((1, 4, 8, 9, 8), (3, 3, 3, 8, 40)),  # rank 3, Co 40: a tap a box, 24 columns past Co
    ((3, 13, 11, 72), (9, 9, 72, 40)),  # Ci 72 (8 rows in the second warpgroup), 429 canvas rows
    ((2, 10, 9, 24), (3, 5, 24, 32)),  # Co 32: 3 boxes a row of 5 taps, groups of 4, 4, 1
    ((2, 9, 10, 96), (3, 3, 96, 64)),  # Co 64, the canvas form's widest: a tap a box
    ((3, 28, 28, 832), (9, 9, 832, 32)),  # the act conv at B 3: 2352 canvas rows, 45 boxes
    ((2, 13, 12, 72), (5, 5, 72, 512)),  # valid-row form, Ci 72, 144 valid rows
    ((2, 71, 64), (7, 64, 512)),  # valid-row form, rank 1: 130 valid rows
    ((1, 28, 28, 832), (9, 9, 832, 512)),  # the pose conv at B 1: 400 valid rows, Ci tile 7 half full
    ((2, 12, 12, 16), (3, 3, 16, 136)),  # valid-row form, Co 136: one 256-wide tile, 2 boxes past Co
]


def _tap_inputs(card, x_shape, k_shape, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    out = (x_shape[0],) + tuple(d - k + 1 for d, k in zip(x_shape[1:-1], k_shape[:-2]))
    x = (0.5 * torch.randn(x_shape, generator=gen, device=card)).to(dtype)
    w = (0.05 * torch.randn(k_shape, generator=gen, device=card)).to(dtype)
    g = torch.randn(out + (k_shape[-1],), generator=gen, device=card).to(dtype)
    return x, w, g


def _check_tap_kernels(card, x_shape, k_shape, dtype):
    """K3, K4 and K5 once each against their plain versions."""
    x, w, g = _tap_inputs(card, x_shape, k_shape, dtype)
    fns, co = (tapconv.tap_conv_fwd, tapconv.tap_conv_dx, tapconv.tap_conv_dw), k_shape[-1]
    before = [(fn.launches, fn.launches_by_co.get(co, 0)) for fn in fns]
    out = tapconv.tap_conv_fwd(x, w)
    dx = tapconv.tap_conv_dx(g, w, x.shape)
    dw = tapconv.tap_conv_dw(x, g, w.shape)
    torch.cuda.synchronize()
    assert [(fn.launches, fn.launches_by_co[co]) for fn in fns] == [
        (n + 1, n_co + 1) for n, n_co in before]
    assert_close_to_plain(out, tapconv.tap_conv_fwd_plain(x, w), "K3 out")
    assert_close_to_plain(dx, tapconv.tap_conv_dx_plain(g, w, x.shape), "K4 dx")
    assert_close_to_plain(dw, tapconv.tap_conv_dw_plain(x, g, w.shape), "K5 dW")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,k_shape", TAP_CASES)
def test_tap_conv_kernels_match_plain(card, no_tf32, x_shape, k_shape, dtype):
    _check_tap_kernels(card, x_shape, k_shape, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("co", [512, 32])
def test_tap_conv_kernels_at_the_train_shape(card, no_tf32, co, dtype):
    """PrimaryCaps' pose (Co 512) and act (Co 32) convs at the train step's
    x (16, 28, 28, 832)."""
    _check_tap_kernels(card, (16, 28, 28, 832), (9, 9, 832, co), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,k_shape", SPLIT_CASES + DX_TABLE_CASES)
def test_tap_conv_kernels_on_the_split_and_table_paths(card, no_tf32, x_shape, k_shape, dtype):
    if k_shape[-1] <= 64:  # bf16 K3 splits its reduction here
        rows = x_shape[0] * int(np.prod([d - k + 1 for d, k in zip(x_shape[1:-1], k_shape)]))
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        assert tapconv.fwd_split_plan(rows, k_shape[-2], k_shape[-1],
                                      int(np.prod(k_shape[:-2])), sms)[0] > 1
    _check_tap_kernels(card, x_shape, k_shape, dtype)


@pytest.mark.parametrize("x_shape,k_shape", DW_CASES)
def test_tap_conv_dw_kernel_matches_plain(card, x_shape, k_shape):
    """bf16 K5 in the form dw_plan gives it, against its plain version."""
    x, _, g = _tap_inputs(card, x_shape, k_shape, torch.bfloat16, seed=11)
    co = k_shape[-1]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = tapconv.dw_plan(x_shape[0], x_shape[1:-1], k_shape[:-2], k_shape[-2], co, sms)
    assert plan.form == ("canvas" if co <= 64 else "rows")
    before = tapconv.tap_conv_dw.launches_by_co.get(co, 0)
    dw = tapconv.tap_conv_dw(x, g, k_shape)
    torch.cuda.synchronize()
    assert tapconv.tap_conv_dw.launches_by_co[co] == before + 1
    assert_close_to_plain(dw, tapconv.tap_conv_dw_plain(x, g, k_shape), f"K5 dW ({plan.form})")


@pytest.mark.parametrize("co", [32, 512])
def test_tap_conv_bf16_kernels_are_deterministic(card, co):
    """Two launches of K3 (the split path at Co 32), of K4 (the tap table;
    W by TMA at Co 512) and of K5 (the canvas form's split at Co 32, the
    valid-row form at 512) give the same bits: fixed summation order, no
    atomics."""
    x, w, g = _tap_inputs(card, (16, 28, 28, 832), (9, 9, 832, co), torch.bfloat16, seed=7)
    runs = [(tapconv.tap_conv_fwd(x, w), tapconv.tap_conv_dx(g, w, x.shape),
             tapconv.tap_conv_dw(x, g, w.shape)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]), "K3"
    assert torch.equal(runs[0][1], runs[1][1]), "K4"
    assert torch.equal(runs[0][2], runs[1][2]), "K5"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape,k_shape", [TAP_CASES[1], TAP_CASES[2], SPLIT_CASES[2]]
                         + DX_TABLE_CASES + [DW_CASES[2], DW_CASES[6]])
def test_tap_conv_kernels_read_nothing_outside_their_operands(card, no_tf32, x_shape,
                                                              k_shape, dtype):
    """Ragged canvases, every operand between NaN guards (gcan too, through
    the launch helper the K4 wrapper uses): the rows before and past the
    canvas must read as zeros inside the kernels, never from memory.
    In bf16 K3 takes its split path, K4 its tap table (W by TMA at Co 64)
    and K5 the form dw_plan gives it."""
    x, w, g = _tap_inputs(card, x_shape, k_shape, dtype, seed=3)
    xg, wg, gg = _nan_guarded(x), _nan_guarded(w), _nan_guarded(g)
    out = tapconv.tap_conv_fwd(xg, wg)
    dw = tapconv.tap_conv_dw(xg, gg, w.shape)
    pads = [0, 0] + [p for d, o in zip(reversed(x.shape[1:-1]), reversed(g.shape[1:-1]))
                     for p in (0, d - o)]
    gcan = _nan_guarded(torch.nn.functional.pad(g, pads))
    dx = torch.empty_like(x)
    tapconv._launch(tapconv._DX, "tap_conv_dx", gcan, wg, dx, x.shape, w.shape)
    torch.cuda.synchronize()
    assert_close_to_plain(out, tapconv.tap_conv_fwd_plain(x, w), "K3 out")
    assert_close_to_plain(dx, tapconv.tap_conv_dx_plain(g, w, x.shape), "K4 dx")
    assert_close_to_plain(dw, tapconv.tap_conv_dw_plain(x, g, w.shape), "K5 dW")


def test_tap_conv_kernels_refuse_what_they_cannot_take(card):
    x, w, g = _tap_inputs(card, (1, 6, 6, 16), (3, 3, 16, 8), torch.float32)
    before = tapconv.tap_conv_fwd.launches
    with pytest.raises(TypeError):
        tapconv.tap_conv_fwd(x.half(), w.half())
    with pytest.raises(ValueError, match="% 8"):
        tapconv.tap_conv_fwd(x[..., :12].contiguous(), w[:, :, :12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tapconv.tap_conv_fwd(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="spatial dims"):  # rank 4
        tapconv.tap_conv_fwd(torch.zeros((1, 2, 2, 6, 6, 16), device=card),
                             torch.zeros((1, 1, 3, 3, 16, 8), device=card))
    with pytest.raises(ValueError, match="one CUDA device"):
        tapconv.tap_conv_valid(x, w.cpu())
    assert tapconv.tap_conv_fwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["fwd", "dx", "dw"])
def test_tap_conv_kernel_refuses_a_tile_it_is_not_built_for(card, monkeypatch, mode, dtype):
    """The wrapper's tile reaches the kernel, which launches nothing at a
    tile it is not built for (64 x 128; for bf16 K4 that is a tap table
    of one row per 64 canvas rows, which the 192-row body would misread;
    for bf16 K5 a plan of groups of four taps at that width)."""
    x, w, g = _tap_inputs(card, (2, 12, 12, 16), (9, 9, 16, 8), dtype)
    tile = tapconv.kernel_tile
    monkeypatch.setattr(tapconv, "kernel_tile", lambda *a: (64, 128, tile(*a)[2]))
    fn = {"fwd": tapconv.tap_conv_fwd, "dx": tapconv.tap_conv_dx, "dw": tapconv.tap_conv_dw}[mode]
    args = {"fwd": (x, w), "dx": (g, w, x.shape), "dw": (x, g, w.shape)}[mode]
    before = fn.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        fn(*args)
    assert fn.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_primary_caps_gradients_on_card_match_cpu(card, no_tf32, dtype):
    """PrimaryCaps at cin 64, 12^2: output and the gradients of x and of
    the four parameters on the card (K3, K4, K5) against the CPU (the plain
    versions), same weights, each within its tolerance of max|CPU|."""
    gen = torch.Generator().manual_seed(5)
    outs = {}
    pc = PrimaryCaps(cin=64, compute_dtype=dtype)
    for p in pc.parameters():
        p.data.normal_(0.0, 0.1, generator=gen)
    x = 0.2 * torch.randn((2, 64, 12, 12), generator=gen)
    g = torch.randn((2, 4, 4, 544), generator=gen)
    for dev in (card, torch.device("cpu")):
        m = PrimaryCaps(cin=64, compute_dtype=dtype).to(dev)
        m.load_state_dict(pc.state_dict())
        xd = x.to(dev).requires_grad_(True)
        before = tapconv.tap_conv_dx.launches
        out = m(xd)
        grads = torch.autograd.grad(out, [xd] + list(m.parameters()), g.to(dev))
        assert tapconv.tap_conv_dx.launches == before + 2 * (dev.type == "cuda")
        outs[dev.type] = [t.detach().cpu() for t in (out, *grads)]
    # bf16: the conv outputs and dW round to bf16 before the f32 bias add
    # and the cast back, so one bf16 ulp of the largest value
    rtol = KERNEL_RTOL + (BF16_ULP if dtype == torch.bfloat16 else 0.0)
    errs = {name: ((got - ref).abs().max() / ref.abs().max()).item()
            for name, got, ref in zip(["out", "x", *dict(pc.named_parameters())],
                                      outs["cuda"], outs["cpu"])}
    assert all(e <= rtol for e in errs.values()), errs


def test_train_step_on_card_matches_cpu(card, no_tf32):
    """One f32 train step at 96^2, bs 2, folded views, bv, dropout 0, same
    weights and batch: the card (K1, K2, and K6 for every BN, with the
    one-pass threshold at 0) against the CPU (the plain versions)."""
    from chip_smoke import train_step_card_vs_cpu

    res = train_step_card_vs_cpu(seed=1, size=96)
    assert res["ok"], res
