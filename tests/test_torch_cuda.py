"""The port's CUDA kernels on the card, held against their plain versions,
and the train step's CUDA graph (train/graph.py) against the eager step.

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


STEM_RTOL = 1e-2  # bf16, as chip_smoke.py phase 10 states


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_s2d_on_card_matches_plain(card, no_tf32, monkeypatch, channels_last, dtype):
    """StemS2D against the plain stem on the card, train mode, bn_groups
    2: the output, dW and the BN weight's gradient (f32 within 1e-4 of
    max|plain|, bf16 within STEM_RTOL); the packed uint8 branch against
    the f32 branch in f32."""
    from picad_tpu_torch.models import i3d
    from picad_tpu_torch.models.layers import Unit3D

    monkeypatch.setattr(i3d, "S2D_CHANNELS_LAST", channels_last)
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn((64, 3, 7, 7, 7), generator=gen, device="cuda") * (3 * 343) ** -0.5
    clip = torch.randint(0, 256, (4, 8, 32, 48, 3), generator=gen, device="cuda",
                         dtype=torch.uint8)
    x = (clip.float() / 255.0).permute(0, 4, 1, 2, 3)
    r = torch.randn((4, 64, 4, 16, 24), generator=gen, device="cuda").to(dtype)
    outs = []
    for cls in (Unit3D, i3d.StemS2D):
        m = cls(3, 64, (7, 7, 7), (2, 2, 2), compute_dtype=dtype, bn_groups=2).cuda()
        with torch.no_grad():
            m.conv3d.weight.copy_(w)
        y = m(x)
        y.backward(r)
        outs.append((y.detach(), m.conv3d.weight.grad, m.bn.weight.grad))
    rtol = STEM_RTOL if dtype == torch.bfloat16 else KERNEL_RTOL
    for got, ref in zip(outs[1], outs[0]):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= rtol * ref.float().abs().max().item(), err
    # the packed uint8 branch against the f32 branch, in f32 (TF32 off)
    m = i3d.StemS2D(3, 64, (7, 7, 7), (2, 2, 2)).cuda().eval()
    with torch.no_grad():
        m.conv3d.weight.copy_(w)
        packed = m(i3d.s2d_pack(clip).permute(0, 4, 1, 2, 3))
        ref = m(x)
    assert (packed - ref).abs().max() <= KERNEL_RTOL * ref.abs().max()


def test_prefetch_loader_on_card_through_pinned_slots(card):
    """Ten batches through three pinned slots and a side stream: every
    batch arrives on the card, in order, with its own values, also when
    the consumer holds them all and the producer refills slots."""
    from picad_tpu_torch.data.loader import PrefetchLoader

    batches = [{"data": np.full((2, 8, 16, 16, 3), i, np.uint8),
                "row_mask": np.full((2,), i, np.float32)} for i in range(10)]
    held = list(PrefetchLoader(iter(batches), prefetch=2))
    torch.cuda.synchronize()
    assert len(held) == 10
    for i, b in enumerate(held):
        assert b["data"].is_cuda and b["data"].dtype == torch.uint8
        assert bool((b["data"] == i).all()) and bool((b["row_mask"] == i).all())


def _small_cache_and_batchers(card, hw, bs):
    from picad_tpu_torch.data.dataset import ClipDataset
    from picad_tpu_torch.data.device_cache import DeviceClipDataset, DeviceVideoCache
    from picad_tpu_torch.data.loader import SemiSupervisedBatcher
    from picad_tpu_torch.data.sources import ConcatVideoSource, SyntheticVideoSource

    def src(labeled, seed):
        return SyntheticVideoSource(4, video_len=24, height=96, width=112,
                                    labeled_fraction=labeled, seed=seed)

    cache = DeviceVideoCache.build(ConcatVideoSource([src(1.0, 1), src(0.0, 2)]),
                                   budget_bytes=1 << 30, device=card)
    kw = dict(batch_size=bs, seed=0, workers=2, process_index=0, process_count=1)
    meta = SemiSupervisedBatcher(
        *(DeviceClipDataset(cache, index_offset=o, length=4, train=True, clip_shape=hw)
          for o in (0, 4)), **kw)
    host = SemiSupervisedBatcher(
        *(ClipDataset(src(f, s), train=True, clip_shape=hw, device_prep=True)
          for f, s in ((1.0, 1), (0.0, 2))), **kw)
    return cache, meta, host


def test_device_cache_on_card_matches_host_batches(card):
    """The card-assembled batches (assembler on the loader's side stream)
    equal the host streaming batches bit for bit, over two epochs."""
    from picad_tpu_torch.data.device_cache import make_assembler_put
    from picad_tpu_torch.data.loader import PrefetchLoader

    hw = (48, 64)
    cache, meta, host = _small_cache_and_batchers(card, hw, 4)
    assert cache.pool_video.is_cuda
    put = make_assembler_put({"pool_video": cache.pool_video, "pool_mask": cache.pool_mask}, hw)
    for epoch in (0, 1):
        dev = list(PrefetchLoader(meta.epoch(epoch), put_fn=put))
        ref = list(host.epoch(epoch))
        assert len(dev) == len(ref) > 0
        for d, h in zip(dev, ref):
            assert set(d) == set(h)
            for k in h:
                assert d[k].is_cuda, k
                np.testing.assert_array_equal(d[k].cpu().numpy(), h[k], err_msg=k)


def test_train_steps_through_both_input_paths_on_card(card):
    """Two bf16 train steps at 80^2, batch 2, through the device cache
    and through host streaming: finite losses, K1 and K2 once a step."""
    from picad_tpu_torch.config import LossConfig
    from picad_tpu_torch.data.device_cache import make_assembler_put
    from picad_tpu_torch.data.loader import PrefetchLoader
    from picad_tpu_torch.train.state import create_train_state
    from picad_tpu_torch.train.step import make_train_step

    hw = (80, 80)
    cache, meta, host = _small_cache_and_batchers(card, hw, 2)
    put = make_assembler_put({"pool_video": cache.pool_video, "pool_mask": cache.pool_mask}, hw)
    step = make_train_step(LossConfig(bv=True, n_frames=5, wt_cons=0.1, thresh_epoch=11))
    for loader in (PrefetchLoader(meta.epoch(0), put_fn=put), PrefetchLoader(host.epoch(0))):
        state = create_train_state(seed=0, device=card, bn_groups=2)
        k1, k2 = composite_convt.launches, composite_convt_bwd.launches
        it = iter(loader)
        for _ in range(2):
            state, metrics = step(state, next(it), 12.0, 0.5)
            assert all(np.isfinite(float(v)) for v in metrics.values())
        it.close()
        assert (composite_convt.launches - k1, composite_convt_bwd.launches - k2) == (2, 2)


@pytest.mark.parametrize("cell", ["ucf101_train_bs8", "ucf101_serve_cb14"])
def test_bench_cell_short_run_on_card(card, cell):
    """Each bench cell at full width, shortened, with its traced run:
    every metric finite, 0 < mfu < 1, the kernel table's launches (the
    traced run raises otherwise)."""
    from picad_tpu_torch.bench import Lengths, load_config, run_cell

    # 38 train steps before the check step, as chip_smoke.py's phase 12:
    # the train check's limits hold from ~40 steps on (PERF.md section 6)
    short = Lengths(warmup=2, steps=8, sync_steps=8, stream_steps=8, h2d_reps=2, serve_warmup=1,
                    serve_calls=4, trace_calls=1, sync_probe_steps=1, component_iters=2)
    r = run_cell(cell, load_config(), seed=0, device=card, lengths=short, trace=True)
    assert r["correct"], r["check"]
    assert r["device"]["name"] == torch.cuda.get_device_name(card)
    for k in r["units"]:
        assert isinstance(r[k], (int, float)) and np.isfinite(r[k]), k
    assert 0 < r["mfu"] < 1


@pytest.mark.parametrize("cell", ["train", "serve"])
def test_bench_check_calls_the_control_wrong_on_card(card, cell):
    """The bench's correctness check at full width: the configuration's
    bf16 path on the card within check.LIMITS of the CPU f32 reference,
    and the float8-weight control outside them."""
    from picad_tpu_torch.bench import calibrate, load_config

    fn = calibrate.train_check if cell == "train" else calibrate.serve_check
    n = 40 if cell == "train" else 3  # train steps or serving calls, as calibrate's defaults
    sound, ctl = (fn(load_config(), 0, n, control) for control in (False, True))
    assert sound["correct"], sound
    assert not ctl["correct"], ctl


def _card_trainer(card, save_root, epochs: int, exp_id: str):
    """The train CLI's path on the card at the bench's widths: 224^2,
    batch 8, bf16, the device cache, 16 synthetic videos (4 steps an
    epoch, 4 val videos)."""
    from picad_tpu_torch.cli.common import args_to_config, build_parser, build_train_datasets
    from picad_tpu_torch.train.loop import Trainer

    args = build_parser("ucf101").parse_args(
        ["--synthetic", "--bs", "8", "--epochs", str(epochs), "--pf", "2", "--wt_cons", "0.1",
         "--bv", "--n_frames", "5", "--thresh_epoch", "1", "--device_cache_gb", "2",
         "--save_root", str(save_root), "--exp_id", exp_id])
    cfg = args_to_config(args, "ucf101")
    cfg.data.synthetic_num_videos = 16
    lab, unl, val = build_train_datasets(cfg, device=card)
    assert lab.cache.pool_video.is_cuda  # the card-resident video cache
    return Trainer(cfg, labeled_dataset=lab, unlabeled_dataset=unl, val_dataset=val, device=card)


def test_trainer_fits_and_resumes_on_card(card, tmp_path):
    """2 epochs, then a resume for a third: K1-K6 launched (1, 1, 2, 2, 2,
    4) a train step and K1 once, K3 twice a validation batch; finite
    logged losses; the resumed run starts at epoch 3 with the LR and the
    scheduler counters of the first."""
    import json
    import os

    from picad_tpu_torch.utils.profiling import read_launches, reset_launches

    first = _card_trainer(card, tmp_path, 2, "first")
    reset_launches()
    first.fit()
    steps, val_batches = 8, 2  # 2 epochs of 4 steps and one val batch
    assert read_launches() == {"composite_convt": steps + val_batches,
                               "composite_convt_bwd": steps, "bn_stats": 4 * steps,
                               "tap_conv_fwd": 2 * (steps + val_batches),
                               "tap_conv_dx": 2 * steps, "tap_conv_dw": 2 * steps}
    ckpt = next(os.path.join(first.save_dir, f"best_model_{t}_loss_2") for t in ("train", "val")
                if os.path.isdir(os.path.join(first.save_dir, f"best_model_{t}_loss_2")))
    second = _card_trainer(card, tmp_path, 3, "second")
    assert second.restore(ckpt) == 3
    assert second.state.learning_rate() == first.state.learning_rate()
    assert (second.scheduler.best, second.scheduler.num_bad_epochs) == \
        (first.scheduler.best, first.scheduler.num_bad_epochs)
    second.fit(3)
    for tr in (first, second):
        with open(os.path.join(tr.save_dir, "metrics.jsonl")) as f:
            losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
        assert losses and np.isfinite(losses).all()
    assert [s["epoch"] for s in second.epoch_stats] == [3]


def test_sweep_checkpoints_on_card(card, tmp_path):
    """The f32 sweep on the card: one eval model loaded with each
    checkpoint; K1 once and K3 twice a padded clip batch, nothing else."""
    import os

    from picad_tpu_torch.checkpoint.manager import CheckpointIO
    from picad_tpu_torch.data.dataset import EvalVideoDataset
    from picad_tpu_torch.data.sources import SyntheticVideoSource
    from picad_tpu_torch.eval.clips import chunk_video_into_clips
    from picad_tpu_torch.eval.runner import sweep_checkpoints
    from picad_tpu_torch.train.state import create_train_state
    from picad_tpu_torch.utils.profiling import read_launches, reset_launches

    state = create_train_state(seed=0, device=card, bn_groups=2)
    for epoch in (1, 2):
        CheckpointIO().save(str(tmp_path / f"best_model_train_loss_{epoch}"), state)
    ds = EvalVideoDataset(SyntheticVideoSource(2, num_classes=24, seed=5))
    batches = sum(-(-chunk_video_into_clips(v, m)[0].shape[0] // 14) for v, m, _ in ds)
    reset_launches()
    results = sweep_checkpoints(str(tmp_path), ds, split="train", nan_safe=True, device=card)
    n = 2 * batches
    assert read_launches() == {"composite_convt": n, "composite_convt_bwd": 0, "bn_stats": 0,
                               "tap_conv_fwd": 2 * n, "tap_conv_dx": 0, "tap_conv_dw": 0}
    assert len(results) == 2
    # the same weights twice: the same summary, and the first kept
    a, b = results.values()
    np.testing.assert_array_equal(a["fmAP"], b["fmAP"])
    assert sorted(os.listdir(tmp_path)) == ["best_model_train_loss_1"]


# ---- the data-parallel path (parallel/mesh.py) on the card ----------------


def test_sync_bn_through_k6_two_ranks_on_one_card(card, tmp_path):
    """Two gloo ranks on cuda:0, each with 2 rows of each of 2 views, every
    BN on K6 (BN_ONEPASS_MIN 0): the values, gradients and running stats
    of one process's K6 BatchNorm on the whole batch."""
    import torch_parallel_ranks as ranks  # tests/, which pytest puts on sys.path

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((8, 16, 2, 12, 12)) * 3 + 40).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    got = [g["onepass"] for g in ranks.run_ranks(
        "sync_bn", 2, tmp_path, {"x": x, "dy": dy, "groups": 2}, device="cuda:0")]
    launches = bn_stats.launches
    ref = ranks.sync_bn(torch.from_numpy(x).to(card), torch.from_numpy(dy).to(card), 2, 0)
    assert bn_stats.launches > launches  # the reference ran K6 too

    def near(a, b, tol=1e-5):
        return float((a - b).abs().max()) <= tol * float(b.abs().max())

    for key in ("y", "dx"):
        assert near(ranks.from_views([g[key] for g in got]), ref[key]), key
    for key in ("dweight", "dbias"):
        assert near(got[0][key] + got[1][key], ref[key]), key
    for key in ("mean", "var", "running_mean", "running_var"):
        assert torch.equal(got[0][key], got[1][key]), key
        assert near(got[0][key], ref[key]), key
    assert near(ranks.from_views([g["dx_stats"] for g in got]), 2 * ref["dx_stats"])


def test_nccl_world_one_is_the_identity(card):
    """A one-rank NCCL group runs every collective of the path; K6's sync-BN,
    the global losses and the gradient average then equal the results
    without a group, bit for bit."""
    import torch.distributed as dist

    from picad_tpu_torch.config import LossConfig
    from picad_tpu_torch.models import layers
    from picad_tpu_torch.parallel import mesh
    from picad_tpu_torch.train.step import compute_losses

    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((8, 64, 2, 28, 28), device=card, generator=g) * 2 + 5
    seg = torch.randn((4, 8, 16, 16), device=card, generator=g)
    scores = torch.rand((4, 24), device=card, generator=g)
    gt = (torch.rand((4, 8, 16, 16), device=card, generator=g) > 0.6).float()
    action = torch.tensor([1, 2, 3, 4], device=card)
    flags = torch.tensor([1.0, 0.0, 1.0, 0.0], device=card)
    rows = torch.tensor([1.0, 1.0, 1.0, 0.0], device=card)

    def run():
        bn = layers.TorchBatchNorm(64, stats_groups=2).to(card)
        xi = x.clone().requires_grad_()
        y = bn(xi)
        ins = [t.clone().requires_grad_() for t in (seg, seg.flip(3), scores)]
        total, metrics = compute_losses(*ins, gt, action, flags, rows,
                                        LossConfig(bv=True, gv=True, n_frames=5), 0.5)
        (total + y.square().mean()).backward()
        params = [torch.nn.Parameter(torch.zeros(3, device=card)) for _ in range(2)]
        for k, p in enumerate(params):
            p.grad = torch.full((3,), float(k + 1), device=card)
        mesh.all_reduce_grads(params)
        return ([y.detach(), xi.grad, bn.running_mean, bn.running_var, total.detach()]
                + [t.grad for t in ins] + [p.grad for p in params])

    saved = layers.BN_ONEPASS_MIN
    layers.BN_ONEPASS_MIN = 0
    try:
        alone = run()
        mesh.initialize_distributed(f"tcp://localhost:{mesh.free_port()}", 1, 0,
                                    device="cuda:0", backend="nccl")
        try:
            assert mesh.is_active() and mesh.world_size() == 1
            grouped = run()
        finally:
            dist.destroy_process_group()
    finally:
        layers.BN_ONEPASS_MIN = saved
    for i, (a, b) in enumerate(zip(alone, grouped)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k,s,offset", [
    ((2, 8, 3, 23, 17), (1, 3, 3), (1, 2, 2), 0),  # odd H and W: a pad on each side
    ((2, 8, 4, 22, 16), (1, 3, 3), (1, 2, 2), 0),  # even: one pad above
    ((2, 8, 4, 16, 24), (1, 3, 3), (1, 2, 2), 0),  # rows of 16-byte vectors, as at MaxPool3d_2a
    ((2, 8, 3, 13, 22), (1, 3, 3), (1, 2, 2), 0),  # a ragged vector tail, 44-byte bf16 rows
    ((2, 8, 4, 16, 24), (1, 3, 3), (1, 2, 2), 1),  # x one element past an aligned address
    ((2, 8, 5, 9, 11), (3, 3, 3), (2, 1, 1), 0),  # up to 18 windows an element
    ((2, 8, 2, 14, 28), (3, 3, 3), (2, 1, 1), 0),  # 56-byte bf16 rows, as at MaxPool3d_4a
    ((2, 8, 3, 12, 10), (3, 3, 3), (2, 1, 1), 0),  # a ragged tail, 20-byte bf16 rows
    ((2, 8, 3, 7, 10), (2, 2, 2), (2, 2, 2), 0),  # MaxPool3d_5a: the run-time window
    ((2, 8, 7, 9, 13), (3, 2, 3), (2, 1, 2), 0),  # another run-time window, pads on each side
])
def test_max_pool_bwd_kernel_matches_plain(card, shape, k, s, offset, dtype, ties):
    """The strided pools' backward kernel against its plain version on
    post-ReLU inputs, with planted equal positive maxima (`ties`, the
    values rounded to integers): f32 bit for bit, bf16 within one bf16
    ulp; twice on the same input, bit for bit; one launch a call.  The
    model's two windows run their compile-time instantiations, any other
    window the run-time one."""
    from picad_tpu_torch.ops import convops

    g = torch.Generator(device=card).manual_seed(1)
    x = torch.relu(torch.randn(shape, generator=g, device=card))
    x = (x.round() if ties else x).to(dtype)
    if offset:  # a contiguous view whose data starts off a vector boundary
        x = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(shape)
    pads = [convops.same_pads(d, kk, ss) for d, kk, ss in zip(shape[2:], k, s)]
    y = torch.nn.functional.max_pool3d(convops._pad_spatial(x, pads), k, s)
    gy = torch.randn(y.shape, generator=g, device=card).to(dtype)
    args = (x, y, gy, k, s, tuple(lo for lo, _ in pads))
    before = convops.max_pool_bwd.launches
    out, again = convops.max_pool_bwd(*args), convops.max_pool_bwd(*args)
    torch.cuda.synchronize()
    assert convops.max_pool_bwd.launches == before + 2
    assert torch.equal(out, again)
    ref = convops.max_pool_bwd_plain(*args)
    assert out.shape == x.shape and out.dtype == dtype
    tol = BF16_ULP * ref.float().abs() if dtype == torch.bfloat16 else 0.0
    assert bool(((out.float() - ref.float()).abs() <= tol).all())


def test_strided_pools_backward_on_card_is_deterministic(card):
    """Through autograd: the encoder's three strided pools' gradient on
    the card, twice bit for bit, and equal to the CPU's (f32, the same
    first-maximum rule)."""
    from picad_tpu_torch.ops import convops

    g = torch.Generator().manual_seed(2)
    x = torch.relu(torch.randn((2, 16, 4, 30, 30), generator=g)).round()
    grads = []
    for dev in ("cuda", "cuda", "cpu"):
        xt = x.to(dev).requires_grad_(True)
        y = convops.max_pool_same_zero_pad(xt, (1, 3, 3), (1, 2, 2))
        y = convops.max_pool_same_zero_pad(y, (3, 3, 3), (2, 1, 1))
        (gx,) = torch.autograd.grad(y, xt, torch.ones_like(y))
        grads.append(gx.cpu())
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], grads[2], rtol=0, atol=0)


def _bits(t):
    return t.contiguous().view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


def _s1_input(shape, kind, gen, dtype, device):
    """post-ReLU x, rounded to integers (ties), or negative (the pads win)."""
    x = torch.randn(shape, generator=gen, device=device)
    x = -(x.abs() + 0.25) if kind == "negative" else torch.relu(x)
    return (x.round() if kind == "ties" else x).to(dtype)


def _s1_grad(shape, gen, dtype, device):
    """g with planted inf, -inf and NaN."""
    g = torch.randn(shape, generator=gen, device=device)
    flat = g.view(-1)
    flat[::17] = float("inf")
    flat[5::19] = float("-inf")
    flat[9::23] = float("nan")
    return g.to(dtype)


@pytest.mark.parametrize("kind", ["relu", "ties", "negative"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,dim,k", [
    ((2, 3, 5, 7, 9), 2, 3), ((2, 3, 5, 7, 9), 3, 3), ((2, 3, 5, 7, 9), 4, 3),  # ragged rows
    ((2, 3, 4, 6, 10), 4, 2), ((2, 3, 4, 6, 10), 3, 5),  # other windows: the run-time path
    ((1, 5, 1, 13), 3, 3),  # a 2-d pool (rank 4)
    ((16, 192, 2, 28, 28), 2, 3), ((16, 192, 2, 28, 28), 3, 3),  # Mixed_3b's three stages
    ((16, 192, 2, 28, 28), 4, 3),
    ((16, 528, 1, 28, 28), 3, 3), ((16, 528, 1, 28, 28), 4, 3),  # Mixed_4f's two
])
def test_max_pool_axis_kernels_match_plain(card, shape, dim, k, dtype, kind):
    """csrc/max_pool_s1.cu's forward and backward against their plain
    versions, bit for bit (compared on the bits: a -0.0 or a NaN's payload
    shows), with inf and NaN in g; twice on one input bit for bit; one
    launch a call each."""
    from picad_tpu_torch.ops import convops

    gen = torch.Generator(device=card).manual_seed(4)
    x = _s1_input(shape, kind, gen, dtype, card)
    g = _s1_grad(shape, gen, dtype, card)
    n_fwd, n_bwd = convops.max_pool_axis.launches, convops.max_pool_axis_bwd.launches
    y, y2 = convops.max_pool_axis(x, dim, k), convops.max_pool_axis(x, dim, k)
    dx, dx2 = convops.max_pool_axis_bwd(x, y, g, dim, k), convops.max_pool_axis_bwd(x, y, g, dim, k)
    torch.cuda.synchronize()
    assert (convops.max_pool_axis.launches - n_fwd, convops.max_pool_axis_bwd.launches - n_bwd) \
        == (2, 2)
    y_ref = convops.max_pool_axis_plain(x, dim, k)
    dx_ref = convops.max_pool_axis_bwd_plain(x, y_ref, g, dim, k)
    assert y.dtype == dx.dtype == dtype and y.shape == dx.shape == x.shape
    assert torch.equal(_bits(y), _bits(y_ref)) and torch.equal(_bits(y), _bits(y2))
    assert torch.equal(_bits(dx), _bits(dx_ref)) and torch.equal(_bits(dx), _bits(dx2))
    assert bool(dx_ref.isnan().any())  # the planted inf and NaN reached dx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_pool_axis_kernels_take_any_layout(card, dtype):
    """A channels_last_3d input and a non-contiguous view give the result
    of the contiguous input, through autograd, bit for bit."""
    from picad_tpu_torch.ops import convops

    gen = torch.Generator(device=card).manual_seed(5)
    x = _s1_input((2, 6, 2, 9, 10), "ties", gen, dtype, card)
    g = torch.randn(x.shape, generator=gen, device=card).to(dtype)
    outs = []
    for t in (x, x.to(memory_format=torch.channels_last_3d),
              torch.cat([x, x], dim=4)[..., :10]):
        t = t.detach().requires_grad_(True)
        y = convops.max_pool_same_zero_pad(t, (3, 3, 3), (1, 1, 1))
        (gx,) = torch.autograd.grad(y, t, g)
        outs.append((_bits(y), _bits(gx)))
    for y, gx in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(gx, outs[0][1])


def test_max_pool_axis_kernels_refuse_what_they_cannot_take(card):
    from picad_tpu_torch.ops import convops

    x = torch.zeros((1, 2, 3, 4, 5), device=card)
    with pytest.raises(TypeError, match="f32 or bf16"):
        convops.max_pool_axis(x.half(), 4, 3)
    with pytest.raises(TypeError, match="f32 or bf16"):
        convops.max_pool_axis_bwd(x, x, x.bfloat16(), 4, 3)
    with pytest.raises(ValueError, match="one CUDA device"):
        convops.max_pool_axis_bwd(x, x, x.cpu(), 4, 3)
    with pytest.raises(ValueError, match="no stride-1 pool"):
        convops.max_pool_axis(x, 1, 3)


def test_serving_artifact_on_card(card, tmp_path):
    """The bf16 CapsNet exported on the card at clip batch 2, 96^2: the
    graph keeps K1 and K3 as custom ops, the loaded artifact launches K1
    once and K3 twice a padded batch, and matches the in-process
    ServingModel within 1e-3 with the same classes; a CPU-traced load is
    refused."""
    from picad_tpu_torch.serve import ServingModel, load_artifact, save_artifact

    model = build_capsnet(seed=0, device=card)
    out = save_artifact(str(tmp_path / "art"), model, clip_batch_size=2, height=96, width=96)
    art = load_artifact(out)
    targets = [str(n.target) for n in art.program.graph.nodes if n.op == "call_function"]
    assert targets.count("picad.composite_convt.default") == 1
    assert targets.count("picad.tap_conv_fwd.default") == 2
    clips = np.random.default_rng(3).random((3, 8, 96, 96, 3), dtype=np.float32)
    k1, k3 = composite_convt.launches, tapconv.tap_conv_fwd.launches
    seg, scores = art.predict_clips(clips)
    torch.cuda.synchronize()
    assert (composite_convt.launches - k1, tapconv.tap_conv_fwd.launches - k3) == (2, 4)
    live = ServingModel.from_model(model, clip_batch_size=2, height=96, width=96)
    seg_l, scores_l = live.predict_clips(clips)
    assert np.abs(seg - seg_l).max() <= SLICE_ATOL and np.abs(scores - scores_l).max() <= SLICE_ATOL
    assert (scores.argmax(1) == scores_l.argmax(1)).all()
    with pytest.raises(ValueError, match="traced on 'cuda'"):
        load_artifact(out, device="cpu")


# ---- the graphed train step (train/graph.py) on the card -----------------

GRAPH_HW, GRAPH_BS = 96, 2  # a small bf16 step; chip_smoke.py phase 8 runs the full width


def _graph_batch(seed=0):
    from picad_tpu_torch.bench.train import synthetic_batch

    return synthetic_batch(np.random.default_rng(seed), GRAPH_BS, (GRAPH_HW, GRAPH_HW))


def _graphed_against_eager(plan, dropout=0.5):
    from chip_smoke import graphed_against_eager

    return graphed_against_eager(plan, _graph_batch(), seed=3, dropout=dropout)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_replayed_steps_equal_eager_steps_bit_for_bit(card, dropout):
    """6 steps through the graphed step (the warm-ups, one capture, then
    replays) against 6 eager steps from the same seeded state: losses,
    parameters, BN running stats, Adam's moments and step counts, and
    the dropout generator's state, bit for bit."""
    from picad_tpu_torch.train import graph

    res = _graphed_against_eager([("graphed", 12.0, 0.5, None)] * 6, dropout)
    assert res["bitwise"], res
    assert (res["captures"], res["replays"]) == (1, 6 - graph.WARMUP), res


def test_eager_and_replayed_steps_taking_turns_equal_eager_steps(card):
    """Once captured, replays and eager steps on one state take turns:
    one parameter, moment and dropout stream, the same as eager steps
    throughout."""
    from picad_tpu_torch.train import graph

    g, e = ("graphed", 12.0, 0.5, None), ("eager", 12.0, 0.5, None)
    res = _graphed_against_eager([g] * (graph.WARMUP + 1) + [e, g, e, g])
    assert res["bitwise"], res
    assert (res["captures"], res["replays"]) == (1, 3), res


def test_lr_and_ramp_changes_reach_the_next_replay(card):
    """with_learning_rate and another wt_ramp between replays: the replays
    take both, as the eager steps do."""
    from picad_tpu_torch.train import graph

    warm = [("graphed", 12.0, 0.5, None)] * (graph.WARMUP + 1)
    res = _graphed_against_eager(warm + [("graphed", 12.0, 0.2, 3e-5),
                                         ("graphed", 12.0, 0.9, 1e-3)])
    assert res["bitwise"], res
    assert (res["captures"], res["replays"]) == (1, 3), res
    same = _graphed_against_eager(warm + [("graphed", 12.0, 0.5, None)] * 2)
    assert same["losses"][-1] != res["losses"][-1]  # the changes moved the step


def test_crossing_thresh_epoch_captures_a_second_graph(card):
    """epoch 10 then 12 around thresh_epoch 11: a graph for each side of
    the pseudo-label branch, both bit for bit the eager steps."""
    from picad_tpu_torch.train import graph

    n = graph.WARMUP + 2
    res = _graphed_against_eager([("graphed", 10.0, 0.5, None)] * n
                                 + [("graphed", 12.0, 0.5, None)] * n)
    assert res["bitwise"], res
    assert (res["captures"], res["graphs"], res["replays"]) == (2, 2, 4), res


def test_a_replay_counts_what_an_eager_step_launches(card):
    """A replay launches, by its trace, the same instances of K1-K6's and
    the pool kernels' CUDA functions as an eager step, and the eager
    step's trace shows every wrapper that counted a launch and no other
    (at this size no BN input reaches K6); and each launch counter, the
    six of the bench's kernel table and the pool kernels' by channels,
    reads per replay what the wrappers count for one eager step."""
    from picad_tpu_torch.config import LossConfig
    from picad_tpu_torch.ops import convops
    from picad_tpu_torch.train import graph
    from picad_tpu_torch.train.state import create_train_state
    from picad_tpu_torch.train.step import make_train_step
    from picad_tpu_torch.utils.profiling import launch_state, launches_between, profile_call

    cfg = LossConfig(bv=True, n_frames=5, wt_cons=0.1, thresh_epoch=11)
    state = create_train_state(seed=0, device=card, bn_groups=2)
    batch = _graph_batch()
    graphed = make_train_step(cfg)
    eager = graphed.eager_step

    def counted(step, n=1):
        torch.cuda.synchronize()
        before = launch_state()
        for _ in range(n):
            step(state, batch, 12.0, 0.5)
        torch.cuda.synchronize()
        return launches_between(before, launch_state())

    one = counted(eager)
    assert one[(convops.max_pool_bwd, "launches")] == 3 and len(one) > 6, one
    # the seven stride-1 pools: 16 stages, one forward and one backward launch each
    assert one[(convops.max_pool_axis, "launches")] == 16, one
    assert one[(convops.max_pool_axis_bwd, "launches")] == 16, one
    for _ in range(graph.WARMUP):
        assert counted(graphed) == one  # the warm-ups: eager
    assert counted(graphed) == one and graphed.captures == 1  # the capture, then its replay
    three = counted(graphed, 3)
    assert three == {k: ({c: 3 * n for c, n in v.items()} if isinstance(v, dict) else 3 * v)
                     for k, v in one.items()}
    assert graphed.replays == 4
    # what the replays launched, in their trace (profile_call: 3 calls, the last traced)
    in_replay = profile_call(lambda: graphed(state, batch, 12.0, 0.5))["kernel_counts"]
    in_eager = profile_call(lambda: eager(state, batch, 12.0, 0.5))["kernel_counts"]
    assert graphed.replays == 7
    counted_by = {fn.__name__ for fn, a in one if a == "launches"}
    traced = {k for k, names in in_eager.items() if names}
    assert traced == counted_by and in_replay == in_eager, (in_replay, in_eager, counted_by)
    # the pool backward: one CUDA function a strided pool, three a step; the
    # stride-1 pools' kernels one a stage each way, 16 a step
    assert sum(in_replay["max_pool_bwd"].values()) == 3, in_replay
    assert sum(in_replay["max_pool_axis"].values()) == 16, in_replay
    assert sum(in_replay["max_pool_axis_bwd"].values()) == 16, in_replay


def test_the_optimizer_is_fused_on_the_card_and_plain_in_a_process_group(card):
    """One card, no group: the fused capturable Adam with a 0-d lr tensor
    (what the graphed step captures).  Inside a process group, whose step
    stays eager: plain Adam with a float lr, as before the graphed step."""
    from picad_tpu_torch.parallel import mesh
    from picad_tpu_torch.train.optimizer import FusedAdam, make_optimizer

    params = [torch.nn.Parameter(torch.ones(4, device=card))]
    alone = make_optimizer(params, 1e-4)
    assert isinstance(alone, FusedAdam) and alone.param_groups[0]["capturable"]
    assert isinstance(alone.param_groups[0]["lr"], torch.Tensor)
    mesh.initialize_distributed(f"tcp://localhost:{mesh.free_port()}", 1, 0,
                                device=torch.device("cuda", 0), backend="gloo")
    try:
        grouped = make_optimizer(params, 1e-4)
    finally:
        torch.distributed.destroy_process_group()
    assert type(grouped) is torch.optim.Adam and grouped.param_groups[0]["lr"] == 1e-4
    assert not grouped.param_groups[0]["fused"]
