"""The port's CUDA kernel on the card, held against its plain version.

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
from picad_tpu_torch.ops.fused_head_kernel import composite_convt, composite_convt_plain

pytestmark = pytest.mark.cuda

KERNEL_RTOL = 1e-4  # of max|plain|: f32 sums of the same products in another order
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
