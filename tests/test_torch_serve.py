"""The port's ServingModel (in-process, CPU f32) vs the JAX package's.

Same fixture weights in both packages (tests/sd_fixtures.py), 96^2 clips.
"""

import numpy as np
import pytest
import torch

from picad_tpu.eval.runner import make_padded_forward as jax_padded_forward
from picad_tpu.serve.runner import ServingModel as JaxServingModel
from picad_tpu_torch.models.capsules import build_capsnet
from picad_tpu_torch.serve.runner import ServingModel
from tests.test_torch_model import (  # noqa: F401
    few_torch_threads,
    jax_capsnet,
    pinned_fixture_sd,
)

H = 96
# The JAX serving forward is jitted (make_padded_forward), and XLA's fused
# EM-routing reductions sum in another order; the reference's cost_std
# quirk amplifies that.  Measured on the pinned fixture's 20-frame video:
# sigmoid seg 9.5e-4, mean class scores 7.6e-4 (top-2 margin 4.9e-3), the
# same size as JAX-jit vs op-by-op JAX.  test_torch_model.py holds the
# model to op-by-op JAX more tightly.
VIDEO_SEG_ATOL = 5e-3
VIDEO_SCORES_ATOL = 5e-3


@pytest.fixture(scope="module")
def sd():
    return pinned_fixture_sd()


@pytest.fixture(scope="module")
def serving(sd):
    return ServingModel.from_state_dict(
        sd, clip_batch_size=2, height=H, width=H, device="cpu"
    )


def test_predict_clips_pads_a_ragged_batch(sd, serving):
    """3 clips at clip_batch_size 2: one full batch and one zero-padded
    one, the padding row dropped — exactly the model's outputs on those
    two batches."""
    clips = np.random.default_rng(5).uniform(0, 1, (3, 8, H, H, 3)).astype(np.float32)
    seg, scores = serving.predict_clips(clips)
    assert seg.shape == (3, 8, H, H) and scores.shape == (3, 24)
    model = build_capsnet(sd, device="cpu")
    padded = np.concatenate([clips, np.zeros_like(clips[:1])])
    with torch.inference_mode():
        for i in (0, 2):
            ref_seg, ref_scores, _ = model(torch.from_numpy(padded[i : i + 2]))
            k = min(2, 3 - i)
            np.testing.assert_array_equal(seg[i : i + k], torch.sigmoid(ref_seg)[:k].numpy())
            np.testing.assert_array_equal(scores[i : i + k], ref_scores[:k].numpy())
    with pytest.raises(ValueError, match="clip shape"):
        serving.predict_clips(np.zeros((1, 8, 80, 80, 3), np.float32))


def test_predict_video_matches_jax_serving(sd, serving):
    """A 20-frame video: 4 interleaved clips, two clip batches, stitched
    back onto their frames; same segmentation and label as the JAX
    ServingModel around its make_padded_forward."""
    m, variables = jax_capsnet(sd, H)
    meta = {"clip_batch_size": 2, "height": H, "width": H}
    jax_serving = JaxServingModel(
        jax_padded_forward(m, variables, clip_batch_size=2), meta
    )
    video = np.random.default_rng(9).uniform(0, 1, (20, H, H, 3)).astype(np.float32)
    ref = jax_serving.predict_video(video)
    out = serving.predict_video(video)
    assert out["segmentation"].shape == (20, H, H, 1)
    assert out["scores"].shape == (24,)
    assert out["pred_label"] == ref["pred_label"]
    np.testing.assert_allclose(out["segmentation"], ref["segmentation"],
                               atol=VIDEO_SEG_ATOL)
    np.testing.assert_allclose(out["scores"], ref["scores"], atol=VIDEO_SCORES_ATOL)
