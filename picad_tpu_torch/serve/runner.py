"""In-process serving of the eval forward.

Counterpart of picad_tpu/serve/runner.py:27-105, with the same two call
shapes:

- `predict_clips`: ragged clip batches -> (sigmoid_seg, class_scores),
  zero-padded to the fixed clip batch and the padding rows dropped.
- `predict_video`: an (F, H, W, 3) video -> per-frame segmentation
  (F, H, W, 1) and the video class.  Clips are the reference's sliding
  8-frame / f_skip=2 interleave (eval/clips.py) with drop_empty=False,
  and the interleave is inverted to put each clip prediction back on its
  source frame.  Video class = argmax of the mean clip score.

`from_model` serves a model in-process; serve/export.load_artifact
serves a `torch.export` artifact through the same class (the JAX
package serves its exported StableHLO artifact the same way).  Either
way the card runs K1 and K3 as CUDA kernels.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from picad_tpu_torch.eval.clips import chunk_video_into_clips
from picad_tpu_torch.eval.runner import make_padded_forward
from picad_tpu_torch.models.capsules import build_capsnet


class ServingModel:
    """Host-side chunking around a clip-batch forward.

    `call` maps at most `clip_batch_size` clips (numpy) to (sigmoid seg,
    class scores) and pads a ragged batch itself (make_padded_forward),
    so the card always sees one batch shape."""

    def __init__(self, call, meta: Mapping[str, Any]):
        self._call = call
        self.meta = dict(meta)
        self.clip_batch_size = int(meta["clip_batch_size"])
        self.depth = int(meta.get("depth", 8))
        self.height = int(meta["height"])
        self.width = int(meta["width"])

    @classmethod
    def from_model(cls, model, *, clip_batch_size=14, height=224, width=224):
        """Serve an eval-mode CapsNet (weights already in it)."""
        meta = {
            "clip_batch_size": clip_batch_size,
            "height": height,
            "width": width,
            "num_classes": model.num_classes,
            "compute_dtype": str(model.compute_dtype),
            "device": str(next(model.parameters()).device),
        }
        forward = make_padded_forward(model, clip_batch_size=clip_batch_size)
        return cls(forward, meta)

    @classmethod
    def from_state_dict(cls, state_dict=None, *, num_classes=24, clip_batch_size=14,
                        height=224, width=224, compute_dtype=None, seed=0,
                        device=None):
        """Build the CapsNet on `device` (default: the CUDA card) from a
        reference-format state dict, or from `seed` without one, and serve it."""
        model = build_capsnet(
            state_dict, num_classes=num_classes, compute_dtype=compute_dtype,
            seed=seed, device=device,
        )
        return cls.from_model(
            model, clip_batch_size=clip_batch_size, height=height, width=width
        )

    @property
    def input_shape(self) -> tuple[int, ...]:
        return (self.clip_batch_size, self.depth, self.height, self.width, 3)

    def predict_clips(self, clips: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(N, depth, H, W, 3) f32 -> (sigmoid_seg (N, depth, H, W),
        class_scores (N, C)); N may be ragged (any size >= 1)."""
        n = clips.shape[0]
        bs = self.clip_batch_size
        if clips.shape[1:] != self.input_shape[1:]:
            raise ValueError(
                f"clip shape {clips.shape[1:]} != served {self.input_shape[1:]}"
            )
        segs, scores = [], []
        for i in range(0, n, bs):
            seg, sc = self._call(clips[i : i + bs])  # pads a ragged batch itself
            segs.append(seg)
            scores.append(sc)
        return np.concatenate(segs, axis=0), np.concatenate(scores, axis=0)

    def predict_video(self, video: np.ndarray, *, f_skip: int = 2) -> dict[str, Any]:
        """(F, H, W, 3) f32 video -> {"segmentation" (F, H, W, 1),
        "pred_label" int, "scores" (C,) mean clip score}."""
        n_frames = video.shape[0]
        dummy_mask = np.zeros((*video.shape[:3], 1), np.float32)
        clips, _ = chunk_video_into_clips(
            video, dummy_mask, depth=self.depth, f_skip=f_skip, drop_empty=False
        )
        seg, scores = self.predict_clips(clips)
        out = np.zeros((n_frames, self.height, self.width, 1), np.float32)
        # invert the interleave: clip c = (i // (depth*f_skip)) * f_skip + j
        # holds frames i + j + k*f_skip, k = 0..depth-1
        c = 0
        for i in range(0, n_frames, self.depth * f_skip):
            for j in range(f_skip):
                for k in range(self.depth):
                    ind = i + j + k * f_skip
                    if ind < n_frames:
                        out[ind, :, :, 0] = seg[c, k]
                c += 1
        mean_scores = scores.mean(axis=0)
        return {
            "segmentation": out,
            "pred_label": int(np.argmax(mean_scores)),
            "scores": mean_scores,
        }
