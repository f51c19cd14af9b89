"""Whole-video -> clip chunking for evaluation.

The port's copy of picad_tpu/eval/clips.py (the reference's sliding-clip
construction, evaluate_ucf101.py:79-101): 8-frame clips with an f_skip=2
interleave — for each window start i (stride depth*f_skip) and each
offset j < f_skip the clip takes frames i + j + k*f_skip, k < depth —
zero-padded past the end, optionally dropping clips whose mask is empty.
"""

from __future__ import annotations

import numpy as np


def chunk_video_into_clips(
    video: np.ndarray,
    mask: np.ndarray,
    *,
    depth: int = 8,
    f_skip: int = 2,
    drop_empty: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """(F, H, W, 3) video + (F, H, W, 1) mask -> (clips (N, depth, H, W, 3),
    clip_masks (N, depth, H, W, 1))."""
    n_frames, h, w, _ = video.shape
    clips, masks = [], []
    for i in range(0, n_frames, depth * f_skip):
        for j in range(f_skip):
            b_vid = np.zeros((depth, h, w, 3), dtype=video.dtype)
            b_msk = np.zeros((depth, h, w, 1), dtype=mask.dtype)
            for k in range(depth):
                ind = i + j + k * f_skip
                if ind < n_frames:
                    b_vid[k] = video[ind]
                    b_msk[k] = mask[ind]
            if drop_empty and b_msk.sum() == 0:
                continue
            clips.append(b_vid)
            masks.append(b_msk)
    if not clips:
        return (
            np.zeros((0, depth, h, w, 3), dtype=video.dtype),
            np.zeros((0, depth, h, w, 1), dtype=mask.dtype),
        )
    return np.stack(clips), np.stack(masks)
