"""Full-video evaluation protocol: accuracy, f-mAP, v-mAP.

The port's copy of picad_tpu/eval/engine.py (numpy on the host), which
replicates evaluate_ucf101.py:66-189 / evaluate_jhmdb.py numerically:

- chunk each test video into interleaved 8-frame clips (clips.py), drop
  clips with empty ground truth; skip videos with no boxed clips;
- run the model over clip batches (clip_batch_size=14 in the reference;
  the forward pads a ragged batch to that size), sigmoid, threshold at
  0.5;
- video class prediction = argmax of the mean class score over clips;
- per-frame IoU over gt-nonempty frames, video IoU = sum(inter)/sum(union)
  over those frames, each swept over 20 thresholds 0.00, 0.05, ..., 0.95;
- fAP[c] = frame hit-rate per class, fmAP = mean over classes; same for
  vmAP; headline numbers at thresholds 0.2 (index 4) and 0.5 (index 10).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np

from picad_tpu_torch.eval.clips import chunk_video_into_clips


@dataclasses.dataclass
class VideoMetrics:
    """Accumulator for the evaluation sweep."""

    n_classes: int
    n_correct: int = 0
    n_vids: np.ndarray | None = None
    n_tot_frames: np.ndarray | None = None
    frame_ious: np.ndarray | None = None
    video_ious: np.ndarray | None = None

    def __post_init__(self):
        c = self.n_classes
        self.n_vids = np.zeros((c, 1))
        self.n_tot_frames = np.zeros((c, 1))
        self.frame_ious = np.zeros((c, 20))
        self.video_ious = np.zeros((c, 20))
        self.iou_threshs = np.arange(0, 20, dtype=np.float32) / 20

    def update(
        self,
        label: int,
        pred_label: int,
        pred_seg: np.ndarray,
        gt_seg: np.ndarray,
    ) -> None:
        """Add one video.  pred_seg/gt_seg: (F, H, W, 1) binary masks.

        Vectorized over frames with bool masks (the reference loops
        frames over int64 `seg + gt` planes, evaluate_ucf101.py:141-160,
        for identical counts; inter = p&g and union = p|g are exactly its
        `==2` / `!=0` counts on 0/1 masks)."""
        if pred_label == label:
            self.n_correct += 1
        f = gt_seg.shape[0]
        p = pred_seg.astype(bool).reshape(f, -1)
        g = gt_seg.astype(bool).reshape(f, -1)
        valid = g.any(axis=1)  # reference skip: frames with empty gt
        inter = (p & g)[valid].sum(axis=1)
        union = (p | g)[valid].sum(axis=1)
        self.n_tot_frames[label] += int(valid.sum())
        i_over_u = inter / union  # union >= gt count > 0 on valid frames
        # compare in f32: the reference tests a python float against
        # float32 thresholds, which NEP-50 evaluates at f32 — an f64
        # array comparison would instead upcast the thresholds and flip
        # boundary cases like iou == 0.15
        self.frame_ious[label] += (
            i_over_u.astype(np.float32)[:, None] >= self.iou_threshs[None, :]
        ).sum(axis=0)
        self.n_vids[label] += 1
        vid_iou = int(inter.sum()) / int(union.sum())
        self.video_ious[label] += (vid_iou >= self.iou_threshs).astype(
            np.float64
        )

    def summarize(self, nan_safe: bool = False) -> dict:
        """Reference semantics (evaluate_ucf101.py:184-187) use np.mean, so a
        class with zero test videos/frames propagates NaN into the headline
        number.  `nan_safe=True` opts into np.nanmean (skip empty classes);
        the default matches the reference bit-for-bit."""
        with np.errstate(divide="ignore", invalid="ignore"):
            fAP = self.frame_ious / self.n_tot_frames
            vAP = self.video_ious / self.n_vids
        mean = np.nanmean if nan_safe else np.mean
        fmAP = mean(fAP, axis=0)
        vmAP = mean(vAP, axis=0)
        return {
            "accuracy": self.n_correct / max(float(np.sum(self.n_vids)), 1.0),
            "fmAP": fmAP,
            "vmAP": vmAP,
            "fmAP@0.2": float(fmAP[4]),
            "vmAP@0.2": float(vmAP[4]),
            "fmAP@0.5": float(fmAP[10]),
            "vmAP@0.5": float(vmAP[10]),
        }


def evaluate_dataset(
    forward_fn: Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]],
    dataset: Iterable,
    *,
    n_classes: int,
    clip_batch_size: int = 14,
    seg_threshold: float = 0.5,
    verbose: bool = False,
    prediction_log: list | None = None,
    nan_safe: bool = False,
) -> dict:
    """Run the full protocol.

    Args:
      forward_fn: maps a clip batch (N, 8, 224, 224, 3) f32 to
        (sigmoid_seg (N, 8, 224, 224), class_scores (N, C)) as numpy
        arrays (eval/runner.py make_padded_forward).
      dataset: yields (video (F, H, W, 3) in [0, 1], mask (F, H, W, 1),
        label) per video (optionally + extras, ignored).

    Returns: summary dict (see VideoMetrics.summarize).
    """
    acc = VideoMetrics(n_classes)
    for sample in dataset:
        video, mask, label = sample[0], sample[1], int(sample[2])
        clips, clip_masks = chunk_video_into_clips(
            np.asarray(video, dtype=np.float32), np.asarray(mask)
        )
        if clips.shape[0] == 0:
            if verbose:
                print("Video has no bounding boxes")
            continue

        seg_chunks, score_chunks = [], []
        for i in range(0, clips.shape[0], clip_batch_size):
            batch = clips[i : i + clip_batch_size]
            seg, scores = forward_fn(batch)
            seg_chunks.append(np.asarray(seg))
            score_chunks.append(np.asarray(scores))
        seg = np.concatenate(seg_chunks, axis=0)  # (N, 8, 224, 224), sigmoid
        scores = np.concatenate(score_chunks, axis=0)  # (N, C)

        pred_label = int(np.argmax(np.mean(scores, axis=0)))
        if prediction_log is not None:
            name = sample[3] if len(sample) > 3 else None
            prediction_log.append(
                {"video": name, "label": label, "pred": pred_label,
                 "correct": pred_label == label}
            )
        pred_seg = seg >= seg_threshold
        pred_seg = pred_seg.reshape(-1, *pred_seg.shape[2:])[..., None]
        gt_seg = clip_masks.reshape(-1, *clip_masks.shape[2:4], 1).astype(bool)
        acc.update(label, pred_label, pred_seg, gt_seg)

    summary = acc.summarize(nan_safe=nan_safe)
    if verbose:
        print(
            "Accuracy:",
            summary["accuracy"],
            "IoU/fmap/vmap",
            0.2,
            summary["fmAP@0.2"],
            summary["vmAP@0.2"],
            0.5,
            summary["fmAP@0.5"],
            summary["vmAP@0.5"],
        )
    return summary
