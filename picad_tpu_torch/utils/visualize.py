"""Matplotlib debug/visualization helpers (reference utils/metrics.py:27-123,
195-245 equivalents).

The port's own copy of picad_tpu/utils/visualize.py (numpy only; the
port imports nothing of picad_tpu).  All functions are lazy-importing
and headless-safe (Agg backend): matplotlib and imageio are imported
only when a function draws or writes, so the module imports without
them.  They save to a path when `save` is given, else call plt.show().

Deliberately excluded (dead in the reference — defined but never invoked
by any entry point, eval, or other helper): `oldIOU` (utils/metrics.py:125-145,
superseded by IOU/IOU2 which eval/metrics.py ports) and `basic_overlay`
(utils/metrics.py:195-207, subsumed by `overlay`/`overlay2` below).
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def normalize_image(pic: np.ndarray) -> np.ndarray:
    """Min-max normalize unless the image is identically zero."""
    pic = np.asarray(pic)
    if pic.min() == 0 and pic.max() == 0:
        return pic
    return (pic - pic.min()) / (pic.max() - pic.min())


def show(image, title=".", save=None):
    """Display an image (CHW tensors are transposed to HWC)."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[0] in (1, 3):
        image = np.transpose(image, (1, 2, 0))
    plt = _plt()
    f, ax = plt.subplots(figsize=(10, 10))
    ax.imshow(np.squeeze(image))
    ax.set_title(title, fontsize=30)
    _finish(plt, f, save)


def overlay(pred_mask, gt_mask, frame, title=".", save=None):
    """Overlay prediction (autumn) and ground truth (jet) on an RGB frame."""
    plt = _plt()
    pred_masked = np.ma.masked_where(pred_mask == 0, pred_mask)
    gt_masked = np.ma.masked_where(gt_mask == 0, gt_mask)
    f, ax = plt.subplots(figsize=(10, 10))
    ax.imshow(normalize_image(np.asarray(frame)))
    ax.imshow(pred_masked, "autumn", interpolation="none", alpha=0.5)
    ax.imshow(gt_masked, "jet", interpolation="none", alpha=0.5)
    ax.set_title(title, fontsize=30)
    _finish(plt, f, save)


def side(pred_mask, gt_mask, orig_clip, title=".", save=None):
    """Prediction-only overlay on the clip's first frame (reference
    utils/metrics.py:67-83: `side` shows only the autumn pred layer)."""
    plt = _plt()
    pred_masked = np.ma.masked_where(pred_mask == 0, pred_mask)
    f, ax = plt.subplots(figsize=(10, 10))
    ax.imshow(normalize_image(_first_frame(orig_clip)))
    ax.imshow(pred_masked, "autumn", interpolation="none", alpha=0.5)
    ax.set_title(title, fontsize=30)
    _finish(plt, f, save)


def byside(pred_mask, gt_mask, orig_clip, title=".", save=None):
    """Ground-truth-only overlay on the clip's first frame (reference
    utils/metrics.py:85-102: `byside` shows only the jet gt layer)."""
    plt = _plt()
    gt_masked = np.ma.masked_where(gt_mask == 0, gt_mask)
    f, ax = plt.subplots(figsize=(10, 10))
    ax.imshow(normalize_image(_first_frame(orig_clip)))
    ax.imshow(gt_masked, "jet", interpolation="none", alpha=0.5)
    ax.set_title(title, fontsize=30)
    _finish(plt, f, save)


def overlay2(mask, frame, title=".", save=None):
    """Single-mask autumn overlay on a raw frame (utils/metrics.py:105-123)."""
    plt = _plt()
    masked = np.ma.masked_where(mask == 0, mask)
    f, ax = plt.subplots(figsize=(10, 10))
    ax.imshow(np.asarray(frame))
    ax.imshow(masked, "autumn", interpolation="none", alpha=0.5)
    ax.set_title(title, fontsize=30)
    _finish(plt, f, save)


def _first_frame(clip: np.ndarray) -> np.ndarray:
    """(C, F, H, W) or (F, H, W, C) clip -> first frame as HWC."""
    clip = np.asarray(clip)
    if clip.ndim == 4 and clip.shape[0] in (1, 3):  # CFHW (torch layout)
        return np.transpose(clip[:, 0], (1, 2, 0))
    return clip[0]


def iou_debug(gt: np.ndarray, pred: np.ndarray) -> float:
    """Binary-mask IoU returning 0.0 on empty union (the reference's
    debug `IOU`, utils/metrics.py:147-169; its eval-path `IOU2` NaN
    variant lives in eval.metrics.binary_mask_iou)."""
    inter = float(np.logical_and(gt > 0, pred > 0).sum())
    union = float(np.logical_or(gt > 0, pred > 0).sum())
    return inter / union if union > 0 else 0.0


def test_iou_cases(save_dir=None):
    """The reference's four hand-made IoU sanity cases
    (utils/metrics.py:209-236 `testIOU`), rendered via overlay2."""
    import os

    cases = [
        ((slice(3, 6), slice(3, 6)), (slice(3, 6), slice(3, 6))),
        ((slice(3, 6), slice(3, 6)), (slice(7, 9), slice(7, 9))),
        ((slice(3, 6), slice(3, 6)), (slice(5, 8), slice(3, 6))),
        ((slice(3, 7), slice(3, 7)), (slice(4, 6), slice(4, 6))),
    ]
    ious = []
    for i, (ga, gb) in enumerate(cases):
        a = np.zeros((10, 10))
        a[ga] = 1
        b = np.zeros((10, 10))
        b[gb] = 1
        iou = iou_debug(a, b)
        ious.append(iou)
        save = os.path.join(save_dir, f"iou_case_{i}.png") if save_dir else None
        overlay2(b, a, title=f"{iou:.3f}", save=save)
    return ious


def histogram(arr, num_bins: int = 200, save=None):
    plt = _plt()
    arr = np.asarray(arr).ravel()
    f = plt.figure()
    plt.hist(arr, num_bins, facecolor="blue", alpha=0.5)
    _finish(plt, f, save)


def dump_clip_gif(clip: np.ndarray, path: str, stride: int = 1) -> None:
    """Write a (F, H, W, 3) float clip as a GIF (the reference's eval-loader
    __main__ smoke dump, ucf_dataloader_eval.py:163-187)."""
    import imageio

    with imageio.get_writer(path, mode="I") as writer:
        for i in range(0, clip.shape[0], stride):
            writer.append_data((np.clip(clip[i], 0, 1) * 255).astype(np.uint8))


def _finish(plt, fig, save):
    if save:
        fig.savefig(save, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()
