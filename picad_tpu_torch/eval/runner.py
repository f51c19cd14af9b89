"""The eval forward, its padded-batch binding and the checkpoint sweep.

Counterpart of picad_tpu/eval/runner.py.  Eval mode matches the
reference eval call (evaluate_ucf101.py:123-128): BatchNorm on running
statistics, no dropout, the pose mask from the predicted argmax (the JAX
call's dummy action 500 is never read at eval), sigmoid on the seg
logits.  A ragged clip batch is zero-padded to `clip_batch_size` and the
padding rows dropped on the host, so the card always sees one batch
shape.

`sweep_checkpoints` (evaluate_ucf101.py equivalent): for every saved
checkpoint matching `best_model_<split>*` in a directory, load its model
state into ONE eval model, run the full-video protocol (eval.engine)
over the test set, print accuracy / f-mAP / v-mAP at 0.2 and 0.5, then
keep only the best-fmAP and best-vmAP checkpoints
(evaluate_ucf101.py:194-203).
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Callable

import numpy as np
import torch

from picad_tpu_torch._device import resolve_device


def make_eval_fn(model: torch.nn.Module):
    """clips (b, 8, H, W, 3) f32 tensor on the model's device ->
    (sigmoid seg (b, 8, H, W), class_scores (b, C)), both f32 tensors."""
    model.eval()

    def fwd(clips: torch.Tensor):
        with torch.inference_mode():
            seg, scores, _ = model(clips)
            return torch.sigmoid(seg), scores

    return fwd


def make_padded_forward(
    model: torch.nn.Module, *, clip_batch_size: int = 14
) -> Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]:
    """Bind the eval forward to numpy clip batches of at most
    `clip_batch_size` on the model's device, zero-padding a ragged batch
    to `clip_batch_size` and dropping the padding rows."""
    fwd = make_eval_fn(model)
    device = next(model.parameters()).device

    def forward(clips: np.ndarray):
        n = clips.shape[0]
        if n < clip_batch_size:
            pad = np.zeros((clip_batch_size - n, *clips.shape[1:]), dtype=clips.dtype)
            clips = np.concatenate([clips, pad], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(clips, dtype=np.float32)).to(device)
        seg, scores = fwd(x)
        return seg[:n].cpu().numpy(), scores[:n].cpu().numpy()

    return forward


def sweep_checkpoints(
    ckpt_dir: str,
    dataset,
    *,
    split: str = "train",
    n_classes: int = 24,
    clip_batch_size: int = 14,
    prune: bool = True,
    log_predictions: bool = False,
    nan_safe: bool = False,
    device=None,
) -> dict:
    """Evaluate every matching checkpoint on `device` (default: the CUDA
    card); prune to the two best.  Returns {checkpoint path: summary}.

    One f32 eval model (the JAX CLIs' CapsNet is f32) is
    built once, on the first checkpoint's weights, and each later
    checkpoint's model state loaded into it, in sorted(glob) order.  log_predictions writes correct_pred_<ckpt>.txt /
    incorrect_pred_<ckpt>.txt with per-video outcomes, the working
    version of the reference's dead logging code (evaluate_jhmdb.py:
    144-147 writes to never-opened handles)."""
    from picad_tpu_torch.checkpoint.manager import CheckpointIO
    from picad_tpu_torch.models.capsules import build_capsnet

    dev = resolve_device(device)
    io = CheckpointIO()
    paths = sorted(glob.glob(os.path.join(ckpt_dir, f"best_model_{split}*")))
    if not paths:
        print(
            f"No checkpoints matching 'best_model_{split}*' in {ckpt_dir!r} — "
            "nothing to evaluate."
        )
        return {}
    from picad_tpu_torch.eval.engine import evaluate_dataset

    model = forward = None
    results = {}
    for path in paths:
        weights = io.load_model(path)
        if model is None:
            model = build_capsnet(weights, num_classes=n_classes,
                                  compute_dtype=torch.float32, device=dev)
            forward = make_padded_forward(model, clip_batch_size=clip_batch_size)
        else:
            model.load_state_dict(weights)
        del weights
        pred_log = [] if log_predictions else None
        summary = evaluate_dataset(
            forward, dataset, n_classes=n_classes,
            clip_batch_size=clip_batch_size, verbose=True,
            prediction_log=pred_log, nan_safe=nan_safe,
        )
        if pred_log is not None:
            tag = os.path.basename(path)
            for fname, want in (("correct_pred", True), ("incorrect_pred", False)):
                with open(os.path.join(ckpt_dir, f"{fname}_{tag}.txt"), "w") as f:
                    for rec in pred_log:
                        if rec["correct"] == want:
                            f.write(f"{rec['video']} label={rec['label']} pred={rec['pred']}\n")
        results[path] = summary

    if prune:
        names = list(results)
        keep = {
            names[int(np.argmax([results[p]["fmAP@0.5"] for p in names]))],
            names[int(np.argmax([results[p]["vmAP@0.5"] for p in names]))],
        }
        for path in names:
            if path not in keep:
                shutil.rmtree(path, ignore_errors=True)
        print(os.listdir(ckpt_dir))
    return results
