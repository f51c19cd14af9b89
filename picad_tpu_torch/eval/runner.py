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

`--eval_dp N` (picad_tpu/eval/runner.py:28-110) puts N replicas of the
eval model on N devices in one process and splits each padded clip
batch over them, clip_batch_size / N clips a replica: eval mode has no cross-sample
reduction (BatchNorm on running statistics, no dropout), so the result
is the one-device forward's.
"""

from __future__ import annotations

import contextlib
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
    return pad_to_batch(make_eval_fn(model), next(model.parameters()).device,
                        clip_batch_size=clip_batch_size)


def pad_to_batch(
    fwd: Callable, device, *, clip_batch_size: int = 14
) -> Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]:
    """Bind `fwd` (a (clip_batch_size, 8, H, W, 3) f32 tensor on `device`
    -> (sigmoid seg, class scores) tensors: `make_eval_fn`'s or a serving
    artifact's) to numpy clip batches of at most `clip_batch_size`,
    zero-padding a ragged batch and dropping the padding rows."""

    def forward(clips: np.ndarray):
        n = clips.shape[0]
        if n < clip_batch_size:
            pad = np.zeros((clip_batch_size - n, *clips.shape[1:]), dtype=clips.dtype)
            clips = np.concatenate([clips, pad], axis=0)
        x = torch.from_numpy(np.ascontiguousarray(clips, dtype=np.float32)).to(device)
        seg, scores = fwd(x)
        return seg[:n].cpu().numpy(), scores[:n].cpu().numpy()

    return forward


def replica_devices(eval_dp: int, device, devices=None) -> list[torch.device] | None:
    """The devices of --eval_dp N's replicas (None for 0/1: one device):
    `devices` when given (e.g. ["cpu", "cpu"], or one card twice), else
    cuda:0 .. cuda:N-1, which must be visible (picad_tpu/eval/runner.py:
    _mesh_or_none)."""
    if eval_dp in (0, 1):
        return None
    if devices is not None:
        if len(devices) != eval_dp:
            raise ValueError(f"--eval_dp {eval_dp} with {len(devices)} replica devices")
        return [torch.device(d) for d in devices]
    dev = torch.device(device)
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    if eval_dp > visible:
        raise ValueError(f"--eval_dp {eval_dp} > {visible} visible devices")
    return [torch.device("cuda", i) for i in range(eval_dp)]


def make_sharded_forward(
    models: list[torch.nn.Module], *, clip_batch_size: int = 14
) -> Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]]:
    """`make_padded_forward` over replicas of one eval model, each on its
    own device: each padded batch of `clip_batch_size` clips (more clips
    take several batches) is split into len(models) equal slices, slice
    i runs on replica i (every replica's forward is enqueued before any
    result is read back), and the outputs are concatenated in order."""
    n = len(models)
    if clip_batch_size % n:
        raise ValueError(f"clip_batch_size {clip_batch_size} must divide evenly "
                         f"over the {n} eval replicas")
    per = clip_batch_size // n
    fwds = [make_eval_fn(m) for m in models]
    devices = [next(m.parameters()).device for m in models]

    def on(dev):
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def batch(clips: np.ndarray):
        n_real = clips.shape[0]
        if n_real < clip_batch_size:
            pad = np.zeros((clip_batch_size - n_real, *clips.shape[1:]), dtype=clips.dtype)
            clips = np.concatenate([clips, pad], axis=0)
        x = np.ascontiguousarray(clips, dtype=np.float32)
        outs = []
        for i, (fwd, dev) in enumerate(zip(fwds, devices)):
            with on(dev):
                outs.append(fwd(torch.from_numpy(x[i * per:(i + 1) * per]).to(dev)))
        seg = np.concatenate([o[0].cpu().numpy() for o in outs])
        scores = np.concatenate([o[1].cpu().numpy() for o in outs])
        return seg[:n_real], scores[:n_real]

    def forward(clips: np.ndarray):
        parts = [batch(clips[i:i + clip_batch_size])
                 for i in range(0, max(clips.shape[0], 1), clip_batch_size)]
        return (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]))

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
    eval_dp: int = 0,
    eval_devices=None,
) -> dict:
    """Evaluate every matching checkpoint on `device` (default: the CUDA
    card); prune to the two best.  Returns {checkpoint path: summary}.

    One f32 eval model (the JAX CLIs' CapsNet is f32) is
    built once, on the first checkpoint's weights, and each later
    checkpoint's model state loaded into it, in sorted(glob) order.
    `eval_dp` > 1 builds that many replicas, on `eval_devices` or on
    cuda:0 .. cuda:N-1, and splits each clip batch over them
    (`make_sharded_forward`).  log_predictions writes correct_pred_<ckpt>.txt /
    incorrect_pred_<ckpt>.txt with per-video outcomes, the working
    version of the reference's dead logging code (evaluate_jhmdb.py:
    144-147 writes to never-opened handles)."""
    from picad_tpu_torch.checkpoint.manager import CheckpointIO
    from picad_tpu_torch.models.capsules import build_capsnet

    dev = resolve_device(device)
    replicas = replica_devices(eval_dp, dev, eval_devices)
    io = CheckpointIO()
    paths = sorted(glob.glob(os.path.join(ckpt_dir, f"best_model_{split}*")))
    if not paths:
        print(
            f"No checkpoints matching 'best_model_{split}*' in {ckpt_dir!r} — "
            "nothing to evaluate."
        )
        return {}
    from picad_tpu_torch.eval.engine import evaluate_dataset

    models, forward = [], None
    results = {}
    for path in paths:
        weights = io.load_model(path)
        if not models:
            models = [build_capsnet(weights, num_classes=n_classes,
                                    compute_dtype=torch.float32, device=d)
                      for d in (replicas or [dev])]
            forward = (make_padded_forward(models[0], clip_batch_size=clip_batch_size)
                       if replicas is None else
                       make_sharded_forward(models, clip_batch_size=clip_batch_size))
        else:
            for model in models:
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
