"""The eval forward and its padded-batch binding.

Counterpart of picad_tpu/eval/runner.py:28-127.  Eval mode matches the
reference eval call (evaluate_ucf101.py:123-128): BatchNorm on running
statistics, no dropout, the pose mask from the predicted argmax (the JAX
call's dummy action 500 is never read at eval), sigmoid on the seg
logits.  A ragged clip batch is zero-padded to `clip_batch_size` and the
padding rows dropped on the host, so the card always sees one batch
shape.  The checkpoint sweep (sweep_checkpoints) comes with the eval
slice of the port.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


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
