"""The semi-supervised train step and the validation step.

Counterpart of picad_tpu/train/step.py (reference train_model_interface,
main_ucf101.py:50-150).  One step: both views' forward, the supervised
BCE + Dice (or IoU) segmentation losses and the SpreadLoss over the
labelled rows, the flip-consistency term over every real row, the
backward and the optimizer update.

- The model's `bn_groups` picks the forward.  2 folds [data; aug] into
  ONE 2B forward (the JAX package's fold_flip): each view normalizes
  with its own batch statistics and the running stats update once per
  view, the numerics of the reference's two forwards.  1 runs the two
  forwards one after the other, the reference's literal order.
- The consistency weighting: plain L2, the cyclic-variance masks in both
  directions (`bv`, ramped against plain L2 by `wt_ramp`), the
  gradient-smoothness mask (`gv`, with the reference's (B, B, ...)
  broadcast), or both.  The masks see detached inputs, exactly where
  the JAX package stops gradients.
- `row_mask` marks real rows of a zero-padded ragged batch: every loss
  reduction skips padded rows, while BatchNorm statistics include them,
  as in the JAX step.
- Inside a process group (parallel/mesh.py) each rank holds its rows of
  the global batch, and every sum the JAX package reduces over the
  global batch is summed over the ranks (`mesh.global_sum`): the
  masked numerators, Dice's (or IoU's) three sums, SpreadLoss's and the
  counts.  Every rank then computes the global losses and metrics, and
  the gradients are averaged over the ranks before the optimizer
  (`mesh.all_reduce_grads`).  Without a group none of that launches.

Batches are dicts of numpy arrays or tensors in the JAX package's
layouts: `data` (B, T, H, W, 3) uint8 (normalized and flipped on the
device) or f32 with an `aug_data` of the same layout, `loc_msk`
(B, T, H, W, 1), `action` (B,), `label_vid` (B,) (1 = labelled),
optional `row_mask` (B,).

With PICAD_PACKED_PREP=1 (off by default, as in the JAX package) the
uint8 layout reaches the model PACKED: `s2d_pack_u8` and `flip_packed_w`
run in uint8 where the batch lies (the card for a CUDA step), and the
stem folds /255 into its kernel (models/i3d.py StemS2D).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from picad_tpu_torch._device import resolve_device
from picad_tpu_torch.config import LossConfig
from picad_tpu_torch.models.i3d import s2d_pack
from picad_tpu_torch.objectives.losses import weighted_mse_outer
from picad_tpu_torch.ops.masks import pixelwise_cyclic_variance, pixelwise_gradient
from picad_tpu_torch.parallel.mesh import all_reduce_grads, global_sum
from picad_tpu_torch.train.graph import GraphedStep


def _to(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device, non_blocking=True)
    return torch.as_tensor(np.asarray(a)).to(device, non_blocking=True)


# The JAX package's switch, read the same way and off by default
# (picad_tpu/train/step.py:55-83 records why it is off there).
_PACKED_PREP = os.environ.get("PICAD_PACKED_PREP", "0") == "1"

s2d_pack_u8 = s2d_pack  # picad_tpu/train/step.py:86: (B, T, H, W, C) -> (B, T/2, H/2, W/2, 8C)


def flip_packed_w(p: torch.Tensor, c_raw: int = 3) -> torch.Tensor:
    """The horizontal flip of the ORIGINAL clip, applied to its packed
    form: w_orig = 2w + wp, so flip(w_orig) = 2(W/2 - 1 - w) + (1 - wp):
    reverse the packed W axis and swap the wp phase inside the channels
    (picad_tpu/train/step.py:96-102)."""
    B, T2, H2, W2, _ = p.shape
    pr = p.reshape(B, T2, H2, W2, 2, 2, 2, c_raw)
    return torch.flip(pr, dims=(3, 6)).reshape(p.shape)


def prepare_views(batch, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(data, aug, seg_gt) on `device`: uint8 clips become f32 /255 there
    and, without an `aug_data`, the flipped view is the W-flip.  With
    `_PACKED_PREP`, a uint8 batch with even T, H, W and no `aug_data`
    returns the packed uint8 views instead (picad_tpu/train/step.py:
    105-143)."""
    data = _to(batch["data"], device)
    seg_gt = _to(batch["loc_msk"], device)[..., 0].to(torch.float32)  # (B, T, H, W)
    if (_PACKED_PREP and batch.get("aug_data") is None and data.dtype == torch.uint8
            and data.shape[-1] == 3 and all(d % 2 == 0 for d in data.shape[1:4])):
        p = s2d_pack_u8(data)
        return p, flip_packed_w(p), seg_gt
    if data.dtype == torch.uint8:
        data = data.to(torch.float32) / 255.0
    aug = batch.get("aug_data")
    if aug is None:
        aug = torch.flip(data, dims=[3])
    else:
        aug = _to(aug, device)
        if aug.dtype == torch.uint8:
            aug = aug.to(torch.float32) / 255.0
    return data, aug, seg_gt


def _rows(row_mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return row_mask.reshape(-1, *([1] * (ndim - 1)))


def _count(row_mask):
    """The global batch's real rows, at least 1."""
    return torch.clamp(global_sum(row_mask.sum()), min=1.0)


def _masked_bce(logits, targets, row_mask):
    """BCEWithLogitsLoss over rows where row_mask == 1."""
    x, z = logits, targets
    elem = torch.clamp(x, min=0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    denom = _count(row_mask) * (elem.numel() // elem.shape[0])
    return global_sum((elem * _rows(row_mask, elem.ndim)).sum()) / denom


def _dice_sums(logits, targets, row_mask):
    """(inter, p, t) over the labelled rows of the global batch."""
    p = torch.sigmoid(logits)
    m = _rows(row_mask, logits.ndim)
    return (global_sum((p * targets * m).sum()), global_sum((p * m).sum()),
            global_sum((targets * m).sum()))


def _masked_dice(logits, targets, row_mask, smooth=1.0):
    """DiceLoss over the flattened labelled rows (losses.py:40-57)."""
    inter, p, t = _dice_sums(logits, targets, row_mask)
    return 1.0 - (2.0 * inter + smooth) / (p + t + smooth)


def _masked_iou(logits, targets, row_mask, smooth=1.0):
    inter, p, t = _dice_sums(logits, targets, row_mask)
    return 1.0 - (inter + smooth) / (p + t - inter + smooth)


def _masked_spread(scores, labels, row_mask, m_min=0.2, m_max=0.9):
    """SpreadLoss over labelled rows (losses.py:14-37, the double /b)."""
    margin = m_min + (m_max - m_min) * 0.0
    at = torch.gather(scores, 1, labels.reshape(-1, 1))
    per = torch.clamp(margin - (at - scores), min=0.0).square()
    n = _count(row_mask)
    return (global_sum((per * row_mask[:, None]).sum()) / n - margin**2) / n


_LOC_LOSS = {"dice": _masked_dice, "iou": _masked_iou}


def compute_losses(output, flip_op, scores, seg_gt, action, flags, row_mask,
                   loss_cfg: LossConfig, wt_ramp) -> tuple[torch.Tensor, dict]:
    """The loss assembly of the step (picad_tpu/train/step.py:273-349).

    output / flip_op (B, T, H, W) seg logits of the two views (flip_op
    still flipped), scores (B, C) of the original view; action (B,)
    int64, flags and row_mask (B,) f32; wt_ramp a float or a 0-d tensor
    (f64 multiplies by the float's f32 values, w and 1 - w rounded from
    double, bit for bit).  Returns (total, metrics)."""
    lm = flags * row_mask  # 1.0 for real labelled rows
    loc_loss = _masked_bce(output, seg_gt, lm) + _LOC_LOSS[loss_cfg.loc_loss](output, seg_gt, lm)
    cls_loss = _masked_spread(scores, action, lm, loss_cfg.spread_m_min, loss_cfg.spread_m_max)

    rm_b = _rows(row_mask, output.ndim)
    n_real = _count(row_mask)

    def masked_mean(x):
        return global_sum((x * rm_b).sum()) / (n_real * (x.numel() // x.shape[0]))

    flipped_pred = torch.flip(flip_op, dims=[3])  # undo the spatial flip
    diff_sq = (flipped_pred - output) ** 2
    loss_simple_l2 = masked_mean(diff_sq)

    cons = None
    if loss_cfg.bv:
        out_d, flipped_d = output.detach(), flipped_pred.detach()
        clck = pixelwise_cyclic_variance(
            out_d, torch.flip(flipped_d, dims=[1]),
            window=loss_cfg.n_frames, use_sigmoid=loss_cfg.predict_maps)
        anticlck = pixelwise_cyclic_variance(
            torch.flip(out_d, dims=[1]), flipped_d,
            window=loss_cfg.n_frames, use_sigmoid=loss_cfg.predict_maps)
        loss_var_1 = masked_mean(clck * diff_sq)
        loss_var_2 = masked_mean(torch.flip(anticlck, dims=[1]) * diff_sq)
        if isinstance(wt_ramp, torch.Tensor):  # the graphed step's, written at each replay
            w, w_rest = wt_ramp.float(), (1.0 - wt_ramp).float()
        else:
            w, w_rest = wt_ramp, 1.0 - wt_ramp
        cons_bv = w * (loss_var_1 + loss_var_2) + w_rest * loss_simple_l2
        cons = cons_bv
    if loss_cfg.gv:
        grad_w = pixelwise_gradient(
            output.detach(), conf_thresh_lower=loss_cfg.lower_thresh,
            conf_thresh_upper=loss_cfg.upper_thresh)
        cons_gv = weighted_mse_outer(flipped_pred, output, grad_w, row_mask=row_mask)
        cons = (loss_cfg.bv_wt * cons_bv + loss_cfg.gv_wt * cons_gv) if loss_cfg.bv else cons_gv
    if cons is None:
        cons = loss_simple_l2

    total = loss_cfg.wt_loc * loc_loss + loss_cfg.wt_cls * cls_loss + loss_cfg.wt_cons * cons
    correct = (scores.argmax(dim=1) == action.reshape(-1)).to(torch.float32)
    acc = global_sum((correct * row_mask).sum()) / n_real
    metrics = {"loss": total, "loss_seg": loc_loss, "loss_cls": cls_loss,
               "loss_consistency": cons, "acc": acc}
    return total, metrics


def _labels(batch, device):
    action = _to(batch["action"], device).long()
    flags = _to(batch["label_vid"], device).to(torch.float32)
    row_mask = batch.get("row_mask")
    row_mask = torch.ones_like(flags) if row_mask is None else _to(row_mask, device).float()
    return action, flags, row_mask


def global_grad_norm(parameters) -> torch.Tensor:
    """The global L2 norm of the parameters' gradients (optax.global_norm
    of the JAX package's gradient tree), as a 0-d f32 tensor on their
    device: no host synchronisation."""
    norms = [torch.linalg.vector_norm(p.grad.float()) for p in parameters if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(norms))


def make_train_step(loss_cfg: LossConfig, *, device=None, grad_metrics: bool = False):
    """The train step `train_step(state, batch, epoch, wt_ramp) -> (state,
    metrics)` on `device` (default: the CUDA card), where the batch is
    moved.  It folds both views into one forward when the state's model
    has bn_groups=2 and runs two forwards when it has 1.  It updates the
    state's model, optimizer and generator in place and returns the JAX
    step's metrics (detached 0-d tensors): loss, loss_seg, loss_cls,
    loss_consistency, acc.  The gradients stay in the parameters' `.grad`
    after the step.

    On a card the step captures itself as one CUDA graph per key after
    graph.WARMUP eager calls, and replays it from then on
    (train/graph.py); its `eager_step` is the eager step, as on the CPU.

    `grad_metrics` adds `grad_norm`, the global L2 of the raw gradients
    (picad_tpu/train/step.py:192-202, the on-device half of the
    reference's `wandb.watch(model)`, main_jhmdb.py:422).  Off by
    default, and then the step launches what it launched before."""
    dev = resolve_device(device)
    if loss_cfg.loc_loss not in _LOC_LOSS:
        raise ValueError(f"unknown loc_loss {loss_cfg.loc_loss!r}")
    if loss_cfg.const_loss not in ("l2", "jsd", "l1"):
        raise ValueError(f"unknown const_loss {loss_cfg.const_loss!r}")
    if loss_cfg.const_loss != "l2":
        # the reference builds a jsd/l1 criterion but computes weighted MSE
        # regardless (main_ucf101.py:402-409)
        print(f"note: const_loss='{loss_cfg.const_loss}' behaves as weighted "
              "MSE, matching the reference's actual computation")

    def check(state):
        if state.device.type != dev.type or dev.index not in (None, state.device.index):
            raise ValueError(f"the train state is on {state.device}, the step on {dev}")
        if state.model.bn_groups not in (1, 2):
            raise ValueError(f"the train step needs a model with bn_groups 1 or 2, "
                             f"not {state.model.bn_groups}")

    def run(state, batch, epoch, wt_ramp) -> dict:
        """Forward, losses, backward and update -> the metrics."""
        model, optimizer = state.model, state.optimizer
        model.train()
        data, aug, seg_gt = prepare_views(batch, dev)
        action, flags, row_mask = _labels(batch, dev)
        kw = dict(epoch=epoch, thresh_epoch=loss_cfg.thresh_epoch, generator=state.generator)

        optimizer.zero_grad(set_to_none=True)
        if model.bn_groups == 2:
            b = data.shape[0]
            seg_all, scores_all, _ = model(
                torch.cat([data, aug]), torch.cat([action, action]),
                torch.cat([flags, flags]), **kw)
            output, flip_op, scores = seg_all[:b], seg_all[b:], scores_all[:b]
        else:
            output, scores, _ = model(data, action, flags, **kw)
            flip_op, _, _ = model(aug, action, flags, **kw)
        total, metrics = compute_losses(output, flip_op, scores, seg_gt, action, flags,
                                        row_mask, loss_cfg, wt_ramp)
        total.backward()
        all_reduce_grads(model.parameters())  # nothing without a process group
        if grad_metrics:
            metrics["grad_norm"] = global_grad_norm(model.parameters())
        optimizer.step()
        return metrics

    def train_step(state, batch, epoch, wt_ramp):
        check(state)
        metrics = run(state, batch, epoch, wt_ramp)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    if dev.type != "cuda":
        return train_step
    return GraphedStep(train_step, run, check, loss_cfg.thresh_epoch, dev)


def make_val_step(loss_cfg: LossConfig, *, device=None):
    """The validation step `val_step(state, batch, row_mask) -> (seg_bin,
    metrics)` (val_model_interface, main_ucf101.py:33-47): the eval
    forward, the losses over the rows where row_mask == 1, and the seg
    binarized at logits > 0."""
    dev = resolve_device(device)
    loc_loss_fn = _LOC_LOSS[loss_cfg.loc_loss]

    @torch.no_grad()
    def val_step(state, batch, row_mask):
        model = state.model.eval()
        data, _, seg_gt = prepare_views(batch, dev)
        action = _to(batch["action"], dev).long()
        row_mask = _to(row_mask, dev).float()
        seg, scores, _ = model(data)
        cls_loss = _masked_spread(scores, action, row_mask, loss_cfg.spread_m_min,
                                  loss_cfg.spread_m_max)
        loc = _masked_bce(seg, seg_gt, row_mask) + loc_loss_fn(seg, seg_gt, row_mask)
        correct = (scores.argmax(dim=1) == action.reshape(-1)).to(torch.float32)
        acc = global_sum((correct * row_mask).sum()) / _count(row_mask)
        metrics = {"loss": loc + cls_loss, "loss_seg": loc, "loss_cls": cls_loss, "acc": acc}
        return (seg > 0).to(torch.float32), metrics

    return val_step
