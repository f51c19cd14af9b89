"""Pixel-attentive consistency masks (counterpart of picad_tpu/ops/masks.py).

Segmentation maps are (B, T, H, W) logits.  The caller detaches the
inputs (the reference detaches: no gradient flows through the masks).
Numerics follow the JAX package, which matches the reference's
utils/helpers.py in f32:

- `pixelwise_cyclic_variance`: the 14-frame cyclic clip
  cat(pred[0:8], flip_pred[1:7]), the population variance of a cyclic
  window of 3 or 5 frames (mod-14 rolls), the two half-cycles folded
  (endpoints doubled), per-clip min-max normalisation;
- `pixelwise_gradient`: sigmoid, optional confidence clamps, the double
  temporal np.gradient, per-clip min-max normalisation.
"""

from __future__ import annotations

import torch


def _minmax_normalize(x: torch.Tensor, dims) -> torch.Tensor:
    """x -= min; x /= (max - min + 1e-7), per helpers.py:59-61, 88-89."""
    x = x - x.amin(dim=dims, keepdim=True)
    return x / (x.amax(dim=dims, keepdim=True) - x.amin(dim=dims, keepdim=True) + 1e-7)


def pixelwise_cyclic_variance(pred: torch.Tensor, flip_pred: torch.Tensor, *,
                              window: int = 5, use_sigmoid: bool = False) -> torch.Tensor:
    """pred, flip_pred (B, 8, H, W) logits (flip_pred flipped back) ->
    (B, 8, H, W) weights in [0, 1]."""
    assert window in (3, 5), window
    if use_sigmoid:
        pred, flip_pred = torch.sigmoid(pred), torch.sigmoid(flip_pred)
    cyclic = torch.cat([pred, flip_pred[:, 1:7]], dim=1)  # (B, 14, H, W)
    half = window // 2
    # stacked[k][:, t] = cyclic[:, (t + k - half) % 14]
    stacked = torch.stack([torch.roll(cyclic, half - k, dims=1) for k in range(window)])
    var = stacked.var(dim=0, unbiased=False)
    folded = torch.cat(
        [2.0 * var[:, 0:1], var[:, 1:7] + torch.flip(var[:, 8:14], dims=[1]),
         2.0 * var[:, 7:8]],
        dim=1,
    )
    return _minmax_normalize(folded, (1, 2, 3))


def temporal_gradient(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """np.gradient along one dim: central differences, one-sided edges."""
    n = x.shape[dim]
    upper = torch.cat([x.narrow(dim, 1, 1), x.narrow(dim, 2, n - 2),
                       x.narrow(dim, n - 1, 1)], dim=dim)
    lower = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 2),
                       x.narrow(dim, n - 2, 1)], dim=dim)
    d = upper - lower
    # the central differences over 2, the edges over 1, each in place on the
    # device: no number written from the host (a CUDA graph capture forbids
    # that copy)
    return torch.cat([d.narrow(dim, 0, 1), d.narrow(dim, 1, n - 2) / 2.0,
                      d.narrow(dim, n - 1, 1)], dim=dim)


def pixelwise_gradient(pred: torch.Tensor, *, conf_thresh_lower: float | None = None,
                       conf_thresh_upper: float | None = None) -> torch.Tensor:
    """pred (B, 8, H, W) logits -> (B, 8, H, W) weights in [0, 1]."""
    p = torch.sigmoid(pred)
    if conf_thresh_lower is not None:
        p = torch.where(p < conf_thresh_lower, torch.zeros_like(p), p)
    if conf_thresh_upper is not None:
        p = torch.where(p > conf_thresh_upper, torch.ones_like(p), p)
    g = temporal_gradient(temporal_gradient(p, dim=1), dim=1)
    return _minmax_normalize(g, (1, 2, 3))
