"""EM routing between capsule layers.

Counterpart of picad_tpu/ops/em_routing.py, with the same reference
quirks (models/capsules_ucf101.py:108-211), which are part of the trained
behaviour:

- a_out = sigmoid(lambda * (beta_a - (cost_mean - cost) / cost_std)) with
  lambda = 1e-6;
- cost_std = sqrt((sum_j (cost_j - mean))^2 / C + eps): the sum over
  capsule types comes *before* the square;
- the eps placement in the r normalizations.

Mixed precision, as in the JAX package: the big (b, Bi, C[, psize])
tensors stay in v.dtype (bf16 in production), while the small (b, C)
cost/activation chain, the C-softmax and a_out run in f32.  With f32
votes every operation is the literal reference form.
"""

from __future__ import annotations

import math

import torch

_HALF_LN_2PI = 0.5 * math.log(2.0 * math.pi)


def _m_step(a_in, r, v, beta_u, beta_a, eps, lam):
    """a_in (b, Bi, 1), r (b, Bi, C), v (b, Bi, C, psize) ->
    a_out (b, C) f32, mu and sigma_sq (b, 1, C, psize) in v.dtype."""
    b, Bi, C, psize = v.shape
    f32 = torch.float32
    r = r * a_in
    r = r / (r.sum(dim=2, keepdim=True) + eps)
    r_sum = r.sum(dim=1, keepdim=True)  # (b, 1, C)
    coeff = (r / (r_sum + eps)).unsqueeze(-1)  # (b, Bi, C, 1)

    mu = (coeff * v).sum(dim=1, keepdim=True)  # (b, 1, C, psize)
    sigma_sq = (coeff * (v - mu) ** 2).sum(dim=1, keepdim=True) + eps

    cost_h = (
        beta_u.to(f32) + torch.log(torch.sqrt(sigma_sq[:, 0].to(f32)))
    ) * r_sum.reshape(b, C, 1).to(f32)
    cost_h = cost_h.sum(dim=2)  # (b, C)

    cost_mean = cost_h.mean(dim=1, keepdim=True)
    # literal reference :144 — sum over C, *then* square
    cost_std = torch.sqrt(
        (cost_h - cost_mean).sum(dim=1, keepdim=True) ** 2 / C + eps
    )
    a_out = torch.sigmoid(
        lam * (beta_a.to(f32) - (cost_mean - cost_h) / (cost_std + eps))
    )
    return a_out, mu, sigma_sq


def _e_step(mu, sigma_sq, a_out, v, eps):
    """ln_p in v.dtype over the big tensor, the C-softmax in f32; r
    returns in v.dtype for the next M step."""
    ln_p = (
        -((v - mu) ** 2) / (2.0 * sigma_sq)
        - torch.log(torch.sqrt(sigma_sq))
        - _HALF_LN_2PI
    )
    ln_ap = ln_p.sum(dim=3).to(torch.float32) + torch.log(eps + a_out[:, None, :])
    return torch.softmax(ln_ap, dim=2).to(v.dtype)


def em_routing(
    v: torch.Tensor,
    a_in: torch.Tensor,
    beta_u: torch.Tensor,
    beta_a: torch.Tensor,
    *,
    iters: int = 3,
    eps: float = 1e-8,
    lam: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """votes v (b, Bi, C, psize), activations a_in (b, Bi, 1), beta_u
    (C, psize), beta_a (C,) -> (mu (b, 1, C, psize) in v.dtype,
    a_out (b, C) f32).

    r starts uniform 1/C and the last iteration skips the E step
    (caps_em_routing, reference :184-211)."""
    b, Bi, C, psize = v.shape
    assert a_in.shape == (b, Bi, 1), (a_in.shape, v.shape)
    r = torch.full((b, Bi, C), 1.0 / C, dtype=v.dtype, device=v.device)
    a_out = mu = None
    for it in range(iters):
        a_out, mu, sigma_sq = _m_step(a_in, r, v, beta_u, beta_a, eps, lam)
        if it < iters - 1:
            r = _e_step(mu, sigma_sq, a_out, v, eps)
    return mu, a_out
