"""Activation models: a(r) plus analytic first/second derivatives.

Port of the JAX package's `ops/activations.py` (crocoddyl
`ActivationModelWeightedQuad`, colmpc `ActivationModelExp` /
`ActivationModelQuadExp`; DSL nodes at `ocp/ocp_croco_generic.py:95-143`).

Each activation is a triple of functions of the residual tensor r [..., nr]:
    value(r, w)  -> a(r) [...]
    dr(r, w)     -> da/dr [..., nr]
    drr(r, w)    -> diagonal of d2a/dr2 [..., nr] (Gauss-Newton diagonal)

``w`` is the runtime weight vector of the weighted quadratic; the exp
activations carry no weights.
"""

from __future__ import annotations

import torch


def weighted_quad_value(r, w):
    """a(r) = 0.5 * sum_i w_i r_i^2."""
    return 0.5 * torch.sum(w * r * r, dim=-1)


def weighted_quad_dr(r, w):
    return w * r


def weighted_quad_drr(r, w):
    return w


def exp_value(r, w, alpha):
    """colmpc ActivationModelExp (exponent=1): a(r) = exp(-||r|| / alpha)."""
    d = torch.linalg.vector_norm(r, dim=-1)
    return torch.exp(-d / alpha)


def exp_dr(r, w, alpha):
    d = torch.sqrt(torch.sum(r * r, dim=-1, keepdim=True) + 1e-12)
    return (-torch.exp(-d / alpha) / (alpha * d)) * r


def exp_drr(r, w, alpha):
    d = torch.sqrt(torch.sum(r * r, dim=-1, keepdim=True) + 1e-12)
    # diagonal Gauss-Newton approximation of the Hessian, kept PSD
    return torch.broadcast_to(torch.exp(-d / alpha) / (alpha * alpha), r.shape)


def quad_exp_value(r, w, alpha):
    """colmpc ActivationModelQuadExp (exponent=2): a(r) = exp(-||r||^2 / alpha)."""
    return torch.exp(-torch.sum(r * r, dim=-1) / alpha)


def quad_exp_dr(r, w, alpha):
    a = quad_exp_value(r, w, alpha)
    return (-2.0 / alpha) * a[..., None] * r


def quad_exp_drr(r, w, alpha):
    # PSD Gauss-Newton diagonal: only the positive 4 r^2 / alpha^2 term
    a = quad_exp_value(r, w, alpha)
    return (4.0 / (alpha * alpha)) * a[..., None] * r * r
