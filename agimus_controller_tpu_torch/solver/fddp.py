"""Feasibility-driven DDP (Crocoddyl `SolverFDDP` semantics).

Port of the JAX package's `solver/fddp.py`: the settings (`SolverSettings`,
read by every solver of the port), the solution tuple (`Solution`) and the
single-scenario solver `solve_fddp` over the generic `CostFunctions`
(`ocp/costs.py`):

- the stage derivatives of all T nodes in one batched evaluation
  (`CostFunctions.stage_derivs_b`),
- the backward Riccati recursion with FDDP gap folding, a Python loop over
  T (the JAX `lax.scan`),
- the line search: the whole alpha ladder in one gap-contracting rollout
  batched over the alphas (JAX `vmap`s `_forward` over them), the first
  acceptable step taken,
- Levenberg-Marquardt regularisation of Quu.

The JAX solver runs `max_iters` iterations with a convergence mask that
makes converged iterations no-ops; this one reads the flag on the host once
per iteration (`Solution.host_syncs`) and stops there, which changes no
result.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Static solver configuration (mirrors `OCPParamsBaseCroco`,
    `ocp_param_base.py:31-85`, solver side)."""

    max_iters: int = 10
    n_alphas: int = 10  # step ladder alpha_i = 0.5 ** i
    termination_tolerance: float = 1e-3  # KKT inf-norm
    reg_init: float = 1e-9
    reg_min: float = 1e-9
    reg_max: float = 1e9
    reg_inc: float = 10.0
    reg_dec: float = 10.0
    use_filter_line_search: bool = True  # mim_solvers default in the reference
    accept_ratio: float = 0.1  # fraction of expected decrease to accept


class Solution(NamedTuple):
    """A solve's result; the batch solver gives every field a leading [B]."""

    xs: torch.Tensor  # [T+1, nx]
    us: torch.Tensor  # [T, nu]
    K: torch.Tensor  # [T, nu, nx] Riccati feedback gains
    k: torch.Tensor  # [T, nu] feed-forward corrections (last pass)
    cost: torch.Tensor
    kkt: torch.Tensor  # KKT inf-norm (criterion of mim_solvers SQP)
    gap_norm: torch.Tensor
    iters: torch.Tensor
    reg: torch.Tensor
    converged: torch.Tensor
    # host reads of a device flag in `solve_fddp` (None from the batch FDDP,
    # which counts them on the solver)
    host_syncs: Optional[int] = None


def cholesky(A):
    """Lower Cholesky factors of the symmetrised A [..., n, n]; NaN where a
    matrix is not positive definite (as the JAX factorisation)."""
    L, info = torch.linalg.cholesky_ex((A + A.transpose(-1, -2)) / 2)
    return torch.where((info == 0)[..., None, None], L, float("nan"))


def cho_solve(L, Bm):
    """(L L^T) X = Bm with L [..., n, n], Bm [..., n, m]."""
    y = torch.linalg.solve_triangular(L, Bm, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def total_cost(cf, xs, us, refs):
    """Running costs of every node plus the terminal cost (JAX
    `_total_cost`); one batched evaluation of the T running nodes."""
    T = us.shape[0]
    ts = torch.arange(T, device=xs.device)
    return cf.value(xs[:-1], us, ts, refs).sum() + cf.terminal_cost(xs[-1],
                                                                    refs)


def _gaps(x0, xs, xnext):
    return torch.cat([(x0 - xs[0])[None], xnext - xs[1:]], 0)  # [T+1, nx]


def _backward(d, term, fs, reg):
    """Riccati sweep with FDDP gap folding (JAX `_backward`). Returns
    (ks, Ks, Qus, d1, d2, diverged)."""
    T, nu = d.lu.shape
    eye = torch.eye(nu, dtype=fs.dtype, device=fs.device)
    Vx, Vxx = term.lx, term.lxx
    d1 = d2 = fs.new_zeros(())
    ks, Ks, Qus = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        Fx, Fu = d.Fx[t], d.Fu[t]
        Vx_plus = Vx + Vxx @ fs[t + 1]  # fold the next-node gap (FDDP)
        Qx = d.lx[t] + Fx.T @ Vx_plus
        Qu = d.lu[t] + Fu.T @ Vx_plus
        Qxx = d.lxx[t] + Fx.T @ Vxx @ Fx
        Qux = d.lxu[t].T + Fu.T @ Vxx @ Fx
        Quu = d.luu[t] + Fu.T @ Vxx @ Fu + reg * eye
        L = cholesky(Quu)
        kk = cho_solve(L, Qu[:, None])[:, 0]
        KK = cho_solve(L, Qux)
        Vx = Qx - Qux.T @ kk
        Vxx = Qxx - Qux.T @ KK
        Vxx = 0.5 * (Vxx + Vxx.T)
        d1 = d1 + torch.dot(Qu, kk)
        d2 = d2 + torch.dot(kk, Quu @ kk)
        ks[t], Ks[t], Qus[t] = kk, KK, Qu
    ks, Ks, Qus = torch.stack(ks), torch.stack(Ks), torch.stack(Qus)
    diverged = ~(torch.isfinite(ks).all() & torch.isfinite(Ks).all())
    return ks, Ks, Qus, d1, d2, diverged


def _forward(cf, x0, xs, us, ks, Ks, fs, alphas, refs):
    """Gap-contracting rollouts at every step length alpha [A] at once:
    gaps contract by (1 - alpha) (Crocoddyl FDDP forwardPass). Returns
    (xs [A,T+1,nx], us [A,T,nu], cost [A])."""
    A, T = alphas.shape[0], us.shape[0]
    one_m_a = (1.0 - alphas)[:, None]
    x = x0 - one_m_a * fs[0]
    xs_new, us_new = [x], []
    for t in range(T):
        u = us[t] - alphas[:, None] * ks[t] - (x - xs[t]) @ Ks[t].T
        x = cf.step_b(x, u, t, refs) - one_m_a * fs[t + 1]
        xs_new.append(x)
        us_new.append(u)
    xs_a, us_a = torch.stack(xs_new, 1), torch.stack(us_new, 1)
    running = cf.value(xs_a[:, :-1].reshape(A * T, -1),
                       us_a.reshape(A * T, -1),
                       torch.arange(T, device=x0.device).repeat(A),
                       refs).reshape(A, T)
    cost = running.sum(1) + cf.term_value(xs_a[:, -1], refs)
    return xs_a, us_a, cost


def solve_fddp(cf, x0, refs, xs_init, us_init,
               settings: SolverSettings = SolverSettings()) -> Solution:
    """Solve the OCP from a warm start (JAX `solve_fddp`): x0 [nx],
    xs_init [T+1, nx], us_init [T, nu], `cf` a `CostFunctions`."""
    s = settings
    T = us_init.shape[0]
    kw = dict(dtype=xs_init.dtype, device=xs_init.device)
    alphas = torch.as_tensor([0.5 ** i for i in range(s.n_alphas)], **kw)
    ts = torch.arange(T, device=xs_init.device)

    def derivs_of(xs, us):
        return (cf.stage_derivs_b(xs[:-1], us, ts, refs),
                cf.terminal_derivs(xs[-1], refs))

    xs, us = xs_init, us_init
    cost = total_cost(cf, xs, us, refs)
    reg = torch.as_tensor(s.reg_init, **kw)
    kkt = torch.as_tensor(float("inf"), **kw)
    converged = torch.zeros((), dtype=torch.bool, device=xs.device)
    iters = 0
    ks = torch.zeros((T, us.shape[1]), **kw)
    Ks = torch.zeros((T, us.shape[1], xs.shape[1]), **kw)
    host_syncs = 0
    for _ in range(s.max_iters):
        host_syncs += 1
        if bool(converged):
            break  # the JAX scan's remaining iterations are no-ops
        d, term = derivs_of(xs, us)
        fs = _gaps(x0, xs, d.xnext)
        gap_norm = fs.abs().max()
        ks_new, Ks_new, Qus, d1, d2, diverged = _backward(d, term, fs, reg)
        kkt_new = torch.maximum(Qus.abs().max(), gap_norm)

        # line search over the whole alpha ladder in one batched rollout
        xs_a, us_a, cost_a = _forward(cf, x0, xs, us, ks_new, Ks_new, fs,
                                      alphas, refs)
        finite = torch.isfinite(cost_a) & torch.isfinite(
            xs_a.reshape(s.n_alphas, -1)).all(-1)
        reduction = cost - cost_a
        if s.use_filter_line_search:
            # mim_solvers filter, gated on feasibility: a feasible iterate
            # accepts on cost decrease only
            gaps_a = (1.0 - alphas) * gap_norm
            infeasible = gap_norm > 1e-9
            accept = finite & ((reduction > 0.0) | (
                infeasible & (gaps_a < gap_norm * (1.0 - 1e-6))))
        else:
            expected = alphas * d1 - 0.5 * alphas ** 2 * d2
            accept = finite & torch.where(
                expected > 0.0, reduction >= s.accept_ratio * expected,
                reduction > 0.0)
        best = accept.to(torch.int32).argmax()  # first True: largest step
        step_ok = accept.any() & ~diverged
        xs = torch.where(step_ok, xs_a[best], xs)
        us = torch.where(step_ok, us_a[best], us)
        cost = torch.where(step_ok, cost_a[best], cost)
        reg = torch.clamp(torch.where(step_ok, reg / s.reg_dec,
                                      reg * s.reg_inc), s.reg_min, s.reg_max)
        kkt, ks, Ks = kkt_new, ks_new, Ks_new
        iters += 1
        converged = kkt_new < s.termination_tolerance

    # final KKT and gains at the solution (the published Riccati gains)
    d, term = derivs_of(xs, us)
    fs = _gaps(x0, xs, d.xnext)
    ks_f, Ks_f, Qus, _, _, diverged = _backward(
        d, term, fs, torch.as_tensor(s.reg_min, **kw))
    gap_norm = fs.abs().max()
    kkt_f = torch.maximum(Qus.abs().max(), gap_norm)
    return Solution(
        xs=xs, us=us, K=torch.where(diverged, Ks, Ks_f),
        k=torch.where(diverged, ks, ks_f), cost=cost, kkt=kkt_f,
        gap_norm=gap_norm, iters=torch.as_tensor(iters, device=xs.device),
        reg=reg, converged=converged | (kkt_f < s.termination_tolerance),
        host_syncs=host_syncs)
