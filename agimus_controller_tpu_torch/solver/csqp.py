"""Constrained SQP (mim_solvers `SolverCSQP` semantics): settings and the
single-scenario solver.

Port of the JAX package's `solver/csqp.py`: `CSQPSettings` (over
`SolverSettings`, whose home is `solver/fddp.py`, as in the JAX package),
`CSQPSolution` and `solve_csqp`. Each SQP iteration linearises dynamics,
costs and inequality constraints (`CostFunctions`, all nodes in one batched
evaluation) and solves the stagewise QP

    min  sum_t  1/2 d' H_t d + h_t' d
    s.t. dx_{t+1} = Fx dx_t + Fu du_t + gap_{t+1},   dx_0 = gap_0,
         lb_t <= g_t + Gx_t dx_t + Gu_t du_t <= ub_t

with OSQP-style scaled ADMM over a Riccati factorisation of the
rho-augmented quadratics, made once per SQP iteration, so each ADMM
iteration is one linear sweep plus a slack clip and a dual update; the
duals carry across SQP iterations. The filter line search takes the whole
alpha ladder in one batched evaluation.

`solve_csqp` takes rho fixed at `settings.rho`, as the JAX function does
(`adaptive_rho`, `constraint_envelope`, `envelope_tol` and `soc_iters` are
read by the batch SQP only). Where the JAX solver scans `max_iters` SQP
iterations and `max_qp_iters` ADMM iterations under convergence masks
(`lax.cond` on the ADMM's done flag), this one reads each flag on the host
(`CSQPSolution.host_syncs`) and stops where the masks freeze the state,
which changes no result. `sweep_f64` is not ported: the sweeps run in the
trajectory dtype.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .fddp import SolverSettings, cho_solve, cholesky, total_cost

__all__ = ["CSQPSettings", "CSQPSolution", "SolverSettings", "solve_csqp"]


@dataclasses.dataclass(frozen=True)
class CSQPSettings(SolverSettings):
    max_qp_iters: int = 200
    eps_abs: float = 1e-6
    eps_rel: float = 0.0
    rho: float = 1e-1
    # OSQP-style per-scenario rho adaptation between SQP iterations
    adaptive_rho: bool = True
    # constraint-envelope acceptance in the filter line search
    constraint_envelope: bool = True
    envelope_tol: float = 1e-5
    # second-order (Maratos) correction iterations of the ADMM step
    soc_iters: int = 4


class CSQPSolution(NamedTuple):
    xs: torch.Tensor
    us: torch.Tensor
    K: torch.Tensor  # [T, nu, nx] Riccati feedback gains (rho-augmented)
    k: torch.Tensor  # [T, nu] last QP feed-forward step
    cost: torch.Tensor
    kkt: torch.Tensor
    gap_norm: torch.Tensor
    constraint_norm: torch.Tensor
    iters: torch.Tensor
    qp_iters: torch.Tensor
    converged: torch.Tensor
    host_syncs: int = 0  # host reads of a device flag (loop conditions)


def _violation(g, lb, ub):
    return torch.clamp(torch.maximum(lb - g, g - ub), min=0.0)


class _Problem:
    """The node data of one SQP iteration and its QP sweeps."""

    def __init__(self, cf, x0, refs, T, nu):
        self.cf, self.x0, self.refs, self.T, self.nu = cf, x0, refs, T, nu
        self.ts = torch.arange(T, device=x0.device)
        self.nc = cf.n_constraints
        if self.nc:
            self.t_all = torch.arange(T + 1, device=x0.device)
            self.rmask = torch.as_tensor(cf.terminal_constraint_row_mask,
                                         dtype=torch.bool, device=x0.device)

    def stage_all(self, xs, us):
        return (self.cf.stage_derivs_b(xs[:-1], us, self.ts, self.refs),
                self.cf.terminal_derivs(xs[-1], self.refs))

    def constraint_all(self, xs, us, derivs=True):
        """[T+1]-node constraint data (JAX `constraint_all`) of xs
        [..., T+1, nx], us [..., T, nu]: the terminal node keeps its
        terminal-flagged rows only and has no control columns. One batched
        evaluation of every node."""
        con, lead, T = self.cf.constraint_functions, xs.shape[:-2], self.T
        n = xs[..., 0, 0].numel() * (T + 1)
        u_all = torch.cat([us, us.new_zeros(lead + (1, self.nu))], -2)
        out = (con.constraint_derivs if derivs else con.constraints)(
            xs.reshape(n, -1), u_all.reshape(n, -1),
            self.t_all.repeat(n // (T + 1)), self.refs)
        out = [a.reshape(lead + (T + 1,) + a.shape[1:]) for a in out]
        g, lb, ub = out[:3]
        inf = float("inf")
        last = lambda a, fill: torch.cat(
            [a[..., :-1, :], torch.where(self.rmask, a[..., -1:, :], fill)],
            -2)
        lb, ub = last(lb, -inf), last(ub, inf)
        if not derivs:
            return g, lb, ub
        Gu = torch.cat([out[4][..., :-1, :, :],
                        torch.zeros_like(out[4][..., :1, :, :])], -3)
        return g, lb, ub, out[3], Gu

    def gaps_of(self, xnext, xs):
        return torch.cat([(self.x0 - xs[0])[None], xnext - xs[1:]], 0)


def _factor(d, term, Gx, Gu, rho, reg, nc):
    """Cholesky factors, gains and next-node value Hessians of the
    rho-augmented quadratic part (JAX `factor_body`, reversed scan)."""
    T, nu = d.lu.shape
    eye = torch.eye(nu, dtype=d.lu.dtype, device=d.lu.device)
    Ls, Ks, Vxx_next = [None] * T, [None] * T, [None] * T
    Vxx = term.lxx + (rho * Gx[-1].T @ Gx[-1] if nc else 0.0)
    for t in reversed(range(T)):
        lxx, lxu, luu, Fx, Fu = d.lxx[t], d.lxu[t], d.luu[t], d.Fx[t], d.Fu[t]
        if nc:
            gx, gu = Gx[t], Gu[t]
            lxx = lxx + rho * gx.T @ gx
            luu = luu + rho * gu.T @ gu
            lxu = lxu + rho * gx.T @ gu
        Qxx = lxx + Fx.T @ Vxx @ Fx
        Quu = luu + Fu.T @ Vxx @ Fu + reg * eye
        Qux = lxu.T + Fu.T @ Vxx @ Fx
        L = cholesky(Quu)
        K = cho_solve(L, Qux)
        Ls[t], Ks[t], Vxx_next[t] = L, K, Vxx
        Vxx = Qxx - Qux.T @ K
        Vxx = 0.5 * (Vxx + Vxx.T)
    return torch.stack(Ls), torch.stack(Ks), torch.stack(Vxx_next)


def _qp_sweep(d, term, fs, Gx, Gu, Ls, Ks, Vxx_next, rho, z, y, nc):
    """Linear backward (cached factors) and forward sweep with the
    slack/dual linear terms l + rho G^T (y - z) (JAX `qp_sweep`). Returns
    (dxs [T+1,nx], dus [T,nu], ks [T,nu], Qus [T,nu])."""
    T = d.lu.shape[0]
    if nc:
        yz = y - z
        rx = d.lx + rho * torch.einsum("tci,tc->ti", Gx[:-1], yz[:-1])
        ru = d.lu + rho * torch.einsum("tci,tc->ti", Gu[:-1], yz[:-1])
        rxT = term.lx + rho * Gx[-1].T @ yz[-1]
    else:
        rx, ru, rxT = d.lx, d.lu, term.lx
    ks, Qus = [None] * T, [None] * T
    Vx = rxT
    for t in reversed(range(T)):
        Vx_plus = Vx + Vxx_next[t] @ fs[t + 1]
        Qx = rx[t] + d.Fx[t].T @ Vx_plus
        Qu = ru[t] + d.Fu[t].T @ Vx_plus
        ks[t] = cho_solve(Ls[t], Qu[:, None])[:, 0]
        Qus[t] = Qu
        Vx = Qx - Ks[t].T @ Qu
    dx, dxs, dus = fs[0], [], []
    for t in range(T):
        du = -ks[t] - Ks[t] @ dx
        dxs.append(dx)
        dus.append(du)
        dx = d.Fx[t] @ dx + d.Fu[t] @ du + fs[t + 1]
    dxs.append(dx)
    return torch.stack(dxs), torch.stack(dus), torch.stack(ks), torch.stack(Qus)


def solve_csqp(cf, x0, refs, xs_init, us_init,
               settings: CSQPSettings = CSQPSettings()) -> CSQPSolution:
    """Solve the constrained OCP from a warm start (JAX `solve_csqp`):
    x0 [nx], xs_init [T+1, nx], us_init [T, nu], `cf` a `CostFunctions`."""
    s = settings
    T, nx, nu = us_init.shape[0], xs_init.shape[1], us_init.shape[1]
    nc = cf.n_constraints
    kw = dict(dtype=xs_init.dtype, device=xs_init.device)
    rho = s.rho
    reg = s.reg_min
    alphas = torch.as_tensor([0.5 ** i for i in range(s.n_alphas)], **kw)
    pb = _Problem(cf, x0, refs, T, nu)
    host_syncs = 0

    def trial(xs, us, dxs, dus):
        """(xs, us, cost, gap + violation) at every alpha, one batched
        evaluation of the A*T nodes."""
        A = alphas.shape[0]
        xs_a = xs + alphas[:, None, None] * dxs
        us_a = us + alphas[:, None, None] * dus
        flat = lambda a, n: a.reshape(A * n, a.shape[-1])
        t_rep = pb.ts.repeat(A)
        running = cf.value(flat(xs_a[:, :-1], T), flat(us_a, T), t_rep,
                           refs).reshape(A, T)
        cost = running.sum(1) + cf.term_value(xs_a[:, -1], refs)
        xnext = cf.step_b(flat(xs_a[:, :-1], T), flat(us_a, T), t_rep,
                          refs).reshape(A, T, nx)
        gap = torch.cat([(x0 - xs_a[:, 0])[:, None], xnext - xs_a[:, 1:]],
                        1).abs().sum((1, 2))
        if nc:
            viol = _violation(*pb.constraint_all(xs_a, us_a, derivs=False)
                              ).sum((1, 2))
        else:
            viol = torch.zeros_like(gap)
        return xs_a, us_a, cost, gap + viol

    xs, us = xs_init, us_init
    cost = total_cost(cf, xs, us, refs)
    kkt = torch.as_tensor(float("inf"), **kw)
    converged = torch.zeros((), dtype=torch.bool, device=xs.device)
    iters = qp_total = 0
    Ks_out = torch.zeros((T, nu, nx), **kw)
    ks_out = torch.zeros((T, nu), **kw)
    y_carry = torch.zeros((T + 1, max(nc, 1)), **kw)  # ADMM dual carry
    for _ in range(s.max_iters):
        host_syncs += 1
        if bool(converged):
            break  # the JAX scan's remaining iterations are no-ops
        d, term = pb.stage_all(xs, us)
        fs = pb.gaps_of(d.xnext, xs)
        gap_norm = fs.abs().sum()
        if nc:
            g, lb, ub, Gx, Gu = pb.constraint_all(xs, us)
            viol = _violation(g, lb, ub).sum()
        else:
            g = lb = ub = Gx = Gu = None
            viol = fs.new_zeros(())

        # ---- factorise the rho-augmented quadratic part (once) ----------
        Ls, Ks, Vxx_next = _factor(d, term, Gx, Gu, rho, reg, nc)
        factor_bad = ~(torch.isfinite(Ls).all() & torch.isfinite(Ks).all())
        sweep = lambda z, y: _qp_sweep(d, term, fs, Gx, Gu, Ls, Ks, Vxx_next,
                                       rho, z, y, nc)

        # ---- ADMM, warm-started from the carried duals -------------------
        if nc:
            lo, hi = lb - g, ub - g  # constraint sets in delta space

            def cvals(dxs, dus):
                cu = torch.einsum("tci,ti->tc", Gu[:-1], dus)
                cx = torch.einsum("tci,ti->tc", Gx, dxs)
                return cx + torch.cat([cu, cu.new_zeros((1, nc))], 0)

            z = torch.clamp(torch.zeros_like(lo), lo, hi)
            y = y_carry
            dxs = torch.zeros((T + 1, nx), **kw)
            dus = torch.zeros((T, nu), **kw)
            ks = torch.zeros((T, nu), **kw)
            qp_n = 0
            for _ in range(s.max_qp_iters):
                dxs, dus, ks, _ = sweep(z, y)
                c = cvals(dxs, dus)
                z2 = torch.clamp(c + y, lo, hi)
                y = y + c - z2
                rp = (c - z2).abs().max()
                dz = z2 - z
                rd = rho * torch.maximum(
                    torch.einsum("tci,tc->ti", Gx, dz).abs().max(),
                    torch.einsum("tci,tc->ti", Gu, dz).abs().max())
                z = z2
                qp_n += 1
                tol = s.eps_abs + s.eps_rel * torch.clamp(z.abs().max(),
                                                          min=1.0)
                host_syncs += 1
                if bool((rp < tol) & (rd < tol)):
                    break  # the JAX `lax.cond` skips the rest
            # TRUE stationarity at the current iterate: the Lagrangian
            # gradient in the reduced u-space with mu = rho*y
            stat = sweep(torch.zeros_like(z), y)[3].abs().max()
        else:
            dxs, dus, ks, Qus = sweep(None, None)
            stat = Qus.abs().max()
            qp_n = 1

        step_bad = factor_bad | ~(torch.isfinite(dxs).all()
                                  & torch.isfinite(dus).all())
        dxs = torch.where(step_bad, torch.zeros_like(dxs), dxs)
        dus = torch.where(step_bad, torch.zeros_like(dus), dus)

        # ---- filter line search (linear state update) -----------------
        xs_a, us_a, cost_a, infeas_a = trial(xs, us, dxs, dus)
        infeas0 = gap_norm + viol
        accept = torch.isfinite(cost_a) & (
            (cost_a < cost) | (infeas_a < infeas0 * (1.0 - 1e-8)))
        any_accept = accept.any() & ~step_bad
        best = accept.to(torch.int32).argmax()

        # KKT at the current iterate: stationarity with the ADMM duals and
        # primal feasibility; a failed factorisation cannot fake it
        kkt_raw = torch.maximum(
            torch.maximum(fs.abs().max(), _violation(g, lb, ub).max()
                          if nc else fs.new_zeros(())), stat)
        kkt = torch.where(step_bad | ~torch.isfinite(kkt_raw),
                          torch.full_like(kkt_raw, float("inf")), kkt_raw)
        newly_conv = kkt < s.termination_tolerance
        # on convergence the verified current iterate is returned
        take = any_accept & ~newly_conv
        xs = torch.where(take, xs_a[best], xs)
        us = torch.where(take, us_a[best], us)
        cost = torch.where(take, cost_a[best], cost)
        Ks_out, ks_out = Ks, ks
        iters += 1
        qp_total += qp_n
        if nc:
            y_carry = y
        converged = newly_conv

    # final feasibility report
    d, _ = pb.stage_all(xs, us)
    fs = pb.gaps_of(d.xnext, xs)
    cnorm = (_violation(*pb.constraint_all(xs, us, derivs=False)).max()
             if nc else fs.new_zeros(()))
    dev = xs.device
    return CSQPSolution(
        xs=xs, us=us, K=Ks_out, k=ks_out, cost=cost, kkt=kkt,
        gap_norm=fs.abs().max(), constraint_norm=cnorm,
        iters=torch.as_tensor(iters, device=dev),
        qp_iters=torch.as_tensor(qp_total, device=dev), converged=converged,
        host_syncs=host_syncs)
