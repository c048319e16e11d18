"""Batch-native multiple-shooting SQP — the latency solver (unconstrained).

The reference's runtime solver semantics (mim_solvers ``SolverSQP``,
reference call site `ocp_base_croco.py:64-80`): multiple shooting with
linear step updates

    xs_try = xs + alpha * dxs,   us_try = us + alpha * dus

Port of the JAX package's `solver/sqp_batch.py::make_batch_sqp`, branch
without constraints:

- stage linearisation: ONE launch of the fused stage kernel K1 over all T*B
  running nodes plus K3 for the terminal nodes (`ops/cuda_costs.py`),
- Riccati backward: factor once per iteration, batch-minor layout
  (`riccati_components`), then a cheap vector sweep,
- line search: first-accept filter ladder over alpha = 0.5**i, each trial
  one K2 + K4 launch (costs + dynamics gaps),
- per-scenario convergence masks, Levenberg-Marquardt regularisation and a
  runtime iteration limit.

Where the JAX solver runs `lax.while_loop`s (the SQP loop and the
line-search ladder) and `lax.scan`s over T (the Riccati sweeps), the port
runs Python loops: the loop conditions read an "all done" flag on the host
once per SQP iteration and once per line-search trial (counted in
`BatchSQP.host_syncs`). Constraints (ADMM, SOC, the constraint envelope),
soft contact and manifold states are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.model import ModelParams, RobotModel
from ..ocp.spec import ProblemSpec
from ..ops.cuda_costs import make_cuda_stage, make_cuda_terminal
from .csqp import CSQPSettings
from .riccati_components import (
    _chol_lanes,
    _chol_solve_lanes,
    _mm,
    _mm_T1,
    _mv,
    _mv_T,
)


class BatchSQPSolution(NamedTuple):
    xs: torch.Tensor  # [B, T+1, nx]
    us: torch.Tensor  # [B, T, nu]
    K: torch.Tensor  # [B, T, nu, nx]
    k: torch.Tensor  # [B, T, nu]
    cost: torch.Tensor  # [B]
    kkt: torch.Tensor  # [B]
    gap_norm: torch.Tensor  # [B]
    constraint_norm: torch.Tensor  # [B]
    iters: torch.Tensor  # [B]
    qp_iters: torch.Tensor  # [B]
    converged: torch.Tensor  # [B]
    # ADMM duals [B, T+1, 1]; zeros (or the given y0) without constraints
    y: Optional[torch.Tensor] = None


def _chol_solve_dense(Ld, rhs, nu):
    """Solve (L L^T) x = rhs with Ld [nu,nu,B] dense lower, rhs [nu,B]."""
    y = [None] * nu
    for i in range(nu):
        s = rhs[i]
        for k in range(i):
            s = s - Ld[i, k] * y[k]
        y[i] = s / Ld[i, i]
    x = [None] * nu
    for i in reversed(range(nu)):
        s = y[i]
        for k in range(i + 1, nu):
            s = s - Ld[k, i] * x[k]
        x[i] = s / Ld[i, i]
    return torch.stack(x)


class BatchSQP:
    """`solve(x0s [B,nx], refs, xs [B,T+1,nx], us [B,T,nu], max_iters=None,
    y0=None) -> BatchSQPSolution` over the fused stage kernels."""

    def __init__(self, model: RobotModel, params: ModelParams,
                 spec: ProblemSpec, settings: CSQPSettings = CSQPSettings(),
                 device: torch.device | str = "cpu"):
        if spec.constraints:
            raise NotImplementedError(
                "constrained specs (ADMM, SOC, constraint envelope) are not "
                "ported yet (ROADMAP queue 1, slice 7)")
        if spec.soft_contact is not None:
            raise NotImplementedError(
                "soft contact is not ported yet (ROADMAP queue 1, slice 12)")
        self.T = spec.horizon
        self.settings = settings
        self.device = torch.device(device)
        self.stage_dk = make_cuda_stage(model, params, spec, True, self.device)
        self.stage_vk = make_cuda_stage(model, params, spec, False, self.device)
        self.term_dk = make_cuda_terminal(model, params, spec, True, self.device)
        self.term_vk = make_cuda_terminal(model, params, spec, False, self.device)
        self._ts = torch.as_tensor(spec.timesteps(), dtype=torch.float64)
        self._alphas = [0.5 ** i for i in range(settings.n_alphas)]
        self._nodes = {}  # (B, dtype) -> (dts_flat, t_idx) on the device
        self.host_syncs = 0  # host reads of a device flag (loop conditions)

    @property
    def kernels(self):
        """The four stage-kernel wrappers, K1-K4."""
        return (self.stage_dk, self.stage_vk, self.term_dk, self.term_vk)

    def _all(self, mask: torch.Tensor) -> bool:
        self.host_syncs += 1
        return bool(mask.all())

    # ------------------------------------------------------------------
    # node-parallel evaluations
    # ------------------------------------------------------------------
    def _flatten_nodes(self, xs, us):
        T, B = self.T, xs.shape[1]
        key = (B, xs.dtype)
        if key not in self._nodes:
            self._nodes[key] = (
                self._ts.to(xs.dtype).repeat_interleave(B).to(xs.device),
                torch.arange(T, device=xs.device).repeat_interleave(B))
        dts_flat, t_idx = self._nodes[key]
        return (xs[:-1].reshape(T * B, xs.shape[2]),
                us.reshape(T * B, us.shape[2]), dts_flat, t_idx)

    @staticmethod
    def _gaps_of(x0s, xs, xnext):
        """Dynamics defects, [T+1, B, nx]."""
        return torch.cat([(x0s - xs[0])[None], xnext - xs[1:]], 0)

    def cost_and_gaps(self, x0s, xs, us, refs):
        """(total cost [B], defects fs [T+1,B,nx]): the line-search merit
        terms, from one K2 and one K4 launch. The cost sum stays in the
        trajectory dtype."""
        T, B, nx = self.T, xs.shape[1], xs.shape[2]
        x_flat, u_flat, dts_flat, t_idx = self._flatten_nodes(xs, us)
        xnext_f, l_f = self.stage_vk(x_flat, u_flat, dts_flat, t_idx, refs)
        (lT,) = self.term_vk(xs[-1], refs)
        cost = l_f.reshape(T, B).sum(0) + lT
        return cost, self._gaps_of(x0s, xs, xnext_f.reshape(T, B, nx))

    def derivs_of(self, xs, us, refs):
        T, B, nx, nu = self.T, xs.shape[1], xs.shape[2], us.shape[2]
        x_flat, u_flat, dts_flat, t_idx = self._flatten_nodes(xs, us)
        (xn, Fx, Fu, l, lx, lu, lxx, lxu, luu) = self.stage_dk(
            x_flat, u_flat, dts_flat, t_idx, refs)
        dyn = (xn.reshape(T, B, nx), Fx.reshape(T, B, nx, nx),
               Fu.reshape(T, B, nx, nu))
        costs = (l.reshape(T, B), lx.reshape(T, B, nx), lu.reshape(T, B, nu),
                 lxx.reshape(T, B, nx, nx), lxu.reshape(T, B, nx, nu),
                 luu.reshape(T, B, nu, nu))
        return dyn, costs, self.term_dk(xs[-1], refs)

    # ------------------------------------------------------------------
    # Riccati: factor once, then cheap vector sweeps (mim_solvers trick)
    # ------------------------------------------------------------------
    def factor(self, Fx_t, Fu_t, lxx_t, lxu_t, luu_t, vxx_term, reg):
        nu = Fu_t.shape[2]
        eye_u = torch.eye(nu, dtype=Fx_t.dtype, device=Fx_t.device)[:, :, None]
        Ls, Ks, Vxx_next = [None] * self.T, [None] * self.T, [None] * self.T
        Vxx = vxx_term
        for t in reversed(range(self.T)):
            M = _mm(Vxx, Fx_t[t])
            N = _mm(Vxx, Fu_t[t])
            Qxx = lxx_t[t] + _mm_T1(Fx_t[t], M)
            Qux = lxu_t[t].transpose(0, 1) + _mm_T1(Fu_t[t], M)
            Quu = luu_t[t] + _mm_T1(Fu_t[t], N) + reg[None, None, :] * eye_u
            Lr = _chol_lanes(Quu, nu)
            KK = _chol_solve_lanes(Lr, Qux, nu)
            QK = _mm_T1(Qux, KK)
            z = torch.zeros_like(Lr[0][0])
            Ls[t] = torch.stack([torch.stack(
                [Lr[i][j] if j <= i else z for j in range(nu)])
                for i in range(nu)])
            Ks[t], Vxx_next[t] = KK, Vxx
            Vxx = Qxx - 0.5 * (QK + QK.transpose(0, 1))
        Ls, Ks, Vxx_next = torch.stack(Ls), torch.stack(Ks), torch.stack(Vxx_next)
        bad = ~(torch.isfinite(Ls).all(2).all(1).all(0)
                & torch.isfinite(Ks).all(2).all(1).all(0))
        return Ls, Ks, Vxx_next, bad

    def vector_sweep(self, Ls, Ks, Vxx_next, Fx_t, Fu_t, rx_t, ru_t, rxT, fs_t):
        """Linear backward (vectors only, cached factors) then forward.

        rx_t [T,nx,B], ru_t [T,nu,B], rxT [nx,B], fs_t [T+1,nx,B].
        Returns dxs_t [T+1,nx,B], dus_t [T,nu,B], ks_t [T,nu,B],
        Qus_t [T,nu,B]."""
        T, nu = self.T, Fu_t.shape[2]
        ks, Qus = [None] * T, [None] * T
        Vx = rxT
        for t in reversed(range(T)):
            Vxp = Vx + _mv(Vxx_next[t], fs_t[t + 1])
            Qx = rx_t[t] + _mv_T(Fx_t[t], Vxp)
            Qu = ru_t[t] + _mv_T(Fu_t[t], Vxp)
            ks[t] = _chol_solve_dense(Ls[t], Qu, nu)
            Qus[t] = Qu
            Vx = Qx - _mv_T(Ks[t], Qu)
        dx, dxs, dus = fs_t[0], [], []
        for t in range(T):
            du = -ks[t] - _mv(Ks[t], dx)
            dxs.append(dx)
            dus.append(du)
            dx = _mv(Fx_t[t], dx) + _mv(Fu_t[t], du) + fs_t[t + 1]
        dxs.append(dx)
        return torch.stack(dxs), torch.stack(dus), torch.stack(ks), torch.stack(Qus)

    # ------------------------------------------------------------------
    # line search: sequential alpha ladder with per-scenario first-accept;
    # it stops as soon as every live scenario accepted, so a warm-started
    # tick costs ONE trial evaluation
    # ------------------------------------------------------------------
    def line_search(self, x0s, xs, us, dxs, dus, refs, cost, infeas0, skip):
        """Returns (accepted [B], xs_new, us_new, cost_new)."""
        done = skip
        took = torch.zeros_like(skip)
        xs_b, us_b, cost_b = xs, us, cost
        for alpha in self._alphas:
            if self._all(done):
                break
            xs_t = xs + alpha * dxs
            us_t = us + alpha * dus
            cost_t, fs_t = self.cost_and_gaps(x0s, xs_t, us_t, refs)
            infeas_t = fs_t.abs().sum((0, 2))  # L1
            finite = torch.isfinite(cost_t) & torch.isfinite(infeas_t)
            accept = finite & ((cost_t < cost) | (infeas_t < infeas0 * (1.0 - 1e-8)))
            take = accept & ~done
            xs_b = torch.where(take[None, :, None], xs_t, xs_b)
            us_b = torch.where(take[None, :, None], us_t, us_b)
            cost_b = torch.where(take, cost_t, cost_b)
            done = done | take
            took = took | take
        return took, xs_b, us_b, cost_b

    # ------------------------------------------------------------------
    def __call__(self, x0s, refs, xs_in, us_in, max_iters=None,
                 y0=None) -> BatchSQPSolution:
        """``max_iters``: optional RUNTIME iteration limit, so one solver
        serves the unlimited first solve and the per-tick budget
        (`ocp_base_croco.py:160-171`). ``y0`` [B, T+1, 1]: dual carry,
        passed through (no constraints)."""
        s = self.settings
        limit = int(s.max_iters if max_iters is None else max_iters)
        T = self.T
        xs = xs_in.transpose(0, 1).contiguous()  # [T+1, B, nx] time-major
        us = us_in.transpose(0, 1).contiguous()
        B, nx, nu = xs.shape[1], xs.shape[2], us.shape[2]
        kw = dict(dtype=xs.dtype, device=xs.device)
        tol = s.termination_tolerance

        cost, _ = self.cost_and_gaps(x0s, xs, us, refs)
        kkt = torch.full((B,), float("inf"), **kw)
        converged = torch.zeros((B,), dtype=torch.bool, device=xs.device)
        iters = torch.zeros((B,), dtype=torch.int32, device=xs.device)
        qp_total = torch.zeros_like(iters)
        ks = torch.zeros((T, B, nu), **kw)
        Ks_d = torch.zeros((T, B, nu, nx), **kw)
        reg = torch.full((B,), s.reg_init, **kw)

        # early-exit iteration loop on the KKT criterion
        # (`termination_tolerance`, ocp_param_base.py:54-57), per-scenario
        # budget
        while not self._all(converged | (iters >= limit)):
            (xnext, Fx, Fu), (l, lx, lu, lxx, lxu, luu), term = self.derivs_of(
                xs, us, refs)
            fs = self._gaps_of(x0s, xs, xnext)
            gap_l1 = fs.abs().sum((0, 2))  # [B]
            gap_inf = fs.abs().amax((0, 2))

            # batch-minor relayout (once per iteration)
            Fx_t = Fx.permute(0, 2, 3, 1)
            Fu_t = Fu.permute(0, 2, 3, 1)
            Ls, Ks, Vxx_next, bad = self.factor(
                Fx_t, Fu_t, lxx.permute(0, 2, 3, 1), lxu.permute(0, 2, 3, 1),
                luu.permute(0, 2, 3, 1), term[2].permute(1, 2, 0), reg)
            dxs_t, dus_t, ks_t, Qus_t = self.vector_sweep(
                Ls, Ks, Vxx_next, Fx_t, Fu_t, lx.permute(0, 2, 1),
                lu.permute(0, 2, 1), term[1].transpose(0, 1),
                fs.permute(0, 2, 1))
            # unconstrained: Qu from the plain sweep IS the reduced
            # Lagrangian gradient
            qp_n = torch.ones_like(iters)

            step_bad = bad | ~(torch.isfinite(dxs_t).all(1).all(0)
                               & torch.isfinite(dus_t).all(1).all(0))
            dxs = torch.where(step_bad[None, :, None], 0.0, dxs_t.permute(0, 2, 1))
            dus = torch.where(step_bad[None, :, None], 0.0, dus_t.permute(0, 2, 1))

            # ---- filter line search (first-accept alpha ladder) ---------
            any_accept, xs_best, us_best, cost_best = self.line_search(
                x0s, xs, us, dxs, dus, refs, cost, gap_l1,
                converged | step_bad)
            any_accept = any_accept & ~step_bad

            # KKT at the current iterate (pre-step): Lagrangian
            # stationarity + primal feasibility, the mim_solvers criterion;
            # a failed factorization keeps the previous value
            kkt_raw = torch.maximum(Qus_t.abs().amax((0, 1)), gap_inf)
            kkt_new = torch.where(step_bad | ~torch.isfinite(kkt_raw), kkt, kkt_raw)

            # live until converged OR out of its own iteration budget
            live = ~converged & (iters < limit)
            # KKT already met at the current iterate: return it unstepped
            conv_now = live & (kkt_new < tol)
            ok = any_accept & live & ~conv_now
            xs = torch.where(ok[None, :, None], xs_best, xs)
            us = torch.where(ok[None, :, None], us_best, us)
            cost = torch.where(ok, cost_best, cost)
            kkt = torch.where(live, kkt_new, kkt)
            ks = torch.where(live[None, :, None], ks_t.permute(0, 2, 1), ks)
            Ks_d = torch.where(live[None, :, None, None],
                               Ks.permute(0, 3, 1, 2), Ks_d)
            iters = iters + live.to(iters.dtype)
            qp_total = qp_total + torch.where(live, qp_n, 0)
            # Levenberg-Marquardt schedule on the Quu regularization: grow
            # on failed factorizations / rejected steps, shrink on accepts
            reg = torch.where(
                converged, reg,
                torch.clamp(torch.where(any_accept & ~step_bad,
                                        reg / s.reg_dec, reg * s.reg_inc),
                            s.reg_min, s.reg_max))
            converged = converged | conv_now

        # final feasibility report (node-parallel)
        _, fs = self.cost_and_gaps(x0s, xs, us, refs)
        gap_inf = fs.abs().amax((0, 2))
        y = (torch.zeros((B, T + 1, 1), **kw) if y0 is None
             else torch.as_tensor(y0, **kw))
        return BatchSQPSolution(
            xs=xs.transpose(0, 1), us=us.transpose(0, 1),
            K=Ks_d.transpose(0, 1), k=ks.transpose(0, 1), cost=cost,
            kkt=kkt, gap_norm=gap_inf, constraint_norm=torch.zeros_like(gap_inf),
            iters=iters, qp_iters=qp_total, converged=converged, y=y)


def make_batch_sqp(model: RobotModel, params: ModelParams, spec: ProblemSpec,
                   settings: CSQPSettings = CSQPSettings(),
                   device: torch.device | str = "cpu") -> BatchSQP:
    """Build the batch SQP solver for `device` (see `BatchSQP`). Unlike the
    JAX factory it takes no `CostFunctions`: the constraint count (0 here)
    and the tangent dimension come from `spec`."""
    return BatchSQP(model, params, spec, settings, device)
