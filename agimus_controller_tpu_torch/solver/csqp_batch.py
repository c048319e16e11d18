"""Batch-native constrained SQP (mim_solvers `SolverCSQP` semantics).

Port of the JAX package's `solver/csqp_batch.py::make_batch_csqp`, the
batch counterpart of `csqp.solve_csqp`, with the batch axis through every
stage:

- linearisation: ONE launch of the dynamics-step kernel K5b over all T*B
  nodes (`ops/cuda_dynamics.py`) and one cost-pack call
  (`ops/batched_costs.py`; the given `CostFunctions` where the pack
  declines the spec), the constraint rows and Jacobians of all (T+1)*B
  nodes in one evaluation,
- the rho-augmented Riccati factorisation once per SQP iteration, a
  Python loop over T of `[B, n, n]` Cholesky factors,
- the QP: OSQP-style scaled ADMM over that factorisation with PER-SCENARIO
  residual masks (a scenario that meets eps_abs/eps_rel keeps its state)
  and a GLOBAL exit once every scenario of the batch is done; the duals
  carry across SQP iterations,
- the filter line search on (cost, gap + violation), all alphas folded
  into the batch: one K5a launch over the T*B*A trial nodes,
- per-scenario convergence on the KKT criterion (stationarity with the
  ADMM duals, gaps, violation).

Rho and the regularisation are fixed (`settings.rho`, `settings.reg_min`),
as in the JAX solver: `adaptive_rho`, `constraint_envelope` and
`soc_iters` belong to the batch SQP (`sqp_batch.py`), the production
constrained solver.

The ADMM count is the loop's: every live scenario adds it to its
`qp_iters`, so it depends on the whole batch. `steps` is the solve as a
generator that yields the scenarios' done flags at each ADMM exit and
takes back whether the whole batch is done: `BatchCSQP.__call__` answers
from its own flags (one host read each), a sharded solve
(`parallel/mesh.py`) from every shard's, so the shards exit together as
the JAX loop does on the global batch. The SQP loop stops once every
scenario has converged (the JAX scan's remaining iterations are no-ops).

The node evaluations are `sqp_batch.BatchSQP`'s on its "xla" backend
(K5a/K5b, the cost pack, the constraint rows), "manifold" for cost
functions with a Lie-group state (dynamics and costs from `cf`, the
steps in its tangent space, retractions through `cf.state_integrate`).
Soft contact steps the force-augmented state with each node's
`contact_active` from the refs (no kernel: the step kernels are
rigid-body). The JAX module's soft branch calls the soft steps without
the activation and raises; the port steps as that branch's `dyn_step` /
`dyn_derivs` (JAX `csqp_batch.py:68-83`) intend (ROADMAP queue 3).
"""

from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE
from ..models.model import ModelParams, RobotModel
from ..ocp.costs import CostFunctions
from ..ocp.spec import ProblemSpec
from .csqp import CSQPSettings, CSQPSolution, _violation
from .fddp import cho_solve, cholesky
from .sqp_batch import BatchSQP


def _all_finite(a, B):
    """[B]: every entry of scenario b of a time-major [T, B, ...] tensor is
    finite."""
    return torch.isfinite(a).reshape(a.shape[0], B, -1).all(2).all(0)


class BatchCSQP:
    """`solve(x0s [B,nx], refs, xs [B,T+1,nx], us [B,T,nu]) ->
    CSQPSolution` with a leading [B] on every field."""

    def __init__(self, model: RobotModel, params: ModelParams,
                 spec: ProblemSpec, cf, settings: CSQPSettings,
                 device: torch.device | str = DEFAULT_DEVICE):
        manifold = getattr(cf, "ntan", None) is not None
        self.nodes = BatchSQP(model, params, spec, settings, device,
                              backend="xla", cf=cf if manifold else None)
        if isinstance(self.nodes.costs, CostFunctions):
            self.nodes.costs = cf  # where the pack declines: the given cf
        self.manifold = manifold
        self.settings, self.T = settings, spec.horizon
        self.nc = cf.n_constraints
        self.device = self.nodes.device
        self.host_syncs = 0  # host reads of a device flag (loop conditions)

    @property
    def kernels(self):
        """K5a and K5b (none for soft contact or a Lie-group state)."""
        return self.nodes.kernels

    def _all(self, mask: torch.Tensor) -> bool:
        self.host_syncs += 1
        return bool(mask.all())

    def total_cost(self, xs, us, refs):
        """[B]: the running costs summed over t in the JAX scan's order,
        plus the terminal cost; one cost evaluation of all T*B nodes."""
        T, B = self.T, xs.shape[1]
        x_flat, u_flat, _, t_idx = self.nodes._flatten_nodes(xs, us)
        c = self.nodes.costs.value(x_flat, u_flat, t_idx, refs).reshape(T, B)
        acc = xs.new_zeros(B)
        for t in range(T):
            acc = acc + c[t]
        return acc + self.nodes.costs.term_value(xs[-1], refs)

    def _xnext(self, xs, us, refs):
        """x+ of every running node, [T, B, nx]: K5a, the soft step or the
        manifold step."""
        T, B, nx = self.T, xs.shape[1], xs.shape[2]
        x_flat, u_flat, dts, t_idx = self.nodes._flatten_nodes(xs, us)
        xn = (self.nodes.costs.step_b(x_flat, u_flat, t_idx, refs)
              if self.manifold else
              self.nodes._step(x_flat, u_flat, dts, t_idx, refs))
        return xn.reshape(T, B, nx)

    def factorize(self, dyn, costs, term, Gx, Gu, rho, reg):
        """The rho-augmented Riccati factorisation (JAX `factorize`):
        (Ls, Ks [T,B,nu,nt], Vxx_next [T,B,nt,nt], bad [B])."""
        _, Fx, Fu = dyn
        _, _, _, lxx, lxu, luu = costs
        T, B, nu = self.T, Fu.shape[1], Fu.shape[-1]
        eye_u = torch.eye(nu, dtype=Fu.dtype, device=Fu.device)
        gtg = lambda A, Bm: A.transpose(-1, -2) @ Bm
        nc = self.nc
        Vxx = term[2] + (rho * gtg(Gx[-1], Gx[-1]) if nc else 0.0)
        Ls, Ks, Vn = [None] * T, [None] * T, [None] * T
        for t in reversed(range(T)):
            lxx_t, lxu_t, luu_t = lxx[t], lxu[t], luu[t]
            if nc:
                gx, gu = Gx[t], Gu[t]
                lxx_t = lxx_t + rho * gtg(gx, gx)
                luu_t = luu_t + rho * gtg(gu, gu)
                lxu_t = lxu_t + rho * gtg(gx, gu)
            FxT, FuT = Fx[t].transpose(-1, -2), Fu[t].transpose(-1, -2)
            VF = Vxx @ Fx[t]
            Qxx = lxx_t + FxT @ VF
            Quu = luu_t + FuT @ (Vxx @ Fu[t]) + reg * eye_u
            Qux = lxu_t.transpose(-1, -2) + FuT @ VF
            L = cholesky(Quu)
            K = cho_solve(L, Qux)
            Ls[t], Ks[t], Vn[t] = L, K, Vxx
            Vxx = Qxx - Qux.transpose(-1, -2) @ K
            Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        Ls, Ks, Vn = torch.stack(Ls), torch.stack(Ks), torch.stack(Vn)
        return Ls, Ks, Vn, ~(_all_finite(Ls, B) & _all_finite(Ks, B))

    def qp_sweep(self, dyn, costs, term, fs, Ls, Ks, Vxx_next, Gx, Gu, rho,
                 z, y):
        """Linear backward sweep over the cached factors, then the forward
        sweep, with the linear terms l + rho G^T (y - z) (JAX `qp_sweep`).
        Returns (dxs [T+1,B,nt], dus [T,B,nu], ks [T,B,nu], Qus)."""
        _, Fx, Fu = dyn
        _, lx, lu, _, _, _ = costs
        mv = lambda M, v: (M @ v[..., None])[..., 0]
        mTv = lambda M, v: (M.transpose(-1, -2) @ v[..., None])[..., 0]
        if self.nc:
            yz = y - z
            rx = lx + rho * mTv(Gx[:-1], yz[:-1])
            ru = lu + rho * mTv(Gu[:-1], yz[:-1])
            rxT = term[1] + rho * mTv(Gx[-1], yz[-1])
        else:
            rx, ru, rxT = lx, lu, term[1]
        T = self.T
        ks, Qus = [None] * T, [None] * T
        Vx = rxT
        for t in reversed(range(T)):
            Vx_plus = Vx + mv(Vxx_next[t], fs[t + 1])
            Qx = rx[t] + mTv(Fx[t], Vx_plus)
            Qu = ru[t] + mTv(Fu[t], Vx_plus)
            ks[t] = cho_solve(Ls[t], Qu[..., None])[..., 0]
            Qus[t] = Qu
            Vx = Qx - mTv(Ks[t], Qu)
        dx, dxs, dus = fs[0], [], []
        for t in range(T):
            du = -ks[t] - mv(Ks[t], dx)
            dxs.append(dx)
            dus.append(du)
            dx = mv(Fx[t], dx) + mv(Fu[t], du) + fs[t + 1]
        dxs.append(dx)
        return (torch.stack(dxs), torch.stack(dus), torch.stack(ks),
                torch.stack(Qus))

    def steps(self, x0s, refs, xs_in, us_in):
        """The solve as a generator: yields the scenarios' ADMM done flags
        [B] at each ADMM exit, takes back whether every scenario of the
        batch is done, returns the `CSQPSolution`."""
        s, T, nc, nodes = self.settings, self.T, self.nc, self.nodes
        syncs0 = self.host_syncs
        xs = xs_in.transpose(0, 1).contiguous()  # [T+1, B, nx] time-major
        us = us_in.transpose(0, 1).contiguous()
        B, nx, nu = xs.shape[1], xs.shape[2], us.shape[2]
        nt = nodes.costs.ntan if self.manifold else nx
        kw = dict(dtype=xs.dtype, device=xs.device)
        rho, reg = float(s.rho), float(s.reg_min)
        alphas = torch.as_tensor([0.5 ** i for i in range(s.n_alphas)], **kw)
        A = s.n_alphas
        mv = lambda M, v: (M @ v[..., None])[..., 0]
        mTv = lambda M, v: (M.transpose(-1, -2) @ v[..., None])[..., 0]
        inf = float("inf")

        cost = self.total_cost(xs, us, refs)
        kkt = torch.full((B,), inf, **kw)
        converged = torch.zeros((B,), dtype=torch.bool, device=xs.device)
        iters = torch.zeros((B,), dtype=torch.int32, device=xs.device)
        qp_total = torch.zeros_like(iters)
        Ks = torch.zeros((T, B, nu, nt), **kw)
        ks = torch.zeros((T, B, nu), **kw)
        y_carry = torch.zeros((T + 1, B, max(nc, 1)), **kw)
        for _ in range(s.max_iters):
            if self._all(converged):
                break  # the JAX scan's remaining iterations are no-ops
            dyn, costs, term = nodes.derivs_of(xs, us, refs)
            fs = nodes._gaps_of(x0s, xs, dyn[0])
            gap_sum = fs.abs().sum((0, 2))
            if nc:
                g, lb, ub, Gx, Gu = nodes.constraints_of(xs, us, refs)
                viol = _violation(g, lb, ub).sum((0, 2))
            else:
                g = lb = ub = Gx = Gu = None
                viol = torch.zeros((B,), **kw)
            Ls, Ks_new, Vxx_next, factor_bad = self.factorize(
                dyn, costs, term, Gx, Gu, rho, reg)
            sweep = lambda z, y: self.qp_sweep(dyn, costs, term, fs, Ls,
                                               Ks_new, Vxx_next, Gx, Gu, rho,
                                               z, y)
            if nc:
                lo, hi = lb - g, ub - g
                # the linearised constraint change G dx + G du, [T+1, B, nc]
                cvals = lambda dxs, dus: mv(Gx, dxs) + torch.cat(
                    [mv(Gu[:-1], dus), dus.new_zeros((1, B, nc))], 0)
                z = torch.clamp(torch.zeros_like(lo), lo, hi)
                y = y_carry  # warm-started duals
                dxs = torch.zeros((T + 1, B, nt), **kw)
                dus = torch.zeros((T, B, nu), **kw)
                ks_q = torch.zeros((T, B, nu), **kw)
                done = converged  # converged scenarios skip the QP
                qp_n = 0
                while qp_n < s.max_qp_iters:
                    if (yield done):
                        break
                    dxs2, dus2, ks2, _ = sweep(z, y)
                    c = cvals(dxs2, dus2)
                    z2 = torch.clamp(c + y, lo, hi)
                    y2 = y + c - z2
                    rp = (c - z2).abs().amax((0, 2))
                    dz = z2 - z
                    rd = rho * torch.maximum(
                        mTv(Gx, dz).abs().amax((0, 2)),
                        mTv(Gu, dz).abs().amax((0, 2)))
                    tol = s.eps_abs + s.eps_rel * torch.clamp(
                        z2.abs().amax((0, 2)), min=1.0)
                    live = ~done[None, :, None]
                    z = torch.where(live, z2, z)
                    y = torch.where(live, y2, y)
                    dxs = torch.where(live, dxs2, dxs)
                    dus = torch.where(live, dus2, dus)
                    ks_q = torch.where(live, ks2, ks_q)
                    done = done | ((rp < tol) & (rd < tol))
                    qp_n += 1
                # stationarity with the ADMM duals mu = rho*y: the sweep
                # with z = 0 builds l + G^T mu; its Qu is the reduced
                # Lagrangian gradient (the mim_solvers KKT criterion)
                Qus_kkt = sweep(torch.zeros_like(z), y)[3]
            else:
                dxs, dus, ks_q, Qus_kkt = sweep(None, None)
                qp_n = 1

            step_bad = factor_bad | ~(_all_finite(dxs, B)
                                      & _all_finite(dus, B))
            dxs = torch.where(step_bad[None, :, None], 0.0, dxs)
            dus = torch.where(step_bad[None, :, None], 0.0, dus)

            # ---- filter line search, the alphas folded into the batch ----
            if self.manifold:
                xs_a = torch.stack([nodes._sint(xs, a * dxs)
                                    for a in alphas.tolist()], 2)
            else:
                xs_a = xs[:, :, None] + alphas[:, None] * dxs[:, :, None]
            us_a = us[:, :, None] + alphas[:, None] * dus[:, :, None]
            xs_f = xs_a.reshape(T + 1, B * A, nx)
            us_f = us_a.reshape(T, B * A, nu)
            cost_a = self.total_cost(xs_f, us_f, refs).reshape(B, A)
            gaps_f = nodes._gaps_of(x0s.repeat_interleave(A, 0), xs_f,
                                    self._xnext(xs_f, us_f, refs))
            gap_a = gaps_f.abs().sum((0, 2)).reshape(B, A)
            viol_a = (_violation(*nodes.constraint_vals(xs_f, us_f, refs))
                      .sum((0, 2)).reshape(B, A) if nc
                      else torch.zeros((B, A), **kw))
            finite = (torch.isfinite(xs_a).all(3).all(0)
                      & torch.isfinite(cost_a))
            accept = finite & ((cost_a < cost[:, None]) | (
                gap_a + viol_a < (gap_sum + viol)[:, None] * (1.0 - 1e-8)))
            any_accept = accept.any(1) & ~step_bad
            best = accept.to(torch.int32).argmax(1)  # first True
            bidx = torch.arange(B, device=xs.device)

            # KKT at the current iterate: stationarity, gaps, violation; a
            # scenario meeting the tolerance returns this iterate unstepped
            kkt_raw = torch.maximum(
                torch.maximum(fs.abs().amax((0, 2)),
                              _violation(g, lb, ub).amax((0, 2)) if nc
                              else torch.zeros((B,), **kw)),
                Qus_kkt.abs().amax((0, 2)))
            kkt_new = torch.where(step_bad | ~torch.isfinite(kkt_raw),
                                  inf, kkt_raw)
            newly = kkt_new < s.termination_tolerance
            ok = (any_accept & ~converged & ~newly)[None, :, None]
            xs = torch.where(ok, xs_a[:, bidx, best], xs)
            us = torch.where(ok, us_a[:, bidx, best], us)
            cost = torch.where(ok[0, :, 0], cost_a[bidx, best], cost)
            live = ~converged
            kkt = torch.where(live, kkt_new, kkt)
            Ks = torch.where(live[None, :, None, None], Ks_new, Ks)
            ks = torch.where(live[None, :, None], ks_q, ks)
            iters = iters + live.to(iters.dtype)
            qp_total = qp_total + torch.where(live, qp_n, 0).to(
                qp_total.dtype)
            if nc:
                y_carry = torch.where(live[None, :, None], y, y_carry)
            converged = converged | newly

        # final feasibility report
        dyn, _, _ = nodes.derivs_of(xs, us, refs)
        fs = nodes._gaps_of(x0s, xs, dyn[0])
        cnorm = (_violation(*nodes.constraint_vals(xs, us, refs)).amax((0, 2))
                 if nc else torch.zeros((B,), **kw))
        return CSQPSolution(
            xs=xs.transpose(0, 1), us=us.transpose(0, 1),
            K=Ks.transpose(0, 1), k=ks.transpose(0, 1), cost=cost, kkt=kkt,
            gap_norm=fs.abs().amax((0, 2)), constraint_norm=cnorm,
            iters=iters, qp_iters=qp_total, converged=converged,
            host_syncs=self.host_syncs - syncs0)

    def __call__(self, x0s, refs, xs_in, us_in) -> CSQPSolution:
        """One batch solve, each ADMM exit decided by its own flags."""
        gen = self.steps(x0s, refs, xs_in, us_in)
        try:
            done = next(gen)
            while True:
                done = gen.send(self._all(done))
        except StopIteration as stop:
            return stop.value


def make_batch_csqp(model: RobotModel, params: ModelParams,
                    spec: ProblemSpec, cf, settings: CSQPSettings = CSQPSettings(),
                    device: torch.device | str = DEFAULT_DEVICE) -> BatchCSQP:
    """Build the batch CSQP for `device` (see `BatchCSQP`): the dynamics on
    K5a/K5b (the soft step for a soft-contact spec), the costs from the
    batched cost pack or ``cf`` where the pack declines the spec, the
    constraint rows from ``cf``; cost functions with a Lie-group state put
    the solver in their tangent space (dynamics and costs from ``cf``)."""
    return BatchCSQP(model, params, spec, cf, settings, device)
