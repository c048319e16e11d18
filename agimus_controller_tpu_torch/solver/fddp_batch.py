"""Batch-native FDDP: thousands of scenarios in one solver call.

Port of the JAX package's `solver/fddp_batch.py::make_batch_fddp`
(Crocoddyl `SolverFDDP` semantics per scenario). The batch dimension runs
through every stage:

- linearisation: ONE launch of the dynamics-step kernel K5b over all T*B
  nodes with per-node dt (`ops/cuda_dynamics.py`; multi-resolution horizons
  work), plus one call of the XLA-style component cost pack over all T*B
  running nodes (`ops/batched_costs.make_batched_cost_pack`) and one over
  the B terminal nodes; where the pack declines the spec, the batched
  forms of the generic `ocp.costs.CostFunctions` take its place, as the
  JAX solver falls back to `vmap(cf.cost_derivs)`,
- Riccati backward: the batch-minor `riccati_components.backward_components`
  ("component", the default; for a rigid state one launch of the sweep
  kernel `ops/cuda_riccati.py` on the card), the horizon-parallel scan of
  `riccati_pscan.parallel_riccati` ("pscan", log2 T combines deep) or the
  dense `[B, n, n]` sweep with batched Cholesky factors ("dense"),
- line search: the alpha = 0.5**i ladder with per-scenario first accept
  (filter or Armijo acceptance), each trial a gap-contracting rollout of T
  sequential K5a launches over the B scenarios; it stops once every live
  scenario has accepted,
- Levenberg-Marquardt regularisation, KKT and convergence per scenario
  (`[B]` masks): a converged scenario's iteration is a no-op.

Where the JAX solver runs `lax.scan`s and `lax.while_loop`s, the port runs
Python loops: it reads an "all done" flag on the host once per iteration
and once per line-search trial (counted in `BatchFDDP.host_syncs`), and the
iteration loop stops once every scenario has converged, which changes no
result. A trial's running cost at node t depends only on that node's
(x_t, u_t): the port evaluates all T*B node costs in one cost-pack call
after the rollout's T steps and sums them over t in the order of the JAX
scan, so the numbers are those of one call per step.

Under a profiler a solve records the spans (`spans.py`) "fddp.solve" (the
call), "fddp.riccati" (each backward pass, whichever sweep), "fddp.costs"
(each cost-pack evaluation) and "fddp.sync" (each host read of a flag, one
per `host_syncs`).

Soft contact (`spec.soft_contact`, JAX `fddp_batch.py:80-124`): the
force-augmented state [q; v; f] is stepped by `ops.batched_dynamics.
make_batched_soft_step(_with_derivs)` with each node's `contact_active`
from the refs (no kernel: the step kernels are rigid-body), the costs by
the generic `CostFunctions`. Given cost functions with a Lie-group state
(`ocp.ff_costs.FFCostFunctions`), the solver runs in their tangent space:
defects through `cf.state_diff`, the rollout's feedback and gap contraction
through `cf.state_diff`/`cf.state_integrate`, dynamics and costs from `cf`
(JAX `fddp_batch.py:72-79,93-125`). As in the JAX package, manifold and
soft contact together are refused.
"""

from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.model import ModelParams, RobotModel
from ..ocp.costs import build_cost_functions
from ..ocp.spec import ProblemSpec
from ..ops.batched_costs import make_batched_cost_pack
from ..ops.batched_dynamics import (
    make_batched_soft_step,
    make_batched_soft_step_with_derivs,
)
from ..ops.cuda_dynamics import make_cuda_step, make_cuda_step_derivs
from ..ops.cuda_riccati import RiccatiKernel
from ..spans import span
from .fddp import (
    Solution,
    SolverSettings,
    cho_solve,
    cholesky,
    feasibility_gate,
    over_leading,
)
from .riccati_components import backward_components
from .riccati_pscan import parallel_riccati

_RICCATI = ("component", "pscan", "dense")


def _all_finite(a, B):
    """[B]: every entry of scenario b of a time-major [T, B, ...] tensor is
    finite."""
    return torch.isfinite(a).reshape(a.shape[0], B, -1).all(2).all(0)


def backward_dense(Fx, Fu, lx, lu, lxx, lxu, luu, fs, term_lx, term_lxx,
                   reg):
    """The `[B, n, n]` reference sweep (JAX `fddp_batch.py:209-244`), with
    the arguments and results of `riccati_components.backward_components`."""
    T, B, nu = Fu.shape[0], fs.shape[1], lu.shape[-1]
    eye_u = torch.eye(nu, dtype=fs.dtype, device=fs.device)
    ein = torch.einsum
    Vx, Vxx = term_lx, term_lxx
    d1 = d2 = fs.new_zeros(B)
    ks, Ks, Qus = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        Fxt, Fut = Fx[t], Fu[t]
        Vx_plus = Vx + ein("bij,bj->bi", Vxx, fs[t + 1])
        Qx = lx[t] + ein("bji,bj->bi", Fxt, Vx_plus)
        Qu = lu[t] + ein("bji,bj->bi", Fut, Vx_plus)
        VF = ein("bij,bjk->bik", Vxx, Fxt)
        Qxx = lxx[t] + ein("bji,bjk->bik", Fxt, VF)
        Qux = lxu[t].transpose(-1, -2) + ein("bji,bjk->bik", Fut, VF)
        VFu = ein("bij,bjk->bik", Vxx, Fut)
        Quu = luu[t] + ein("bji,bjk->bik", Fut, VFu) + (
            reg[:, None, None] * eye_u)
        L = cholesky(Quu)
        kk = cho_solve(L, Qu[..., None])[..., 0]
        KK = cho_solve(L, Qux)
        Vx = Qx - ein("bji,bj->bi", Qux, kk)
        Vxx = Qxx - ein("bji,bjk->bik", Qux, KK)
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        d1 = d1 + ein("bi,bi->b", Qu, kk)
        d2 = d2 + ein("bi,bij,bj->b", kk, Quu, kk)
        ks[t], Ks[t], Qus[t] = kk, KK, Qu
    ks, Ks, Qus = torch.stack(ks), torch.stack(Ks), torch.stack(Qus)
    bad = ~(_all_finite(ks, B) & _all_finite(Ks, B))
    return ks, Ks, Qus, d1, d2, bad


class BatchFDDP:
    """`solve(x0s [B,nx], refs, xs [B,T+1,nx], us [B,T,nu]) -> Solution`
    (every field with a leading [B]) over the dynamics-step kernels."""

    def __init__(self, model: RobotModel, params: ModelParams,
                 spec: ProblemSpec, settings: SolverSettings = SolverSettings(),
                 riccati: str = "component",
                 device: torch.device | str = DEFAULT_DEVICE, cf=None):
        if riccati not in _RICCATI:
            raise ValueError(riccati)
        self.soft = spec.soft_contact is not None
        self.manifold = getattr(cf, "ntan", None) is not None
        if self.manifold and self.soft:
            # the JAX package's batch FDDP asserts the same
            raise NotImplementedError(
                "manifold + soft contact not supported yet")
        self.device = resolve_device(device)
        if self.manifold:
            self.pack = cf  # dynamics and costs together
        else:
            # the batched cost pack, or the generic CostFunctions where it
            # declines the spec (same batched interface)
            self.pack = make_batched_cost_pack(model, params, spec,
                                               device=self.device)
            if self.pack is None:
                self.pack = build_cost_functions(model, params, spec,
                                                 torch.float64)
        self.T = spec.horizon
        self.settings, self.riccati = settings, riccati
        if self.soft:
            self.soft_b = make_batched_soft_step(model, params,
                                                 spec.soft_contact)
            self.soft_db = make_batched_soft_step_with_derivs(
                model, params, spec.soft_contact)
        elif not self.manifold:
            self.step_k = make_cuda_step(model, params, self.device)
            self.step_dk = make_cuda_step_derivs(model, params, self.device)
            self.riccati_k = RiccatiKernel(model.nj, self.device)
        self._ts = torch.as_tensor(spec.timesteps(), dtype=torch.float64)
        self._alphas = [0.5 ** i for i in range(settings.n_alphas)]
        self._nodes = {}  # (B, dtype, device) -> per-node dt and times
        self.host_syncs = 0  # host reads of a device flag (loop conditions)

    @property
    def kernels(self):
        """The two step-kernel wrappers, K5a and K5b, and the component
        Riccati sweep's (none for soft contact or a manifold state)."""
        if self.soft or self.manifold:
            return ()
        return (self.step_k, self.step_dk, self.riccati_k)

    def _all(self, mask: torch.Tensor) -> bool:
        self.host_syncs += 1
        with span("fddp.sync"):
            return bool(mask.all())

    def _node_data(self, xs):
        """(dt [T, B], the same flattened [T*B], node times [T*B]) on xs's
        device, time-major."""
        T, B = self.T, xs.shape[1]
        key = (B, xs.dtype, xs.device)
        if key not in self._nodes:
            dts = self._ts.to(xs.dtype)[:, None].expand(T, B).contiguous().to(
                xs.device)
            self._nodes[key] = (
                dts, dts.reshape(T * B),
                torch.arange(T, device=xs.device).repeat_interleave(B))
        return self._nodes[key]

    # ------------------------------------------------------------------
    # node-parallel evaluations
    # ------------------------------------------------------------------
    def total_cost(self, xs, us, refs):
        """[B]: the running costs summed over t in the scan's order, plus
        the terminal cost; one cost-pack call over all T*B nodes."""
        T, B = self.T, xs.shape[1]
        _, _, t_flat = self._node_data(xs)
        with span("fddp.costs"):
            c = self.pack.value(xs[:-1].reshape(T * B, -1),
                                us.reshape(T * B, -1), t_flat,
                                refs).reshape(T, B)
            acc = xs.new_zeros(B)
            for t in range(T):
                acc = acc + c[t]
            return acc + self.pack.term_value(xs[-1], refs)

    def _step(self, x, u, dts, t_idx, refs):
        """x+ of the nodes: K5a, or the soft step with the nodes' contact
        activation (`t_idx` an [N] tensor or an int)."""
        if self.manifold:
            return self.pack.step_b(x, u, t_idx, refs)
        if not self.soft:
            return self.step_k(x, u, dts)
        act = refs["contact_active"].to(x.dtype)[t_idx]
        return self.soft_b(x, u, dts, act.expand(x.shape[0]))

    def derivs_of(self, xs, us, refs):
        T, B, nx, nu = self.T, xs.shape[1], xs.shape[2], us.shape[2]
        _, dts_flat, t_flat = self._node_data(xs)
        x_flat = xs[:-1].reshape(T * B, nx)
        u_flat = us.reshape(T * B, nu)
        if self.manifold:
            # tangent-space blocks, dynamics and costs in one evaluation
            d = self.pack.stage_derivs_b(x_flat, u_flat, t_flat, refs)
            nt = self.pack.ntan
            dyn = (d.xnext.reshape(T, B, nx), d.Fx.reshape(T, B, nt, nt),
                   d.Fu.reshape(T, B, nt, nu))
            costs = tuple(c.reshape((T, B) + c.shape[1:]) for c in d[:6])
            with span("fddp.costs"):
                return dyn, costs, self.pack.term_pack(xs[-1], refs)
        if self.soft:
            act = refs["contact_active"].to(xs.dtype).index_select(0, t_flat)
            xnext, Fx, Fu = self.soft_db(x_flat, u_flat, dts_flat, act)
        else:
            xnext, Fx, Fu = self.step_dk(x_flat, u_flat, dts_flat)
        dyn = (xnext.reshape(T, B, nx), Fx.reshape(T, B, nx, nx),
               Fu.reshape(T, B, nx, nu))
        with span("fddp.costs"):
            costs = tuple(c.reshape((T, B) + c.shape[1:]) for c in
                          self.pack.pack(x_flat, u_flat, t_flat, refs))
            return dyn, costs, self.pack.term_pack(xs[-1], refs)

    def _sdiff(self, x1, x0):
        """x1 (-) x0 over leading batch dimensions: the tangent difference
        of the manifold, else the vector difference."""
        if not self.manifold:
            return x1 - x0
        return over_leading(self.pack.state_diff, x1)(x1, x0)

    def _sint(self, x, dx):
        """x (+) dx over leading batch dimensions (the retraction)."""
        if not self.manifold:
            return x + dx
        return over_leading(self.pack.state_integrate, x)(x, dx)

    def _gaps_of(self, x0s, xs, xnext):
        """Dynamics defects, [T+1, B, ntan]."""
        if self.manifold:
            return torch.cat([self._sdiff(x0s, xs[0])[None],
                              self._sdiff(xnext, xs[1:])], 0)
        return torch.cat([(x0s - xs[0])[None], xnext - xs[1:]], 0)

    # ------------------------------------------------------------------
    # Riccati backward
    # ------------------------------------------------------------------
    def backward(self, dyn, costs, term, fs, reg):
        """(ks [T,B,nu], Ks [T,B,nu,nx], Qus [T,B,nu], d1 [B], d2 [B],
        bad [B])."""
        _, Fx, Fu = dyn
        _, lx, lu, lxx, lxu, luu = costs
        with span("fddp.riccati"):
            if self.riccati == "pscan":
                return parallel_riccati(lx, lu, lxx, lxu, luu, Fx, Fu, fs,
                                        term[1], term[2], reg)
            if self.riccati == "dense":
                sweep = backward_dense
            elif self.soft or self.manifold:
                # their state is not the kernel's [q; v] of 2 nj
                sweep = backward_components
            else:
                sweep = self.riccati_k
            return sweep(Fx, Fu, lx, lu, lxx, lxu, luu, fs, term[1], term[2],
                         reg)

    # ------------------------------------------------------------------
    # line search
    # ------------------------------------------------------------------
    def rollout_alpha(self, alpha, x0s, xs, us, ks, Ks, fs, refs):
        """One gap-contracting FDDP rollout at step length ``alpha``: T
        K5a launches over the B scenarios, then the trial cost of all nodes
        in one cost-pack call. Returns (xs [T+1,B,nx], us [T,B,nu],
        cost [B])."""
        one_m_a = 1.0 - alpha
        dts, _, _ = self._node_data(xs)
        if self.manifold:
            x = self._sint(x0s, -one_m_a * fs[0])
        else:
            x = x0s - one_m_a * fs[0]
        xs_new, us_new = [x], []
        for t in range(self.T):
            dx = self._sdiff(x, xs[t])
            du = -alpha * ks[t] - (Ks[t] * dx[:, None, :]).sum(-1)
            u = us[t] + du
            if self.manifold:
                x = self._sint(self._step(x, u, dts[t], t, refs),
                               -one_m_a * fs[t + 1])
            else:
                x = self._step(x, u, dts[t], t, refs) - one_m_a * fs[t + 1]
            xs_new.append(x)
            us_new.append(u)
        xs_try, us_try = torch.stack(xs_new), torch.stack(us_new)
        return xs_try, us_try, self.total_cost(xs_try, us_try, refs)

    def _accept(self, alpha, cost, cost_a, finite, gap_norm, d1, d2):
        s = self.settings
        reduction = cost - cost_a  # [B]
        if s.use_filter_line_search:
            # feasibility-gated filter: a feasible scenario accepts on cost
            # decrease only, otherwise (1-a)*gap < gap admits
            # cost-increasing steps (`feasibility_gate`: 1e-9 in float64)
            gaps_a = (1.0 - alpha) * gap_norm
            infeasible = gap_norm > feasibility_gate(gap_norm.dtype)
            return finite & ((reduction > 0.0) | (
                infeasible & (gaps_a < gap_norm * (1.0 - 1e-6))))
        expected = alpha * d1 - 0.5 * (alpha ** 2) * d2
        return finite & torch.where(expected > 0.0,
                                    reduction >= s.accept_ratio * expected,
                                    reduction > 0.0)

    def line_search(self, x0s, xs, us, ks, Ks, fs, refs, cost, gap_norm, d1,
                    d2, skip):
        """Sequential alpha ladder with per-scenario first accept (the order
        Crocoddyl tries step lengths). Returns (took [B], xs, us, cost)."""
        done = skip
        took = torch.zeros_like(skip)
        xs_b, us_b, cost_b = xs, us, cost
        for alpha in self._alphas:
            if self._all(done):
                break
            xs_t, us_t, cost_t = self.rollout_alpha(alpha, x0s, xs, us, ks,
                                                    Ks, fs, refs)
            finite = torch.isfinite(xs_t).all(2).all(0) & torch.isfinite(cost_t)
            take = self._accept(alpha, cost, cost_t, finite, gap_norm, d1,
                                d2) & ~done
            xs_b = torch.where(take[None, :, None], xs_t, xs_b)
            us_b = torch.where(take[None, :, None], us_t, us_b)
            cost_b = torch.where(take, cost_t, cost_b)
            done = done | take
            took = took | take
        return took, xs_b, us_b, cost_b

    # ------------------------------------------------------------------
    def __call__(self, x0s, refs, xs_in, us_in) -> Solution:
        with span("fddp.solve"):
            return self._solve(x0s, refs, xs_in, us_in)

    def _solve(self, x0s, refs, xs_in, us_in) -> Solution:
        s = self.settings
        T = self.T
        xs = xs_in.transpose(0, 1).contiguous()  # [T+1, B, nx] time-major
        us = us_in.transpose(0, 1).contiguous()
        B, nu = xs.shape[1], us.shape[2]
        nx = self.pack.ntan if self.manifold else xs.shape[2]  # tangent
        kw = dict(dtype=xs.dtype, device=xs.device)

        cost = self.total_cost(xs, us, refs)
        reg = torch.full((B,), s.reg_init, **kw)
        kkt = torch.full((B,), float("inf"), **kw)
        converged = torch.zeros((B,), dtype=torch.bool, device=xs.device)
        iters = torch.zeros((B,), dtype=torch.int32, device=xs.device)
        ks = torch.zeros((T, B, nu), **kw)
        Ks = torch.zeros((T, B, nu, nx), **kw)

        for _ in range(s.max_iters):
            if self._all(converged):
                break
            dyn, costs, term = self.derivs_of(xs, us, refs)
            fs = self._gaps_of(x0s, xs, dyn[0])
            gap_norm = fs.abs().amax((0, 2))  # [B]
            ks_new, Ks_new, Qus, d1, d2, bad = self.backward(
                dyn, costs, term, fs, reg)
            kkt_new = torch.maximum(Qus.abs().amax((0, 2)), gap_norm)

            any_accept, xs_best, us_best, cost_best = self.line_search(
                x0s, xs, us, ks_new, Ks_new, fs, refs, cost, gap_norm, d1, d2,
                converged | bad)

            ok = any_accept & ~converged
            xs = torch.where(ok[None, :, None], xs_best, xs)
            us = torch.where(ok[None, :, None], us_best, us)
            cost = torch.where(ok, cost_best, cost)
            reg = torch.where(
                converged, reg,
                torch.clamp(torch.where(any_accept & ~bad, reg / s.reg_dec,
                                        reg * s.reg_inc),
                            s.reg_min, s.reg_max))
            live = ~converged
            kkt = torch.where(live, kkt_new, kkt)
            ks = torch.where(live[None, :, None], ks_new, ks)
            Ks = torch.where(live[None, :, None, None], Ks_new, Ks)
            iters = iters + live.to(iters.dtype)
            converged = converged | (kkt_new < s.termination_tolerance)

        # final report pass
        dyn, costs, term = self.derivs_of(xs, us, refs)
        fs = self._gaps_of(x0s, xs, dyn[0])
        ks_f, Ks_f, Qus, _, _, bad = self.backward(
            dyn, costs, term, fs, torch.full((B,), s.reg_min, **kw))
        gap_norm = fs.abs().amax((0, 2))
        kkt_f = torch.maximum(Qus.abs().amax((0, 2)), gap_norm)
        return Solution(
            xs=xs.transpose(0, 1), us=us.transpose(0, 1),
            K=torch.where(bad[None, :, None, None], Ks, Ks_f).transpose(0, 1),
            k=torch.where(bad[None, :, None], ks, ks_f).transpose(0, 1),
            cost=cost, kkt=kkt_f, gap_norm=gap_norm, iters=iters, reg=reg,
            converged=converged | (kkt_f < s.termination_tolerance))


def make_batch_fddp(model: RobotModel, params: ModelParams, spec: ProblemSpec,
                    settings: SolverSettings = SolverSettings(),
                    riccati: str = "component",
                    device: torch.device | str = DEFAULT_DEVICE,
                    cf=None) -> BatchFDDP:
    """Build the batch FDDP solver for `device` (see `BatchFDDP`). The costs
    come from `spec` through the batched cost pack, or the generic
    `CostFunctions` where the pack declines the spec; `cf`, cost functions
    with a Lie-group state (`ocp.ff_costs.build_ff_cost_functions`), puts
    the solver in their tangent space."""
    return BatchFDDP(model, params, spec, settings, riccati, device, cf)
