"""Batch-native multiple-shooting SQP / CSQP — the latency solver.

The reference's runtime solver semantics (mim_solvers ``SolverSQP`` /
``SolverCSQP``, reference call site `ocp_base_croco.py:64-80`): multiple
shooting with linear step updates

    xs_try = xs + alpha * dxs,   us_try = us + alpha * dus

Port of the JAX package's `solver/sqp_batch.py::make_batch_sqp`:

- stage linearisation: ONE launch of the fused stage kernel K1 over all T*B
  running nodes plus K3 for the terminal nodes (`ops/cuda_costs.py`); on
  the "xla" backend one K5b launch over the T*B nodes
  (`ops/cuda_dynamics.py`) and one cost evaluation of them (see below),
- Riccati backward: factor once per iteration, batch-minor layout
  (`riccati_components`), then a cheap vector sweep,
- QP (constrained specs): OSQP-style ADMM over the cached factorisation
  (rho-augmented quadratics, per-scenario done masks), a guarded
  second-order correction, the Lagrangian KKT sweep and per-scenario rho
  adaptation; the scaled duals carry across SQP iterations and, rescaled
  to the initial rho, across solves (`y0` / `solution.y`). The constraint
  rows and Jacobians come from `ocp.costs.ConstraintFunctions`,
- line search: first-accept filter ladder over alpha = 0.5**i, each trial
  one K2 + K4 launch (costs + dynamics gaps; on the "xla" backend one K5a
  launch and the cost values) plus, when constrained, the violation terms
  and the constraint envelope,
- per-scenario convergence masks, Levenberg-Marquardt regularisation and a
  runtime iteration limit.

Where the JAX solver runs `lax.while_loop`s (the SQP loop, the ADMM loop
and the line-search ladder) and `lax.scan`s over T (the Riccati sweeps), the
port runs Python loops: the loop conditions read an "all done" flag on the
host once per SQP iteration, once per ADMM iteration and once per
line-search trial (counted in `BatchSQP.host_syncs`). The sweeps run in the
trajectory dtype (no `sweep_f64`).

Soft contact (`spec.soft_contact`, JAX `sqp_batch.py:186-203`): the state
is the force-augmented [q; v; f] throughout (the Riccati sweep, the line
search and the dual carry), stepped by `ops.batched_dynamics.
make_batched_soft_step(_with_derivs)` with each node's `contact_active`
from the refs, on the "xla" backend (the stage and step kernels are
rigid-body, as the Pallas kernels are) with the generic `CostFunctions`.

The manifold backend (JAX `sqp_batch.py:124-134,177-185,208-215,252-320`):
given cost functions with a Lie-group state (`ocp.ff_costs.
FFCostFunctions`, `cf.ntan` set), the gains, steps and defects live in the
tangent space ([T+1, B, ntan]), the defects come from `cf.state_diff`, the
line search and the second-order correction retract through
`cf.state_integrate`, and the dynamics, costs and constraint rows are the
cost functions' (plain PyTorch, as the JAX package's XLA). Manifold and
soft contact compose there.

The backend (JAX `sqp_batch.py:135-170`, where "pallas" is this port's
"kernels"): "kernels" runs the stage kernels K1-K4; "xla" runs the
dynamics-step kernels K5a/K5b with the batched cost pack
(`ops/batched_costs.make_batched_cost_pack`) where the pack takes the spec,
else the generic `ocp.costs.CostFunctions` in its batched forms. The
default, "auto", takes "kernels" when `cuda_costs.check_supported` passes
for the spec, the model and the device, else "xla", and logs the refusal's
reason; `backend="xla"` forces the fallback on any spec. A kernel that
fails to build or launch raises, it never changes the backend. The
kernels take any joint count and any kinematic tree (one library per count,
`ops/_build.py`); on the card the one refusal left, of the stage and the
step kernels alike, is a block that needs more shared memory than the card
gives one (`cuda_dynamics.check_smem`, with the bytes), and "auto" takes
"xla" where the stage kernels refuse.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.model import ModelParams, RobotModel
from ..ocp.costs import build_constraint_functions, build_cost_functions
from ..ocp.spec import ProblemSpec
from ..ops.batched_costs import make_batched_cost_pack
from ..ops.batched_dynamics import (
    make_batched_soft_step,
    make_batched_soft_step_with_derivs,
)
from ..ops.cuda_costs import (
    check_supported,
    make_cuda_stage,
    make_cuda_terminal,
)
from ..ops.cuda_dynamics import make_cuda_step, make_cuda_step_derivs
from .csqp import CSQPSettings
from .fddp import over_leading
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
    # final scaled ADMM duals [B, T+1, max(nc, 1)], rescaled to the initial
    # rho: the next warm-started tick's `y0` (zeros, or the given y0,
    # without constraints)
    y: Optional[torch.Tensor] = None
    # per-iteration telemetry (JAX `BatchSQPSolution.trace_*`), with
    # `trace=True`: row i holds iteration i's cost after its step, its KKT
    # and its gap; NaN past each scenario's last iteration
    trace_cost: Optional[torch.Tensor] = None  # [max_iters, B]
    trace_kkt: Optional[torch.Tensor] = None  # [max_iters, B]
    trace_gap: Optional[torch.Tensor] = None  # [max_iters, B]


BACKENDS = ("auto", "xla")


def select_backend(model: RobotModel, spec: ProblemSpec,
                   device: torch.device | str, backend: str = "auto",
                   cf=None):
    """(backend, reason): the backend "auto" resolves to for the spec, the
    model and the device, with the stage kernels' refusal as the reason
    (None when they take the spec); "xla" passes through. Cost functions
    with a Lie-group state (`cf.ntan` set) take "manifold"."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if getattr(cf, "ntan", None) is not None:
        return "manifold", None
    if backend != "auto":
        return backend, None
    try:
        check_supported(spec, model, torch.device(device))
    except NotImplementedError as refusal:
        return "xla", str(refusal)
    return "kernels", None


def _violation(g, lb, ub):
    return torch.clamp(torch.maximum(lb - g, g - ub), min=0.0)


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
    y0=None) -> BatchSQPSolution` over the fused stage kernels ("kernels")
    or the step kernels and a cost evaluation ("xla"); `backend` holds the
    one chosen, `backend_reason` why "auto" declined the stage kernels."""

    def __init__(self, model: RobotModel, params: ModelParams,
                 spec: ProblemSpec, settings: CSQPSettings = CSQPSettings(),
                 device: torch.device | str = DEFAULT_DEVICE,
                 backend: str = "auto", cf=None, trace: bool = False):
        self.T = spec.horizon
        self.settings = settings
        self.trace = trace
        self.device = resolve_device(device)
        self.soft = spec.soft_contact is not None
        self.backend, self.backend_reason = select_backend(
            model, spec, self.device, backend, cf)
        self.manifold = self.backend == "manifold"
        if self.backend_reason is not None:
            logging.getLogger(__name__).info(
                "BatchSQP backend='auto': the stage kernels decline this "
                "spec (%s); using the 'xla' backend", self.backend_reason)
        if self.backend == "kernels":
            self.stage_dk = make_cuda_stage(model, params, spec, True,
                                            self.device)
            self.stage_vk = make_cuda_stage(model, params, spec, False,
                                            self.device)
            self.term_dk = make_cuda_terminal(model, params, spec, True,
                                              self.device)
            self.term_vk = make_cuda_terminal(model, params, spec, False,
                                              self.device)
        elif self.manifold:
            # dynamics and costs together from the Lie-group cost functions
            self.costs = cf
        else:
            if self.soft:
                self.soft_b = make_batched_soft_step(model, params,
                                                     spec.soft_contact)
                self.soft_db = make_batched_soft_step_with_derivs(
                    model, params, spec.soft_contact)
            else:
                self.step_k = make_cuda_step(model, params, self.device)
                self.step_dk = make_cuda_step_derivs(model, params,
                                                     self.device)
            # the costs: the batched pack where it takes the spec, else the
            # generic CostFunctions (same batched interface)
            self.costs = make_batched_cost_pack(model, params, spec,
                                                self.device)
            if self.costs is None:
                self.costs = build_cost_functions(model, params, spec,
                                                  torch.float64)
        self.cf = (cf.constraint_functions if self.manifold
                   else build_constraint_functions(model, params, spec))
        self.nc = self.cf.n_constraints
        self._ts = torch.as_tensor(spec.timesteps(), dtype=torch.float64)
        self._alphas = [0.5 ** i for i in range(settings.n_alphas)]
        self._nodes = {}  # (B, dtype) -> (dts_flat, t_idx) on the device
        self._cnodes = {}  # (B, device) -> (t_idx of all T+1 nodes, row mask)
        self.host_syncs = 0  # host reads of a device flag (loop conditions)
        self.admm_iters = 0  # ADMM iterations run, over all solves

    @property
    def kernels(self):
        """The kernel wrappers of the backend: K1-K4 ("kernels"), K5a and
        K5b ("xla"), none for soft contact or "manifold"."""
        if self.backend == "kernels":
            return (self.stage_dk, self.stage_vk, self.term_dk, self.term_vk)
        if self.manifold or self.soft:
            return ()
        return (self.step_k, self.step_dk)

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

    def _active(self, refs, t_idx, x):
        """The nodes' contact activation, [N] in x's dtype."""
        return refs["contact_active"].to(x.dtype).index_select(0, t_idx)

    def _step(self, x, u, dts, t_idx, refs):
        """x+ of the nodes on the "xla" backend: K5a, or the soft step."""
        if self.soft:
            return self.soft_b(x, u, dts, self._active(refs, t_idx, x))
        return self.step_k(x, u, dts)

    def _step_derivs(self, x, u, dts, t_idx, refs):
        if self.soft:
            return self.soft_db(x, u, dts, self._active(refs, t_idx, x))
        return self.step_dk(x, u, dts)

    def _sdiff(self, x1, x0):
        """x1 (-) x0 over leading batch dimensions: the tangent difference
        of the manifold, else the vector difference."""
        if not self.manifold:
            return x1 - x0
        return over_leading(self.costs.state_diff, x1)(x1, x0)

    def _sint(self, x, dx):
        """x (+) dx over leading batch dimensions (the retraction)."""
        if not self.manifold:
            return x + dx
        return over_leading(self.costs.state_integrate, x)(x, dx)

    def _gaps_of(self, x0s, xs, xnext):
        """Dynamics defects, [T+1, B, ntan]."""
        if self.manifold:
            return torch.cat([self._sdiff(x0s, xs[0])[None],
                              self._sdiff(xnext, xs[1:])], 0)
        return torch.cat([(x0s - xs[0])[None], xnext - xs[1:]], 0)

    def cost_and_gaps(self, x0s, xs, us, refs):
        """(total cost [B], defects fs [T+1,B,nx]): the line-search merit
        terms, from one K2 and one K4 launch ("xla": one K5a launch and the
        cost values). The cost sum stays in the trajectory dtype."""
        T, B, nx = self.T, xs.shape[1], xs.shape[2]
        x_flat, u_flat, dts_flat, t_idx = self._flatten_nodes(xs, us)
        if self.backend == "kernels":
            xnext_f, l_f = self.stage_vk(x_flat, u_flat, dts_flat, t_idx,
                                         refs)
            (lT,) = self.term_vk(xs[-1], refs)
        else:
            xnext_f = (self.costs.step_b(x_flat, u_flat, t_idx, refs)
                       if self.manifold else
                       self._step(x_flat, u_flat, dts_flat, t_idx, refs))
            l_f = self.costs.value(x_flat, u_flat, t_idx, refs)
            lT = self.costs.term_value(xs[-1], refs)
        cost = l_f.reshape(T, B).sum(0) + lT
        return cost, self._gaps_of(x0s, xs, xnext_f.reshape(T, B, nx))

    def derivs_of(self, xs, us, refs):
        T, B, nx, nu = self.T, xs.shape[1], xs.shape[2], us.shape[2]
        x_flat, u_flat, dts_flat, t_idx = self._flatten_nodes(xs, us)
        nt = nx  # the tangent dimension
        if self.backend == "kernels":
            (xn, Fx, Fu, l, lx, lu, lxx, lxu, luu) = self.stage_dk(
                x_flat, u_flat, dts_flat, t_idx, refs)
            term = self.term_dk(xs[-1], refs)
        elif self.manifold:
            # tangent-space blocks, dynamics and costs in one evaluation
            (l, lx, lu, lxx, lxu, luu, xn, Fx, Fu) = self.costs.stage_derivs_b(
                x_flat, u_flat, t_idx, refs)
            term = self.costs.term_pack(xs[-1], refs)
            nt = self.costs.ntan
        else:
            xn, Fx, Fu = self._step_derivs(x_flat, u_flat, dts_flat, t_idx,
                                           refs)
            l, lx, lu, lxx, lxu, luu = self.costs.pack(x_flat, u_flat, t_idx,
                                                       refs)
            term = self.costs.term_pack(xs[-1], refs)
        dyn = (xn.reshape(T, B, nx), Fx.reshape(T, B, nt, nt),
               Fu.reshape(T, B, nt, nu))
        costs = (l.reshape(T, B), lx.reshape(T, B, nt), lu.reshape(T, B, nu),
                 lxx.reshape(T, B, nt, nt), lxu.reshape(T, B, nt, nu),
                 luu.reshape(T, B, nu, nu))
        return dyn, costs, term

    # ------------------------------------------------------------------
    # constraints: all (T+1)*B nodes in one batched evaluation
    # ------------------------------------------------------------------
    def _constraint_nodes(self, xs, us):
        """x, u and node times of every node, time-major; the terminal nodes
        take refs row T and u = 0."""
        T, B = self.T, xs.shape[1]
        key = (B, xs.device)
        if key not in self._cnodes:
            self._cnodes[key] = (
                torch.arange(T + 1, device=xs.device).repeat_interleave(B),
                torch.as_tensor(self.cf.terminal_constraint_row_mask,
                                dtype=torch.bool, device=xs.device))
        t_idx, rmask = self._cnodes[key]
        u_all = torch.cat([us, torch.zeros_like(us[:1])], 0)
        return (xs.reshape((T + 1) * B, xs.shape[2]),
                u_all.reshape((T + 1) * B, us.shape[2]), t_idx, rmask)

    def _terminal_bounds(self, lb, ub, rmask):
        """The terminal node keeps only its terminal-flagged rows."""
        inf = float("inf")
        lb = torch.cat([lb[:-1], torch.where(rmask, lb[-1:], -inf)], 0)
        ub = torch.cat([ub[:-1], torch.where(rmask, ub[-1:], inf)], 0)
        return lb, ub

    def constraint_vals(self, xs, us, refs):
        """Constraint values and bounds only (line-search merit),
        [T+1, B, nc] each."""
        T, B, nc = self.T, xs.shape[1], self.nc
        x, u, t_idx, rmask = self._constraint_nodes(xs, us)
        g, lb, ub = (a.reshape(T + 1, B, nc)
                     for a in self.cf.constraints(x, u, t_idx, refs))
        return (g,) + self._terminal_bounds(lb, ub, rmask)

    def constraints_of(self, xs, us, refs):
        """[T+1]-node constraint data, time-major: g, lb, ub [T+1, B, nc],
        Gx [T+1, B, nc, nx], Gu [T+1, B, nc, nu] (zero at the terminal)."""
        T, B, nc = self.T, xs.shape[1], self.nc
        x, u, t_idx, rmask = self._constraint_nodes(xs, us)
        g, lb, ub, Gx, Gu = self.cf.constraint_derivs(x, u, t_idx, refs)
        lb, ub = self._terminal_bounds(lb.reshape(T + 1, B, nc),
                                       ub.reshape(T + 1, B, nc), rmask)
        Gu = Gu.reshape(T + 1, B, nc, us.shape[2])
        Gu = torch.cat([Gu[:-1], torch.zeros_like(Gu[-1:])], 0)
        return (g.reshape(T + 1, B, nc), lb, ub,
                Gx.reshape(T + 1, B, nc, Gx.shape[-1]), Gu)

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
    def trial_infeas(self, x0s, xs_t, us_t, refs):
        """(cost, gap + violation L1, violation inf-norm) of a trial."""
        cost_t, fs_t = self.cost_and_gaps(x0s, xs_t, us_t, refs)
        gap = fs_t.abs().sum((0, 2))  # L1
        if self.nc == 0:
            return cost_t, gap, torch.zeros_like(cost_t)
        v = _violation(*self.constraint_vals(xs_t, us_t, refs))
        return cost_t, gap + v.sum((0, 2)), v.amax((0, 2))

    def line_search(self, x0s, xs, us, dxs, dus, refs, cost, infeas0, viol0,
                    skip):
        """Returns (accepted [B], xs_new, us_new, cost_new).

        Filter acceptance with a CONSTRAINT ENVELOPE on the cost branch: a
        step is only accepted while the trial's max constraint violation
        stays within max(current, tol), so boundary-riding optima do not
        limit-cycle between cost and feasibility steps (JAX :481-491)."""
        s = self.settings
        vtol = max(s.termination_tolerance, s.envelope_tol)
        done = skip
        took = torch.zeros_like(skip)
        xs_b, us_b, cost_b = xs, us, cost
        for alpha in self._alphas:
            if self._all(done):
                break
            xs_t = self._sint(xs, alpha * dxs)  # the retraction
            us_t = us + alpha * dus
            cost_t, infeas_t, viol_t = self.trial_infeas(x0s, xs_t, us_t, refs)
            admissible = torch.isfinite(cost_t) & torch.isfinite(infeas_t)
            # the envelope never blocks repair steps; a scenario with no
            # admissible alpha holds its feasible iterate this iteration
            if s.constraint_envelope and self.nc > 0:
                admissible &= viol_t <= torch.clamp(viol0, min=vtol)
            accept = admissible & ((cost_t < cost) | (infeas_t < infeas0 * (1.0 - 1e-8)))
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
        (`ocp_base_croco.py:160-171`). ``y0`` [B, T+1, max(nc, 1)]: scaled
        ADMM duals to warm-start from, normally the previous tick's
        `solution.y`; default zeros (cold)."""
        s = self.settings
        limit = int(s.max_iters if max_iters is None else max_iters)
        T, nc = self.T, self.nc
        xs = xs_in.transpose(0, 1).contiguous()  # [T+1, B, nx] time-major
        us = us_in.transpose(0, 1).contiguous()
        B, nu = xs.shape[1], us.shape[2]
        nx = self.costs.ntan if self.manifold else xs.shape[2]  # tangent
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
        rho_b = torch.full((B,), float(s.rho), **kw)
        # ADMM dual carry [T+1, max(nc, 1), B], warm-startable across solves
        y_carry = (torch.zeros((T + 1, max(nc, 1), B), **kw) if y0 is None
                   else torch.as_tensor(y0, **kw).permute(1, 2, 0))
        if self.trace:
            # one spare row past `max_iters` takes the writes of scenarios
            # that are no longer live (the JAX scatter's dropped indices)
            trace = torch.full((3, s.max_iters + 1, B), float("nan"), **kw)
            b_idx = torch.arange(B, device=xs.device)

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
            lx_t = lx.permute(0, 2, 1)
            lu_t = lu.permute(0, 2, 1)
            lxx_t = lxx.permute(0, 2, 3, 1)
            lxu_t = lxu.permute(0, 2, 3, 1)
            luu_t = luu.permute(0, 2, 3, 1)
            fs_t = fs.permute(0, 2, 1)
            rxT = term[1].transpose(0, 1)
            vxxT = term[2].permute(1, 2, 0)

            if nc > 0:
                g, lb, ub, Gx, Gu = self.constraints_of(xs, us, refs)
                v0 = _violation(g, lb, ub)
                viol = v0.sum((0, 2))  # [B]
                viol_inf = v0.amax((0, 2))
                Gx_t = Gx.permute(0, 2, 3, 1)  # [T+1, nc, nx, B]
                Gu_t = Gu.permute(0, 2, 3, 1)
                # rho-augmented quadratics (fixed for this SQP iteration;
                # rho is per-scenario, adapted OSQP-style between iterations)
                rho4 = rho_b[None, None, None, :]
                gtg = lambda A, Bm: torch.einsum("tcib,tcjb->tijb", A, Bm)
                lxx_q = lxx_t + rho4 * gtg(Gx_t[:-1], Gx_t[:-1])
                lxu_q = lxu_t + rho4 * gtg(Gx_t[:-1], Gu_t[:-1])
                luu_q = luu_t + rho4 * gtg(Gu_t[:-1], Gu_t[:-1])
                vxx_q = vxxT + rho_b[None, None, :] * _mm_T1(
                    Gx_t[-1], Gx_t[-1])
            else:
                viol = torch.zeros((B,), **kw)
                viol_inf = torch.zeros((B,), **kw)
                lxx_q, lxu_q, luu_q, vxx_q = lxx_t, lxu_t, luu_t, vxxT

            Ls, Ks, Vxx_next, bad = self.factor(
                Fx_t, Fu_t, lxx_q, lxu_q, luu_q, vxx_q, reg)

            if nc > 0:
                qp = _ADMM(self, Ls, Ks, Vxx_next, Fx_t, Fu_t, lx_t, lu_t, rxT,
                           fs_t, Gx_t, Gu_t, rho_b, lb - g, ub - g)
                z, y, dxs_t, dus_t, ks_t, Qus_t, qp_n, rp_f, rd_f = qp.solve(
                    y_carry)
                if s.soc_iters > 0:
                    z, y, dxs_t, dus_t, ks_t, Qus_t = qp.second_order(
                        xs, us, refs, g, lb, ub, z, y, dxs_t, dus_t, ks_t,
                        Qus_t)
                # TRUE stationarity at the current iterate: the Lagrangian
                # gradient in the reduced u-space with the multipliers
                # mu = rho*y (mim_solvers KKT criterion); sweep_with(0, y)
                # builds l + G^T mu, its Qu output is the reduced gradient
                Qus_kkt = qp.sweep_with(torch.zeros_like(z), y)[3]
                # OSQP-style per-scenario rho adaptation for the NEXT SQP
                # iteration
                if s.adaptive_rho:
                    ratio = torch.sqrt((rp_f + 1e-12) / (rd_f + 1e-12))
                    rho_next = torch.clamp(
                        rho_b * torch.clamp(ratio, 0.2, 5.0), 1e-4, 1e4)
                    rho_next = torch.where(torch.isfinite(rho_next), rho_next,
                                           rho_b)
                else:
                    rho_next = rho_b
            else:
                dxs_t, dus_t, ks_t, Qus_t = self.vector_sweep(
                    Ls, Ks, Vxx_next, Fx_t, Fu_t, lx_t, lu_t, rxT, fs_t)
                # unconstrained: Qu from the plain sweep IS the reduced
                # Lagrangian gradient
                Qus_kkt = Qus_t
                qp_n = torch.ones_like(iters)
                rho_next = rho_b

            step_bad = bad | ~(torch.isfinite(dxs_t).all(1).all(0)
                               & torch.isfinite(dus_t).all(1).all(0))
            dxs = torch.where(step_bad[None, :, None], 0.0, dxs_t.permute(0, 2, 1))
            dus = torch.where(step_bad[None, :, None], 0.0, dus_t.permute(0, 2, 1))

            # ---- filter line search (first-accept alpha ladder) ---------
            any_accept, xs_best, us_best, cost_best = self.line_search(
                x0s, xs, us, dxs, dus, refs, cost, gap_l1 + viol, viol_inf,
                converged | step_bad)
            any_accept = any_accept & ~step_bad

            # KKT at the current iterate (pre-step): Lagrangian
            # stationarity (ADMM duals included) + primal feasibility, the
            # mim_solvers criterion; a failed factorization keeps the
            # previous value
            kkt_raw = torch.maximum(Qus_kkt.abs().amax((0, 1)),
                                    torch.maximum(gap_inf, viol_inf))
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
            if self.trace:
                row = torch.where(live & (iters < s.max_iters), iters,
                                  s.max_iters).long()
                trace[:, row, b_idx] = torch.stack([cost, kkt_new, gap_inf])
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
            if nc > 0:
                # carry the MULTIPLIER mu = rho*y invariantly across the
                # rho adaptation: y is the scaled dual, so rescale
                y_carry = torch.where(live[None, None, :],
                                      y * (rho_b / rho_next)[None, None, :],
                                      y_carry)
            rho_b = torch.where(converged, rho_b, rho_next)
            converged = converged | conv_now

        # final feasibility report (node-parallel)
        _, fs = self.cost_and_gaps(x0s, xs, us, refs)
        gap_inf = fs.abs().amax((0, 2))
        cnorm = (_violation(*self.constraint_vals(xs, us, refs)).amax((0, 2))
                 if nc > 0 else torch.zeros_like(gap_inf))
        return BatchSQPSolution(
            xs=xs.transpose(0, 1), us=us.transpose(0, 1),
            K=Ks_d.transpose(0, 1), k=ks.transpose(0, 1), cost=cost,
            kkt=kkt, gap_norm=gap_inf, constraint_norm=cnorm,
            iters=iters, qp_iters=qp_total, converged=converged,
            # rescaled to the NEXT solve's initial rho, so the multiplier
            # mu = rho*y is what carries across solves
            y=(y_carry * (rho_b / float(s.rho))[None, None, :]).permute(2, 0, 1),
            **({} if not self.trace else dict(
                trace_cost=trace[0, :-1], trace_kkt=trace[1, :-1],
                trace_gap=trace[2, :-1])))


class _ADMM:
    """The QP of one constrained SQP iteration: OSQP-style ADMM over the
    cached Riccati factorisation (JAX `sqp_batch.py:617-756`).

    Each ADMM iteration is one linear vector sweep with the
    rho-augmented linear terms, a slack clip into the bounds and a scaled
    dual update. All tensors are batch-minor: lo/hi/z/y [T+1, nc, B]."""

    def __init__(self, solver, Ls, Ks, Vxx_next, Fx_t, Fu_t, lx_t, lu_t, rxT,
                 fs_t, Gx_t, Gu_t, rho_b, lo, hi):
        self.solver = solver
        self.factors = (Ls, Ks, Vxx_next, Fx_t, Fu_t)
        self.lx_t, self.lu_t, self.rxT, self.fs_t = lx_t, lu_t, rxT, fs_t
        self.Gx_t, self.Gu_t, self.rho = Gx_t, Gu_t, rho_b
        self.lo_t = lo.permute(0, 2, 1)
        self.hi_t = hi.permute(0, 2, 1)

    def cvals_t(self, dxs_t, dus_t):
        """Linearised constraint change G dx + G du, [T+1, nc, B]."""
        cx = (self.Gx_t * dxs_t[:, None, :, :]).sum(2)
        cu = (self.Gu_t[:-1] * dus_t[:, None, :, :]).sum(2)
        return cx + torch.cat([cu, torch.zeros_like(cu[:1])], 0)

    def sweep_with(self, z_t, y_t):
        """Vector sweep with the linear terms l + rho G^T (y - z)."""
        Gx_t, Gu_t = self.Gx_t, self.Gu_t
        yz = y_t - z_t  # [T+1, nc, B]
        rho3 = self.rho[None, None, :]
        rx_t = self.lx_t + rho3 * (Gx_t[:-1] * yz[:-1, :, None, :]).sum(1)
        ru_t = self.lu_t + rho3 * (Gu_t[:-1] * yz[:-1, :, None, :]).sum(1)
        rxT_q = self.rxT + self.rho[None, :] * (
            Gx_t[-1] * yz[-1, :, None, :]).sum(0)
        Ls, Ks, Vxx_next, Fx_t, Fu_t = self.factors
        return self.solver.vector_sweep(Ls, Ks, Vxx_next, Fx_t, Fu_t, rx_t,
                                        ru_t, rxT_q, self.fs_t)

    def solve(self, y0):
        """ADMM from the warm-started duals y0 until every scenario meets its
        primal and dual residual tolerance or `max_qp_iters` is spent.
        Returns (z, y, dxs_t, dus_t, ks_t, Qus_t, iterations [B], final
        primal and dual residuals [B])."""
        s = self.solver.settings
        lo_t, hi_t, rho = self.lo_t, self.hi_t, self.rho
        T, B = self.fs_t.shape[0] - 1, self.fs_t.shape[2]
        nx, nu = self.fs_t.shape[1], self.lu_t.shape[1]
        kw = dict(dtype=self.fs_t.dtype, device=self.fs_t.device)
        z = torch.clamp(torch.zeros_like(lo_t), lo_t, hi_t)
        y = y0
        dxs_t = torch.zeros((T + 1, nx, B), **kw)
        dus_t = torch.zeros((T, nu, B), **kw)
        ks_t = torch.zeros((T, nu, B), **kw)
        Qus_t = torch.zeros((T, nu, B), **kw)
        done = torch.zeros((B,), dtype=torch.bool, device=lo_t.device)
        n = torch.zeros((B,), dtype=torch.int32, device=lo_t.device)
        rp_f = torch.full((B,), float("inf"), **kw)
        rd_f = torch.full((B,), float("inf"), **kw)
        # every iteration advances at least one scenario, so the host count
        # of iterations is max(n), the JAX loop bound
        it = 0
        while it < s.max_qp_iters and not self.solver._all(done):
            it += 1
            self.solver.admm_iters += 1
            dxs2, dus2, ks2, Qus2 = self.sweep_with(z, y)
            c = self.cvals_t(dxs2, dus2)
            z2 = torch.clamp(c + y, lo_t, hi_t)
            y2 = y + c - z2
            rp = (c - z2).abs().amax((0, 1))  # [B]
            dz = z2 - z
            rd = rho * torch.maximum(
                (self.Gx_t * dz[:, :, None, :]).sum(1).abs().amax((0, 1)),
                (self.Gu_t * dz[:, :, None, :]).sum(1).abs().amax((0, 1)))
            tol = s.eps_abs + s.eps_rel * torch.clamp(
                z2.abs().amax((0, 1)), min=1.0)
            # scenarios already done keep their state
            keep = done[None, None, :]
            z = torch.where(keep, z, z2)
            y = torch.where(keep, y, y2)
            dxs_t = torch.where(keep, dxs_t, dxs2)
            dus_t = torch.where(keep, dus_t, dus2)
            ks_t = torch.where(keep, ks_t, ks2)
            Qus_t = torch.where(keep, Qus_t, Qus2)
            rp_f = torch.where(done, rp_f, rp)
            rd_f = torch.where(done, rd_f, rd)
            n = n + (~done).to(n.dtype)
            done = done | ((rp < tol) & (rd < tol))
        return z, y, dxs_t, dus_t, ks_t, Qus_t, n, rp_f, rd_f

    def second_order(self, xs, us, refs, g, lb, ub, z, y, dxs_t, dus_t, ks_t,
                     Qus_t):
        """Guarded second-order (Maratos) correction: re-evaluate the
        NONLINEAR constraints at the full step, shift the bounds by the
        curvature residual and run `soc_iters` more ADMM iterations; keep the
        corrected step per scenario only when its true violation is not
        worse (JAX :698-756)."""
        solver = self.solver
        step = lambda d_t: d_t.permute(0, 2, 1)
        g_try, _, _ = solver.constraint_vals(solver._sint(xs, step(dxs_t)),
                                             us + step(dus_t), refs)
        d_t = (g_try.permute(0, 2, 1) - g.permute(0, 2, 1)
               - self.cvals_t(dxs_t, dus_t))
        lo_soc, hi_soc = self.lo_t - d_t, self.hi_t - d_t
        soc = (z, y, dxs_t, dus_t, ks_t, Qus_t)
        for _ in range(solver.settings.soc_iters):
            z_s, y_s = soc[0], soc[1]
            dxs2, dus2, ks2, Qus2 = self.sweep_with(z_s, y_s)
            c = self.cvals_t(dxs2, dus2)
            z2 = torch.clamp(c + y_s, lo_soc, hi_soc)
            soc = (z2, y_s + c - z2, dxs2, dus2, ks2, Qus2)
        v_soc = _violation(*solver.constraint_vals(
            solver._sint(xs, step(soc[2])), us + step(soc[3]),
            refs)).amax((0, 2))
        v_try = _violation(g_try, lb, ub).amax((0, 2))
        take = (v_soc <= v_try)[None, None, :]
        return tuple(torch.where(take, a, b) for a, b in zip(
            soc, (z, y, dxs_t, dus_t, ks_t, Qus_t)))

def make_batch_sqp(model: RobotModel, params: ModelParams, spec: ProblemSpec,
                   settings: CSQPSettings = CSQPSettings(),
                   device: torch.device | str = DEFAULT_DEVICE,
                   backend: str = "auto", cf=None,
                   trace: bool = False) -> BatchSQP:
    """Build the batch SQP solver for `device` (see `BatchSQP`; `backend`
    "auto" or "xla"). The costs and constraint rows come from `spec`,
    unless `cf` is cost functions with a Lie-group state
    (`ocp.ff_costs.build_ff_cost_functions`): then the backend is
    "manifold" and everything comes from `cf`. `trace=True` fills the
    solution's `trace_cost`, `trace_kkt` and `trace_gap`; the loop runs on
    the host, so without it nothing is recorded."""
    return BatchSQP(model, params, spec, settings, device, backend, cf, trace)
