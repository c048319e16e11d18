"""Cost functions on the quaternion free-flyer state (tangent-space
Gauss-Newton).

Port of the JAX package's `ocp/ff_costs.py`. `build_ff_cost_functions`
builds cost functions whose derivative blocks live in the TANGENT space of
the SE(3) x R^n state (`ops/lie.py`), the structure the reference gets from
`crocoddyl.StateMultibody` over a pinocchio free-flyer model: residuals and
dynamics are differentiated through `integrate`, so the solvers' Riccati
sweeps, gaps and gains run on ntan = nv + nv coordinates while the
configurations stay on the manifold (unit quaternion, no euler
singularity).

Cost kinds: `FF_COST_KINDS`; constraint kinds: `FF_CONSTRAINT_KINDS` (box
semantics of `ocp/costs.py`). With soft contact (`spec.soft_contact`) the
state is force-augmented, [p; quat; qj; v; f], with ntan = 2 nv + nc.
Refs keys: `xref [T+1, nq+nv]`, `w_x [T+1, ntan]`, `w_u [T+1, nu]`,
`w_coll [T+1]`, `ee_rot:/ee_trans:/w_ee:/ee_vel:/w_ee_vel:<frame>` as in
`ocp/costs.py`, `f_des`, `w_force`, `contact_active` with soft contact.

Actuation (`actuation=`): "floating_base" (the default) is the reference's
`ActuationModelFloatingBase`: nu = nv - 6, the base is unactuated and the
control maps to [0_6; u]; "full" actuates all nv DoFs.

`FFCostFunctions` has the single-node functions of the JAX tuple and the
batched forms of `ocp.costs.CostFunctions` (`step_b`, `stage_derivs_b`,
`value`, `term_value`, `term_pack`), and its constraint side
(`constraint_functions`) the batched interface of
`ocp.costs.ConstraintFunctions`. The Jacobians come from `torch.func.
jacrev` where the JAX package takes `jax.jacfwd` (`ocp/costs.py`'s
docstring says why). XLA in the JAX package, plain PyTorch here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.model import ModelParams, RobotModel
from ..ops import dynamics as dyn
from ..ops import lie, residuals, spatial
from ..ops.soft_contact import ff_soft_contact_step
from .costs import StageDerivs, TerminalDerivs, _item_keys
from .spec import ProblemSpec

FF_COST_KINDS = (
    "state", "control", "control_grav", "frame_placement",
    "frame_translation", "frame_rotation", "frame_velocity",
    "collision_distance", "visual_servoing", "force_tracking",
)
FF_CONSTRAINT_KINDS = ("control_limit", "collision_distance", "force_box")


def _per_node(key: str, val: torch.Tensor) -> bool:
    """Whether a refs entry holds one row per node time (the vision
    transform may be streamed per node, [T+1, 3, 3], or held constant)."""
    if key.startswith("wMo_rot"):
        return val.ndim == 3
    if key.startswith("wMo_trans"):
        return val.ndim == 2
    return True


def _node_refs(refs: Dict, t, keys):
    """The refs `keys` at node time t (an int, or an [N] tensor of node
    times)."""
    out = {}
    for k in keys:
        v = refs[k]
        if not _per_node(k, v):
            out[k] = v
        elif isinstance(t, torch.Tensor) and t.ndim == 1:
            out[k] = v.index_select(0, t)
        else:
            out[k] = v[t]
    return out


class FFCostFunctions:
    """The free-flyer spec's costs, dynamics and constraints (see the module
    docstring); refs are sliced at a node before the per-node bodies run."""

    def __init__(self, model: RobotModel, params: ModelParams,
                 spec: ProblemSpec, dtype: torch.dtype = torch.float32,
                 actuation: str = "floating_base"):
        for item in spec.all_costs():
            if item.kind not in FF_COST_KINDS:
                raise NotImplementedError(
                    f"free-flyer cost kind {item.kind!r} not supported yet")
        for c in spec.constraints:
            if c.kind not in FF_CONSTRAINT_KINDS:
                raise NotImplementedError(
                    f"free-flyer constraint kind {c.kind!r} not supported yet")
        if actuation not in ("floating_base", "full"):
            raise ValueError(actuation)
        self.model, self.params, self.spec = model, params, spec
        self._timesteps = torch.as_tensor(np.append(spec.timesteps(), 0.0),
                                          dtype=dtype)
        self._ts = {}
        nv = model.nj
        self.nv = nv
        self.under = actuation == "floating_base"
        self.nu = nv - lie.N_FF if self.under else nv
        self.sc = spec.soft_contact
        self.nf = self.sc.nc if self.sc is not None else 0
        self.nxr = lie.ff_dims(model)[2]  # rigid (quaternion) ambient dim
        self.ntan_r = 2 * nv
        self.ntan = self.ntan_r + self.nf
        self._sdiff_r = lie.state_difference(model)
        self._sint_r = lie.state_integrate(model)
        self.running = tuple(i for i in spec.running_costs if i.active)
        self.terminal = tuple(i for i in spec.terminal_costs if i.active)
        # the refs the items and the step read
        items = self.running + self.terminal
        keys = [k for i in items for k in _item_keys(i)]
        # every frame kind reads the rotation target (as the JAX package's)
        keys += [f"ee_rot:{i.frame}" for i in items if i.kind in (
            "frame_placement", "frame_translation", "frame_rotation",
            "visual_servoing")]
        keys += [f"{pre}:{i.object_frame}" for i in items
                 if i.kind == "visual_servoing"
                 for pre in ("wMo_rot", "wMo_trans")]
        if self.sc is not None:
            keys.append("contact_active")
        self._keys = tuple(dict.fromkeys(keys))
        self._con = FFConstraintFunctions(self)
        self.n_constraints = self._con.n_constraints
        self.terminal_constraint_mask = self._con.terminal_constraint_mask
        self.terminal_constraint_row_mask = (
            self._con.terminal_constraint_row_mask)

    # -- the state manifold -----------------------------------------------
    def state_diff(self, x1, x0):
        """Tangent difference x1 (-) x0, [ntan]."""
        if self.sc is None:
            return self._sdiff_r(x1, x0)
        n = self.nxr
        return torch.cat([self._sdiff_r(x1[:n], x0[:n]), x1[n:] - x0[n:]])

    def state_integrate(self, x, dx):
        """Retraction x (+) dx of a tangent increment dx [ntan]."""
        if self.sc is None:
            return self._sint_r(x, dx)
        n = self.nxr
        return torch.cat([self._sint_r(x[:n], dx[:self.ntan_r]),
                          x[n:] + dx[self.ntan_r:]])

    # -- per-node bodies (refs sliced at the node) --------------------------
    def _dt(self, t, x):
        key = (x.dtype, x.device)
        if key not in self._ts:
            self._ts[key] = self._timesteps.to(device=x.device, dtype=x.dtype)
        return self._ts[key][t]

    def _tau_full(self, u):
        """Actuation map: the floating base takes no direct wrench
        (`ActuationModelFloatingBase`)."""
        if self.under:
            return torch.cat([u.new_zeros(lie.N_FF), u])
        return u

    def _step(self, x, u, dt, rt):
        if self.sc is not None:
            return ff_soft_contact_step(self.model, self.params, self.sc, x,
                                        self._tau_full(u), dt,
                                        rt["contact_active"])
        return lie.ff_step(self.model, self.params, x, self._tau_full(u), dt)

    def _chart(self, xp):
        """(recentered params, chart q, v) at a global state (a force tail
        is ignored)."""
        p, quat, qj, v = lie.split_state(self.model, xp[:self.nxr])
        pr = lie.recenter_params(self.model, self.params, p, quat)
        return pr, lie.chart_q(self.model, qj), v

    def _grav_tau(self, xp):
        pr, qc, _ = self._chart(xp)
        z = xp.new_zeros(self.nv)
        return dyn.rnea(self.model, pr, qc, z, z)

    def _residuals(self, items, x, u, rt):
        """(weight, residual fn of the tangent increment, weights [nr],
        "x" | "u" | "both") of each item (JAX `_residuals`)."""
        model, nu, sint = self.model, self.nu, self.state_integrate
        ones = lambda n: x.new_ones(n)
        out = []
        for item in items:
            kind, frame = item.kind, item.frame
            if kind == "state":
                xref = rt["xref"]
                w = rt["w_x"] if item.update else ones(self.ntan)
                out.append((item.weight, lambda dx, xref=xref: self.state_diff(
                    sint(x, dx), xref), w, "x"))
            elif kind == "control":
                uref = rt["uref"][-nu:] if item.update else x.new_zeros(nu)
                w = rt["w_u"][-nu:] if item.update else ones(nu)
                out.append((item.weight, lambda du, uref=uref: (u + du) - uref,
                            w, "u"))
            elif kind == "control_grav":
                # r(x, u) = u - the actuated part of the gravity torque
                # (`ResidualModelControlGrav`): lx and lxu blocks too
                w = rt["w_u"][-nu:] if item.update else ones(nu)
                out.append((item.weight, lambda dx, du: (u + du) - self._grav_tau(
                    sint(x, dx))[-nu:], w, "both"))
            elif kind == "collision_distance":
                wgt = item.weight * (rt["w_coll"] if item.update else 1.0)

                def r_coll(dx, pair=item.pair_id):
                    pr, qc, v = self._chart(sint(x, dx))
                    return residuals.collision_distance_residual(
                        model, pr, torch.cat([qc, v]), pair)

                out.append((wgt, r_coll, ones(1), "x"))
            elif kind == "force_tracking":
                # r = f - f_des on the augmented tail (reference
                # `dam.f_des/f_weight`)
                fdes = rt["f_des"]
                w = rt["w_force"] if item.update else ones(self.nf)
                out.append((item.weight, lambda dx, fdes=fdes: sint(
                    x, dx)[self.nxr:] - fdes, w, "x"))
            elif kind == "frame_velocity":
                fid = model.frame_id(frame)
                vref = rt[f"ee_vel:{frame}"]
                w = rt[f"w_ee_vel:{frame}"] if item.update else ones(6)

                def r_fv(dx, fid=fid, vref=vref, rf=item.reference_frame):
                    pr, qc, v = self._chart(sint(x, dx))
                    return residuals.frame_velocity_residual(
                        model, pr, torch.cat([qc, v]), fid, vref, rf)

                out.append((item.weight, r_fv, w, "x"))
            else:  # frame placement / translation / rotation / servoing
                fid = model.frame_id(frame)
                refR, refp = rt[f"ee_rot:{frame}"], rt[f"ee_trans:{frame}"]
                if kind == "visual_servoing":
                    # the composed target wMf = wMo_vision * oMf_ref, then a
                    # frame-placement residual on the manifold state
                    obj = item.object_frame
                    refR, refp = spatial.se3_mul(
                        (rt[f"wMo_rot:{obj}"], rt[f"wMo_trans:{obj}"]),
                        (refR, refp))
                    kind = "frame_placement"
                if item.update:
                    w6 = rt[f"w_ee:{frame}"]
                    w = {"frame_placement": w6, "frame_rotation": w6[:3],
                         "frame_translation": w6[3:]}[kind]
                else:
                    w = ones({"frame_placement": 6, "frame_translation": 3,
                              "frame_rotation": 3}[kind])

                def r_fp(dx, fid=fid, refR=refR, refp=refp, kind=kind):
                    R, p = lie.ff_frame_placement(model, self.params,
                                                  sint(x, dx), fid)
                    if kind == "frame_translation":
                        return p - refp
                    dR = refR.T @ R
                    if kind == "frame_rotation":
                        return spatial.log3(dR)
                    return spatial.log6(dR, refR.T @ (p - refp))

                out.append((item.weight, r_fp, w, "x"))
        return out

    def _cost_value(self, items, x, u, rt):
        total = x.new_zeros(())
        zx, zu = x.new_zeros(self.ntan), x.new_zeros(self.nu)
        for wgt, rfn, w, dep in self._residuals(items, x, u, rt):
            r = rfn(zx, zu) if dep == "both" else rfn(zu if dep == "u" else zx)
            total = total + wgt * 0.5 * torch.sum(w * r * r)
        return total

    def _gn_blocks(self, items, x, u, rt):
        """Gauss-Newton (l, lx, lu, lxx, lxu, luu) in tangent coordinates."""
        nt, nu = self.ntan, self.nu
        l = x.new_zeros(())
        lx, lu = x.new_zeros(nt), x.new_zeros(nu)
        lxx, lxu, luu = (x.new_zeros((nt, nt)), x.new_zeros((nt, nu)),
                         x.new_zeros((nu, nu)))
        zx, zu = x.new_zeros(nt), x.new_zeros(nu)
        for wgt, rfn, w, dep in self._residuals(items, x, u, rt):
            aux = lambda *a, rfn=rfn: (lambda r: (r, r))(rfn(*a))
            if dep == "both":
                (Jx, Ju), r = torch.func.jacrev(aux, argnums=(0, 1),
                                                has_aux=True)(zx, zu)
                wr, JxW = w * r, Jx.T * (w * wgt)
                l = l + wgt * 0.5 * torch.sum(w * r * r)
                lx = lx + Jx.T @ wr * wgt
                lu = lu + Ju.T @ wr * wgt
                lxx = lxx + JxW @ Jx
                lxu = lxu + JxW @ Ju
                luu = luu + (Ju.T * (w * wgt)) @ Ju
                continue
            J, r = torch.func.jacrev(aux, has_aux=True)(zu if dep == "u"
                                                        else zx)
            g = J.T @ (w * r) * wgt
            H = (J.T * (w * wgt)) @ J
            l = l + wgt * 0.5 * torch.sum(w * r * r)
            if dep == "u":
                lu, luu = lu + g, luu + H
            else:
                lx, lxx = lx + g, lxx + H
        return l, lx, lu, lxx, lxu, luu

    def _stage_derivs(self, x, u, rt, dt):
        l, lx, lu, lxx, lxu, luu = self._gn_blocks(self.running, x, u, rt)
        xnext = self._step(x, u, dt, rt)
        nt = self.ntan

        def dstep(dxu):
            d = self.state_diff(self._step(self.state_integrate(
                x, dxu[:nt]), u + dxu[nt:], dt, rt), xnext)
            return d, d

        Fxu, _ = torch.func.jacrev(dstep, has_aux=True)(
            x.new_zeros(nt + self.nu))
        return StageDerivs(dt * l, dt * lx, dt * lu, dt * lxx, dt * lxu,
                           dt * luu, xnext, Fxu[:, :nt], Fxu[:, nt:])

    def _terminal_derivs(self, x, rt):
        l, lx, _, lxx, _, _ = self._gn_blocks(self.terminal, x,
                                              x.new_zeros(self.nu), rt)
        return TerminalDerivs(l, lx, lxx)

    # -- single node (the JAX package's functions) ---------------------------
    def _at(self, refs, t):
        return _node_refs(refs, t, self._keys)

    def step(self, x, u, t, refs):
        return self._step(x, u, self._dt(t, x), self._at(refs, t))

    def stage_cost(self, x, u, t, refs):
        return self._dt(t, x) * self._cost_value(self.running, x, u,
                                                 self._at(refs, t))

    def terminal_cost(self, x, refs):
        return self._cost_value(self.terminal, x, x.new_zeros(self.nu),
                                self._at(refs, self.spec.horizon))

    def stage_derivs(self, x, u, t, refs) -> StageDerivs:
        return self._stage_derivs(x, u, self._at(refs, t), self._dt(t, x))

    def terminal_derivs(self, x, refs) -> TerminalDerivs:
        return self._terminal_derivs(x, self._at(refs, self.spec.horizon))

    def constraints(self, x, u, t, refs):
        """(g, lb, ub) [nc] at one node, or None without constraints."""
        if not self.n_constraints:
            return None
        t_idx = torch.as_tensor([t], device=x.device).reshape(1)
        return tuple(a[0] for a in self._con.constraints(
            x[None], u[None], t_idx, refs))

    def constraint_derivs(self, x, u, t, refs):
        """(g, lb, ub, Gx [nc, ntan], Gu [nc, nu]) at one node, or None."""
        if not self.n_constraints:
            return None
        t_idx = torch.as_tensor([t], device=x.device).reshape(1)
        return tuple(a[0] for a in self._con.constraint_derivs(
            x[None], u[None], t_idx, refs))

    @property
    def constraint_functions(self):
        """The batched constraint side (`FFConstraintFunctions`)."""
        return self._con

    # -- batched over nodes (x [N, nx], u [N, nu], t an int or [N]) -----------
    def _map(self, fn, x, u, t, refs):
        N = x.shape[0]
        if not (isinstance(t, torch.Tensor) and t.ndim == 1):
            t = torch.full((N,), int(t), dtype=torch.long, device=x.device)
        sel = {k: refs[k] for k in self._keys}
        glob = {k: v for k, v in sel.items() if not _per_node(k, v)}
        rows = {k: v.index_select(0, t) for k, v in sel.items()
                if _per_node(k, v)}
        return torch.func.vmap(
            lambda x1, u1, r1, d1: fn(x1, u1, {**r1, **glob}, d1))(
                x, u, rows, self._dt(t, x))

    def step_b(self, x, u, t, refs):
        return self._map(lambda x1, u1, rt, dt: self._step(x1, u1, dt, rt),
                         x, u, t, refs)

    def stage_derivs_b(self, x, u, t, refs) -> StageDerivs:
        return StageDerivs(*self._map(self._stage_derivs, x, u, t, refs))

    def value(self, x, u, t, refs):
        return self._map(lambda x1, u1, rt, dt: dt * self._cost_value(
            self.running, x1, u1, rt), x, u, t, refs)

    def term_pack(self, x, refs):
        """`terminal_derivs` of N nodes: (l, lx, lxx), [N, ...]."""
        u0 = x.new_zeros((x.shape[0], self.nu))
        return tuple(self._map(lambda x1, u1, rt, dt: self._terminal_derivs(
            x1, rt), x, u0, self.spec.horizon, refs))

    def term_value(self, x, refs):
        u0 = x.new_zeros((x.shape[0], self.nu))
        return self._map(lambda x1, u1, rt, dt: self._cost_value(
            self.terminal, x1, u1, rt), x, u0, self.spec.horizon, refs)


class FFConstraintFunctions:
    """The free-flyer spec's constraint rows with tangent-space Jacobians,
    batched over nodes with the interface of `ocp.costs.
    ConstraintFunctions` (JAX `ff_costs.py` constraints)."""

    def __init__(self, cf: FFCostFunctions):
        self.cf = cf
        self.items = tuple(cf.spec.constraints)
        dims = [self._dim(c) for c in self.items]
        self.n_constraints = sum(dims)
        self.terminal_constraint_mask = tuple(c.terminal for c in self.items)
        self.terminal_constraint_row_mask = tuple(
            flag for c, n in zip(self.items, dims) for flag in [c.terminal] * n)

    def _dim(self, c):
        return {"control_limit": self.cf.nu,
                "force_box": self.cf.nf}.get(c.kind, 1)

    def _bounds(self, c, dtype, device):
        cf, nr = self.cf, self._dim(c)
        kw = dict(dtype=dtype, device=device)
        full = lambda v: torch.full((nr,), v, **kw)
        if c.kind == "control_limit":
            lim = cf.params.effort_limit.to(**kw)[-cf.nu:]
            return -lim, lim
        if c.kind == "force_box":
            # the IAMSoftContactAugmented force bounds
            sc = cf.sc
            lo = (torch.as_tensor(c.lower, **kw) if c.lower
                  else torch.as_tensor(sc.force_lb, **kw) if sc.force_lb
                  else full(float("-inf")))
            hi = (torch.as_tensor(c.upper, **kw) if c.upper
                  else torch.as_tensor(sc.force_ub, **kw) if sc.force_ub
                  else full(float("inf")))
            return lo.expand(nr), hi.expand(nr)
        lo = torch.as_tensor(c.lower, **kw) if c.lower else full(float("-inf"))
        hi = torch.as_tensor(c.upper, **kw) if c.upper else full(float("inf"))
        return lo.expand(nr), hi.expand(nr)

    def bounds(self, dtype, device):
        lohi = [self._bounds(c, dtype, device) for c in self.items]
        return (torch.cat([lo for lo, _ in lohi]),
                torch.cat([hi for _, hi in lohi]))

    def _g(self, x, u, dx, du):
        cf, out = self.cf, []
        for c in self.items:
            if c.kind == "control_limit":
                out.append(u + du)
            elif c.kind == "force_box":
                out.append(cf.state_integrate(x, dx)[cf.nxr:])
            else:
                pr, qc, v = cf._chart(cf.state_integrate(x, dx))
                out.append(residuals.collision_distance_residual(
                    cf.model, pr, torch.cat([qc, v]), c.pair_id))
        return torch.cat([torch.atleast_1d(g) for g in out])

    def constraints(self, x, u, t_idx, refs):
        """(g, lb, ub), each [N, nc]."""
        zx, zu = x.new_zeros(self.cf.ntan), x.new_zeros(self.cf.nu)
        g = torch.func.vmap(lambda x1, u1: self._g(x1, u1, zx, zu))(x, u)
        lb, ub = self.bounds(x.dtype, x.device)
        return g, lb.expand_as(g), ub.expand_as(g)

    def constraint_derivs(self, x, u, t_idx, refs):
        """(g, lb, ub, Gx [N, nc, ntan], Gu [N, nc, nu])."""
        zx, zu = x.new_zeros(self.cf.ntan), x.new_zeros(self.cf.nu)

        def with_aux(dx, du, x1, u1):
            g = self._g(x1, u1, dx, du)
            return g, g

        (Gx, Gu), g = torch.func.vmap(
            lambda x1, u1: torch.func.jacrev(with_aux, argnums=(0, 1),
                                             has_aux=True)(zx, zu, x1, u1))(
                x, u)
        lb, ub = self.bounds(x.dtype, x.device)
        return g, lb.expand_as(g), ub.expand_as(g), Gx, Gu


def build_ff_cost_functions(model: RobotModel, params: ModelParams,
                            spec: ProblemSpec,
                            dtype: torch.dtype = torch.float32,
                            actuation: str = "floating_base"
                            ) -> FFCostFunctions:
    """The free-flyer spec's `FFCostFunctions` (JAX
    `build_ff_cost_functions`)."""
    return FFCostFunctions(model, params, spec, dtype, actuation)
