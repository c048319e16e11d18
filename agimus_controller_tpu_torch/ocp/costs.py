"""Cost and constraint assembly: a ProblemSpec compiled into functions.

Port of the JAX package's `ocp/costs.py` (the reference's Crocoddyl
`CostModelSum` + `DifferentialActionModelFreeFwdDynamics` +
`IntegratedActionModelEuler` + `ConstraintModelManager` object graph,
`ocp/ocp_croco_generic.py:560-762`):

    step(x, u, t, refs)            -> x_next           (semi-implicit Euler)
    stage_cost(x, u, t, refs)      -> dt_t * l(x, u)   (running node)
    terminal_cost(x, refs)         -> l(x)             (unscaled)
    cost_derivs / stage_derivs / terminal_derivs -> Gauss-Newton packs
    constraints(x, u, t, refs)     -> (g, lb, ub) and their Jacobians

`CostFunctions` holds the single-node functions of the JAX `CostFunctions`
and their forms batched over nodes (`torch.func.vmap`): `step_b`,
`stage_derivs_b`, and `pack`/`term_pack`/`value`/`term_value` with the
interface of `ops.batched_costs.BatchedCostPack`, so a solver takes either.
The batched forms take x [N, nx], u [N, nu] and a node time t, an int or an
[N] tensor of node times.

Derivatives: the residual Jacobians and Fx/Fu come from `torch.func.jacrev`
(the JAX package takes `jax.jacfwd`; the Jacobians are the same).
PyTorch's forward mode is not an option in float32: the tangent of a 0-dim
tensor divided by a Python scalar comes out in float64 (torch 2.13), which
breaks the next matrix product. The activation derivatives are analytic and
the Hessians Gauss-Newton, J^T diag(a'') J, as in Crocoddyl. The state is
the vector [q; v], or with soft contact (`spec.soft_contact`) the
force-augmented [q; v; f] of `ops/soft_contact.py`: the step is the
soft-contact step with the per-node activation `refs["contact_active"]`,
the `force_tracking` cost and the `force_box` constraint read the force
part. The quaternion free-flyer state (`ntan`, `state_diff`,
`state_integrate`) is `ocp/ff_costs.py`'s. In the JAX package this is XLA,
not a Pallas kernel, so it stays plain PyTorch here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..models.model import ModelParams, RobotModel
from ..ops import activations as act
from ..ops import integrator, residuals
from ..ops.soft_contact import soft_contact_step
from .spec import ConstraintItem, CostItem, ProblemSpec, slice_refs

# refs that hold one value for the whole horizon (`slice_refs`)
_GLOBAL_PREFIXES = ("wMo_", "geom_")
# residual kinds a constraint may take; force_box bounds the force part of
# a soft-contact state
CONSTRAINT_KINDS = ("control_limit", "state", "control", "control_grav",
                    "frame_placement", "frame_translation", "frame_rotation",
                    "frame_velocity", "visual_servoing", "collision_distance",
                    "force_box")


def _is_global(key: str) -> bool:
    return key.startswith(_GLOBAL_PREFIXES)


def _item_keys(item) -> Tuple[str, ...]:
    """The per-node refs an item's residual and weights may read."""
    f = item.frame
    keys = {"state": ("xref", "w_x"), "control": ("uref", "w_u"),
            "control_grav": ("w_u",),
            "frame_placement": (f"ee_rot:{f}", f"ee_trans:{f}", f"w_ee:{f}"),
            "frame_translation": (f"ee_trans:{f}", f"w_ee:{f}"),
            "frame_rotation": (f"ee_rot:{f}", f"w_ee:{f}"),
            "frame_velocity": (f"ee_vel:{f}", f"w_ee_vel:{f}"),
            "visual_servoing": (f"ee_rot:{f}", f"ee_trans:{f}", f"w_ee:{f}"),
            "collision_distance": ("w_coll",),
            "force_tracking": ("f_des", "w_force")}
    return keys.get(item.kind, ())


def _override_geoms(params: ModelParams, refs: Dict) -> ModelParams:
    """Moving obstacles: refs may carry full geometry placement overrides
    (the reference's `update_geometry_placement`)."""
    if "geom_rot" in refs:
        params = params._replace(geom_rot=refs["geom_rot"])
    if "geom_trans" in refs:
        params = params._replace(geom_trans=refs["geom_trans"])
    return params


def _item_residual(item, model: RobotModel, params: ModelParams, x, u,
                   rt: Dict):
    """Residual of one cost item (or constraint item taken as a cost item
    without references of its own) at one node; refs pre-sliced."""
    kind = item.kind
    if kind in ("state", "control"):
        y = x if kind == "state" else u
        key = "xref" if kind == "state" else "uref"
        if getattr(item, "update", False):
            ref = rt[key]
        elif getattr(item, "static_ref", None):
            ref = torch.as_tensor(item.static_ref, dtype=x.dtype,
                                  device=x.device)
        else:
            ref = torch.zeros_like(y)
        return (residuals.state_residual(model, x, ref) if kind == "state"
                else residuals.control_residual(u, ref))
    if kind == "control_grav":
        return residuals.control_grav_residual(model, params, x, u)
    if kind == "collision_distance":
        return residuals.collision_distance_residual(model, params, x,
                                                     item.pair_id)
    if kind == "force_tracking":
        # the force part of a soft-contact state against f_des (reference
        # `dam.f_des/f_weight`)
        return x[model.nx:] - rt["f_des"]
    fid = model.frame_id(item.frame)
    f = item.frame
    if kind == "frame_placement":
        return residuals.frame_placement_residual(
            model, params, x, fid, rt[f"ee_rot:{f}"], rt[f"ee_trans:{f}"])
    if kind == "frame_translation":
        return residuals.frame_translation_residual(
            model, params, x, fid, rt[f"ee_trans:{f}"])
    if kind == "frame_rotation":
        return residuals.frame_rotation_residual(
            model, params, x, fid, rt[f"ee_rot:{f}"])
    if kind == "frame_velocity":
        return residuals.frame_velocity_residual(
            model, params, x, fid, rt[f"ee_vel:{f}"], item.reference_frame)
    if kind == "visual_servoing":
        # a constraint item has no object frame: it reads `wMo_*:None`, as
        # the JAX package's constraint does
        obj = getattr(item, "object_frame", None)
        return residuals.visual_servoing_residual(
            model, params, x, fid, rt[f"wMo_rot:{obj}"],
            rt[f"wMo_trans:{obj}"], rt[f"ee_rot:{f}"], rt[f"ee_trans:{f}"])
    raise ValueError(kind)


def _item_act_weights(item: CostItem, model: RobotModel, rt: Dict, x,
                      nc: int = 0):
    """Activation weight vector of an item at one node (nc: the contact
    force's dimension of a soft-contact state)."""
    nr = item.residual_dim(model, nc)
    if item.update:
        kind, f = item.kind, item.frame
        if kind == "state":
            return rt["w_x"]
        if kind == "force_tracking":
            return rt["w_force"]
        if kind in ("control", "control_grav"):
            return rt["w_u"]
        if kind in ("frame_placement", "visual_servoing"):
            return rt[f"w_ee:{f}"]
        if kind == "frame_rotation":
            return rt[f"w_ee:{f}"][:3]
        if kind == "frame_translation":
            return rt[f"w_ee:{f}"][3:]
        if kind == "frame_velocity":
            return rt[f"w_ee_vel:{f}"]
    if item.act_weights is not None:
        w = torch.as_tensor(item.act_weights, dtype=x.dtype, device=x.device)
        return w.expand(nr) if w.ndim == 0 or w.shape[0] != nr else w
    return x.new_ones(nr)


def _item_weight(item: CostItem, rt: Dict):
    """Scalar cost weight; collision items scale by the streamed
    `w_coll` when updated."""
    if item.kind == "collision_distance" and item.update:
        return item.weight * rt["w_coll"]
    return item.weight


def _item_activation(item: CostItem):
    """(value, dr, drr) of the item's activation, as functions of (r, w)."""
    if item.activation == "weighted_quad":
        return act.weighted_quad_value, act.weighted_quad_dr, act.weighted_quad_drr
    a = item.act_alpha
    fns = ((act.exp_value, act.exp_dr, act.exp_drr)
           if item.activation == "exp" else
           (act.quad_exp_value, act.quad_exp_dr, act.quad_exp_drr))
    return tuple((lambda fn: lambda r, w: fn(r, w, a))(fn) for fn in fns)


class StageDerivs(NamedTuple):
    cost: torch.Tensor
    lx: torch.Tensor
    lu: torch.Tensor
    lxx: torch.Tensor
    lxu: torch.Tensor
    luu: torch.Tensor
    xnext: torch.Tensor
    Fx: torch.Tensor
    Fu: torch.Tensor


class TerminalDerivs(NamedTuple):
    cost: torch.Tensor
    lx: torch.Tensor
    lxx: torch.Tensor


class ConstraintFunctions:
    """The constraint rows of a spec, stacked in item order (JAX
    `ocp/costs.py:298-358`; the reference's `ConstraintModelManager` over
    `ConstraintModelResidual` / `ConstraintModelControlLimit`).

    The JAX functions are single-node and the solver vmaps them; here every
    call takes all its nodes at once: x [N, nx], u [N, nu], node times
    t_idx [N]. Per-node references are gathered at t_idx; the global ones
    (`wMo_*`, the geometry overrides `geom_rot`/`geom_trans`) pass through.
    The Jacobians Gx/Gu come from `torch.func.jacrev` under `vmap`."""

    def __init__(self, model: RobotModel, params: ModelParams,
                 spec: ProblemSpec):
        for c in spec.constraints:
            if c.kind not in CONSTRAINT_KINDS:
                raise ValueError(f"constraint kind {c.kind!r}")
        self.model, self.params = model, params
        self.sc, self.nc = spec.soft_contact, spec.nc
        self.items: Tuple[ConstraintItem, ...] = tuple(spec.constraints)
        self.n_constraints = sum(c.residual_dim(model, self.nc)
                                 for c in self.items)
        self.terminal_constraint_mask = tuple(c.terminal for c in self.items)
        self.terminal_constraint_row_mask = tuple(
            flag for c in self.items
            for flag in [c.terminal] * c.residual_dim(model, self.nc))
        # per-node refs the residuals read (the weights are costs' only)
        self._node_keys = tuple(dict.fromkeys(
            k for c in self.items for k in _item_keys(c)
            if not k.startswith(("w_", "xref", "uref"))))

    # ------------------------------------------------------------------
    def _bounds(self, c: ConstraintItem, dtype, device):
        nr = c.residual_dim(self.model, self.nc)
        kw = dict(dtype=dtype, device=device)
        if c.kind == "control_limit":
            # default +-effortLimit (ConstraintModelControlLimit); explicit
            # lower/upper override the box
            lim = self.params.effort_limit.to(**kw)
            lo = (torch.as_tensor(c.lower, **kw).expand(nr) if c.lower
                  else -lim)
            hi = torch.as_tensor(c.upper, **kw).expand(nr) if c.upper else lim
            return lo, hi
        sc = self.sc
        if c.kind == "force_box" and not c.lower and not c.upper and \
                sc is not None:
            # the IAMSoftContactAugmented force bounds
            # (`ocp_croco_generic_force_feedback.py:191-215`)
            lo = (torch.as_tensor(sc.force_lb, **kw) if sc.force_lb
                  else torch.full((nr,), float("-inf"), **kw))
            hi = (torch.as_tensor(sc.force_ub, **kw) if sc.force_ub
                  else torch.full((nr,), float("inf"), **kw))
            return lo.expand(nr), hi.expand(nr)
        lo = (torch.as_tensor(c.lower, **kw) if c.lower
              else torch.full((nr,), float("-inf"), **kw))
        hi = (torch.as_tensor(c.upper, **kw) if c.upper
              else torch.full((nr,), float("inf"), **kw))
        return lo.expand(nr), hi.expand(nr)

    def bounds(self, dtype, device):
        """(lb [nc], ub [nc])."""
        lohi = [self._bounds(c, dtype, device) for c in self.items]
        return (torch.cat([lo for lo, _ in lohi]),
                torch.cat([hi for _, hi in lohi]))

    def _con_residual(self, c: ConstraintItem, params, x, u, rt):
        """One item's rows at one node (single-sample)."""
        if c.kind == "control_limit":
            return u
        if c.kind == "force_box":
            return x[self.model.nx:]
        return _item_residual(c, self.model, params, x, u, rt)

    def _g_fn(self, refs: Dict):
        """Single-node g(x, u, rt) with the refs' global entries."""
        params = _override_geoms(self.params, refs)
        glob = {k: v for k, v in refs.items() if _is_global(k)}

        def g(x, u, rt):
            rt = {**rt, **glob}
            return torch.cat([torch.atleast_1d(self._con_residual(
                c, params, x, u, rt)) for c in self.items])
        return g

    def _node_refs(self, refs: Dict, t_idx: torch.Tensor):
        return {k: refs[k].index_select(0, t_idx) for k in self._node_keys}

    # ------------------------------------------------------------------
    def constraints(self, x, u, t_idx, refs):
        """(g, lb, ub), each [N, nc], at nodes x [N,nx], u [N,nu], t_idx [N]."""
        g = torch.func.vmap(self._g_fn(refs))(x, u, self._node_refs(refs, t_idx))
        lb, ub = self.bounds(x.dtype, x.device)
        return g, lb.expand_as(g), ub.expand_as(g)

    def constraint_derivs(self, x, u, t_idx, refs):
        """(g, lb, ub, Gx [N,nc,nx], Gu [N,nc,nu])."""
        g_of = self._g_fn(refs)

        def with_aux(x1, u1, rt):
            g = g_of(x1, u1, rt)
            return g, g

        (Gx, Gu), g = torch.func.vmap(torch.func.jacrev(
            with_aux, argnums=(0, 1), has_aux=True))(
                x, u, self._node_refs(refs, t_idx))
        lb, ub = self.bounds(x.dtype, x.device)
        return g, lb.expand_as(g), ub.expand_as(g), Gx, Gu


class CostFunctions:
    """The spec's costs, dynamics and constraints as functions of one node,
    with their forms batched over nodes (see the module docstring).

    Port of the JAX package's `build_cost_functions` (`ocp/costs.py:157-
    373`). ``dtype`` is the dtype of the timestep table, as in the JAX
    package (float32 by default): the running costs and the step take dt
    from it, converted to the state's dtype. A soft-contact spec steps the
    force-augmented state with the node's `contact_active` from the refs."""

    ntan = None  # vector state: no Lie-group tangent (`ocp/ff_costs.py`)
    state_diff = None
    state_integrate = None

    def __init__(self, model: RobotModel, params: ModelParams,
                 spec: ProblemSpec, dtype: torch.dtype = torch.float32):
        self.model, self.params, self.spec = model, params, spec
        self.sc, self.nc = spec.soft_contact, spec.nc
        # refs the step reads at a node: the contact activation
        self._step_keys = ("contact_active",) if self.sc is not None else ()
        self.running = tuple(i for i in spec.running_costs if i.active)
        self.terminal = tuple(i for i in spec.terminal_costs if i.active)
        # dt per node time, the terminal node's 0 last
        self._timesteps = torch.as_tensor(np.append(spec.timesteps(), 0.0),
                                          dtype=dtype)
        self._ts = {}  # (dtype, device) -> timesteps
        self._con = ConstraintFunctions(model, params, spec)
        self.n_constraints = self._con.n_constraints
        self.terminal_constraint_mask = self._con.terminal_constraint_mask
        self.terminal_constraint_row_mask = (
            self._con.terminal_constraint_row_mask)
        keys = lambda items: tuple(dict.fromkeys(
            k for i in items for k in _item_keys(i)))
        self._run_keys = keys(self.running) + self._step_keys
        self._term_keys = keys(self.terminal)

    # -- per-node bodies (refs already sliced at the node) -------------------
    def _dt(self, t, x):
        key = (x.dtype, x.device)
        if key not in self._ts:
            self._ts[key] = self._timesteps.to(device=x.device, dtype=x.dtype)
        return self._ts[key][t]

    def _step(self, x, u, dt, rt):
        if self.sc is not None:
            return soft_contact_step(self.model, self.params, self.sc, x, u,
                                     dt, rt["contact_active"])
        return integrator.euler_step(self.model, self.params, x, u, dt)

    def _item_values(self, items, x, u, rt):
        """(item, weighted value, residual) of each item at one node."""
        params = _override_geoms(self.params, rt)
        for item in items:
            value, _, _ = _item_activation(item)
            r = _item_residual(item, self.model, params, x, u, rt)
            w = _item_act_weights(item, self.model, rt, x, self.nc)
            yield item, _item_weight(item, rt) * value(r, w), r

    def _cost_sum(self, items, x, u, rt):
        total = x.new_zeros(())
        for _, v, _ in self._item_values(items, x, u, rt):
            total = total + v
        return total

    def _gn_derivs(self, items, x, u, rt, with_u: bool):
        """Gauss-Newton pack of `items` at one node (JAX `_gn_derivs`)."""
        model = self.model
        params = _override_geoms(self.params, rt)
        nx, nu = model.nx + self.nc, model.nv
        l = x.new_zeros(())
        lx, lu = x.new_zeros(nx), x.new_zeros(nu)
        lxx, lxu, luu = (x.new_zeros((nx, nx)), x.new_zeros((nx, nu)),
                         x.new_zeros((nu, nu)))
        for item in items:
            value, dr, drr = _item_activation(item)
            w_act = _item_act_weights(item, model, rt, x, self.nc)
            w_cost = _item_weight(item, rt)
            if item.kind == "control":
                r = _item_residual(item, model, params, x, u, rt)
            else:
                def r_of(xx, item=item):
                    r = _item_residual(item, model, params, xx, u, rt)
                    return r, r
                Jx, r = torch.func.jacrev(r_of, has_aux=True)(x)
            a_dr, a_drr = dr(r, w_act), drr(r, w_act)
            l = l + w_cost * value(r, w_act)
            if item.kind in ("control", "control_grav"):
                lu = lu + w_cost * a_dr
                luu = luu + w_cost * torch.diag(a_drr)
            if item.kind != "control":
                JtA = Jx.T * a_drr
                lx = lx + w_cost * (Jx.T @ a_dr)
                lxx = lxx + w_cost * JtA @ Jx
                if item.kind == "control_grav":
                    lxu = lxu + w_cost * JtA
        if not with_u:
            return l, lx, lxx
        return l, lx, lu, lxx, lxu, luu

    def _cost_derivs(self, x, u, rt, dt):
        l, lx, lu, lxx, lxu, luu = self._gn_derivs(self.running, x, u, rt,
                                                   True)
        return dt * l, dt * lx, dt * lu, dt * lxx, dt * lxu, dt * luu

    def _stage_derivs(self, x, u, rt, dt):
        if self.sc is None:
            xnext, Fx, Fu = integrator.euler_step_with_derivatives(
                self.model, self.params, x, u, dt)
        else:
            def step(xx, uu):
                xn = self._step(xx, uu, dt, rt)
                return xn, xn
            (Fx, Fu), xnext = torch.func.jacrev(step, argnums=(0, 1),
                                                has_aux=True)(x, u)
        return StageDerivs(*self._cost_derivs(x, u, rt, dt), xnext, Fx, Fu)

    def _terminal_derivs(self, x, rt):
        u0 = x.new_zeros(self.model.nv)
        return TerminalDerivs(*self._gn_derivs(self.terminal, x, u0, rt,
                                               False))

    # -- single node (the JAX package's functions) ---------------------------
    def step(self, x, u, t, refs):
        """x_next of the semi-implicit Euler step at node t."""
        return self._step(x, u, self._dt(t, x),
                          {k: refs[k][t] for k in self._step_keys})

    def stage_cost(self, x, u, t, refs):
        """dt_t * l(x, u) of the running model at node t."""
        return self._dt(t, x) * self._cost_sum(self.running, x, u,
                                               slice_refs(refs, t))

    def terminal_cost(self, x, refs):
        """l(x) of the terminal model (refs row T, u = 0, no dt)."""
        return self._cost_sum(self.terminal, x, x.new_zeros(self.model.nv),
                              slice_refs(refs, self.spec.horizon))

    def cost_breakdown(self, x, u, t, refs, terminal=False):
        """{item name: (weighted value, residual)} at one node."""
        items = self.terminal if terminal else self.running
        return {item.name: (v, r) for item, v, r in self._item_values(
            items, x, u, slice_refs(refs, t))}

    def cost_derivs(self, x, u, t, refs):
        """dt-scaled Gauss-Newton cost pack (l, lx, lu, lxx, lxu, luu)."""
        return self._cost_derivs(x, u, slice_refs(refs, t), self._dt(t, x))

    def stage_derivs(self, x, u, t, refs) -> StageDerivs:
        return self._stage_derivs(x, u, slice_refs(refs, t), self._dt(t, x))

    def terminal_derivs(self, x, refs) -> TerminalDerivs:
        return self._terminal_derivs(x, slice_refs(refs, self.spec.horizon))

    def constraints(self, x, u, t, refs):
        """(g, lb, ub) [nc] at one node, or None without constraints."""
        if not self.n_constraints:
            return None
        t_idx = torch.as_tensor([t], device=x.device).reshape(1)
        return tuple(a[0] for a in self._con.constraints(
            x[None], u[None], t_idx, refs))

    def constraint_derivs(self, x, u, t, refs):
        """(g, lb, ub, Gx [nc, nx], Gu [nc, nu]) at one node, or None."""
        if not self.n_constraints:
            return None
        t_idx = torch.as_tensor([t], device=x.device).reshape(1)
        return tuple(a[0] for a in self._con.constraint_derivs(
            x[None], u[None], t_idx, refs))

    @property
    def constraint_functions(self) -> ConstraintFunctions:
        """The batched constraint side (`ConstraintFunctions`)."""
        return self._con

    # -- batched over nodes ----------------------------------------------------
    def _nodes(self, keys, x, t, refs):
        """(per-node refs rows, global refs, dt [N]) of N nodes at t (an
        int or an [N] tensor of node times)."""
        N = x.shape[0]
        if isinstance(t, torch.Tensor) and t.ndim == 1:
            rows = {k: refs[k].index_select(0, t) for k in keys if k in refs}
            dt = self._dt(t, x)
        else:
            rows = {k: refs[k][t].expand((N,) + refs[k].shape[1:])
                    for k in keys if k in refs}
            dt = self._dt(t, x).expand(N)
        glob = {k: v for k, v in refs.items() if _is_global(k)}
        return rows, glob, dt

    def _map(self, fn, keys, x, u, t, refs):
        rows, glob, dt = self._nodes(keys, x, t, refs)
        return torch.func.vmap(
            lambda x1, u1, r1, d1: fn(x1, u1, {**r1, **glob}, d1))(
                x, u, rows, dt)

    def step_b(self, x, u, t, refs):
        """x_next [N, nx] of N nodes."""
        return self._map(lambda x1, u1, rt, dt: self._step(x1, u1, dt, rt),
                         self._step_keys, x, u, t, refs)

    def stage_derivs_b(self, x, u, t, refs) -> StageDerivs:
        """`stage_derivs` of N nodes, every field with a leading [N]."""
        return StageDerivs(*self._map(self._stage_derivs, self._run_keys, x, u,
                                      t, refs))

    def cost_breakdown_b(self, x, u, t, refs):
        """`cost_breakdown` of N running nodes: {item name: (weighted value
        [N], residual [N, r])}."""
        return self._map(
            lambda x1, u1, rt, dt: {item.name: (v, r) for item, v, r in
                                    self._item_values(self.running, x1, u1,
                                                      rt)},
            self._run_keys, x, u, t, refs)

    def pack(self, x, u, t, refs):
        """`cost_derivs` of N nodes: (l, lx, lu, lxx, lxu, luu), [N, ...]."""
        return self._map(self._cost_derivs, self._run_keys, x, u, t, refs)

    def value(self, x, u, t, refs):
        """`stage_cost` of N nodes, [N]."""
        return self._map(
            lambda x1, u1, rt, dt: dt * self._cost_sum(self.running, x1, u1,
                                                       rt),
            self._run_keys, x, u, t, refs)

    def term_pack(self, x, refs):
        """`terminal_derivs` of N nodes: (l, lx, lxx), [N, ...]."""
        u0 = x.new_zeros((x.shape[0], self.model.nv))
        return tuple(self._map(
            lambda x1, u1, rt, dt: self._terminal_derivs(x1, rt),
            self._term_keys, x, u0, self.spec.horizon, refs))

    def term_value(self, x, refs):
        """`terminal_cost` of N nodes, [N]."""
        u0 = x.new_zeros((x.shape[0], self.model.nv))
        return self._map(
            lambda x1, u1, rt, dt: self._cost_sum(self.terminal, x1, u1, rt),
            self._term_keys, x, u0, self.spec.horizon, refs)


def build_cost_functions(model: RobotModel, params: ModelParams,
                         spec: ProblemSpec,
                         dtype: torch.dtype = torch.float32) -> CostFunctions:
    """The spec's `CostFunctions` (JAX `build_cost_functions`)."""
    return CostFunctions(model, params, spec, dtype)


def build_constraint_functions(model: RobotModel, params: ModelParams,
                               spec: ProblemSpec) -> ConstraintFunctions:
    """The constraint side of `spec` (see `ConstraintFunctions`)."""
    return ConstraintFunctions(model, params, spec)
