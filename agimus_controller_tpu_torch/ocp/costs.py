"""Constraint side of the OCP assembly: lb <= g(x, u) <= ub per node.

Port of the JAX package's `ocp/costs.py:298-358` (`constraints`,
`constraint_derivs`, `n_constraints`, `terminal_constraint_row_mask`; the
reference's `ConstraintModelManager` over `ConstraintModelResidual` /
`ConstraintModelControlLimit`, `ocp/ocp_croco_generic.py:594-654`).

The JAX functions are single-node and the solver vmaps them; here every call
takes all its nodes at once: x [N, nx], u [N, nu], node times t_idx [N].
Per-node references are gathered at t_idx; the geometry overrides
`geom_rot`/`geom_trans` are global. The Jacobians Gx/Gu come from
`torch.func.jacrev` under `vmap`: one batched pass per constraint row (the
JAX package takes `jax.jacfwd`, one pass per state and control entry; the
rows are fewer). Forward mode is not an option in float32: PyTorch's tangent
of `torch.where` over a 0-dim branch computed with a Python scalar comes out
in float64, which breaks the next matrix product. In the JAX package this is
XLA, not a Pallas kernel, so it stays plain PyTorch here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.model import ModelParams, RobotModel
from ..ops import residuals
from .spec import ConstraintItem, ProblemSpec

# residual kinds a constraint may take here; the others (state, control,
# control_grav, frame_velocity, visual_servoing, force_box) are not ported
CONSTRAINT_KINDS = ("control_limit", "frame_placement", "frame_translation",
                    "frame_rotation", "collision_distance")
_FRAME_KEYS = {"frame_placement": ("ee_rot", "ee_trans"),
               "frame_translation": ("ee_trans",),
               "frame_rotation": ("ee_rot",)}


class ConstraintFunctions:
    """The constraint rows of a spec, stacked in item order."""

    def __init__(self, model: RobotModel, params: ModelParams,
                 spec: ProblemSpec):
        if spec.soft_contact is not None:
            raise NotImplementedError(
                "soft contact is not ported yet (ROADMAP queue 1, slice 12)")
        for c in spec.constraints:
            if c.kind not in CONSTRAINT_KINDS:
                raise NotImplementedError(
                    f"constraint kind {c.kind!r} is not ported yet")
        self.model, self.params = model, params
        self.items: Tuple[ConstraintItem, ...] = tuple(spec.constraints)
        self.n_constraints = sum(c.residual_dim(model) for c in self.items)
        self.terminal_constraint_row_mask = tuple(
            flag for c in self.items
            for flag in [c.terminal] * c.residual_dim(model))
        self._node_keys = tuple(dict.fromkeys(
            f"{key}:{c.frame}" for c in self.items
            for key in _FRAME_KEYS.get(c.kind, ())))

    # ------------------------------------------------------------------
    def _bounds(self, c: ConstraintItem, dtype, device):
        nr = c.residual_dim(self.model)
        kw = dict(dtype=dtype, device=device)
        if c.kind == "control_limit":
            # default +-effortLimit (ConstraintModelControlLimit); explicit
            # lower/upper override the box
            lim = self.params.effort_limit.to(**kw)
            lo = (torch.as_tensor(c.lower, **kw).expand(nr) if c.lower
                  else -lim)
            hi = torch.as_tensor(c.upper, **kw).expand(nr) if c.upper else lim
            return lo, hi
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
        if c.kind == "collision_distance":
            return residuals.collision_distance_residual(
                self.model, params, x, c.pair_id)
        fid = self.model.frame_id(c.frame)
        if c.kind == "frame_placement":
            return residuals.frame_placement_residual(
                self.model, params, x, fid, rt[f"ee_rot:{c.frame}"],
                rt[f"ee_trans:{c.frame}"])
        if c.kind == "frame_translation":
            return residuals.frame_translation_residual(
                self.model, params, x, fid, rt[f"ee_trans:{c.frame}"])
        return residuals.frame_rotation_residual(
            self.model, params, x, fid, rt[f"ee_rot:{c.frame}"])

    def _g_fn(self, refs: Dict):
        """Single-node g(x, u, rt) with the refs' geometry overrides (the
        reference's `update_geometry_placement`)."""
        params = self.params
        if "geom_rot" in refs:
            params = params._replace(geom_rot=refs["geom_rot"])
        if "geom_trans" in refs:
            params = params._replace(geom_trans=refs["geom_trans"])

        def g(x, u, rt):
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


def build_constraint_functions(model: RobotModel, params: ModelParams,
                               spec: ProblemSpec) -> ConstraintFunctions:
    """The constraint side of `spec` (see `ConstraintFunctions`)."""
    return ConstraintFunctions(model, params, spec)
