"""Rigid-body dynamics on tensors: RNEA, CRBA, forward dynamics, energies.

Port of the JAX package's `ops/dynamics.py`: pinocchio `pin.rnea`,
`computeGeneralizedGravity`, `crba`, and the forward dynamics with armature
of `DifferentialActionModelFreeFwdDynamics.calc`. Single-sample over a
static topology (the joint loops unroll in Python); batch with
`torch.func.vmap`. Forward dynamics takes the mass-matrix route
`solve(M + diag(armature), tau - b)` with a Cholesky factor and two
triangular solves, as the JAX package does. The solvers' per-node dynamics
run in component form (`batched_dynamics`, `cuda_dynamics`) and in the
kernels; `integrator.euler_step` and the generic `ocp.costs.CostFunctions`
run these.
"""

from __future__ import annotations

import torch

from ..models.model import ModelParams, RobotModel
from . import spatial
from .kinematics import _joint_motion_subspace, joint_placements, joint_transform


def rnea(model: RobotModel, params: ModelParams, q, v, a, fext=None):
    """Recursive Newton-Euler inverse dynamics tau(q, v, a), `[nv]`.

    ``fext``: optional `[nj, 6]` external forces `[n; f]` expressed in each
    joint's local frame (subtracted, pinocchio convention). Armature is not
    included (as `pin.rnea`: it enters the mass matrix only)."""
    nj = model.nj
    g = params.gravity
    a_base = torch.cat([torch.zeros_like(g), -g])  # gravity as a base acceleration
    Xl = [joint_transform(model, params, q, i) for i in range(nj)]
    vels, accs, forces = [], [], []
    for i in range(nj):
        S = _joint_motion_subspace(model, params, i)
        p = model.parents[i]
        v_parent = vels[p] if p >= 0 else torch.zeros(6, dtype=q.dtype,
                                                      device=q.device)
        a_parent = accs[p] if p >= 0 else a_base
        vi = spatial.motion_act_inv(Xl[i], v_parent) + S * v[i]
        ai = (spatial.motion_act_inv(Xl[i], a_parent) + S * a[i]
              + spatial.motion_cross(vi, S * v[i]))
        hi = spatial.inertia_apply(params.mass[i], params.com[i],
                                   params.inertia[i], vi)
        fi = (spatial.inertia_apply(params.mass[i], params.com[i],
                                    params.inertia[i], ai)
              + spatial.motion_cross_force(vi, hi))
        if fext is not None:
            fi = fi - fext[i]
        vels.append(vi)
        accs.append(ai)
        forces.append(fi)
    tau = [None] * nj
    for i in reversed(range(nj)):
        S = _joint_motion_subspace(model, params, i)
        tau[i] = torch.dot(S, forces[i])
        p = model.parents[i]
        if p >= 0:
            forces[p] = forces[p] + spatial.force_act(Xl[i], forces[i])
    return torch.stack(tau)


def nonlinear_effects(model: RobotModel, params: ModelParams, q, v):
    """Coriolis + gravity bias b(q, v) = rnea(q, v, 0)."""
    return rnea(model, params, q, v, torch.zeros_like(v))


def generalized_gravity(model: RobotModel, params: ModelParams, q):
    """g(q) = rnea(q, 0, 0), pinocchio `computeGeneralizedGravity`."""
    z = torch.zeros_like(q)
    return rnea(model, params, q, z, z)


def _spatial_inertia_matrix(mass, com, I_com):
    C = spatial.hat(com)
    mC = mass * C
    eye = torch.eye(3, dtype=com.dtype, device=com.device)
    top = torch.cat([I_com - mass * (C @ C), mC], dim=-1)
    bot = torch.cat([-mC, mass * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _force_act_matrix(X):
    """6x6 matrix of `spatial.force_act` for placement X = (R, p)."""
    R, p = X
    Z = torch.zeros_like(R)
    pR = spatial.hat(p) @ R
    return torch.cat([torch.cat([R, pR], dim=-1), torch.cat([Z, R], dim=-1)],
                     dim=-2)


def _motion_act_inv_matrix(X):
    """6x6 matrix of `spatial.motion_act_inv` for placement X = (R, p)."""
    R, p = X
    Rt = torch.swapaxes(R, -1, -2)
    Z = torch.zeros_like(R)
    return torch.cat([torch.cat([Rt, Z], dim=-1),
                      torch.cat([-Rt @ spatial.hat(p), Rt], dim=-1)], dim=-2)


def crba(model: RobotModel, params: ModelParams, q):
    """Composite rigid-body algorithm: joint-space mass matrix M(q),
    `[nv, nv]`. Armature is not included; `mass_matrix` adds it."""
    nj = model.nj
    Xl = [joint_transform(model, params, q, i) for i in range(nj)]
    Ic = [_spatial_inertia_matrix(params.mass[i], params.com[i],
                                  params.inertia[i]) for i in range(nj)]
    for i in reversed(range(nj)):
        p = model.parents[i]
        if p >= 0:
            Ic[p] = Ic[p] + (_force_act_matrix(Xl[i]) @ Ic[i]
                             @ _motion_act_inv_matrix(Xl[i]))
    entries = {}
    for i in range(nj):
        Si = _joint_motion_subspace(model, params, i)
        F = Ic[i] @ Si
        entries[(i, i)] = torch.dot(Si, F)
        j = i
        while model.parents[j] >= 0:
            F = _force_act_matrix(Xl[j]) @ F
            j = model.parents[j]
            entries[(i, j)] = torch.dot(
                _joint_motion_subspace(model, params, j), F)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    return torch.stack([
        torch.stack([entries.get((max(i, j), min(i, j)), zero)
                     for j in range(nj)]) for i in range(nj)])


def mass_matrix(model: RobotModel, params: ModelParams, q):
    """M(q) + diag(armature): the inertia the forward dynamics inverts
    (Crocoddyl's DAM-with-armature semantics)."""
    return crba(model, params, q) + torch.diag(params.armature)


def forward_dynamics(model: RobotModel, params: ModelParams, q, v, tau,
                     fext=None):
    """Forward dynamics a(q, v, tau) with armature: the Cholesky factor of
    M + diag(armature) and two triangular solves against tau - b(q, v)."""
    M = mass_matrix(model, params, q)
    b = rnea(model, params, q, v, torch.zeros_like(v), fext=fext)
    L = torch.linalg.cholesky(M)
    y = torch.linalg.solve_triangular(L, (tau - b)[:, None], upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]


def kinetic_energy(model: RobotModel, params: ModelParams, q, v):
    return 0.5 * v @ crba(model, params, q) @ v


def potential_energy(model: RobotModel, params: ModelParams, q):
    rots, trans = joint_placements(model, params, q)
    com_w = torch.einsum("nij,nj->ni", rots, params.com) + trans
    return -torch.sum(params.mass * (com_w @ params.gravity))
