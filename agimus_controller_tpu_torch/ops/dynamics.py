"""Inverse dynamics on tensors: RNEA and the generalized gravity.

Port of the part of the JAX package's `ops/dynamics.py` that the trajectory
generators call (`trajectories/base.py`: the efforts of a reference
trajectory): pinocchio `pin.rnea` and `pin.computeGeneralizedGravity`.
Single-sample over a static topology (the joint loop unrolls in Python).
The solver's dynamics run in component form (`batched_dynamics`,
`cuda_dynamics`) and in the stage kernels instead.
"""

from __future__ import annotations

import torch

from ..models.model import ModelParams, RobotModel
from . import spatial
from .kinematics import _joint_motion_subspace, joint_transform


def rnea(model: RobotModel, params: ModelParams, q, v, a):
    """Recursive Newton-Euler inverse dynamics tau(q, v, a), `[nv]`.

    Armature is not included (as `pin.rnea`: it enters the mass matrix
    only)."""
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


def generalized_gravity(model: RobotModel, params: ModelParams, q):
    """g(q) = rnea(q, 0, 0), pinocchio `computeGeneralizedGravity`."""
    z = torch.zeros_like(q)
    return rnea(model, params, q, z, z)
