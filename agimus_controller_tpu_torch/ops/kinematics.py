"""Forward kinematics on tensors: joint and frame placements.

Port of the JAX package's `ops/kinematics.py` (`joint_placements`,
`frame_placement`, `frame_jacobian`, `frame_velocity`, `integrate`,
`difference`; pinocchio `forwardKinematics` / `updateFramePlacements` /
`computeFrameJacobian` / `integrate` / `difference`).
Single-sample over a static topology (the joint loop unrolls in Python);
batch with `torch.func.vmap`. Motion vectors are `[w; v]`.
"""

from __future__ import annotations

import torch

from ..models.model import ModelParams, RobotModel
from . import spatial


def joint_transform(model: RobotModel, params: ModelParams, q, i: int):
    """Placement of joint-i frame in its parent joint frame at angle q[i]."""
    Rj, pj = params.joint_rot[i], params.joint_trans[i]
    axis = params.axis[i]
    if model.joint_types[i] == "revolute":
        return Rj @ spatial.exp3(axis * q[..., i, None]), pj
    if model.joint_types[i] == "prismatic":
        return Rj, pj + torch.einsum("ij,...j->...i", Rj, axis * q[..., i, None])
    raise ValueError(f"unsupported joint type {model.joint_types[i]}")


def joint_placements(model: RobotModel, params: ModelParams, q):
    """World placements of all joint frames: ([nj,3,3], [nj,3])."""
    rots, trans = [], []
    for i in range(model.nj):
        Xl = joint_transform(model, params, q, i)
        p = model.parents[i]
        oMi = Xl if p < 0 else spatial.se3_mul((rots[p], trans[p]), Xl)
        rots.append(oMi[0])
        trans.append(oMi[1])
    return torch.stack(rots), torch.stack(trans)


def frame_placement(model: RobotModel, params: ModelParams, q, frame_id: int):
    """World placement (R, p) of an operational frame."""
    fr = model.frames[frame_id]
    fR, fp = params.frame_rot[frame_id], params.frame_trans[frame_id]
    if fr.parent_joint < 0:
        return fR, fp
    rots, trans = joint_placements(model, params, q)
    return spatial.se3_mul((rots[fr.parent_joint], trans[fr.parent_joint]),
                           (fR, fp))


def _ancestors(model: RobotModel, joint: int):
    """The joints from the root down to `joint`."""
    out = []
    j = joint
    while j >= 0:
        out.append(j)
        j = model.parents[j]
    return out[::-1]


def _joint_motion_subspace(model: RobotModel, params: ModelParams, i: int):
    """S of joint i, `[6]`: [axis; 0] revolute, [0; axis] prismatic."""
    axis = params.axis[i]
    zero = torch.zeros_like(axis)
    if model.joint_types[i] == "revolute":
        return torch.cat([axis, zero])
    return torch.cat([zero, axis])


def frame_jacobian(model: RobotModel, params: ModelParams, q, frame_id: int,
                   reference_frame: str = "local_world_aligned"):
    """Geometric Jacobian of a frame, `[6, nv]`, rows `[w; v]`.

    ``reference_frame``: "world", "local", or (any other value)
    "local_world_aligned", the pinocchio conventions."""
    fr = model.frames[frame_id]
    rots, trans = joint_placements(model, params, q)
    oMf = spatial.se3_mul(
        (rots[fr.parent_joint], trans[fr.parent_joint]),
        (params.frame_rot[frame_id], params.frame_trans[frame_id]))
    cols = []
    anc = set(_ancestors(model, fr.parent_joint))
    for i in range(model.nj):
        if i not in anc:
            cols.append(torch.zeros(6, dtype=q.dtype, device=q.device))
            continue
        S = _joint_motion_subspace(model, params, i)
        S_world = spatial.motion_act((rots[i], trans[i]), S)
        if reference_frame == "world":
            cols.append(S_world)
        elif reference_frame == "local":
            cols.append(spatial.motion_act_inv(oMf, S_world))
        else:  # local_world_aligned: local linear/angular parts rotated to world
            S_local = spatial.motion_act_inv(oMf, S_world)
            R = oMf[0]
            cols.append(torch.cat([R @ S_local[:3], R @ S_local[3:]]))
    return torch.stack(cols, dim=-1)


def frame_velocity(model: RobotModel, params: ModelParams, q, v,
                   frame_id: int, reference_frame: str = "local_world_aligned"):
    """Spatial velocity `[w; v]` of a frame (J @ v)."""
    return frame_jacobian(model, params, q, frame_id, reference_frame) @ v


def integrate(model: RobotModel, q, dq):
    """Configuration integration (pinocchio `pin.integrate`): every
    supported joint is revolute or prismatic, so this is plain addition."""
    return q + dq


def difference(model: RobotModel, q0, q1):
    """Tangent-space difference (pinocchio `pin.difference`)."""
    return q1 - q0
