"""Forward kinematics on tensors: joint and frame placements.

Port of the JAX package's `ops/kinematics.py` (`joint_placements`,
`frame_placement`; pinocchio `forwardKinematics` / `updateFramePlacements`).
Single-sample over a static topology (the joint loop unrolls in Python);
batch with `torch.func.vmap`.
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
