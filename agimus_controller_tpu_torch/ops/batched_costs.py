"""Component-form kinematics and SE(3) log maps in plain PyTorch.

The pieces of the JAX package's `ops/batched_costs.py` that the frame cost
kinds need: world joint placements, frame poses, rotation -> quaternion, and
the SO(3)/SE(3) logs. Same component layout as `batched_dynamics`: every
scalar is an `[N]` tensor.
"""

from __future__ import annotations

from typing import List

import torch

from ..models.model import ModelParams, RobotModel
from .batched_dynamics import (
    _StaticModel,
    _add,
    _cross,
    _dot,
    _joint_transforms,
    _matmul,
    _matvec,
)

SUPPORTED_KINDS = (
    "state",
    "control",
    "control_grav",
    "frame_placement",
    "frame_translation",
    "frame_rotation",
    "frame_velocity",
    "visual_servoing",
    "collision_distance",
)


def _fk_world(sm: _StaticModel, q: List):
    """World placements of every joint in component form (unrolled chain)."""
    Xs = _joint_transforms(sm, q)
    oR, op = [], []
    for i in range(sm.nj):
        R, p = Xs[i]
        par = sm.parents[i]
        if par < 0:
            oR.append(R)
            op.append(p)
        else:
            oR.append(_matmul(oR[par], R))
            op.append(_add(_matvec(oR[par], p), op[par]))
    return oR, op


def _quat_c(R):
    """Branchless rotation-matrix -> quaternion [x,y,z,w], component form
    (candidate-select construction: the largest of m00, m11, m22, trace)."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = R
    tr = m00 + m11 + m22
    cands = [
        ((1.0 + m00 - m11 - m22), (m01 + m10), (m02 + m20), (m21 - m12)),
        ((m01 + m10), (1.0 - m00 + m11 - m22), (m12 + m21), (m02 - m20)),
        ((m02 + m20), (m12 + m21), (1.0 - m00 - m11 + m22), (m10 - m01)),
        ((m21 - m12), (m02 - m20), (m10 - m01), (1.0 + tr)),
    ]
    scores = [m00, m11, m22, tr]
    best = scores[0]
    out = list(cands[0])
    for s, c in zip(scores[1:], cands[1:]):
        take = s > best
        best = torch.where(take, s, best)
        out = [torch.where(take, cc, oo) for cc, oo in zip(c, out)]
    n = torch.sqrt(out[0] ** 2 + out[1] ** 2 + out[2] ** 2 + out[3] ** 2)
    return tuple(o / n for o in out)


def _log3_c(R):
    """SO(3) log, component form (quaternion / atan2 route)."""
    qx, qy, qz, qw = _quat_c(R)
    sign = torch.where(qw < 0.0, -1.0, 1.0).to(qw.dtype)
    qx, qy, qz = qx * sign, qy * sign, qz * sign
    c = torch.abs(qw)
    s2 = qx * qx + qy * qy + qz * qz
    # float32-robust branch: s2 carries ~1e-12 of rounding noise near the
    # identity, and theta/s vs its 2/c limit agree to ~s2 there — the 1e-8
    # threshold fixes which Jacobian branch is taken
    small = s2 < 1e-8
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = 2.0 * torch.atan2(s, c)
    scale = torch.where(small, 2.0 / c, theta / s)
    return (scale * qx, scale * qy, scale * qz)


def _log6_c(R, p):
    """SE(3) log -> ([w; v] 6-tuple)."""
    w = _log3_c(R)
    t2 = _dot(w, w)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    half = th * 0.5
    sin_half = torch.where(small, torch.ones_like(th), torch.sin(half))
    coef = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        (1.0 - half * torch.cos(half) / sin_half) / t2s)
    # V^-1 p = p - 0.5 w x p + coef * w x (w x p)
    wxp = _cross(w, p)
    wwxp = _cross(w, wxp)
    v = tuple(p[i] - 0.5 * wxp[i] + coef * wwxp[i] for i in range(3))
    return w + v  # 6-tuple


def _frame_pose_c(model: RobotModel, params: ModelParams, oR, op,
                  frame_id: int):
    """(R, p) of frame `frame_id` from world joint placements (components)."""
    fr = model.frames[frame_id]
    fR = tuple(float(x) for x in params.frame_rot[frame_id].reshape(-1))
    fp = tuple(float(x) for x in params.frame_trans[frame_id])
    j = fr.parent_joint
    return _matmul(oR[j], fR), _add(_matvec(oR[j], fp), op[j])
