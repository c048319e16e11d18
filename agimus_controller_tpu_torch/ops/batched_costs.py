"""Component-form kinematics and SE(3) log maps in plain PyTorch.

The pieces of the JAX package's `ops/batched_costs.py` that the frame,
frame-velocity, visual-servoing and collision cost kinds need: world joint
placements, frame poses and spatial velocities, rotation -> quaternion, the
SO(3)/SE(3) logs, geometry placements and the capsule distance. Same
component layout as `batched_dynamics`: every scalar is an `[N]` tensor.
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
    _mattvec,
    _matvec,
    _scale,
    _sub,
)
from .kinematics import _ancestors as _ancestors_static

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


def _frame_velocity_c(model: RobotModel, sm: _StaticModel, oR, op,
                      v: List, frame_id: int, reference_frame: str,
                      Rf, pf):
    """Spatial velocity [w(3); v(3)] 6-tuple of a frame, component form.

    The frame Jacobian times v in the pinocchio conventions (`world`,
    `local`, else `local_world_aligned`), as `kinematics.frame_velocity`."""
    fr = model.frames[frame_id]
    zero3 = (0.0, 0.0, 0.0)
    w, v0 = zero3, zero3  # world spatial twist at the world origin
    for i in _ancestors_static(model, fr.parent_joint):
        ax = sm.axis[i]
        if sm.types[i] == "revolute":
            Sw = _matvec(oR[i], ax)
            col_w = Sw
            col_v = _cross(op[i], Sw)  # R Sv (=0) + p x (R Sw)
        else:
            col_w = zero3
            col_v = _matvec(oR[i], ax)
        w = _add(w, _scale(v[i], col_w))
        v0 = _add(v0, _scale(v[i], col_v))
    if reference_frame == "world":
        return w + v0
    # v at the frame origin: v0 - pf x w  (motion_act_inv's v - p x w term)
    v_at = _sub(v0, _cross(pf, w))
    if reference_frame == "local":
        return _mattvec(Rf, w) + _mattvec(Rf, v_at)
    # local_world_aligned: local parts rotated back to world
    return w + v_at


def _one_below(x, eps):
    """1 where x < eps, else x; x a tensor or, for a world-fixed geometry's
    constant axis, a Python float."""
    if isinstance(x, torch.Tensor):
        return torch.where(x < eps, torch.ones_like(x), x)
    return 1.0 if x < eps else x


def _capsule_distance_c(R1, p1, r1, l1, R2, p2, r2, l2):
    """Signed capsule-capsule distance, component form (the branch-free
    Ericson clamps of `collision.capsule_capsule_distance`)."""
    d1 = (R1[2], R1[5], R1[8])  # local z column
    d2 = (R2[2], R2[5], R2[8])
    r = _sub(p1, p2)
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    b = _dot(d1, d2)
    c = _dot(d1, r)
    f = _dot(d2, r)
    denom = a * e - b * b
    denom_safe = torch.where(denom < 1e-9, torch.ones_like(denom), denom)
    s = torch.where(denom < 1e-9, torch.zeros_like(denom),
                    (b * f - c * e) / denom_safe)
    s = torch.clamp(s, -l1, l1)
    t = (b * s + f) / _one_below(e, 1e-12)
    t_cl = torch.clamp(t, -l2, l2)
    s = torch.clamp((b * t_cl - c) / _one_below(a, 1e-12), -l1, l1)
    c1 = _add(p1, _scale(s, d1))
    c2 = _add(p2, _scale(t_cl, d2))
    diff = _sub(c1, c2)
    dist = torch.sqrt(_dot(diff, diff) + 1e-12)
    return dist - r1 - r2


def _geom_placement_c(model: RobotModel, params: ModelParams, oR, op,
                      gi: int, refs):
    """World placement of collision geometry `gi`, component form. Local
    placements come from the refs overrides `geom_rot`/`geom_trans` when
    present (moving obstacles, the reference's `update_geometry_placement`,
    `ocp_base_croco.py:110-132`), else from the model."""
    g = model.geometries[gi]
    if "geom_rot" in refs:
        gRa = refs["geom_rot"][gi]
        gR = tuple(gRa[r, c] for r in range(3) for c in range(3))
    else:
        gR = tuple(float(x) for x in params.geom_rot[gi].reshape(-1))
    if "geom_trans" in refs:
        gpa = refs["geom_trans"][gi]
        gp = tuple(gpa[i] for i in range(3))
    else:
        gp = tuple(float(x) for x in params.geom_trans[gi])
    if g.parent_joint < 0:
        return gR, gp
    j = g.parent_joint
    return _matmul(oR[j], gR), _add(_matvec(oR[j], gp), op[j])
