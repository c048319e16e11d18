"""Residuals r(x, u, ref) on tensors: the ones constraints reach.

Port of the part of the JAX package's `ops/residuals.py` that
`ocp/costs.py::_con_residual` calls: state, control, frame placement,
translation and rotation, and the collision distance (crocoddyl / colmpc
residual models of the YAML DSL, `ocp/ocp_croco_generic.py:154-557`).
Single-sample; Jacobians come from `torch.func` at the assembly level.
"""

from __future__ import annotations

import torch

from ..models.model import ModelParams, RobotModel
from . import collision as _collision
from . import kinematics as _kinematics
from . import spatial


def state_residual(model: RobotModel, x, xref):
    """r = x - xref (`ResidualModelState` on a vector state)."""
    return x - xref


def control_residual(u, uref):
    """r = u - uref (`ResidualModelControl`)."""
    return u - uref


def frame_placement_residual(model: RobotModel, params: ModelParams, x,
                             frame_id: int, ref_rot, ref_trans):
    """r = log6(refM^-1 * oMf(q)), `[6]` = [w; v]."""
    q = x[..., :model.nq]
    R, p = _kinematics.frame_placement(model, params, q, frame_id)
    dR, dp = spatial.se3_mul(spatial.se3_inv((ref_rot, ref_trans)), (R, p))
    return spatial.log6(dR, dp)


def frame_translation_residual(model: RobotModel, params: ModelParams, x,
                               frame_id: int, ref_trans):
    """r = p(q) - pref, `[3]`."""
    q = x[..., :model.nq]
    _, p = _kinematics.frame_placement(model, params, q, frame_id)
    return p - ref_trans


def frame_rotation_residual(model: RobotModel, params: ModelParams, x,
                            frame_id: int, ref_rot):
    """r = log3(Rref^T R(q)), `[3]`."""
    q = x[..., :model.nq]
    R, _ = _kinematics.frame_placement(model, params, q, frame_id)
    return spatial.log3(torch.swapaxes(ref_rot, -1, -2) @ R)


def collision_distance_residual(model: RobotModel, params: ModelParams, x,
                                pair_id: int):
    """r = signed distance of a collision pair, `[1]`."""
    q = x[..., :model.nq]
    return _collision.pair_distance(model, params, q, pair_id)[..., None]
