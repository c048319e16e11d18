"""Residuals r(x, u, ref) on tensors.

Port of the JAX package's `ops/residuals.py`: state, control, control
minus gravity, frame placement, translation, rotation and velocity, visual
servoing and the collision distance (crocoddyl / colmpc
residual models of the YAML DSL, `ocp/ocp_croco_generic.py:154-557`).
Single-sample; Jacobians come from `torch.func` at the assembly level.
"""

from __future__ import annotations

import torch

from ..models.model import ModelParams, RobotModel
from . import collision as _collision
from . import dynamics as _dynamics
from . import kinematics as _kinematics
from . import spatial


def state_residual(model: RobotModel, x, xref):
    """r = x - xref (`ResidualModelState` on a vector state)."""
    return x - xref


def control_residual(u, uref):
    """r = u - uref (`ResidualModelControl`)."""
    return u - uref


def control_grav_residual(model: RobotModel, params: ModelParams, x, u):
    """r = u - g(q) (`ResidualModelControlGrav`)."""
    q = x[..., :model.nq]
    return u - _dynamics.generalized_gravity(model, params, q)


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


def frame_velocity_residual(model: RobotModel, params: ModelParams, x,
                            frame_id: int, ref_vel,
                            reference_frame: str = "world"):
    """r = nu_f(q, v) - nuref, `[6]` [w; v] (`ResidualModelFrameVelocity`)."""
    nq = model.nq
    q, v = x[..., :nq], x[..., nq:]
    nu = _kinematics.frame_velocity(model, params, q, v, frame_id,
                                    reference_frame)
    return nu - ref_vel


def visual_servoing_residual(model: RobotModel, params: ModelParams, x,
                             frame_id: int, wMo_rot, wMo_trans, oMf_ref_rot,
                             oMf_ref_trans):
    """Frame-placement residual against the composed target
    wMf_target = wMo_vision * oMf_target (`ResidualModelVisualServoing`,
    `ocp_croco_generic.py:436-495`); the vision transform wMo is a runtime
    input."""
    ref_rot, ref_trans = spatial.se3_mul((wMo_rot, wMo_trans),
                                         (oMf_ref_rot, oMf_ref_trans))
    return frame_placement_residual(model, params, x, frame_id, ref_rot,
                                    ref_trans)


def collision_distance_residual(model: RobotModel, params: ModelParams, x,
                                pair_id: int):
    """r = signed distance of a collision pair, `[1]`."""
    q = x[..., :model.nq]
    return _collision.pair_distance(model, params, q, pair_id)[..., None]
