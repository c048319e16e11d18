"""Batched FK extraction helpers over recorded trajectories (reference:
`plots/pin_utils.py:6-200` — `get_p_`, `get_v_`, `get_R_`, `get_rpy_`,
`get_w_`, `get_u_grav`). One FK pass vmapped over the samples instead of a
python loop of pinocchio calls.

Port of the JAX package's `plots/pin_utils.py` over the port's
`kinematics` and `dynamics`: the samples go to the params' device and
dtype, the results come back as numpy."""

from __future__ import annotations

import numpy as np
import torch

from ..models.model import ModelParams, RobotModel
from ..ops import dynamics, kinematics


def _fid(model: RobotModel, frame) -> int:
    return frame if isinstance(frame, int) else model.frame_id(frame)


def _on(params: ModelParams, a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=params.mass.dtype,
                           device=params.mass.device)


def _vmap(fn, params, *arrays) -> np.ndarray:
    out = torch.func.vmap(fn)(*(_on(params, a) for a in arrays))
    return out.detach().cpu().numpy()


def get_p_(qs, model: RobotModel, params: ModelParams, frame) -> np.ndarray:
    """EE positions along a trajectory, [N, 3]."""
    fid = _fid(model, frame)
    return _vmap(
        lambda q: kinematics.frame_placement(model, params, q, fid)[1],
        params, qs)


def get_R_(qs, model: RobotModel, params: ModelParams, frame) -> np.ndarray:
    """EE rotation matrices along a trajectory, [N, 3, 3]."""
    fid = _fid(model, frame)
    return _vmap(
        lambda q: kinematics.frame_placement(model, params, q, fid)[0],
        params, qs)


def get_rpy_(qs, model: RobotModel, params: ModelParams, frame) -> np.ndarray:
    """EE roll-pitch-yaw along a trajectory, [N, 3]."""
    Rs = get_R_(qs, model, params, frame)
    # inverse of rpy_to_matrix (Rz Ry Rx)
    pitch = -np.arcsin(np.clip(Rs[:, 2, 0], -1, 1))
    roll = np.arctan2(Rs[:, 2, 1], Rs[:, 2, 2])
    yaw = np.arctan2(Rs[:, 1, 0], Rs[:, 0, 0])
    return np.stack([roll, pitch, yaw], axis=-1)


def get_v_(qs, vs, model: RobotModel, params: ModelParams, frame) -> np.ndarray:
    """EE linear velocities (LOCAL_WORLD_ALIGNED), [N, 3]."""
    fid = _fid(model, frame)
    return _vmap(
        lambda q, v: kinematics.frame_velocity(model, params, q, v, fid,
                                               "local_world_aligned")[3:],
        params, qs, vs)


def get_w_(qs, vs, model: RobotModel, params: ModelParams, frame) -> np.ndarray:
    """EE angular velocities (LOCAL_WORLD_ALIGNED), [N, 3]."""
    fid = _fid(model, frame)
    return _vmap(
        lambda q, v: kinematics.frame_velocity(model, params, q, v, fid,
                                               "local_world_aligned")[:3],
        params, qs, vs)


def get_u_grav(qs, model: RobotModel, params: ModelParams) -> np.ndarray:
    """Gravity-compensation torques along a trajectory, [N, nv]."""
    return _vmap(lambda q: dynamics.generalized_gravity(model, params, q),
                 params, qs)
