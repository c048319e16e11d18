"""Trajectory generator base and shared primitives.

Port of the JAX package's `trajectories/base.py` (reference
`trajectories/trajectory_base.py:9-51`, `quintic_trajectory.py:6-42`,
`weight_increasing.py:4-20`, `sine_wave_params.py`). Generators are
host-side objects streaming `WeightedTrajectoryPoint`s at the control rate;
their forward kinematics and RNEA run through `ops.kinematics` and
`ops.dynamics` on the device and dtype of the `ModelParams` that
`initialize` is given, and come back as numpy arrays.
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.model import ModelParams, RobotModel
from ..mpc.buffer import WeightedTrajectoryPoint
from ..ops import dynamics, kinematics


class QuinticTrajectory:
    """Smooth-start ramp p(s) = 10 s^3 - 15 s^4 + 6 s^5 per axis, with value,
    velocity and acceleration (reference `QuinticTrajectory`)."""

    def __init__(self, scale_duration: Sequence[float]):
        self.scale_duration = np.asarray(scale_duration, dtype=float)

    def get_value_at_t(self, t: float):
        T = self.scale_duration
        s = np.clip(np.divide(t, T, out=np.ones_like(T), where=T > 0), 0.0, 1.0)
        p = 10 * s**3 - 15 * s**4 + 6 * s**5
        v = np.where((t > 0) & (t < T), (30 * s**2 - 60 * s**3 + 30 * s**4) / T, 0.0)
        a = np.where((t > 0) & (t < T), (60 * s - 180 * s**2 + 120 * s**3) / T**2, 0.0)
        p = np.where(t <= 0, 0.0, np.where(t >= T, 1.0, p))
        return p, v, a


class WeightIncreasing:
    """w(t) = max_weight * tanh(t * atanh(percent) / time_reach_percent)
    (reference `WeightIncreasing.get_weight_at_t`)."""

    def __init__(self, max_weight: float, percent: float, time_reach_percent: float):
        self.max_weight = max_weight
        self.percent = percent
        self.time_reach_percent = time_reach_percent

    def get_weight_at_t(self, t: float):
        return self.max_weight * np.tanh(
            t * np.arctanh(self.percent) / self.time_reach_percent
        )


class SinWaveParams:
    """Sine wave parameters (reference `SinWaveParams`): per-axis amplitude,
    period, and quintic ramp duration; scalar or length-1 entries
    broadcast, anything else must match the per-axis length."""

    def __init__(self, amplitude, period, scale_duration):
        amp = np.atleast_1d(np.asarray(amplitude, dtype=float))
        per = np.atleast_1d(np.asarray(period, dtype=float))
        dur = np.atleast_1d(np.asarray(scale_duration, dtype=float))
        n = max(amp.size, per.size, dur.size)
        out = []
        for name, arr in (("amplitude", amp), ("period", per),
                          ("scale_duration", dur)):
            if arr.size == 1:
                arr = np.full(n, arr[0])
            elif arr.size != n:
                raise ValueError(
                    f"SinWaveParams.{name} has length {arr.size}, expected "
                    f"1 or {n} (per-axis)")
            out.append(arr)
        self.amplitude = out[0].tolist()
        self.period = out[1].tolist()
        self.scale_duration = out[2].tolist()

    @property
    def frequency(self):
        p = np.asarray(self.period, dtype=float)
        safe = np.where(np.abs(p) < 1e-6, np.nan, p)
        return np.nan_to_num(1.0 / safe, nan=0.0).tolist()

    @property
    def pulsation(self):
        return (2 * np.pi * np.asarray(self.frequency)).tolist()


class TrajectoryBase(abc.ABC):
    """Generator interface: `initialize(model, params, q0)` then
    `get_traj_point_at_t(t)` (reference `TrajectoryBase`)."""

    def __init__(self, ee_frame_name: str) -> None:
        self.ee_frame_name = ee_frame_name
        self.trajectory_is_done = False
        self.model: Optional[RobotModel] = None
        self.params: Optional[ModelParams] = None
        self.ee_frame_id: Optional[int] = None
        self.q0 = None
        self.is_initialized = False

    def initialize(self, model: RobotModel, params: ModelParams, q0: np.ndarray) -> None:
        self.model = model
        self.params = params
        self.ee_frame_id = model.frame_id(self.ee_frame_name)
        self.q0 = np.asarray(q0, dtype=float).copy()
        self.is_initialized = True

    def _tensor(self, a):
        ref = self.params.joint_rot
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=ref.dtype,
                               device=ref.device)

    def get_end_effector_pose_from_q(self, q) -> Tuple[np.ndarray, np.ndarray]:
        R, p = kinematics.frame_placement(self.model, self.params,
                                          self._tensor(q), self.ee_frame_id)
        return R.cpu().numpy(), p.cpu().numpy()

    def effort_from_rnea(self, q, dq, ddq) -> np.ndarray:
        tau = dynamics.rnea(self.model, self.params, self._tensor(q),
                            self._tensor(dq), self._tensor(ddq))
        return tau.cpu().numpy()

    @abc.abstractmethod
    def get_traj_point_at_t(self, t: float) -> WeightedTrajectoryPoint:
        ...
