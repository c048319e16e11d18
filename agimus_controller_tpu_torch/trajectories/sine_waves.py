"""Sine-wave trajectory generators + jitted Gauss-Newton IK.

Reference: `trajectories/sine_wave_configuration_space.py:15-72` (joint-space
sine with analytic derivatives and RNEA effort),
`sine_wave_cartesian_space.py:15-142` (EE-space sine; damped-free
Gauss-Newton IK with masked DoF, velocity IK via the LOCAL_WORLD_ALIGNED
Jacobian), `sine_wave_cartesian_space_weight_increasing.py:19-108` (two-target
switching at sine extrema with tanh-ramped per-axis pose weights).

Port of the JAX package's `trajectories/sine_waves.py`. Where the JAX IK is
a jitted `lax.while_loop`, this one is a Python loop with the same stopping
rule (error norm >= precision and fewer than `it_max` iterations), so it
takes the same iterations; its FK and Jacobians run on the device and dtype
of the `ModelParams` given to `initialize`, one host read of the error norm
per iteration (the reference runs up to 10000 python-loop pinocchio calls
per point)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..mpc.buffer import TrajectoryPoint, TrajectoryPointWeights, WeightedTrajectoryPoint
from ..ops import kinematics, spatial
from .base import QuinticTrajectory, SinWaveParams, TrajectoryBase, WeightIncreasing


class SinusWaveConfigurationSpace(TrajectoryBase):
    """q(t) = q0 + A * quintic(t) * sin(w t), analytic dq/ddq, u = RNEA."""

    def __init__(self, sine_wave_params: SinWaveParams, ee_frame_name: str,
                 w_q, w_qdot, w_qddot, w_robot_effort, w_pose):
        super().__init__(ee_frame_name)
        self.quint_traj = QuinticTrajectory(sine_wave_params.scale_duration)
        self.amp = np.asarray(sine_wave_params.amplitude, dtype=float)
        self.w = np.asarray(sine_wave_params.pulsation, dtype=float)
        self.w_q = np.asarray(w_q, dtype=float)
        self.w_qdot = np.asarray(w_qdot, dtype=float)
        self.w_qddot = np.asarray(w_qddot, dtype=float)
        self.w_robot_effort = np.asarray(w_robot_effort, dtype=float)
        self.w_pose = np.asarray(w_pose, dtype=float)

    def get_traj_point_at_t(self, t: float) -> WeightedTrajectoryPoint:
        quint, dquint, ddquint = self.quint_traj.get_value_at_t(t)
        sin_wt, cos_wt = np.sin(self.w * t), np.cos(self.w * t)
        q = self.q0 + self.amp * quint * sin_wt
        dq = self.amp * (dquint * sin_wt + quint * self.w * cos_wt)
        ddq = self.amp * (
            ddquint * sin_wt + 2 * dquint * self.w * cos_wt - quint * self.w**2 * sin_wt
        )
        u = self.effort_from_rnea(q, dq, ddq)
        pose = self.get_end_effector_pose_from_q(q)
        point = TrajectoryPoint(
            time_ns=int(t * 1e9), robot_configuration=q, robot_velocity=dq,
            robot_acceleration=ddq, robot_effort=u,
            end_effector_poses={self.ee_frame_name: pose},
        )
        weights = TrajectoryPointWeights(
            w_robot_configuration=self.w_q, w_robot_velocity=self.w_qdot,
            w_robot_acceleration=self.w_qddot, w_robot_effort=self.w_robot_effort,
            w_end_effector_poses={self.ee_frame_name: self.w_pose},
        )
        return WeightedTrajectoryPoint(point=point, weights=weights)


class SinusWaveCartesianSpace(TrajectoryBase):
    """EE-space sine target tracked through Gauss-Newton IK.

    ``mask``: IK DoF selection ordered [x, y, z, roll, pitch, yaw]
    (reference wire order; internally remapped to the [w; v] twist order)."""

    def __init__(self, sine_wave_params: SinWaveParams, ee_frame_name: str,
                 w_q, w_qdot, w_qddot, w_robot_effort, w_pose,
                 mask: Sequence[bool] = (True,) * 6):
        super().__init__(ee_frame_name)
        self.quint_traj = QuinticTrajectory(sine_wave_params.scale_duration)
        self.amp = np.asarray(sine_wave_params.amplitude, dtype=float)
        self.w = np.asarray(sine_wave_params.pulsation, dtype=float)
        self.w_q = np.asarray(w_q, dtype=float)
        self.w_qdot = np.asarray(w_qdot, dtype=float)
        self.w_qddot = np.asarray(w_qddot, dtype=float)
        self.w_robot_effort = np.asarray(w_robot_effort, dtype=float)
        self.w_pose = np.asarray(w_pose, dtype=float)
        # [x,y,z,r,p,y] -> [w(3); v(3)]
        m = np.asarray(mask, dtype=bool)
        self.mask_wv = np.concatenate([m[3:], m[:3]])
        self.ik_q = None
        self.last_ik_iters = None  # iterations of the last IK solve
        self._ik = None
        self._vel_ik = None

    def initialize(self, model, params, q0):
        super().initialize(model, params, q0)
        self.ik_q = self.q0.copy()
        self.ee_init_pos = self.get_end_effector_pose_from_q(self.q0)
        fid = self.ee_frame_id
        mask = self._tensor(self.mask_wv)
        eye6 = self._tensor(np.eye(6))

        def error_of(q, des_rot, des_trans):
            R, p = kinematics.frame_placement(model, params, q, fid)
            dR, dp = spatial.se3_mul(spatial.se3_inv((des_rot, des_trans)), (R, p))
            return spatial.log6(dR, dp) * mask

        def ik(q_init, des_rot, des_trans, precision, it_max):
            """Masked Gauss-Newton IK (reference `inverse_kinematics`,
            `sine_wave_cartesian_space.py:62-111`)."""
            q = q_init
            err_norm = float(torch.linalg.norm(error_of(q, des_rot, des_trans)))
            iters = 0
            while err_norm >= precision and iters < it_max:
                err = error_of(q, des_rot, des_trans)
                J = kinematics.frame_jacobian(model, params, q, fid, "local") * mask[:, None]
                JJt = J @ J.T + 1e-10 * eye6
                dq = -J.T @ torch.linalg.solve(JJt, err)
                q = kinematics.integrate(model, q, dq)
                err_norm = float(torch.linalg.norm(error_of(q, des_rot, des_trans)))
                iters += 1
            return q, err_norm, iters

        def vel_ik(q, des_vel_wv):
            J = kinematics.frame_jacobian(model, params, q, fid, "local_world_aligned")
            J = J * mask[:, None]
            JJt = J @ J.T + 1e-10 * eye6
            return J.T @ torch.linalg.solve(JJt, des_vel_wv * mask)

        self._ik = ik
        self._vel_ik = vel_ik

    def inverse_kinematics(self, des_rot, des_trans, des_vel_wv,
                           precision=1e-5, it_max=10000):
        q, err_norm, iters = self._ik(
            self._tensor(self.ik_q), self._tensor(des_rot),
            self._tensor(des_trans), precision, it_max)
        self.last_ik_iters = iters
        if err_norm >= precision:
            raise RuntimeError(
                f"Inverse kinematics failed to converge, error {err_norm} "
                f"after {iters} iterations")
        self.ik_q = q.cpu().numpy()
        dq = self._vel_ik(q, self._tensor(des_vel_wv)).cpu().numpy()
        return self.ik_q.copy(), dq

    def get_traj_point_at_t(self, t: float) -> WeightedTrajectoryPoint:
        quint, dquint, _ = self.quint_traj.get_value_at_t(t)
        sin_wt, cos_wt = np.sin(self.w * t), np.cos(self.w * t)
        des_rot = self.ee_init_pos[0].copy()
        des_trans = self.ee_init_pos[1] + self.amp * quint * sin_wt
        des_vel = np.zeros(6)  # [w; v]
        des_vel[3:] = self.amp * (dquint * sin_wt + quint * self.w * cos_wt)
        q, dq = self.inverse_kinematics(des_rot, des_trans, des_vel)
        ddq = np.zeros_like(dq)
        u = self.effort_from_rnea(q, dq, ddq)
        point = TrajectoryPoint(
            time_ns=int(t * 1e9), robot_configuration=q, robot_velocity=dq,
            robot_acceleration=ddq, robot_effort=u,
            end_effector_poses={self.ee_frame_name: (des_rot, des_trans)},
        )
        weights = TrajectoryPointWeights(
            w_robot_configuration=self.w_q, w_robot_velocity=self.w_qdot,
            w_robot_acceleration=self.w_qddot, w_robot_effort=self.w_robot_effort,
            w_end_effector_poses={self.ee_frame_name: self.w_pose.copy()},
        )
        return WeightedTrajectoryPoint(point=point, weights=weights)


class SinusWaveCartesianSpaceWeightIncreasing(SinusWaveCartesianSpace):
    """Per-axis two-target switching at the sine extrema with tanh-increasing
    pose weights (reference
    `sine_wave_cartesian_space_weight_increasing.py:19-108`)."""

    def __init__(self, sine_wave_params: SinWaveParams, ee_frame_name: str,
                 w_q, w_qdot, w_qddot, w_robot_effort,
                 weight_increasing: WeightIncreasing,
                 mask: Sequence[bool] = (True,) * 6):
        super().__init__(sine_wave_params, ee_frame_name, w_q, w_qdot, w_qddot,
                         w_robot_effort, np.zeros(6), mask=mask)
        self.weight_increasing = weight_increasing

    def get_targets_time(self, t: float):
        """Time since the last extremum per axis: the target holds at the
        sine extremes (+-A) and the weight ramps from each switch
        (reference `get_targets_time`, `:51-84`)."""
        period = np.where(self.w > 0, 2 * np.pi / np.where(self.w > 0, self.w, 1.0), np.inf)
        # extrema at quarter and three-quarter period
        phase = np.mod(t, period)
        t_since = np.where(
            phase < 0.25 * period, phase + 0.25 * period,
            np.where(phase < 0.75 * period, phase - 0.25 * period, phase - 0.75 * period),
        )
        sign = np.where(np.mod(phase - 0.25 * period, period) < 0.5 * period, 1.0, -1.0)
        return t_since, sign

    def get_traj_point_at_t(self, t: float) -> WeightedTrajectoryPoint:
        quint, _, _ = self.quint_traj.get_value_at_t(t)
        t_since, sign = self.get_targets_time(t)
        des_rot = self.ee_init_pos[0].copy()
        des_trans = self.ee_init_pos[1] + self.amp * quint * sign
        q, dq = self.inverse_kinematics(des_rot, des_trans, np.zeros(6))
        u = self.effort_from_rnea(q, np.zeros_like(q), np.zeros_like(q))
        w_axis = self.weight_increasing.get_weight_at_t(t_since)
        w_pose = np.concatenate([np.broadcast_to(w_axis, (3,)), np.full(3, np.max(w_axis))])
        point = TrajectoryPoint(
            time_ns=int(t * 1e9), robot_configuration=q, robot_velocity=np.zeros_like(q),
            robot_acceleration=np.zeros_like(q), robot_effort=u,
            end_effector_poses={self.ee_frame_name: (des_rot, des_trans)},
        )
        weights = TrajectoryPointWeights(
            w_robot_configuration=self.w_q, w_robot_velocity=self.w_qdot,
            w_robot_acceleration=self.w_qddot, w_robot_effort=self.w_robot_effort,
            w_end_effector_poses={self.ee_frame_name: w_pose},
        )
        return WeightedTrajectoryPoint(point=point, weights=weights)
