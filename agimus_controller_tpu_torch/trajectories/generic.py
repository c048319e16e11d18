"""User-supplied trajectories and the visual-servoing state machine.

Port of the JAX package's `trajectories/generic.py` (reference
`trajectories/generic_trajectory.py:13-87`: array ingestion with RNEA
efforts and FK poses, index-stepped playback with a done flag;
`generic_visual_servoing_trajectory.py:11-141`: the IDLE /
USING_VISUAL_SERVOING / COMING_BACK_TO_IDLE state machine keyed on an index
range, object-frame re-expression of the references, a tanh-ramped
translation weight with scaled rotation and collision weights, the ramp time
clamped at `time_reach_percent`). Host-side numpy objects.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np

from ..mpc.buffer import TrajectoryPoint, TrajectoryPointWeights, WeightedTrajectoryPoint
from .base import TrajectoryBase, WeightIncreasing


class GenericTrajectory(TrajectoryBase):
    """Playback of user-supplied (q, dq, ddq) arrays."""

    def __init__(self, ee_frame_name, w_q, w_qdot, w_qddot, w_robot_effort,
                 w_pose, w_collision_avoidance=0.0):
        super().__init__(ee_frame_name)
        self.trajectory: Optional[List[TrajectoryPoint]] = None
        self.traj_idx = 0
        self.w_q = np.asarray(w_q, dtype=float)
        self.w_qdot = np.asarray(w_qdot, dtype=float)
        self.w_qddot = np.asarray(w_qddot, dtype=float)
        self.w_robot_effort = np.asarray(w_robot_effort, dtype=float)
        self.w_pose = np.asarray(w_pose, dtype=float)
        self.robot_frame = self.ee_frame_name
        self.w_collision_avoidance = w_collision_avoidance

    def build_trajectory_from_q_dq_ddq_arrays(
        self, q_array, dq_array, ddq_array
    ) -> List[TrajectoryPoint]:
        """(q, dq, ddq) arrays -> TrajectoryPoints with RNEA efforts and FK
        end-effector poses (reference `:37-65`)."""
        if not len(q_array) == len(dq_array) == len(ddq_array):
            raise ValueError("q, dq and ddq arrays must have the same length")
        out = []
        for q, dq, ddq in zip(q_array, dq_array, ddq_array):
            out.append(TrajectoryPoint(
                robot_configuration=np.asarray(q, dtype=float),
                robot_velocity=np.asarray(dq, dtype=float),
                robot_acceleration=np.asarray(ddq, dtype=float),
                robot_effort=self.effort_from_rnea(q, dq, ddq),
                end_effector_poses={
                    self.robot_frame: self.get_end_effector_pose_from_q(q)},
            ))
        return out

    def add_trajectory(self, trajectory: List[TrajectoryPoint]) -> None:
        self.trajectory_is_done = False
        if self.trajectory is None:
            self.trajectory = list(trajectory)
        else:
            self.trajectory.extend(list(trajectory))

    def _weights(self, w_pose=None, w_coll=None) -> TrajectoryPointWeights:
        return TrajectoryPointWeights(
            w_robot_configuration=self.w_q,
            w_robot_velocity=self.w_qdot,
            w_robot_acceleration=self.w_qddot,
            w_robot_effort=self.w_robot_effort,
            w_end_effector_poses={
                self.robot_frame: self.w_pose if w_pose is None else np.asarray(w_pose)
            },
            w_collision_avoidance=(
                self.w_collision_avoidance if w_coll is None else w_coll
            ),
        )

    def get_traj_point_at_t(self, t: float) -> WeightedTrajectoryPoint:
        traj_point = self.trajectory[self.traj_idx]
        self.trajectory_is_done = self.traj_idx == len(self.trajectory) - 1
        self.traj_idx = min(self.traj_idx + 1, len(self.trajectory) - 1)
        return WeightedTrajectoryPoint(point=traj_point, weights=self._weights())


class VisualServoingState(enum.Enum):
    IDLE = 1
    USING_VISUAL_SERVOING = 2
    COMING_BACK_TO_IDLE = 3


class GenericVisualServoingTrajectory(GenericTrajectory):
    """Generic playback with a visual-servoing activation window.

    Every end-effector reference is re-expressed in the initially detected
    object frame (oMee = wMo^-1 * wMee) and streamed under the `<ee>_vs` key
    that the visual-servoing residual reads. Inside
    `visual_servoing_idx_range` the translation weight tanh-ramps up and the
    rotation and collision weights scale with it; leaving the window ramps
    them back down."""

    def __init__(self, ee_frame_name, dt, w_q, w_qdot, w_qddot, w_robot_effort,
                 w_pose, w_increasing: WeightIncreasing,
                 w_increasing_max_rotation: float,
                 w_increasing_max_collision_avoidance: float,
                 w_collision_avoidance: float = 0.0):
        super().__init__(ee_frame_name, w_q, w_qdot, w_qddot, w_robot_effort,
                         w_pose, w_collision_avoidance)
        self.w_increasing = w_increasing
        self.w_increasing_max_rotation = w_increasing_max_rotation
        self.w_increasing_max_collision_avoidance = w_increasing_max_collision_avoidance
        self.visual_servoing_state = VisualServoingState.IDLE
        self.dt = dt
        self.visual_servoing_time = 0.0
        self.init_in_world_M_object: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.robot_frame = self.ee_frame_name + "_vs"  # reference `:56`
        self.visual_servoing_idx_range = (0, 0)

    def add_trajectory(self, trajectory, visual_servoing_idx_range=(0, 0),
                       init_in_world_M_object=None):
        if init_in_world_M_object is None and (
            visual_servoing_idx_range[0] != visual_servoing_idx_range[1]
        ):
            raise ValueError("Init pose detection not set.")
        if init_in_world_M_object is not None:
            self.init_in_world_M_object = init_in_world_M_object  # (R, p)
        super().add_trajectory(trajectory)
        self.visual_servoing_idx_range = visual_servoing_idx_range
        self.traj_idx = 0
        self.trajectory = list(trajectory)

    def update_activation_of_visual_servoing(self):
        """State machine keyed on the playback index (reference `:63-76`)."""
        lo, hi = self.visual_servoing_idx_range
        if lo <= self.traj_idx < hi:
            if self.visual_servoing_state != VisualServoingState.USING_VISUAL_SERVOING:
                self.visual_servoing_time = 0.0
            self.visual_servoing_state = VisualServoingState.USING_VISUAL_SERVOING
        elif self.visual_servoing_time > 0.0:
            self.visual_servoing_state = VisualServoingState.COMING_BACK_TO_IDLE
        else:
            self.visual_servoing_state = VisualServoingState.IDLE

    def get_traj_point_at_t(self, t: float) -> WeightedTrajectoryPoint:
        self.update_activation_of_visual_servoing()
        stored = self.trajectory[self.traj_idx]
        # re-express on a copy: the reference mutates the stored point in
        # place (`:97-100`), which transforms the clamped last point again
        # on every overrun step
        traj_point = dataclasses.replace(
            stored, end_effector_poses=dict(stored.end_effector_poses))
        key = next(iter(traj_point.end_effector_poses))
        if self.init_in_world_M_object is not None:
            Rw, pw = traj_point.end_effector_poses[key]
            Ro, po = self.init_in_world_M_object
            # oMee = wMo^-1 * wMee (reference `:97-100`)
            traj_point.end_effector_poses[key] = (Ro.T @ Rw, Ro.T @ (pw - po))

        vs = self.visual_servoing_state
        if vs in (VisualServoingState.USING_VISUAL_SERVOING,
                  VisualServoingState.COMING_BACK_TO_IDLE):
            w_inc = self.w_increasing.get_weight_at_t(self.visual_servoing_time)
            w_rot = w_inc * self.w_increasing_max_rotation / self.w_increasing.max_weight
            w_pose = np.asarray([w_inc] * 3 + [w_rot] * 3)
            if vs == VisualServoingState.USING_VISUAL_SERVOING:
                # ramp time clamped so the return-to-idle duration is bounded
                # (reference `:108-111`)
                self.visual_servoing_time = min(
                    self.visual_servoing_time + self.dt,
                    self.w_increasing.time_reach_percent)
            else:
                self.visual_servoing_time -= self.dt
            w_coll = (self.w_increasing_max_collision_avoidance
                      * self.w_increasing_max_rotation / self.w_increasing.max_weight)
        else:
            w_pose = np.zeros(6)
            w_coll = self.w_collision_avoidance

        self.trajectory_is_done = self.traj_idx == len(self.trajectory) - 1
        self.traj_idx = min(self.traj_idx + 1, len(self.trajectory) - 1)
        return WeightedTrajectoryPoint(
            point=traj_point, weights=self._weights(w_pose=w_pose, w_coll=w_coll))
