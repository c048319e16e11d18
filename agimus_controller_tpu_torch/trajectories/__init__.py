"""Reference trajectory generators: quintic ramps, weight schedules,
user-supplied arrays and the visual-servoing state machine (the JAX
package's `trajectories/`, without the sine waves and their IK)."""

from .base import QuinticTrajectory, SinWaveParams, TrajectoryBase, WeightIncreasing
from .generic import GenericTrajectory, GenericVisualServoingTrajectory, VisualServoingState

__all__ = [
    "GenericTrajectory",
    "GenericVisualServoingTrajectory",
    "QuinticTrajectory",
    "SinWaveParams",
    "TrajectoryBase",
    "VisualServoingState",
    "WeightIncreasing",
]
