"""Reference trajectory generators: quintic ramps, sine waves in
configuration and cartesian space (with their Gauss-Newton IK), weight
schedules, user-supplied arrays and the visual-servoing state machine (the
JAX package's `trajectories/`)."""

from .base import QuinticTrajectory, SinWaveParams, TrajectoryBase, WeightIncreasing
from .generic import GenericTrajectory, GenericVisualServoingTrajectory, VisualServoingState
from .sine_waves import (
    SinusWaveCartesianSpace,
    SinusWaveCartesianSpaceWeightIncreasing,
    SinusWaveConfigurationSpace,
)

__all__ = [
    "GenericTrajectory",
    "GenericVisualServoingTrajectory",
    "QuinticTrajectory",
    "SinWaveParams",
    "SinusWaveCartesianSpace",
    "SinusWaveCartesianSpaceWeightIncreasing",
    "SinusWaveConfigurationSpace",
    "TrajectoryBase",
    "VisualServoingState",
    "WeightIncreasing",
]
