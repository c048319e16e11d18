"""Robot model layer: URDF/SRDF (or xacro) -> static topology + `ModelParams`
tensors, and the reference-API model factory (`RobotModelParameters`,
`build_robot_models`)."""

from .model import Frame, Geometry, ModelParams, RobotModel, params_from_numpy
from .urdf import (
    RobotModelParameters,
    RobotModels,
    build_model_from_urdf,
    build_robot_models,
)

__all__ = [
    "Frame",
    "Geometry",
    "ModelParams",
    "RobotModel",
    "RobotModelParameters",
    "RobotModels",
    "build_model_from_urdf",
    "build_robot_models",
    "params_from_numpy",
]
