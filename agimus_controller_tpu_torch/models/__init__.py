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
from .tiago_pro import (
    TIAGO_PRO_LEFT_ARM_JOINTS,
    TIAGO_PRO_Q_READY,
    load_tiago_pro,
    tiago_pro_urdf,
)

__all__ = [
    "Frame",
    "Geometry",
    "ModelParams",
    "RobotModel",
    "RobotModelParameters",
    "RobotModels",
    "TIAGO_PRO_LEFT_ARM_JOINTS",
    "TIAGO_PRO_Q_READY",
    "build_model_from_urdf",
    "build_robot_models",
    "load_tiago_pro",
    "params_from_numpy",
    "tiago_pro_urdf",
]
