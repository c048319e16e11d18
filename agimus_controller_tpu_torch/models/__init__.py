"""Robot model layer: URDF/SRDF -> static topology + `ModelParams` tensors."""

from .model import Frame, Geometry, ModelParams, RobotModel, params_from_numpy
from .urdf import build_model_from_urdf

__all__ = [
    "Frame",
    "Geometry",
    "ModelParams",
    "RobotModel",
    "build_model_from_urdf",
    "params_from_numpy",
]
