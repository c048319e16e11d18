"""Host runtime: the controller-node lifecycle without ROS (reference L6,
`agimus_controller_ros/agimus_controller.py`) and the engine config loader.
Port of the JAX package's `runtime/controller.py` and `runtime/config.py`;
its publisher, recorder, debugger, checkpoint, bag readers, ROS shim and
meshcat viewer are not ported yet (ROADMAP queue 1, slice 14)."""

from .config import EngineConfig, load_engine_config
from .controller import Control, ControllerRuntime, RuntimeParams, Sensor

__all__ = [
    "Control",
    "ControllerRuntime",
    "EngineConfig",
    "RuntimeParams",
    "Sensor",
    "load_engine_config",
]
