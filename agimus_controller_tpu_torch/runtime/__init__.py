"""Host runtime: the controller-node lifecycle without ROS (reference L6,
`agimus_controller_ros/agimus_controller.py`). In-process channels replace
DDS topics; the same semantics are preserved (buffer gating, constant-delay
compensation, control message contents, telemetry). Port of the JAX
package's `runtime/`: the controller and the engine config, the recorder
and its bag containers, checkpoints, the trajectory-publisher process, the
ROS shim, the debugger and the meshcat scene export."""

from .config import EngineConfig, load_engine_config
from .controller import Control, ControllerRuntime, RuntimeParams, Sensor
from .recorder import MPCRecorder

__all__ = [
    "Control",
    "ControllerRuntime",
    "EngineConfig",
    "MPCRecorder",
    "RuntimeParams",
    "Sensor",
    "load_engine_config",
]
