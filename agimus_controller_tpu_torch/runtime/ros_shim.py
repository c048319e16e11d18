"""Optional ROS 2 interop shim: the reference's topic graph over the engine.

The reference deploys as 4 ROS nodes wired by DDS topics
(`agimus_controller_ros/agimus_controller.py:215-300`; topic graph
`README.md:93-196`).  The engine here is transport-free (SURVEY.md §5) —
this shim is the "optional adapter exporting the same topic names" that
survey allows: a robot already running `linear_feedback_controller` can
keep its topic wiring and swap the controller node for this one.

Two transports behind one interface:

- ``MessageBus`` (default): in-process pub/sub queues.  Zero dependencies,
  used by tests and single-process deployments; payloads are the engine's
  native wire dataclasses (`Sensor`, `Control`, `WeightedTrajectoryPoint`).
- ``RclpyBus``: created by :func:`make_bus` when ``rclpy`` is importable
  and ``use_ros=True``.  Each topic becomes a real ROS 2
  publisher/subscription; payload conversion to the reference's message
  types (`linear_feedback_controller_msgs`, `agimus_msgs`) is delegated to
  registered codecs so the engine itself never imports ROS.

The engine remains importable without ROS: nothing in this module imports
``rclpy`` at module scope.

Port of the JAX package's `runtime/ros_shim.py` over the port's
`ControllerRuntime`; `RclpyBus`'s `repr` fallback for topics without a
codec is the reference's, kept as it is.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..mpc.buffer import WeightedTrajectoryPoint
from .controller import Control, ControllerRuntime, Sensor

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# transport
# ----------------------------------------------------------------------
class MessageBus:
    """In-process pub/sub with ROS-style topic names.

    Delivery is synchronous (subscriber callbacks run in `publish`) —
    the single-process analog of intra-process DDS; the reference's QoS
    depth is modeled by an optional bounded history per topic."""

    def __init__(self):
        self._subs: Dict[str, List[Callable[[Any], None]]] = defaultdict(list)
        self._history: Dict[str, List[Any]] = defaultdict(list)
        self._depth: Dict[str, int] = {}

    def advertise(self, topic: str, depth: int = 10) -> None:
        self._depth[topic] = depth

    def subscribe(self, topic: str, callback: Callable[[Any], None]) -> None:
        self._subs[topic].append(callback)

    def publish(self, topic: str, msg: Any) -> None:
        hist = self._history[topic]
        hist.append(msg)
        depth = self._depth.get(topic, 10)
        if len(hist) > depth:
            del hist[: len(hist) - depth]
        for cb in self._subs[topic]:
            cb(msg)

    def latest(self, topic: str) -> Optional[Any]:
        hist = self._history.get(topic)
        return hist[-1] if hist else None

    def history(self, topic: str) -> List[Any]:
        return list(self._history.get(topic, ()))


class RclpyBus:
    """ROS 2 transport: every topic is a real publisher/subscription.

    ``codecs`` maps topic name -> (ros_msg_type, encode, decode): encode
    turns an engine payload into the ROS message, decode the reverse.
    Topics without a codec pass payloads through `std_msgs/String` repr —
    enough for bring-up; production wiring registers the
    `linear_feedback_controller_msgs`/`agimus_msgs` codecs."""

    def __init__(self, node_name: str,
                 codecs: Optional[Dict[str, Tuple[Any, Callable, Callable]]]
                 = None):
        import rclpy  # deferred: engine imports stay ROS-free
        from rclpy.node import Node

        if not rclpy.ok():
            rclpy.init()
        self._node: "Node" = rclpy.create_node(node_name)
        self._codecs = codecs or {}
        self._pubs: Dict[str, Any] = {}

    def _codec(self, topic):
        if topic in self._codecs:
            return self._codecs[topic]
        from std_msgs.msg import String

        return (String,
                lambda payload: String(data=repr(payload)),
                lambda msg: msg.data)

    def advertise(self, topic: str, depth: int = 10) -> None:
        mtype, _, _ = self._codec(topic)
        self._pubs[topic] = self._node.create_publisher(mtype, topic, depth)

    def subscribe(self, topic: str, callback: Callable[[Any], None]) -> None:
        mtype, _, decode = self._codec(topic)
        self._node.create_subscription(
            mtype, topic, lambda msg: callback(decode(msg)), 10)

    def publish(self, topic: str, msg: Any) -> None:
        if topic not in self._pubs:
            self.advertise(topic)
        _, encode, _ = self._codec(topic)
        self._pubs[topic].publish(encode(msg))

    def spin_once(self, timeout_sec: float = 0.0) -> None:
        import rclpy

        rclpy.spin_once(self._node, timeout_sec=timeout_sec)


def make_bus(node_name: str = "agimus_controller_node",
             use_ros: bool = False, codecs=None):
    """MessageBus, or RclpyBus when requested AND rclpy is importable."""
    if use_ros:
        try:
            return RclpyBus(node_name, codecs)
        except ImportError:
            logger.warning(
                "use_ros=True but rclpy is not importable; "
                "falling back to the in-process MessageBus")
    return MessageBus()


# ----------------------------------------------------------------------
# node shims (topic names and directions match README.md:93-196)
# ----------------------------------------------------------------------
CONTROLLER_PUBLISHERS = (
    "control",          # linear_feedback_controller_msgs/Control
    "mpc_debug",        # agimus_msgs/MpcDebug (gated by publish_debug_data)
    "ocp_solve_time",   # builtin_interfaces/Duration
    "ocp_x0",           # state used by the MPC (offline replay)
    "mpc_buffer_size",  # reference publishes it each tick (`:453-454`)
)
CONTROLLER_SUBSCRIBERS = (
    "sensor",                   # linear_feedback_controller_msgs/Sensor
    "mpc_input",                # agimus_msgs/MpcInput
    "robot_description",        # std_msgs/String (URDF)
    "environment_description",  # std_msgs/String (URDF)
    "robot_srdf_description",   # std_msgs/String (SRDF)
    "joint_state",              # sensor_msgs/JointState
)
TRAJECTORY_PUBLISHER_PUBLISHERS = ("mpc_input",)
TRAJECTORY_PUBLISHER_SUBSCRIBERS = ("sensor", "robot_description")
DEBUGGER_PUBLISHERS = ("mpc_states_prediction_markers",)
DEBUGGER_SUBSCRIBERS = (
    "mpc_debug", "robot_description", "environment_description",
    "robot_srdf_description", "joint_state",
)


@dataclasses.dataclass
class MpcDebugMsg:
    """`agimus_msgs/MpcDebug` analog (reference fills it in
    `ros_utils.py:295-317`): solver telemetry + per-cost streams."""

    kkt_norm: float = 0.0
    nb_iter: int = 0
    nb_qp_iter: int = 0
    problem_solved: bool = False
    states_prediction: Optional[np.ndarray] = None  # [T+1, nx]
    controls_prediction: Optional[np.ndarray] = None  # [T, nu]
    references: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)
    residuals: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)


class ControllerNodeShim:
    """`agimus_controller_node` over a `ControllerRuntime`.

    Maps the runtime's transport-free I/O 1:1 onto the reference's topics:
    inbound `sensor` -> `set_sensor`, `mpc_input` -> `append_reference`;
    each `tick()` publishes `control` (+ debug topics when
    `publish_debug_data`)."""

    publishers = CONTROLLER_PUBLISHERS
    subscribers = CONTROLLER_SUBSCRIBERS

    def __init__(self, runtime: ControllerRuntime, bus=None,
                 publish_debug_data: Optional[bool] = None):
        self.bus = bus if bus is not None else MessageBus()
        self.runtime = runtime
        self._pub_debug = (runtime.params.publish_debug_data
                           if publish_debug_data is None
                           else publish_debug_data)
        self.descriptions: Dict[str, str] = {}
        self.last_joint_state = None
        for topic in self.publishers:
            self.bus.advertise(topic)
        self.bus.subscribe("sensor", self._on_sensor)
        self.bus.subscribe("mpc_input", self._on_mpc_input)
        for topic in ("robot_description", "environment_description",
                      "robot_srdf_description"):
            self.bus.subscribe(topic, self._make_desc_cb(topic))
        self.bus.subscribe("joint_state", self._on_joint_state)
        # runtime callbacks -> topics
        runtime.control_callbacks.append(
            lambda c: self.bus.publish("control", c))
        if self._pub_debug:
            runtime.solve_time_callbacks.append(
                lambda s: self.bus.publish("ocp_solve_time", s))
            runtime.buffer_size_callbacks.append(
                lambda n: self.bus.publish("mpc_buffer_size", n))

    # -- inbound ---------------------------------------------------------
    def _on_sensor(self, msg: Sensor) -> None:
        self.runtime.set_sensor(msg)

    def _on_mpc_input(self, msg: WeightedTrajectoryPoint) -> None:
        self.runtime.append_reference(msg)

    def _make_desc_cb(self, topic: str):
        def cb(msg: str) -> None:
            self.descriptions[topic] = msg

        return cb

    def _on_joint_state(self, msg) -> None:
        self.last_joint_state = msg

    # -- tick ------------------------------------------------------------
    def tick(self, now_ns: Optional[int] = None) -> Optional[Control]:
        """One `run_callback`: step the runtime; publish the debug tail."""
        control = self.runtime.step(now_ns=now_ns)
        if control is None or not self._pub_debug:
            return control
        sensor = self.runtime._sensor
        if sensor is not None:
            self.bus.publish("ocp_x0", np.concatenate(
                [sensor.position, sensor.velocity]))
        ocp = self.runtime._mpc._ocp
        res = getattr(ocp, "ocp_results", None)
        dbg = getattr(ocp, "debug_data", None)
        if dbg is not None:
            self.bus.publish("mpc_debug", MpcDebugMsg(
                kkt_norm=float(getattr(dbg, "kkt_norm", 0.0) or 0.0),
                nb_iter=int(getattr(dbg, "nb_iter", 0) or 0),
                nb_qp_iter=int(getattr(dbg, "nb_qp_iter", 0) or 0),
                problem_solved=bool(getattr(dbg, "problem_solved", False)),
                states_prediction=(None if res is None else res.states),
                controls_prediction=(
                    None if res is None else res.feed_forward_terms),
                references=dict(getattr(dbg, "references", {}) or {}),
                residuals=dict(getattr(dbg, "residuals", {}) or {}),
            ))
        return control


class TrajectoryPublisherShim:
    """`simple_trajectory_publisher` topic surface: publishes `mpc_input`
    points from any generator callable; consumes `sensor` to seed the
    trajectory at the measured state (reference behavior)."""

    publishers = TRAJECTORY_PUBLISHER_PUBLISHERS
    subscribers = TRAJECTORY_PUBLISHER_SUBSCRIBERS

    def __init__(self, bus, point_source: Callable[
            [Optional[Sensor]], Optional[WeightedTrajectoryPoint]]):
        self.bus = bus
        self._source = point_source
        self._sensor: Optional[Sensor] = None
        self.bus.advertise("mpc_input")
        self.bus.subscribe("sensor", self._on_sensor)
        self.bus.subscribe("robot_description", lambda m: None)

    def _on_sensor(self, msg: Sensor) -> None:
        self._sensor = msg

    def tick(self) -> Optional[WeightedTrajectoryPoint]:
        point = self._source(self._sensor)
        if point is not None:
            self.bus.publish("mpc_input", point)
        return point


class DebuggerNodeShim:
    """`mpc_debugger_node` topic surface: consumes `mpc_debug`, publishes
    state-prediction markers (here: the raw [T+1, nx] prediction array —
    the viz layer renders it, `runtime/debugger.py`)."""

    publishers = DEBUGGER_PUBLISHERS
    subscribers = DEBUGGER_SUBSCRIBERS

    def __init__(self, bus):
        self.bus = bus
        self.last_debug: Optional[MpcDebugMsg] = None
        self.bus.advertise("mpc_states_prediction_markers")
        self.bus.subscribe("mpc_debug", self._on_debug)
        for topic in ("robot_description", "environment_description",
                      "robot_srdf_description", "joint_state"):
            self.bus.subscribe(topic, lambda m: None)

    def _on_debug(self, msg: MpcDebugMsg) -> None:
        self.last_debug = msg
        if msg.states_prediction is not None:
            self.bus.publish(
                "mpc_states_prediction_markers", msg.states_prediction)


def topic_graph() -> Dict[str, Dict[str, Tuple[str, ...]]]:
    """The shim's node->topics map, for asserting parity with the
    reference's ROS API section (`README.md:93-196`)."""
    return {
        "agimus_controller_node": {
            "publishers": CONTROLLER_PUBLISHERS,
            "subscribers": CONTROLLER_SUBSCRIBERS,
        },
        "simple_trajectory_publisher": {
            "publishers": TRAJECTORY_PUBLISHER_PUBLISHERS,
            "subscribers": TRAJECTORY_PUBLISHER_SUBSCRIBERS,
        },
        "mpc_debugger_node": {
            "publishers": DEBUGGER_PUBLISHERS,
            "subscribers": DEBUGGER_SUBSCRIBERS,
        },
    }
