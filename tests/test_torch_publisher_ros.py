"""The port's trajectory-publisher process and ROS shim
(`runtime/publisher.py`, `runtime/ros_shim.py`): `test_publisher_process.py`
and `test_ros_shim.py` on the port.

- The publisher streams 50 points with monotonic ids from a spawned child
  that builds the Panda on the CPU and imports only the port; the points
  equal the same generator's evaluated in this process; a controller
  buffer is fed through `pump_into`; a child that fails before its end of
  stream raises in `pump_into`.
- The ROS shim's node graph is the JAX shim's (and the reference README's
  ROS API section); `make_bus` falls back to the in-process `MessageBus`
  without `rclpy`; the controller, trajectory-publisher and debugger node
  shims run end to end over the bus on the port's `ControllerRuntime`
  (the ring-fed "sqp" `OCPTorch`, 2-DoF arm, f64).
"""

import sys
import time

import numpy as np
import pytest
import torch

from agimus_controller_tpu.runtime.ros_shim import topic_graph as jax_graph
from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
from agimus_controller_tpu_torch.mpc.buffer import (
    DTFactorsNSeq,
    TrajectoryBuffer,
)
from agimus_controller_tpu_torch.runtime.publisher import (
    PublisherParams,
    TrajectoryPublisherProcess,
)
from agimus_controller_tpu_torch.runtime.ros_shim import (
    ControllerNodeShim,
    DebuggerNodeShim,
    MessageBus,
    MpcDebugMsg,
    RclpyBus,
    TrajectoryPublisherShim,
    make_bus,
    topic_graph,
)
from tests._torch_publisher_traj import make_broken_traj, make_sine_traj


def _drain(pub, append, deadline_s=60.0):
    t0 = time.monotonic()
    while not pub.done and time.monotonic() - t0 < deadline_s:
        pub.pump_into(append, timeout_s=1.0)


def test_publisher_streams_points():
    params = PublisherParams(ocp_dt=0.01, rate_s=0.0, max_points=50)
    got = []
    with TrajectoryPublisherProcess(make_sine_traj, PANDA_Q_READY,
                                    params) as pub:
        _drain(pub, got.append)
    assert len(got) == 50
    assert [p.point.id for p in got] == list(range(50))
    assert got[0].point.robot_configuration.shape == (7,)
    assert np.isfinite(got[0].point.robot_effort).all()
    assert np.all(np.asarray(got[0].weights.w_robot_configuration) == 1.0)
    # the child's points are the generator's, evaluated here on the CPU
    traj = make_sine_traj()
    traj.initialize(*load_panda(dtype=torch.float64, device="cpu"),
                    np.asarray(PANDA_Q_READY, float))
    t = 0.0  # the child's clock: ocp_dt added once a point
    for k in range(50):
        if k in (0, 17, 49):
            want = traj.get_traj_point_at_t(t)
            for f in ("robot_configuration", "robot_velocity",
                      "robot_effort"):
                np.testing.assert_array_equal(getattr(got[k].point, f),
                                              getattr(want.point, f),
                                              err_msg=f)
        t += params.ocp_dt


def test_publisher_feeds_buffer():
    buf = TrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[10]))
    params = PublisherParams(ocp_dt=0.01, rate_s=0.0, max_points=30)
    with TrajectoryPublisherProcess(make_sine_traj, PANDA_Q_READY,
                                    params) as pub:
        _drain(pub, buf.append)
    assert len(buf) == 30
    assert len(buf.horizon) == 11  # horizon_indexes[-1] + 1 points


def test_publisher_child_failure_surfaces():
    pub = TrajectoryPublisherProcess(make_broken_traj, PANDA_Q_READY,
                                     PublisherParams(rate_s=0.0))
    with pub, pytest.raises(RuntimeError, match="exited with code"):
        _drain(pub, lambda p: None)


# -- the ROS shim ------------------------------------------------------------
def test_engine_importable_without_ros():
    assert "rclpy" not in sys.modules


def test_topic_graph_matches_jax_and_reference_readme():
    graph = topic_graph()
    assert graph == jax_graph()
    ctrl = graph["agimus_controller_node"]
    assert set(ctrl["publishers"]) - {
        "control", "mpc_debug", "ocp_solve_time", "ocp_x0"} == {
        "mpc_buffer_size"}
    assert set(ctrl["subscribers"]) == {
        "mpc_input", "sensor", "robot_description",
        "environment_description", "robot_srdf_description", "joint_state"}
    assert graph["simple_trajectory_publisher"] == {
        "publishers": ("mpc_input",),
        "subscribers": ("sensor", "robot_description")}
    assert set(graph["mpc_debugger_node"]["publishers"]) == {
        "mpc_states_prediction_markers"}


def test_make_bus_falls_back_without_rclpy():
    assert isinstance(make_bus(use_ros=True), MessageBus)
    assert isinstance(make_bus(), MessageBus)
    with pytest.raises(ImportError):
        RclpyBus("node")


def test_message_bus_history_depth():
    bus = MessageBus()
    bus.advertise("t", depth=3)
    seen = []
    bus.subscribe("t", seen.append)
    for i in range(5):
        bus.publish("t", i)
    assert seen == list(range(5))
    assert bus.history("t") == [2, 3, 4] and bus.latest("t") == 4
    assert bus.latest("none") is None and bus.history("none") == []


def _build_node(bus):
    """`test_ros_shim._build_node` on the port: the ring-fed "sqp"
    `OCPTorch` behind a `ControllerRuntime`, f64 on the CPU."""
    from agimus_controller_tpu_torch.models.urdf import build_model_from_urdf
    from agimus_controller_tpu_torch.mpc.mpc import MPC
    from agimus_controller_tpu_torch.mpc.ocp_base import OCPParams, OCPTorch
    from agimus_controller_tpu_torch.mpc.ring import (
        PackedTrajectoryBuffer,
        RowLayout,
    )
    from agimus_controller_tpu_torch.mpc.warm_start import (
        WarmStartReference,
        WarmStartShiftPreviousSolution,
    )
    from agimus_controller_tpu_torch.ops import dynamics, kinematics
    from agimus_controller_tpu_torch.runtime.controller import (
        ControllerRuntime,
        RuntimeParams,
    )
    from tests.test_ring_control_loop import Q0, T, URDF_2DOF
    from tests.test_torch_ocp_base import DT_EXACT, _point, _specs

    model, params = build_model_from_urdf(
        URDF_2DOF, armature=np.array([0.1, 0.1]), dtype=torch.float64,
        device="cpu")
    _, spec = _specs("goal", DT_EXACT)
    buf = PackedTrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[T]),
                                 RowLayout(spec, model), dtype=torch.float64,
                                 device="cpu")
    ocp = OCPTorch(model, params, spec, OCPParams(
        dt=DT_EXACT, horizon_size=T, solver_iters=10, max_solve_time=10.0,
        use_debug_data=True, termination_tolerance=1e-6),
        dtype=torch.float64, ring=buf.ring, device="cpu")
    assert ocp.solver_kind == "sqp"
    ws_shift = WarmStartShiftPreviousSolution()
    ws_shift.setup(model, params, spec.timesteps(), device="cpu")
    ws_ref = WarmStartReference()
    ws_ref.setup(model, params, device="cpu")
    mpc = MPC()
    mpc.setup(ocp, ws_shift, buf)
    rt = ControllerRuntime(mpc, buf, ws_ref, RuntimeParams())
    q0 = torch.as_tensor(Q0)
    R0, p0 = (a.numpy() for a in kinematics.frame_placement(
        model, params, q0, model.frame_id("tip")))
    z = torch.zeros(2, dtype=torch.float64)
    arm = dict(R0=R0, p0=p0,
               tau_g=dynamics.rnea(model, params, q0, z, z).numpy())
    return ControllerNodeShim(rt, bus=bus), (
        lambda i: _point(i, arm, DT_EXACT)), Q0, T, DT_EXACT, URDF_2DOF


def test_full_node_graph_over_the_bus():
    """sensor + mpc_input arrive as topics; tick() publishes control and
    the debug tail; the debugger node consumes mpc_debug; then five warm
    ticks through the whole graph."""
    from agimus_controller_tpu_torch.runtime.controller import Sensor

    bus = MessageBus()
    node, point, Q0, T, dt, urdf = _build_node(bus)
    debugger = DebuggerNodeShim(bus)
    counter = {"i": 0}

    def source(sensor):
        counter["i"] += 1
        return point(counter["i"] - 1)

    publisher = TrajectoryPublisherShim(bus, source)
    bus.publish("robot_description", urdf)
    assert node.descriptions["robot_description"] == urdf
    bus.publish("sensor", Sensor(time_ns=0, position=Q0.copy(),
                                 velocity=np.zeros(2)))
    for _ in range(3 * T):
        publisher.tick()
    ctrl = node.tick(now_ns=0)
    assert ctrl is not None and bus.latest("control") is ctrl
    assert np.all(np.isfinite(ctrl.feedforward))
    assert bus.latest("ocp_solve_time") is not None
    assert bus.latest("mpc_buffer_size") is not None
    np.testing.assert_allclose(bus.latest("ocp_x0"),
                               np.concatenate([Q0, np.zeros(2)]))
    dbg = bus.latest("mpc_debug")
    assert isinstance(dbg, MpcDebugMsg) and dbg.problem_solved
    assert dbg.states_prediction.shape == (T + 1, 4)
    assert set(dbg.residuals) and set(dbg.references)
    assert debugger.last_debug is dbg
    assert bus.latest("mpc_states_prediction_markers").shape[0] == T + 1
    for k in range(5):
        bus.publish("sensor", Sensor(time_ns=int((k + 1) * dt * 1e9),
                                     position=Q0.copy(),
                                     velocity=np.zeros(2)))
        publisher.tick()
        assert node.tick() is not None
    assert len(bus.history("control")) == 6
