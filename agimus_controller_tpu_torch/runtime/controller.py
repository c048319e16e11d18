"""Controller runtime: the reference's `AgimusController` node lifecycle
(`agimus_controller_ros/agimus_controller.py:166-563`) as a transport-free
state machine, stepped by the caller (a 100 Hz asyncio/timer loop, a sim, or
a test).

Semantics preserved:
- initialization gate: buffer must hold >= 2x horizon time before the first
  solve (`initialization_callback`, `:457-462`),
- first solve with unlimited iteration budget from the reference warm start
  (`setup_mpc_initial_guess`, `:359-381`),
- per-tick buffer policy: warn below 1.5x horizon, error below 1x and pad by
  re-appending the last point so the solver keeps running (`run_callback`,
  `:488-503`),
- constant-delay compensation: publish the PREVIOUS tick's control, then
  predict x0 one dt ahead through the OCP integrator (`:479-523`),
- control output = (Riccati gain K[0], feedforward us[0], initial state)
  (`send_control_msg`, `:418-426`).

Port of the JAX package's `runtime/controller.py` (numpy only, the same code
over the port's `MPC`).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional

import numpy as np

from ..mpc.buffer import TrajectoryBuffer, TrajectoryPoint, WeightedTrajectoryPoint
from ..mpc.data import OCPResults
from ..mpc.mpc import MPC
from ..mpc.warm_start import WarmStartBase

logger = logging.getLogger(__name__)


class _Throttle:
    """Rate-limit a log channel (the reference's ROS
    `throttle_duration_sec=` warnings, e.g. `agimus_controller.py:494-502`)."""

    def __init__(self, period_s: float = 1.0):
        self.period_s = period_s
        self._last: dict = {}

    def ok(self, key: str, now_s: Optional[float] = None) -> bool:
        now_s = time.monotonic() if now_s is None else now_s
        last = self._last.get(key)
        if last is not None and now_s - last < self.period_s:
            return False
        self._last[key] = now_s
        return True


@dataclasses.dataclass
class Sensor:
    """Robot state sample (the `linear_feedback_controller_msgs` Sensor
    analog, SURVEY.md §2b N9)."""

    time_ns: int
    position: np.ndarray
    velocity: np.ndarray


@dataclasses.dataclass
class Control:
    """Control output wire type: (K, feedforward, linearization state)."""

    feedback_gain: np.ndarray  # [nu, nx]
    feedforward: np.ndarray  # [nu]
    initial_state: Sensor


@dataclasses.dataclass
class RuntimeParams:
    rate: float = 100.0
    constant_delay: bool = False
    publish_debug_data: bool = True
    start_ratio: float = 2.0  # buffer gate to start (x horizon time)
    warn_ratio: float = 1.5
    warn_throttle_s: float = 1.0  # rate limit for repeated warnings
    # degradation policy when the solver reports problem_solved=False:
    # "publish" (reference behavior — torque goes out regardless,
    # `ocp_base_croco.py:136` is recorded but unused) or "hold" (re-emit the
    # last good control and skip updating the feedback linearization)
    on_unsolved: str = "publish"


class ControllerRuntime:
    """Transport-free controller lifecycle. Wire in sensors with
    `set_sensor`, references with `append_reference`, and consume controls
    via the `control_callbacks`."""

    def __init__(
        self,
        mpc: MPC,
        buffer: TrajectoryBuffer,
        warm_start_reference: WarmStartBase,
        params: Optional[RuntimeParams] = None,
    ):
        self._mpc = mpc
        self._buffer = buffer
        self._ws_ref = warm_start_reference
        self.params = params or RuntimeParams()
        self._sensor: Optional[Sensor] = None
        self._prev_res: Optional[OCPResults] = None
        self._last_good_res: Optional[OCPResults] = None
        self.initialized = False
        self.control_callbacks: List[Callable[[Control], None]] = []
        self.solve_time_callbacks: List[Callable[[float], None]] = []
        # buffer-occupancy telemetry (the reference publishes the size each
        # tick on `/mpc_buffer_size`, `agimus_controller.py:453-454`)
        self.buffer_size_callbacks: List[Callable[[int], None]] = []
        self.last_control: Optional[Control] = None
        self.last_solve_time: Optional[float] = None
        self.last_problem_solved: Optional[bool] = None
        self._throttle = _Throttle(self.params.warn_throttle_s)

    # ------------------------------------------------------------------
    def set_sensor(self, sensor: Sensor) -> None:
        self._sensor = sensor

    def append_reference(self, point: WeightedTrajectoryPoint) -> None:
        self._buffer.append(point)

    def buffer_has_enough_data(self, ratio: float) -> bool:
        """len(buffer)*dt >= ratio * horizon total_time (reference
        `buffer_has_enough_data`, `:408-416`)."""
        ocp = self._mpc._ocp
        total_time = float(np.sum(ocp.spec.timesteps())) if hasattr(ocp, "spec") else (
            ocp.n_controls * ocp.dt
        )
        return len(self._buffer) * ocp.dt >= ratio * total_time

    # ------------------------------------------------------------------
    def try_initialize(self) -> bool:
        """Initialization gate + unlimited-budget first solve."""
        if self.initialized:
            return True
        if self._sensor is None:
            return False
        if not self.buffer_has_enough_data(self.params.start_ratio):
            return False
        ocp = self._mpc._ocp
        horizon = self._buffer.horizon
        ocp.set_reference_weighted_trajectory(horizon)
        x0pt = TrajectoryPoint(
            time_ns=self._sensor.time_ns,
            robot_configuration=self._sensor.position,
            robot_velocity=self._sensor.velocity,
        )
        x0, xs, us = self._ws_ref.generate(x0pt, [wp.point for wp in horizon])
        res = ocp.solve(x0, xs, us, use_iteration_limits_and_timeout=False)
        self._mpc._warm_start.update_previous_solution(res)
        # enforce `max_solve_time` from here on: calibrate the compiled run
        # solver and cap its iteration count (reference
        # `ocp_base_croco.py:70-71,166-171` caps every tick at 0.1 s)
        if hasattr(ocp, "calibrate_solve_budget"):
            cap = ocp.calibrate_solve_budget(x0, xs, us)
            logger.info("solver budget: %s iterations per tick", cap)
        self.initialized = True
        logger.info("MPC initialized; buffer has enough data.")
        return True

    # ------------------------------------------------------------------
    def step(self, now_ns: Optional[int] = None) -> Optional[Control]:
        """One control tick (the reference `run_callback`)."""
        if not self.initialized and not self.try_initialize():
            return None
        assert self._sensor is not None
        now_ns = now_ns if now_ns is not None else self._sensor.time_ns

        prev_control = None
        if self.params.constant_delay and self._prev_res is not None:
            # publish last tick's result now; solve for the next tick
            self._emit_control(self._prev_res)
            prev_control = self._prev_res.feed_forward_terms[0].copy()
            self._prev_res = None

        # buffer policy: warn / pad (reference `:488-503`). The error branch
        # pads until the horizon is actually extractable (the reference's
        # 1.0x time-ratio test deadlocks at exactly T points because the
        # horizon needs horizon_indexes[-1]+1 points — fixed here).
        if not self.buffer_has_enough_data(self.params.warn_ratio):
            needed = self._buffer.horizon_indexes[-1] + 1
            if len(self._buffer) >= needed:
                if self._throttle.ok("buffer_low"):
                    logger.warning(
                        "MPC buffer size becomes low (%d points)",
                        len(self._buffer))
            else:
                if self._throttle.ok("buffer_underrun"):
                    logger.error(
                        "MPC buffer underrun (%d points); padding with "
                        "last point", len(self._buffer))
                while len(self._buffer) < needed:
                    self._buffer.append(self._buffer[len(self._buffer) - 1])
        for cb in self.buffer_size_callbacks:
            cb(len(self._buffer))

        # stale-TF cutoff + VS-weight invariant (reference
        # `agimus_controller.py:306-338`, `ocp_croco_generic.py:463-467`)
        ocp = self._mpc._ocp
        if hasattr(ocp, "validate_transforms"):
            ocp.validate_transforms(now_ns)

        start = time.perf_counter()
        x0pt = TrajectoryPoint(
            time_ns=now_ns,
            robot_configuration=self._sensor.position.copy(),
            robot_velocity=self._sensor.velocity.copy(),
            robot_acceleration=np.zeros_like(self._sensor.velocity),
        )
        if self.params.constant_delay and prev_control is not None:
            x0pt = self._mpc.integrate(x0pt, prev_control)

        res = self._mpc.run(initial_state=x0pt, current_time_ns=x0pt.time_ns)
        if res is None:
            return None
        self.last_solve_time = time.perf_counter() - start
        for cb in self.solve_time_callbacks:
            cb(self.last_solve_time)

        # degradation policy on an unconverged solve: the reference records
        # `problem_solved` but publishes regardless (`ocp_base_croco.py:136`);
        # here the policy is explicit — warn always, optionally hold the
        # last good control instead of publishing a diverged one.
        dbg = self._mpc.mpc_debug_data
        solved = bool(dbg.ocp.problem_solved) if dbg is not None else True
        self.last_problem_solved = solved
        if not solved:
            if self._throttle.ok("unsolved"):
                logger.warning(
                    "OCP did not converge this tick (kkt=%s)",
                    getattr(dbg.ocp, "kkt_norm", None))
            if self.params.on_unsolved == "hold" and \
                    self.last_control is not None:
                if self.params.constant_delay:
                    # the tick-start emission already published the last
                    # good control; re-arm it (instead of the diverged
                    # result) so the stream stays one message per tick
                    self._prev_res = self._last_good_res
                    return self.last_control
                for cb in self.control_callbacks:
                    cb(self.last_control)
                return self.last_control

        if self.params.constant_delay:
            self._prev_res = res
            if solved:
                self._last_good_res = res
            return self.last_control
        if solved:
            self._last_good_res = res
        return self._emit_control(res)

    def _emit_control(self, res: OCPResults) -> Control:
        ctrl = Control(
            feedback_gain=res.ricatti_gains[0],
            feedforward=res.feed_forward_terms[0],
            initial_state=self._sensor,
        )
        self.last_control = ctrl
        for cb in self.control_callbacks:
            cb(ctrl)
        return ctrl
