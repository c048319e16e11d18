"""MPC orchestrator: the per-tick receding-horizon pipeline.

Functional contract of the reference `MPC` (`mpc.py:14-95`): consume the
reference buffer's horizon, update OCP references, warm-start, solve, store
the previous solution, drop the consumed head, and expose nanosecond phase
timings. Structured here as an explicit phase pipeline — each tick phase is
a named method timed by `_timed`, so the debug data is assembled from the
phase table instead of inline stopwatch bookkeeping. The known reference
defect `time_ns += int(dt*1e-9)` (`mpc.py:77`) is not replicated.

Port of the JAX package's `mpc/mpc.py` (host-side, the same code over the
port's `OCPBase`).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from .buffer import TrajectoryBuffer, TrajectoryPoint, WeightedTrajectoryPoint
from .data import MPCDebugData, OCPResults
from .ocp_base import OCPBase
from .warm_start import WarmStartBase


class MPC:
    """Receding-horizon loop over (OCP backend, warm start, buffer)."""

    #: tick phases, in order; each maps to duration_<name>_ns debug fields
    _PHASES = ("horizon_update", "generate_warm_start", "ocp_solve")

    def __init__(self) -> None:
        self._ocp: Optional[OCPBase] = None
        self._warm_start: Optional[WarmStartBase] = None
        self._buffer: Optional[TrajectoryBuffer] = None
        self._mpc_debug_data: Optional[MPCDebugData] = None
        self._phase_ns = dict.fromkeys(self._PHASES, 0)

    def setup(
        self,
        ocp: OCPBase,
        warm_start: WarmStartBase,
        buffer: TrajectoryBuffer,
    ) -> None:
        self._ocp = ocp
        self._warm_start = warm_start
        self._buffer = buffer
        self._mpc_debug_data = MPCDebugData(ocp=ocp.debug_data)

    # ------------------------------------------------------------------
    def _timed(self, phase: str, fn, *args):
        t0 = time.perf_counter_ns()
        out = fn(*args)
        self._phase_ns[phase] = time.perf_counter_ns() - t0
        return out

    def _phase_horizon(self):
        horizon = self._buffer.horizon
        self._ocp.set_reference_weighted_trajectory(horizon)
        return horizon

    def _phase_warm_start(self, initial_state, horizon):
        points = [wp.point for wp in horizon]
        x0, x_init, u_init = self._warm_start.generate(initial_state, points)
        n = self._ocp.n_controls
        if len(x_init) != n + 1 or len(u_init) != n:
            raise ValueError(
                f"warm start shape mismatch: {len(x_init)} states / "
                f"{len(u_init)} controls for an {n}-control horizon")
        return points, x0, x_init, u_init

    def _phase_solve(self, x0, x_init, u_init):
        self._ocp.solve(x0, x_init, u_init)
        self._warm_start.update_previous_solution(self._ocp.ocp_results)
        self._buffer.clear_past()
        return self._ocp.ocp_results

    def run(self, initial_state: TrajectoryPoint,
            current_time_ns: int) -> Optional[OCPResults]:
        """One control tick; None while the buffer cannot fill a horizon."""
        if self._ocp is None or self._warm_start is None:
            raise RuntimeError("MPC.setup() was never called")
        if len(self._buffer) < self._ocp.n_controls + 1:
            return None

        tick0 = time.perf_counter_ns()
        horizon = self._timed("horizon_update", self._phase_horizon)
        points, x0, x_init, u_init = self._timed(
            "generate_warm_start", self._phase_warm_start,
            initial_state, horizon)
        results = self._timed("ocp_solve", self._phase_solve,
                              x0, x_init, u_init)

        dbg = self._mpc_debug_data
        dbg.ocp = self._ocp.debug_data
        dbg.reference_id = points[0].id
        dbg.duration_iteration_ns = time.perf_counter_ns() - tick0
        dbg.duration_horizon_update_ns = self._phase_ns["horizon_update"]
        dbg.duration_generate_warm_start_ns = (
            self._phase_ns["generate_warm_start"])
        dbg.duration_ocp_solve_ns = self._phase_ns["ocp_solve"]
        return results

    # ------------------------------------------------------------------
    def integrate(self, state: TrajectoryPoint,
                  control: np.ndarray) -> TrajectoryPoint:
        """Advance a state one OCP dt through the node-0 action model
        (constant-delay compensation, reference `mpc.py:68-83` /
        `agimus_controller.py:518-523`)."""
        x = self._ocp.integrate(state.robot_state, control)
        nq = len(state.robot_configuration)
        state.time_ns += int(self._ocp.dt * 1e9)
        state.robot_configuration = x[:nq]
        state.robot_velocity = x[nq:]
        return state

    @property
    def mpc_debug_data(self) -> MPCDebugData:
        return self._mpc_debug_data

    def append_trajectory_point(self, point: WeightedTrajectoryPoint):
        self._buffer.append(point)

    def append_trajectory_points(
            self, points: Sequence[WeightedTrajectoryPoint]):
        self._buffer.extend(points)
