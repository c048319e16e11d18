"""OCP facade: the reference's `OCPBase` contract over the port's solvers.

Port of the JAX package's `mpc/ocp_base.py` (`OCPParams`, `OCPBase`,
`OCPJax`, whose counterpart here is `OCPTorch`). It mirrors the reference's
`ocp_base.py:11-107` (abstract interface) and `ocp_base_croco.py:16-215`
(concrete Crocoddyl OCP) with one deep difference: references and weights
are not mutated into a model object graph. `set_reference_weighted_trajectory`
packs the horizon into the refs dict the solve reads, one host-to-device
copy per tick instead of the reference's per-tick Python property-write loop
(`ocp_croco_generic.py:855-892`); with a `RefRing` attached the refs are
gathered on the device and nothing is packed per tick.

Where the JAX facade jits its solve, this one calls the port's solvers
directly; they read their loop conditions on the host (`host_syncs` of
`BatchSQP`, `CSQPSolution` and `Solution`). The facade itself reads a
solve's results back in one transfer (`OCPTorch.host_syncs`).
"""

from __future__ import annotations

import abc
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.model import ModelParams, RobotModel
from ..ocp.costs import build_cost_functions
from ..ocp.spec import ProblemSpec, default_references
from ..solver.csqp import CSQPSettings, solve_csqp
from ..solver.fddp import SolverSettings, solve_fddp
from ..solver.sqp_batch import make_batch_sqp
from .buffer import WeightedTrajectoryPoint
from .data import OCPDebugData, OCPResults
from .ring import _NP_DTYPE, RowLayout, gather_horizon_rows


@dataclasses.dataclass
class OCPParams:
    """Solver/runtime parameters (reference `OCPParamsBaseCroco`,
    `ocp_param_base.py:31-85`)."""

    dt: float = 0.01
    horizon_size: int = 20
    dt_factor_n_seq: Tuple[Tuple[int, int], ...] = ()
    solver_iters: int = 10
    qp_iters: int = 200
    termination_tolerance: float = 1e-3
    eps_abs: float = 1e-6
    eps_rel: float = 0.0
    max_solve_time: float = 0.1
    use_filter_line_search: bool = True
    use_debug_data: bool = False
    n_threads: int = 1  # accepted for API parity; the device owns parallelism
    # per-tick solver backend:
    #   "auto" — the batch-native SQP (below) whenever the spec supports
    #            it, falling back (with a logged reason) to single-scenario
    #            CSQP/FDDP otherwise,
    #   "sqp"  — the batch-native multiple-shooting SQP/CSQP
    #            (`solver/sqp_batch.py`) at B=1: the production
    #            control-loop solver,
    #   "fddp"/"csqp" — force the single-scenario solvers.
    solver: str = "auto"

    @property
    def n_controls(self) -> int:
        return self.horizon_size


class OCPBase(abc.ABC):
    """Abstract OCP contract (reference `OCPBase`, `ocp_base.py:11-107`)."""

    @abc.abstractmethod
    def set_reference_weighted_trajectory(
        self, reference_weighted_trajectory: List[WeightedTrajectoryPoint]
    ): ...

    @property
    @abc.abstractmethod
    def n_controls(self) -> int: ...

    @property
    @abc.abstractmethod
    def dt(self) -> float: ...

    @abc.abstractmethod
    def solve(
        self,
        x0: np.ndarray,
        x_warmstart: List[np.ndarray],
        u_warmstart: List[np.ndarray],
        use_iteration_limits_and_timeout: bool = True,
    ): ...

    @abc.abstractmethod
    def integrate(self, state: np.ndarray, control: np.ndarray) -> np.ndarray: ...

    @property
    @abc.abstractmethod
    def ocp_results(self) -> OCPResults: ...

    @property
    @abc.abstractmethod
    def debug_data(self) -> OCPDebugData: ...


# transforms older than this are nulled before a solve (reference
# `agimus_controller.py:306-338`: 0.5 s TF staleness cutoff)
TRANSFORM_STALENESS_NS = int(0.5e9)

# which refs key each cost kind publishes as its reference stream (reference
# `init_debug_data_attributes`, `ocp_croco_generic.py:814-825`)
_REF_KEY = {
    "state": lambda c: "xref",
    "control": lambda c: "uref",
    "control_grav": lambda c: "uref",
    "frame_placement": lambda c: f"ee_trans:{c.frame}",
    "frame_translation": lambda c: f"ee_trans:{c.frame}",
    "visual_servoing": lambda c: f"ee_trans:{c.frame}",
    "frame_rotation": lambda c: f"ee_rot:{c.frame}",
    "frame_velocity": lambda c: f"ee_vel:{c.frame}",
    "force_tracking": lambda c: "f_des",
}


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Copy a dict of tensors of one dtype and device to numpy in one
    transfer."""
    if not tensors:
        return {}
    flat = torch.cat([t.reshape(-1) for t in tensors.values()]).cpu().numpy()
    out, off = {}, 0
    for k, t in tensors.items():
        out[k] = flat[off:off + t.numel()].reshape(tuple(t.shape))
        off += t.numel()
    return out


class OCPTorch(OCPBase):
    """Concrete OCP over the port's solvers: the counterpart of the JAX
    package's `OCPJax` (the `OCPBaseCroco` / `OCPCrocoGeneric`
    replacement). Its tensors live on ``device``, in ``dtype``."""

    def __init__(
        self,
        model: RobotModel,
        params: ModelParams,
        spec: ProblemSpec,
        ocp_params: Optional[OCPParams] = None,
        dtype: torch.dtype = torch.float32,
        ring=None,
        device: torch.device | str = DEFAULT_DEVICE,
    ):
        """``ring``: an optional `RefRing` (usually the one inside a
        `PackedTrajectoryBuffer`, on the same device). When attached, each
        solve gathers its references from the device-resident ring: a tick
        costs one row pack on append and one row copy, the O(1) analog of
        the reference's rolling-buffer mode (`ocp_croco_generic.py:865-881`).
        """
        self.device = resolve_device(device)
        params = ModelParams(*(t.to(self.device) for t in params))
        self._model = model
        self._params = params
        self._spec = spec
        self._dtype = dtype
        self._ocp_params = ocp_params or OCPParams(
            dt=spec.dt, horizon_size=spec.horizon, dt_factor_n_seq=spec.dt_factor_n_seq
        )
        self._cf = build_cost_functions(model, params, spec, dtype=dtype)
        self._refs = default_references(spec, model, dtype=dtype,
                                        device=self.device)
        self._results: Optional[OCPResults] = None
        self._debug = OCPDebugData()
        self._timesteps = spec.timesteps()
        self._ring = ring
        self._row_layout = ring.layout if ring is not None else None
        if ring is not None:
            hidx, self._cap_mask = ring.gather_spec()
            self._hidx = torch.as_tensor(hidx, device=self.device)
        self.host_syncs = 0  # device-to-host reads of the facade
        self._solver_syncs = 0  # the single-scenario solvers' host reads

        solver_kind = self._ocp_params.solver
        if solver_kind == "auto":
            # the batch-native SQP at B=1 (reference analog: its runtime
            # solver IS the fast path, `ocp_base_croco.py:64-80`); the JAX
            # facade knows no spec it declines either
            solver_kind = "sqp"
        if solver_kind == "fddp" and spec.constraints:
            raise ValueError(
                "spec has constraints; use solver='csqp' or 'sqp'")
        self._solver_kind = solver_kind
        self._batched = solver_kind == "sqp"
        op = self._ocp_params

        self.solver = None
        if solver_kind == "sqp":
            # batch-native multiple-shooting SQP/CSQP at B=1. The iteration
            # limit is an argument of each call, so one solver serves the
            # unlimited first solve, the per-tick budget and the
            # max_solve_time cap.
            st = CSQPSettings(
                max_iters=op.solver_iters,
                max_qp_iters=op.qp_iters,
                eps_abs=op.eps_abs,
                eps_rel=op.eps_rel,
                termination_tolerance=op.termination_tolerance,
                use_filter_line_search=op.use_filter_line_search,
                reg_init=1e-7,
            )
            self.solver = make_batch_sqp(model, params, spec, st, self.device)
            build_core = None
            # cross-tick ADMM dual warm start (device-resident carry)
            self._y_carry = torch.zeros(
                (spec.horizon + 1, max(self._cf.n_constraints, 1)),
                dtype=dtype, device=self.device)
        elif solver_kind == "csqp":
            # single-scenario CSQP, the reference's runtime solver
            # (`mim_solvers.SolverCSQP`, `ocp_base_croco.py:64-80`)
            def build_core(max_iters: int):
                st = CSQPSettings(
                    max_iters=max_iters,
                    max_qp_iters=op.qp_iters,
                    eps_abs=op.eps_abs,
                    eps_rel=op.eps_rel,
                    termination_tolerance=op.termination_tolerance,
                    use_filter_line_search=op.use_filter_line_search,
                )
                return lambda x0, refs, xs, us: solve_csqp(
                    self._cf, x0, refs, xs, us, st)
        elif solver_kind == "fddp":
            def build_core(max_iters: int):
                st = SolverSettings(
                    max_iters=max_iters,
                    termination_tolerance=op.termination_tolerance,
                    use_filter_line_search=op.use_filter_line_search,
                )
                return lambda x0, refs, xs, us: solve_fddp(
                    self._cf, x0, refs, xs, us, st)
        else:
            raise ValueError(
                f"OCPParams.solver must be one of auto/sqp/csqp/fddp, got "
                f"{solver_kind!r}")

        # first-solve semantics: unlimited budget (1000 iters, no time cap,
        # reference `ocp_base_croco.py:160-171`); the solvers stop on the
        # KKT criterion, so the large cap costs nothing once converged
        self._build_core = build_core
        if build_core is not None:
            self._solve_run = build_core(op.solver_iters)
            self._solve_init = build_core(1000)
        else:
            self._solve_run = self._solve_init = None
        # wall-clock budget enforcement (`max_solve_time`): a calibrated
        # per-iteration cost -> iteration cap (see `calibrate_solve_budget`).
        # None = not yet calibrated.
        self._budget_iters: Optional[int] = None
        self._budget_per_iter_s: Optional[float] = None
        # visual-servoing transform staleness bookkeeping (reference
        # `agimus_controller.py:306-338` + `ocp_croco_generic.py:463-467`)
        self._transform_stamp_ns: Dict[str, int] = {}
        self._vs_items = tuple(
            (c.object_frame, c.frame)
            for c in (tuple(spec.running_costs) + tuple(spec.terminal_costs))
            if c.kind == "visual_servoing"
        )
        self._host_refs: Dict[str, np.ndarray] = {}
        # per-tick debug streams (reference `init_debug_data_attributes`,
        # `ocp_croco_generic.py:814-825`): which cost names publish their
        # references (update=True) and residual predictions
        # (publish_residual=True) each tick when use_debug_data is on
        seen = set()
        self._ref_stream_items = tuple(
            (c.name, _REF_KEY[c.kind](c))
            for c in spec.all_costs()
            if c.update and c.kind in _REF_KEY
            and not (c.name in seen or seen.add(c.name)))
        self._residual_names = tuple(sorted(
            {c.name for c in spec.all_costs() if c.publish_residual}))

    # ------------------------------------------------------------------
    @property
    def spec(self) -> ProblemSpec:
        return self._spec

    @property
    def n_controls(self) -> int:
        return self._spec.horizon

    @property
    def dt(self) -> float:
        return float(self._timesteps[0])

    @property
    def horizon_size(self) -> int:
        return self._spec.horizon

    @property
    def refs(self) -> Dict[str, torch.Tensor]:
        return self._refs

    @property
    def solver_kind(self) -> str:
        """The solver "auto" resolved to: "sqp", "csqp" or "fddp"."""
        return self._solver_kind

    @property
    def solver_host_syncs(self) -> int:
        """Host reads of a device flag in the solvers' loops, over every
        solve (the batch SQP's count, or the single-scenario solves')."""
        if self._batched:
            return self.solver.host_syncs
        return self._solver_syncs

    # ------------------------------------------------------------------
    @property
    def row_layout(self):
        """Packed per-point row layout (lazy; shared with `RefRing`)."""
        if self._row_layout is None:
            self._row_layout = RowLayout(self._spec, self._model)
        return self._row_layout

    @property
    def ring(self):
        return self._ring

    def _current_refs(self) -> Dict[str, torch.Tensor]:
        """The refs dict the next solve sees. In ring mode the horizon rows
        are gathered on the device at the ring's read slot (no host
        packing; `RefRing.device_state` ships rows appended since the last
        solve) and sliced over the base refs, as `FusedTick` does."""
        if self._ring is None:
            return self._refs
        ring_arr, slot = self._ring.device_state()
        rows = gather_horizon_rows(ring_arr, slot, self._hidx, self._cap_mask)
        return self.row_layout.unpack_refs(rows, self._refs)

    def set_reference_weighted_trajectory(
        self, reference_weighted_trajectory: List[WeightedTrajectoryPoint]
    ):
        """Pack the horizon's references/weights into device tensors
        (replaces the per-node `update()` mutation loop,
        `ocp_croco_generic.py:855-892`). Each point is flattened into one
        packed row, then the refs tensors are sliced out of the row matrix:
        the layout the device-resident `RefRing` ships, so the host path and
        the ring path cannot diverge.

        Ring mode: the points were already packed on append
        (`PackedTrajectoryBuffer`), so this only refreshes the host views
        used by the staleness checks and asserts the ring head matches the
        passed horizon (id coherence)."""
        pts = reference_weighted_trajectory
        T1 = self._spec.horizon + 1
        assert len(pts) == T1, f"expected {T1} horizon points, got {len(pts)}"
        layout = self.row_layout
        if self._ring is not None:
            rows = self._ring.host_horizon_rows()
            head_id = rows[0, layout._by_key["id"].offset]
            if pts[0].point.id is not None and head_id >= 0:
                assert int(head_id) == int(pts[0].point.id), (
                    f"ring head id {int(head_id)} != horizon head id "
                    f"{pts[0].point.id}: ring and buffer desynced")
        else:
            rows = np.zeros((T1, layout.width), _NP_DTYPE[self._dtype])
            for t, wp in enumerate(pts):
                layout.pack_point(wp, out=rows[t])
            self._refs = layout.unpack_refs(
                torch.as_tensor(rows, device=self.device), self._refs)
        # host copies kept for staleness checks (no device reads on the
        # control path)
        for frame in layout._frames:
            fl = layout._by_key[f"w_ee:{frame}"]
            self._host_refs[f"w_ee:{frame}"] = (
                rows[:, fl.offset:fl.offset + fl.size])

    def set_transform(
        self,
        object_frame: str,
        rot: np.ndarray,
        trans: np.ndarray,
        time_ns: Optional[int] = None,
    ):
        """Feed a visual-servoing vision transform (reference
        `input_transforms`, `ocp_croco_generic.py:791-796`). ``time_ns``
        stamps the transform for the 0.5 s staleness cutoff
        (`agimus_controller.py:306-338`); defaults to now."""
        self._refs[f"wMo_rot:{object_frame}"] = self._tensor(rot)
        self._refs[f"wMo_trans:{object_frame}"] = self._tensor(trans)
        self._transform_stamp_ns[object_frame] = (
            time.time_ns() if time_ns is None else int(time_ns))

    def validate_transforms(self, now_ns: Optional[int] = None):
        """Null stale visual-servoing transforms and enforce the reference's
        invariant that VS weights are zero while no transform is available.

        Mirrors the controller's TF handling (`agimus_controller.py:306-338`:
        transforms older than 0.5 s are dropped) + the OCP-side assertion
        (`ocp_croco_generic.py:463-467`). Raises AssertionError if the
        streamed VS weights are nonzero for a frame with no fresh transform.
        """
        now = time.time_ns() if now_ns is None else int(now_ns)
        for obj, frame in self._vs_items:
            stamp = self._transform_stamp_ns.get(obj)
            if stamp is not None and now - stamp <= TRANSFORM_STALENESS_NS:
                continue
            if stamp is not None:
                self._transform_stamp_ns.pop(obj, None)
                self._refs[f"wMo_rot:{obj}"] = self._tensor(np.eye(3))
                self._refs[f"wMo_trans:{obj}"] = self._tensor(np.zeros(3))
            w = self._host_refs.get(f"w_ee:{frame}")
            assert w is None or not np.any(np.abs(w) > 0.0), (
                f"weights of visual servoing cost (frame {frame!r}) must be "
                f"zero while no fresh transform for {obj!r} is available "
                "(reference ocp_croco_generic.py:463-467)")

    def update_geometry_placement(self, geom_rot: np.ndarray, geom_trans: np.ndarray):
        """Move obstacle geometries (reference `update_geometry_placement`,
        `ocp_base_croco.py:110-132`)."""
        self._refs["geom_rot"] = self._tensor(geom_rot)
        self._refs["geom_trans"] = self._tensor(geom_trans)

    # ------------------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=self._dtype,
                            device=self.device)

    def _warm(self, x0, x_warmstart, u_warmstart):
        return (self._tensor(x0), self._tensor(np.stack(x_warmstart)),
                self._tensor(np.stack(u_warmstart)))

    def _solve_batched(self, x0, xs, us, limit: int):
        return self.solver(x0[None], self._current_refs(), xs[None], us[None],
                           max_iters=int(limit), y0=self._y_carry[None])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def calibrate_solve_budget(self, x0, x_warmstart, u_warmstart) -> int:
        """Enforce `max_solve_time` (reference `ocp_base_croco.py:70-71,
        166-171`): measure the per-iteration cost of the run solver once,
        then cap its iteration count so a tick can never exceed its
        wall-clock budget. Returns the cap.

        Call after the first (unlimited) solve, e.g. from the runtime's
        initialization path. Times three solves after one warm-up on the
        host clock, the device synchronized before each reading.
        """
        x0t, xs, us = self._warm(x0, x_warmstart, u_warmstart)
        full_iters = max(1, int(self._ocp_params.solver_iters))

        def run_once():
            if self._batched:
                return self._solve_batched(x0t, xs, us, full_iters)
            return self._solve_run(x0t, self._current_refs(), xs, us)

        run_once()  # warm-up
        self._sync()
        t0 = time.perf_counter()
        n_cal = 3
        for _ in range(n_cal):
            run_once()
        self._sync()
        per_solve = (time.perf_counter() - t0) / n_cal
        self._budget_per_iter_s = per_solve / full_iters
        budget = self._ocp_params.max_solve_time
        if budget and per_solve > budget:
            capped = max(1, int(budget / self._budget_per_iter_s))
            capped = min(capped, full_iters)
            if capped < full_iters and not self._batched:
                # the single-scenario solvers take the cap in their
                # settings; the sqp backend takes it per call
                self._solve_run = self._build_core(capped)
            self._budget_iters = capped
        else:
            self._budget_iters = full_iters
        return self._budget_iters

    @property
    def budget_iters(self) -> Optional[int]:
        return self._budget_iters

    def solve(
        self,
        x0: np.ndarray,
        x_warmstart,
        u_warmstart,
        use_iteration_limits_and_timeout: bool = True,
    ):
        x0t, xs, us = self._warm(x0, x_warmstart, u_warmstart)
        if self._batched:
            limit = (
                (self._budget_iters or self._ocp_params.solver_iters)
                if use_iteration_limits_and_timeout else 1000)
            sol = self._solve_batched(x0t, xs, us, limit)
            self._y_carry = sol.y[0]  # next tick's dual warm start
            row = lambda a: a[0]  # noqa: E731  (B = 1)
        else:
            fn = (self._solve_run if use_iteration_limits_and_timeout
                  else self._solve_init)
            sol = fn(x0t, self._current_refs(), xs, us)
            self._solver_syncs += sol.host_syncs
            row = lambda a: a  # noqa: E731
        qp = getattr(sol, "qp_iters", None)
        f = lambda a: row(a).to(self._dtype)  # noqa: E731
        out = _to_host({
            "xs": f(sol.xs), "K": f(sol.K), "us": f(sol.us),
            "kkt": f(sol.kkt), "iters": f(sol.iters),
            "qp": f(qp) if qp is not None else f(torch.zeros_like(sol.kkt)),
            "converged": f(sol.converged)})
        self.host_syncs += 1
        self._solution = (row(sol.xs), row(sol.us))  # on the device
        self._results = OCPResults(
            states=out["xs"],
            ricatti_gains=out["K"],
            feed_forward_terms=out["us"],
        )
        self._debug.kkt_norm = float(out["kkt"].reshape(-1)[0])
        self._debug.nb_iter = int(out["iters"].reshape(-1)[0])
        self._debug.nb_qp_iter = int(out["qp"].reshape(-1)[0])
        self._debug.problem_solved = bool(out["converged"].reshape(-1)[0])
        if self._ocp_params.use_debug_data:
            self._fill_debug_streams()
        return self._results

    def _fill_debug_streams(self):
        """Populate `OCPDebugData.references/residuals` on the tick path
        (reference: per-tick named cost references + residual predictions
        selected by the YAML update/publish_residual flags,
        `ocp_croco_generic.py:814-853` / `ros_utils.py:295-317`): the
        residuals of every running node along the solution, in one batched
        evaluation, and every stream read back in one transfer."""
        refs = self._current_refs()
        streams = {f"ref:{name}": refs[key]
                   for name, key in self._ref_stream_items if key in refs}
        if self._residual_names:
            T = self._spec.horizon
            xs, us = self._solution
            rb = self._cf.cost_breakdown_b(
                xs[:-1], us, torch.arange(T, device=self.device), refs)
            streams.update({f"res:{n}": rb[n][1] for n in rb
                            if n in self._residual_names})
        host = _to_host({k: v.to(self._dtype) for k, v in streams.items()})
        self.host_syncs += 1
        self._debug.references = {k[4:]: v for k, v in host.items()
                                  if k.startswith("ref:")}
        if self._residual_names:
            self._debug.residuals = {k[4:]: v for k, v in host.items()
                                     if k.startswith("res:")}

    def integrate(self, state: np.ndarray, control: np.ndarray) -> np.ndarray:
        """One Euler step on the first node's dynamics (delay compensation,
        reference `ocp_base_croco.py:184-189`)."""
        x = self._cf.step(self._tensor(state), self._tensor(control), 0,
                          self._current_refs())
        self.host_syncs += 1
        return x.cpu().numpy()

    @property
    def ocp_results(self) -> OCPResults:
        return self._results

    @ocp_results.setter
    def ocp_results(self, value: OCPResults):
        self._results = value

    @property
    def debug_data(self) -> OCPDebugData:
        return self._debug
