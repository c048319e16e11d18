"""The port's OCP facade vs the JAX package, f64.

On the 2-DoF planar arm of `test_ring_control_loop.py` (T=8), `OCPTorch`
against `OCPJax` with ``solver`` "fddp" on its goal spec, and "sqp" and
"csqp" on the `control_box` spec of `_torch_csqp_cases.py` (two constraint
rows: the ADMM branch and the dual carry): a first solve, then a budgeted
solve from the shifted solution, the carry fed back. Iterates and gains at
1e-8, the delay-compensation step (`integrate`) at 1e-8, iteration and QP
counts equal. Also: the `max_solve_time` cap and transform staleness with an
explicit clock. The closed loop through `ControllerRuntime`, the debug
streams, the ring against host packing and the fused tick are in
`test_torch_runtime.py` (so the JAX compiles spread over workers).

The "sqp" route runs at dt = 2^-6: the JAX batch SQP's XLA cost pack scales
running costs by a float32 copy of dt (ROADMAP queue 3, known reference
behaviour; at dt = 0.02 the gains differ by ~2e-6), the port's in the
trajectory dtype. The single-scenario solvers take dt in f64 in both
packages and run at the JAX tests' dt = 0.02.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.mpc import warm_start as jws
from agimus_controller_tpu.mpc.ocp_base import OCPJax, OCPParams as JaxParams
from agimus_controller_tpu.models.urdf import build_model_from_urdf as jax_build
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ops import dynamics, kinematics
from agimus_controller_tpu_torch.models.urdf import build_model_from_urdf
from agimus_controller_tpu_torch.mpc.buffer import (
    TrajectoryPoint,
    TrajectoryPointWeights,
    WeightedTrajectoryPoint,
)
from agimus_controller_tpu_torch.mpc.data import OCPResults
from agimus_controller_tpu_torch.mpc.ocp_base import (
    TRANSFORM_STALENESS_NS,
    OCPParams,
    OCPTorch,
)
from agimus_controller_tpu_torch.mpc.warm_start import WarmStartShiftPreviousSolution
from agimus_controller_tpu_torch.ocp.spec import CostItem, ProblemSpec
from tests._torch_csqp_cases import to_port_spec
from tests.test_ring_control_loop import DT, Q0, T, URDF_2DOF, _spec

ATOL = 1e-8
DT_EXACT = 2.0 ** -6  # exact in f32 (see the module docstring)
GOAL = np.array([0.02, 0.0, -0.03])


@pytest.fixture(scope="module")
def arm():
    jm, jp = jax_build(URDF_2DOF, armature=np.array([0.1, 0.1]),
                       dtype=np.float64)
    pm, pp = build_model_from_urdf(URDF_2DOF, armature=np.array([0.1, 0.1]),
                                   dtype=torch.float64, device="cpu")
    q0 = jnp.asarray(Q0)
    R0, p0 = (np.asarray(a) for a in kinematics.frame_placement(
        jm, jp, q0, jm.frame_id("tip")))
    tau_g = np.asarray(dynamics.rnea(jm, jp, q0, jnp.zeros(2), jnp.zeros(2)))
    return dict(jm=jm, jp=jp, pm=pm, pp=pp, R0=R0, p0=p0, tau_g=tau_g)


def _specs(case, dt):
    """(JAX spec, port spec): the goal spec of the JAX ring tests, or it with
    a control box the solution rides (`_torch_csqp_cases.py`)."""
    js = dataclasses.replace(_spec(), dt=dt)
    if case == "control_box":
        js = dataclasses.replace(js, constraints=(jspec.ConstraintItem(
            name="ubox", kind="control_limit", lower=(-1.3,) * 2,
            upper=(1.3,) * 2),))
    return js, to_port_spec(js)


def _point(i, arm, dt):
    """Streamed point i: the tip goal drifts along x with i."""
    pt = TrajectoryPoint(
        id=i, time_ns=int(i * dt * 1e9), robot_configuration=Q0.copy(),
        robot_velocity=np.zeros(2), robot_acceleration=np.zeros(2),
        robot_effort=arm["tau_g"].copy(),
        end_effector_poses={"tip": (arm["R0"], arm["p0"] + GOAL + np.asarray(
            [0.001 * (i % 7), 0.0, 0.0]))})
    w = TrajectoryPointWeights(
        w_robot_configuration=np.full(2, 0.5), w_robot_velocity=np.full(2, 1.0),
        w_robot_effort=np.ones(2),
        w_end_effector_poses={"tip": np.ones(6)})
    return WeightedTrajectoryPoint(point=pt, weights=w)


def _params(cls, solver, dt, **kw):
    return cls(dt=dt, horizon_size=T, solver_iters=10, solver=solver,
               termination_tolerance=1e-6, **kw)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _same_results(rp, rj, atol=ATOL):
    _close(rp.states, rj.states, atol)
    _close(rp.feed_forward_terms, rj.feed_forward_terms, atol)
    _close(rp.ricatti_gains, rj.ricatti_gains, atol)


# (solver, spec, dt); the unconstrained "sqp" route is the closed loop's
CASES = {"fddp": ("fddp", "goal", DT),
         "sqp_control_box": ("sqp", "control_box", DT_EXACT),
         "csqp_control_box": ("csqp", "control_box", DT)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_solvers_match_jax(arm, name):
    solver, case, dt = CASES[name]
    js, ps = _specs(case, dt)
    ocps = (OCPJax(arm["jm"], arm["jp"], js, _params(JaxParams, solver, dt),
                   dtype=jnp.float64),
            OCPTorch(arm["pm"], arm["pp"], ps, _params(OCPParams, solver, dt),
                     dtype=torch.float64, device="cpu"))
    assert ocps[1].solver_kind == solver
    x0 = np.concatenate([Q0 + 0.05, [0.1, -0.1]])
    xs = [np.concatenate([Q0, np.zeros(2)])] * (T + 1)
    us = [arm["tau_g"]] * T
    shifts = (jws.WarmStartShiftPreviousSolution(),
              WarmStartShiftPreviousSolution())
    shifts[0].setup(arm["jm"], arm["jp"], js.timesteps())
    shifts[1].setup(arm["pm"], arm["pp"], ps.timesteps(), device="cpu")
    results = []
    for ocp, shift in zip(ocps, shifts):
        ocp.set_reference_weighted_trajectory(
            [_point(i, arm, dt) for i in range(T + 1)])
        # the unlimited first solve on "sqp" (its limit is an argument);
        # the JAX single-scenario routes compile one program per iteration
        # cap, so both of their solves take the budget
        first = ocp.solve(x0, xs, us,
                          use_iteration_limits_and_timeout=solver != "sqp")
        dbg1 = dataclasses.replace(ocp.debug_data)
        ocp.set_reference_weighted_trajectory(
            [_point(i, arm, dt) for i in range(1, T + 2)])
        shift.update_previous_solution(first)
        x1 = ocp.integrate(x0, first.feed_forward_terms[0])
        _, xw, uw = shift.generate(TrajectoryPoint(
            robot_configuration=x1[:2], robot_velocity=x1[2:]), None)
        second = ocp.solve(x1, xw, uw)
        results.append((first, dbg1, x1, second, dataclasses.replace(
            ocp.debug_data)))
    (f_j, d1_j, x1_j, s_j, d2_j), (f_p, d1_p, x1_p, s_p, d2_p) = results
    _same_results(f_p, f_j)
    _close(x1_p, x1_j)
    _same_results(s_p, s_j)
    for dp, dj in ((d1_p, d1_j), (d2_p, d2_j)):
        assert (dp.nb_iter, dp.nb_qp_iter, dp.problem_solved) == (
            dj.nb_iter, dj.nb_qp_iter, dj.problem_solved)
        assert abs(dp.kkt_norm - dj.kkt_norm) < ATOL
    assert d1_p.nb_iter > 1
    if solver == "sqp":
        # the dual carry: [T+1, max(nc, 1)] rows, fed to the next solve
        nc = 2 if case == "control_box" else 0
        assert tuple(ocps[1]._y_carry.shape) == (T + 1, max(nc, 1))
        _close(ocps[1]._y_carry.numpy(), np.asarray(ocps[0]._y_carry))
        if nc:
            assert np.abs(np.asarray(ocps[0]._y_carry)).max() > 0


def test_transform_staleness(arm):
    """A fresh transform holds, a stale one is nulled (identity, zero), and
    nonzero visual-servoing weights without a fresh transform raise
    (`test_budget_staleness.py`'s checks, on the 2-DoF arm)."""
    spec = ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="vs", kind="visual_servoing", weight=5.0,
                     update=True, frame="tip", object_frame="object")),
        terminal_costs=(), horizon=4, dt=DT)
    ocp = OCPTorch(arm["pm"], arm["pp"], spec, OCPParams(dt=DT, horizon_size=4),
                   dtype=torch.float64, device="cpu")
    now = 10**12
    trans = np.array([0.3, 0.1, 0.5])
    ocp.set_transform("object", np.eye(3), trans, time_ns=now)
    ocp.validate_transforms(now_ns=now + TRANSFORM_STALENESS_NS // 2)
    _close(ocp.refs["wMo_trans:object"].numpy(), trans, 0)
    ocp.validate_transforms(now_ns=now + TRANSFORM_STALENESS_NS + 1)
    _close(ocp.refs["wMo_trans:object"].numpy(), np.zeros(3), 0)
    _close(ocp.refs["wMo_rot:object"].numpy(), np.eye(3), 0)
    ocp._host_refs["w_ee:tip"] = np.ones((5, 6))
    with pytest.raises(AssertionError, match="visual servoing"):
        ocp.validate_transforms(now_ns=now + 2 * TRANSFORM_STALENESS_NS)


def test_budget_caps_the_iterations(arm):
    """An impossible `max_solve_time` caps every tick at one iteration, and
    the capped solve reports no convergence (`test_budget_staleness.py`; a
    generous budget keeps `solver_iters`, `test_torch_runtime.py`)."""
    js, ps = _specs("goal", DT)
    x0 = np.concatenate([Q0 + 0.05, np.zeros(2)])
    xs = [np.concatenate([Q0, np.zeros(2)])] * (T + 1)
    us = [arm["tau_g"]] * T
    ocp = OCPTorch(arm["pm"], arm["pp"], ps, _params(
        OCPParams, "sqp", DT, max_solve_time=1e-7), dtype=torch.float64,
        device="cpu")
    ocp.solve(x0, xs, us, use_iteration_limits_and_timeout=False)
    assert ocp.calibrate_solve_budget(x0, xs, us) == 1
    assert ocp.budget_iters == 1
    res = ocp.solve(x0, xs, us)
    assert ocp.debug_data.nb_iter == 1
    assert not ocp.debug_data.problem_solved
    assert isinstance(res, OCPResults)
