"""The batch-native CSQP (`solver/csqp_batch.py`) of the port.

- Against the JAX package's `make_batch_csqp` in f64 on the 2-DoF arm of
  `tests/_torch_csqp_cases.py` (T = 8, B = 3): the elbow band, active at
  the solution, every scenario converged after early ADMM exits; every
  field within 1e-8, iterations, ADMM counts and flags equal. The
  manifold branch on the 2-DoF arm on a quaternion free-flyer (T = 6,
  B = 2, no constraint: the sweep path): its rows, its convergence and
  its goal, and against JAX's under `-m slow` (the JAX manifold solver
  compiles for ~50 s).
- The three properties of `tests/test_csqp_batch.py` on the port side, on
  the arm: each row is `solve_csqp`'s, the unconstrained batch CSQP finds
  the batch FDDP's optimum, per-scenario iterations with the ADMM bounded.
- The soft-contact branch: each row is `solve_csqp`'s on the soft step (a
  control box on the soft arm of `test_torch_tick_repairs.py`). The JAX
  module's soft branch raises (ROADMAP queue 3): the port does not copy it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.urdf import build_model_from_urdf as jax_build
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.costs import build_cost_functions as jax_cf
from agimus_controller_tpu.ocp.ff_costs import (
    build_ff_cost_functions as jax_ff_cf,
)
from agimus_controller_tpu.ops import lie as jlie
from agimus_controller_tpu.ops import soft_contact as jsc
from agimus_controller_tpu.solver.csqp import CSQPSettings as JaxSettings
from agimus_controller_tpu.solver.csqp_batch import (
    make_batch_csqp as jax_make_batch_csqp,
)
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
from agimus_controller_tpu_torch.ocp.ff_costs import build_ff_cost_functions
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.ops.soft_contact import SoftContactConfig
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings, solve_csqp
from agimus_controller_tpu_torch.solver.csqp_batch import make_batch_csqp
from agimus_controller_tpu_torch.solver.fddp import SolverSettings
from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp
from tests._torch_csqp_cases import Case, to_port_spec
from tests.test_ring_control_loop import Q0, URDF_2DOF
from tests.test_torch_soft_contact import port_spec
from tests.test_torch_tick_repairs import SC_ARM, soft_arm_spec

CPU = dict(device="cpu")
# the elbow band: fixed rho 10 lets the ADMM exit early and every scenario
# converge in 3 SQP iterations with the band active
BAND = dict(max_iters=10, max_qp_iters=100, eps_abs=1e-6,
            termination_tolerance=1e-5, rho=10.0)
# the control box: converged in 2-4 SQP iterations, the box ridden
BOX = dict(max_iters=10, max_qp_iters=50, eps_abs=1e-5,
           termination_tolerance=1e-4)
VALUES = ("xs", "us", "K", "k", "cost", "kkt", "gap_norm", "constraint_norm")
COUNTS = ("iters", "qp_iters", "converged")
t = torch.as_tensor


def port_cf(case):
    return build_cost_functions(case.jm, case.p, case.ps, torch.float64)


def solve_port(case, settings, x0s, xs, us, refs):
    solver = make_batch_csqp(case.jm, case.p, case.ps, port_cf(case),
                             CSQPSettings(**settings), **CPU)
    return solver(t(x0s), refs_from_numpy(refs, **CPU), t(xs), t(us))


def assert_match(got, want, field):
    g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
    assert g.shape == w.shape
    if field in COUNTS:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-8)


# -- against the JAX package -------------------------------------------------
@pytest.fixture(scope="module")
def band():
    case = Case("elbow_band")
    refs = case.refs()
    x0s, xs, us = case.start(3, 0)
    solve = jax.jit(jax_make_batch_csqp(case.jm, case.jp, case.js, case.cf,
                                        JaxSettings(**BAND)))
    want = solve(jnp.asarray(x0s), {k: jnp.asarray(v) for k, v in
                                    refs.items()},
                 jnp.asarray(xs), jnp.asarray(us))
    return case, refs, want, solve_port(case, BAND, x0s, xs, us, refs)


@pytest.mark.parametrize("field", VALUES + COUNTS)
def test_batch_csqp_matches_jax(band, field):
    _, _, want, got = band
    assert_match(got, want, field)


def test_band_active_and_converged(band):
    """The case is the one described: converged, the ADMM exiting early
    (fewer than max_qp_iters per SQP iteration), the band active at the
    solution (some row within 1e-4 of a bound)."""
    case, refs, _, got = band
    assert bool(got.converged.all())
    assert (got.qp_iters < got.iters * BAND["max_qp_iters"]).all()
    nodes = make_batch_csqp(case.jm, case.p, case.ps, port_cf(case),
                            CSQPSettings(**BAND), **CPU).nodes
    g, lb, ub = nodes.constraint_vals(got.xs.transpose(0, 1),
                                      got.us.transpose(0, 1),
                                      refs_from_numpy(refs, **CPU))
    assert float(torch.minimum(g - lb, ub - g).min()) < 1e-4
    assert float(got.constraint_norm.max()) < 1e-5


FF_T = 6


def _freeflyer():
    """The 2-DoF arm on a quaternion free-flyer, zero gravity, its tip
    pulled 2 cm: (JAX model, params, spec, refs, x0s [2], the port's
    model params, spec and cost functions)."""
    jm, jp = jax_build(URDF_2DOF, armature=np.array([0.1, 0.1]),
                       gravity=(0.0, 0.0, 0.0), dtype=np.float64,
                       free_flyer=True)
    C = jspec.CostItem
    js = jspec.ProblemSpec(
        running_costs=(C(name="state_reg", kind="state", weight=0.01,
                         update=True),
                       C(name="ctrl", kind="control", weight=1e-4,
                         update=True)),
        terminal_costs=(C(name="goal", kind="frame_placement", weight=100.0,
                          update=True, frame="tip"),),
        horizon=FF_T, dt=0.02)
    nv = jm.nj
    quat = jnp.asarray([0.0, np.sin(0.15), 0.0, np.cos(0.15)])
    x0 = jlie.join_state(jnp.zeros(3), quat, jnp.asarray(Q0), jnp.zeros(nv))
    R0, p0 = jlie.ff_frame_placement(jm, jp, x0, jm.frame_id("tip"))
    refs = {"xref": np.tile(np.asarray(x0)[None], (FF_T + 1, 1)),
            "w_x": np.tile(np.r_[np.full(nv, 0.1), np.ones(nv)][None],
                           (FF_T + 1, 1)),
            "w_u": np.ones((FF_T + 1, nv)), "uref": np.zeros((FF_T + 1, nv)),
            "ee_rot:tip": np.tile(np.asarray(R0)[None], (FF_T + 1, 1, 1)),
            "ee_trans:tip": np.tile(np.asarray(p0) + [0.02, 0.0, -0.02],
                                    (FF_T + 1, 1)),
            "w_ee:tip": np.ones((FF_T + 1, 6))}
    x0s = np.tile(np.asarray(x0)[None], (2, 1))
    x0s[1, 7:9] += [0.05, -0.05]  # the second scenario's joints moved
    p = params_from_numpy(jp, dtype=torch.float64, **CPU)
    ps = to_port_spec(js)
    return jm, jp, js, refs, x0s, p, ps, build_ff_cost_functions(
        jm, p, ps, torch.float64)


FF_SETTINGS = dict(max_iters=12, termination_tolerance=1e-8)


def _ff_port_solve(ff, rows):
    jm, _, _, refs, x0s, p, ps, pcf = ff
    solver = make_batch_csqp(jm, p, ps, pcf, CSQPSettings(**FF_SETTINGS),
                             **CPU)
    assert solver.nodes.backend == "manifold" and solver.kernels == ()
    x0s = x0s[rows]
    xs = np.tile(x0s[:, None], (1, FF_T + 1, 1))
    return solver(t(x0s), refs_from_numpy(refs, **CPU), t(xs),
                  torch.zeros((len(x0s), FF_T, pcf.nu), dtype=torch.float64))


def test_manifold_batch_csqp_rows_and_goal():
    """The manifold branch: each row of the B = 2 solve is its B = 1 solve,
    every scenario converges and the tip moves most of the way to its goal
    (the JAX package's `test_csqp_batch_manifold_unconstrained_path`)."""
    ff = _freeflyer()
    sol = _ff_port_solve(ff, [0, 1])
    assert bool(sol.converged.all())
    from agimus_controller_tpu_torch.ops import lie

    jm, _, _, refs, _, p, _, _ = ff
    for i in range(2):
        one = _ff_port_solve(ff, [i])
        np.testing.assert_allclose(sol.us[i].numpy(), one.us[0].numpy(),
                                   rtol=0, atol=1e-12)
        _, pe = lie.ff_frame_placement(jm, p, sol.xs[i, -1],
                                       jm.frame_id("tip"))
        x0 = sol.xs[i, 0]
        _, p0 = lie.ff_frame_placement(jm, p, x0, jm.frame_id("tip"))
        goal = torch.as_tensor(refs["ee_trans:tip"][-1])
        assert float((pe - goal).norm()) < 0.7 * float((p0 - goal).norm())


@pytest.fixture(scope="module")
def freeflyer():
    ff = _freeflyer()
    jm, jp, js, refs, x0s, *_ = ff
    cf = jax_ff_cf(jm, jp, js, dtype=jnp.float64)
    xs = np.tile(x0s[:, None], (1, FF_T + 1, 1))
    want = jax.jit(jax_make_batch_csqp(jm, jp, js, cf, JaxSettings(
        **FF_SETTINGS)))(jnp.asarray(x0s), {k: jnp.asarray(v) for k, v in
                                            refs.items()},
                         jnp.asarray(xs),
                         jnp.zeros((2, FF_T, jm.nj - jlie.N_FF)))
    return want, _ff_port_solve(ff, [0, 1])


@pytest.mark.slow  # the JAX manifold solver compiles for ~50 s
@pytest.mark.parametrize("field", VALUES + COUNTS)
def test_manifold_batch_csqp_matches_jax(freeflyer, field):
    want, got = freeflyer
    assert_match(got, want, field)


# -- the properties of tests/test_csqp_batch.py, on the port side ------------
@pytest.fixture(scope="module")
def box():
    return Case("control_box")


def test_batch_csqp_matches_single(box):
    """Each row equals the single-scenario `solve_csqp`; the control box
    holds and the dynamics close."""
    refs = box.refs()
    x0s, xs, us = box.start(3, 0)
    sol = solve_port(box, BOX, x0s, xs, us, refs)
    assert float(sol.us.abs().max()) <= 1.3 + 1e-5
    assert bool(sol.converged.all())
    assert (sol.gap_norm < BOX["termination_tolerance"]).all()
    cf, prefs = port_cf(box), refs_from_numpy(refs, **CPU)
    for i in range(3):
        one = solve_csqp(cf, t(x0s[i]), prefs, t(xs[i]), t(us[i]),
                         CSQPSettings(**BOX))
        np.testing.assert_allclose(sol.us[i].numpy(), one.us.numpy(),
                                   atol=5e-5, err_msg=f"scenario {i}")
        np.testing.assert_allclose(float(sol.cost[i]), float(one.cost),
                                   rtol=1e-5)
        assert int(sol.iters[i]) == int(one.iters)


def test_batch_csqp_unconstrained_matches_fddp_batch(box):
    """No constraint and a strongly regularised tracking OCP: the batch CSQP
    and the batch FDDP find the same optimum."""
    C = jspec.CostItem
    js = jspec.ProblemSpec(
        running_costs=(C(name="state_reg", kind="state", weight=2.0,
                         update=True),
                       C(name="ctrl", kind="control", weight=0.1,
                         update=True)),
        terminal_costs=(C(name="state_reg", kind="state", weight=20.0,
                          update=True),),
        horizon=8, dt=0.02)
    ps = to_port_spec(js)
    refs = {k: np.asarray(v) for k, v in jspec.default_references(
        js, box.jm, dtype=jnp.float64).items()}
    refs["xref"] = np.tile(box.x0[None], (9, 1)) + 0.05
    prefs = refs_from_numpy(refs, **CPU)
    x0s = t(np.tile(box.x0[None], (2, 1)))
    xs, us = x0s[:, None].repeat(1, 9, 1), torch.zeros((2, 8, 2),
                                                     dtype=torch.float64)
    cf = build_cost_functions(box.jm, box.p, ps, torch.float64)
    sol_c = make_batch_csqp(box.jm, box.p, ps, cf, CSQPSettings(
        max_iters=40, termination_tolerance=1e-10), **CPU)(x0s, prefs, xs, us)
    sol_f = make_batch_fddp(box.jm, box.p, ps, SolverSettings(
        max_iters=40, termination_tolerance=1e-10), **CPU)(x0s, prefs, xs, us)
    np.testing.assert_allclose(sol_c.us.numpy(), sol_f.us.numpy(), atol=1e-5)
    np.testing.assert_allclose(sol_c.cost.numpy(), sol_f.cost.numpy(),
                               rtol=1e-8)


def test_batch_csqp_per_scenario_qp_and_convergence(box):
    """An easy and a hard start: per-scenario SQP iteration counts, the
    ADMM bounded by its cap, the box held, the dynamics closed."""
    refs = box.refs()
    x0s, xs, us = box.start(2, 0)
    x0s[1, :2] += 0.3
    xs = np.tile(x0s[:, None], (1, 9, 1))
    settings = dict(max_iters=30, max_qp_iters=100, eps_abs=1e-8,
                    termination_tolerance=1e-6)
    sol = solve_port(box, settings, x0s, xs, us, refs)
    assert (sol.qp_iters <= 30 * 100).all()
    assert (sol.gap_norm < 1e-4).all()
    assert float(sol.us.abs().max()) <= 1.3 + 1e-5


# -- soft contact ------------------------------------------------------------
def _soft_problem():
    jm, jp = jax_build(URDF_2DOF, armature=np.array([0.1, 0.1]),
                       dtype=np.float64)
    base = soft_arm_spec()
    js = jspec.ProblemSpec(
        running_costs=base.running_costs, terminal_costs=base.terminal_costs,
        constraints=(jspec.ConstraintItem(
            name="ubox", kind="control_limit", lower=(-3.0,) * 2,
            upper=(3.0,) * 2),),
        horizon=base.horizon, dt=base.dt, soft_contact=base.soft_contact)
    T = js.horizon
    refs = {k: np.array(v) for k, v in jspec.default_references(
        js, jm, dtype=jnp.float64).items()}
    refs["xref"][:, :2] = Q0
    refs["f_des:tip"] = np.tile([0.0, 0.0, -4.0], (T + 1, 1))
    refs["contact_active"] = np.r_[np.ones(T - 1), 0.0, 0.0]
    x0 = np.r_[Q0, 0.0, 0.0, 0.0, 0.0, 0.0]
    x0s = np.stack([x0, x0 + np.r_[0.05, -0.05, np.zeros(5)]])
    return jm, jp, js, refs, x0s


def test_soft_batch_csqp_matches_single():
    """The soft branch (the force-augmented state, each node's contact
    activation from the refs): each row equals `solve_csqp` on the soft
    cost functions."""
    jm, jp, js, refs, x0s = _soft_problem()
    p = params_from_numpy(jp, dtype=torch.float64, **CPU)
    ps = port_spec(js, SoftContactConfig(**SC_ARM))
    assert set(refs) >= {"f_des:tip", "contact_active"}
    T = js.horizon
    cf = build_cost_functions(jm, p, ps, torch.float64)
    settings = CSQPSettings(max_iters=10, max_qp_iters=50, eps_abs=1e-7,
                            termination_tolerance=1e-6)
    solver = make_batch_csqp(jm, p, ps, cf, settings, **CPU)
    assert solver.nodes.soft and solver.kernels == ()
    xs = np.tile(x0s[:, None], (1, T + 1, 1))
    us = np.zeros((2, T, 2))
    prefs = refs_from_numpy(refs, **CPU)
    sol = solver(t(x0s), prefs, t(xs), t(us))
    assert bool(torch.isfinite(sol.us).all())
    for i in range(2):
        one = solve_csqp(cf, t(x0s[i]), prefs, t(xs[i]), t(us[i]), settings)
        for f in ("xs", "us", "cost", "kkt"):
            np.testing.assert_allclose(getattr(sol, f)[i].numpy(),
                                       getattr(one, f).numpy(), rtol=0,
                                       atol=1e-9, err_msg=f"{f} row {i}")
        assert (int(sol.iters[i]), bool(sol.converged[i])) == (
            int(one.iters), bool(one.converged))


def test_jax_soft_branch_raises():
    """The reference fault the port does not copy: JAX's soft branch calls
    the soft steps without the contact activation."""
    jm, jp, js, refs, x0s = _soft_problem()
    T = js.horizon
    solve = jax_make_batch_csqp(jm, jp, js, jax_cf(jm, jp, js,
                                                   dtype=jnp.float64),
                                JaxSettings(max_iters=1))
    with pytest.raises(TypeError):
        solve(jnp.asarray(x0s), {k: jnp.asarray(v) for k, v in refs.items()},
              jnp.asarray(np.tile(x0s[:, None], (1, T + 1, 1))),
              jnp.zeros((2, T, 2)))
