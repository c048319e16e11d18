"""The batch solvers' fallback backend vs the JAX package, f64 on the CPU.

Specs the stage kernels K1-K4 decline solve on the "xla" backend: the step
kernels K5a/K5b (here their plain versions) with the batched cost pack
where it takes the spec ("pack": the goal items under quad_exp, alpha 0.02)
or the generic `CostFunctions` where it does not ("cost_functions": the
state items under quad_exp, alpha 0.5). On the 2-DoF arm of
`_torch_csqp_cases.py` (T=8, dt = 2^-6, f64, its SETTINGS), B=3 from
perturbed starts with a random dual warm start:

- `make_batch_sqp` (backend "auto", which must resolve to "xla") against
  JAX `make_batch_sqp(..., backend="xla")`, unconstrained (the
  flagship-shaped costs of the `elbow_band` case); with the collision
  constraint of the shipped YAML in `test_torch_fallback_constrained.py`
  ("pack") and `test_torch_fallback_tick.py` ("cost_functions", with a
  fused-tick chain);
- `make_batch_fddp` on the "cost_functions" spec against JAX
  `make_batch_fddp` (its `CostFunctions` fallback), in
  `test_torch_fallback_constrained.py`;
- the "auto" selection table: every `chip_smoke.CHECKED_SPECS` spec and
  the collision YAML on the Panda stay on the kernels; a quad_exp goal, a
  quad_exp state item, a frame fixed to the root (2-DoF arm and the 2-DoF
  fork) and, on the card only, a 3-joint arm go to "xla", each with the
  refusal as its reason.

Iterates, gains, duals and reports agree to `ATOL` (1e-8); iteration and
ADMM counts and convergence flags are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from agimus_controller_tpu.ocp.costs import build_cost_functions as jax_build_cf
from agimus_controller_tpu.solver.csqp import CSQPSettings as JaxSettings
from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp as jax_make_batch_sqp
from agimus_controller_tpu_torch.models.panda import load_panda
from agimus_controller_tpu_torch.models.urdf import build_model_from_urdf
from agimus_controller_tpu_torch.ocp.costs import CostFunctions
from agimus_controller_tpu_torch.ocp.spec import CostItem, ProblemSpec, refs_from_numpy
from agimus_controller_tpu_torch.ops.batched_costs import BatchedCostPack
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp, select_backend
from tests._torch_csqp_cases import NC, SETTINGS, Case, T, to_port_spec
from tests.test_ring_control_loop import URDF_2DOF
from tests.test_torch_step_lanes import URDF_FORK
from tests.test_torch_tick import ATOL

# route -> (the kind put under quad_exp, alpha)
ROUTES = {"pack": ("frame_placement", 0.02), "cost_functions": ("state", 0.5)}
COSTS = {"pack": BatchedCostPack, "cost_functions": CostFunctions}
FIELDS = ("xs", "us", "K", "k", "kkt", "cost", "gap_norm", "constraint_norm",
          "iters", "qp_iters", "converged", "y")
COUNTS = ("iters", "qp_iters", "converged")


def declined(js, route):
    """js with the route's kind under quad_exp, in both models."""
    kind, alpha = ROUTES[route]
    swap = lambda items: tuple(
        dataclasses.replace(i, activation="quad_exp", act_alpha=alpha)
        if i.kind == kind else i for i in items)
    return dataclasses.replace(js, running_costs=swap(js.running_costs),
                               terminal_costs=swap(js.terminal_costs))


def declined_case(route, constrained):
    """A `_torch_csqp_cases.Case` on the declined spec: the YAML's collision
    constraint, or the elbow band's costs without their constraint."""
    c = Case("yaml" if constrained else "elbow_band")
    js = c.js if constrained else dataclasses.replace(c.js, constraints=())
    c.js = declined(js, route)
    c.ps = to_port_spec(c.js)
    c.cf = jax_build_cf(c.jm, c.jp, c.js, dtype=jnp.float64)
    return c


def solve_sqp_both(route, constrained, B=3, seed=0):
    """(JAX solution, port solution, port solver) of one batch solve on the
    "xla" backend from the same inputs and dual warm start."""
    c = declined_case(route, constrained)
    refs = c.refs()
    x0s, xs, us = c.start(B, seed)
    nc = NC["yaml"] if constrained else 1
    y0 = np.random.default_rng(seed + 1).uniform(0.0, 0.1, (B, T + 1, nc))
    solve = jax.jit(jax_make_batch_sqp(c.jm, c.jp, c.js, c.cf,
                                       JaxSettings(**SETTINGS), backend="xla"))
    j = jnp.asarray
    ref = solve(j(x0s), {k: j(v) for k, v in refs.items()}, j(xs), j(us),
                None, j(y0) if constrained else None)
    port = make_batch_sqp(c.jm, c.p, c.ps, CSQPSettings(**SETTINGS),
                          device="cpu")
    t = torch.as_tensor
    sol = port(t(x0s), refs_from_numpy(refs, device="cpu"), t(xs), t(us),
               None, t(y0) if constrained else None)
    return ref, sol, port


def check_solution(route, ref, sol, port, constrained):
    assert port.backend == "xla"
    assert port.backend_reason is not None and "quad_exp" in port.backend_reason
    assert isinstance(port.costs, COSTS[route])
    for f in FIELDS:
        if f == "y" and not constrained:
            continue  # the JAX solver carries no duals without constraints
        g, w = getattr(sol, f).numpy(), np.asarray(getattr(ref, f))
        assert g.shape == w.shape, f
        if f in COUNTS:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f)
    assert int(sol.iters.min()) >= 2  # real iterations compared
    if constrained:
        assert int(sol.qp_iters.min()) > int(sol.iters.min())


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_xla_backend_matches_jax(route):
    ref, sol, port = solve_sqp_both(route, constrained=False)
    check_solution(route, ref, sol, port, constrained=False)


# ---------------------------------------------------------------------------
# the "auto" selection
# ---------------------------------------------------------------------------

URDF_3DOF = URDF_2DOF.replace(
    '<joint name="jt" type="fixed"><parent link="l2"/><child link="tip"/>',
    '<joint name="j3" type="revolute"><parent link="l2"/><child link="tip"/>'
    '<axis xyz="0 1 0"/><limit effort="50" lower="-3" upper="3" '
    'velocity="3"/>').replace(
    '<link name="tip"/>',
    '<link name="tip"><inertial><mass value="0.3"/><inertia ixx="0.001" '
    'iyy="0.001" izz="0.001" ixy="0" ixz="0" iyz="0"/></inertial></link>')


def _goal_spec(frame, **kw):
    C = CostItem
    return ProblemSpec(
        running_costs=(C(name="x", kind="state", weight=0.1, update=True),
                       C(name="goal", kind="frame_placement", weight=10.0,
                         update=True, frame=frame, **kw)),
        terminal_costs=(), horizon=4, dt=0.01)


@pytest.fixture(scope="module")
def models():
    cpu = dict(dtype=torch.float64, device="cpu")
    build = lambda urdf: build_model_from_urdf(
        urdf, armature=np.full(urdf.count('type="revolute"')
                               + urdf.count('type="prismatic"'), 0.1), **cpu)
    return dict(panda=load_panda(env_urdf=chip_smoke.ENV_URDF,
                                 collision_pairs=chip_smoke.PAIR, **cpu),
                arm=build(URDF_2DOF), fork=build(URDF_FORK),
                arm3=build(URDF_3DOF))


CUDA = torch.device("cuda")


@pytest.mark.parametrize("name", chip_smoke.CHECKED_SPECS)
def test_auto_keeps_checked_specs_on_the_kernels(models, name):
    model, _ = models["panda"]
    spec = chip_smoke.SPECS[name](100, model)
    for device in (CUDA, torch.device("cpu")):
        assert select_backend(model, spec, device) == ("kernels", None)


def test_auto_keeps_the_collision_yaml_on_the_kernels(models):
    model, _ = models["panda"]
    for T in (19, 100):
        spec = chip_smoke.yaml_spec(T, model)
        assert spec.constraints and select_backend(model, spec, CUDA) == (
            "kernels", None)


# case: (model, spec factory, device, reason fragment or None)
DECLINED = {
    "quad_exp_goal": ("panda", lambda: declined(
        chip_smoke.flagship_spec(100), "pack"), CUDA, "quad_exp"),
    "quad_exp_state": ("panda", lambda: declined(
        chip_smoke.flagship_spec(100), "cost_functions"), CUDA, "quad_exp"),
    "root_frame_arm": ("arm", lambda: _goal_spec("base"), CUDA,
                       "fixed to the root"),
    "root_frame_fork": ("fork", lambda: _goal_spec("base"), CUDA,
                        "fixed to the root"),
    "root_frame_fork_cpu": ("fork", lambda: _goal_spec("base"),
                            torch.device("cpu"), "fixed to the root"),
    "nj3_card": ("arm3", lambda: _goal_spec("tip"), CUDA, "queue 2, item 4"),
    "nj3_cpu": ("arm3", lambda: _goal_spec("tip"), torch.device("cpu"), None),
    "fork_tip_card": ("fork", lambda: _goal_spec("l2"), CUDA, None),
}


@pytest.mark.parametrize("case", sorted(DECLINED))
def test_auto_selection(models, case):
    name, make, device, reason = DECLINED[case]
    model, _ = models[name]
    backend, why = select_backend(model, make(), device)
    if reason is None:
        assert (backend, why) == ("kernels", None)
    else:
        assert backend == "xla" and reason in why, why
    # "xla" is taken as it is; the stage kernels are never named
    assert select_backend(model, make(), device, "xla") == ("xla", None)
    for named in ("pallas", "kernels"):
        with pytest.raises(ValueError):
            select_backend(model, make(), device, named)


def test_declined_spec_solves_on_the_cpu(models):
    """A frame fixed to the root on the fork and a 3-joint arm: "auto"
    builds the xla backend (or the kernels' plain versions) and solves."""
    for name, frame in (("fork", "base"), ("arm3", "tip")):
        model, params = models[name]
        spec = dataclasses.replace(_goal_spec(frame), terminal_costs=(
            CostItem(name="x", kind="state", weight=1.0, update=True),))
        solver = make_batch_sqp(model, params, spec,
                                CSQPSettings(max_iters=3), device="cpu")
        assert solver.backend == ("xla" if name == "fork" else "kernels")
        refs = chip_smoke_refs(spec, model)
        nx, nu = 2 * model.nj, model.nj
        sol = solver(torch.zeros((1, nx), dtype=torch.float64), refs,
                     torch.zeros((1, spec.horizon + 1, nx),
                                 dtype=torch.float64),
                     torch.zeros((1, spec.horizon, nu), dtype=torch.float64))
        assert bool(torch.isfinite(sol.us).all()) and int(sol.iters) >= 1


def chip_smoke_refs(spec, model):
    from agimus_controller_tpu_torch.ocp.spec import default_references

    refs = default_references(spec, model, dtype=torch.float64, device="cpu")
    for k in refs:
        if k.startswith("ee_trans:"):
            refs[k] = refs[k] + 0.05
    return refs
