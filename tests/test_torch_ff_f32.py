"""The port's FDDP solvers on the quaternion free-flyer in float32, the
card's dtype, against float64 and the JAX package.

The problem is `chip_smoke.ff_problem`: the Panda on a free-flyer base at
pitch pi/2, full actuation, the hand's goal 5 cm away, T = 15 here.

A float32 trajectory that is feasible keeps gaps of a few machine epsilons
(the round-off of the step and of the state's retraction). The JAX solvers
count an iterate as infeasible above a gap of 1e-9, so in float32 every
iterate does, and the filter line search then takes any full step on gap
contraction alone, cost increases included: the JAX package's float32
solve of this problem raises its cost at iteration 4 and diverges. The
port gates at 100 epsilons of the dtype (`fddp.feasibility_gate`, 1e-9 in
float64):

- the gate's values, and the retraction round trip's float32 defects of
  the port and of JAX, both above 1e-9 and under the gate;
- tier 1: the port's float32 `solve_fddp` takes the float64 solve's
  iterations and ends on its hand position (`BatchFDDP`: the next file);
- slow (a JAX compile of ~100 s each): the port's float32 iterates equal
  JAX's through iteration 3, where the gate has not yet decided a step,
  and at iteration 4 JAX's cost rises where the port's falls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.ocp.ff_costs import build_ff_cost_functions as jax_ff
from agimus_controller_tpu.ops import lie as jlie
from agimus_controller_tpu.solver.fddp import SolverSettings as JaxSettings
from agimus_controller_tpu.solver.fddp import solve_fddp as jax_solve_fddp
from agimus_controller_tpu_torch.ops import lie
from agimus_controller_tpu_torch.solver.fddp import (
    SolverSettings,
    feasibility_gate,
    solve_fddp,
)

T = 15
SETTINGS = dict(max_iters=30, termination_tolerance=1e-4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def problems():
    return {d: cs.ff_problem(CPU, d, T) for d in (torch.float32,
                                                  torch.float64)}


@pytest.fixture(scope="module")
def f64_solution(problems):
    p = problems[torch.float64]
    return solve_fddp(p.cf, p.x0, p.refs, p.xs0, p.us0,
                      SolverSettings(**SETTINGS))


def test_feasibility_gate():
    """The gate is JAX's 1e-9 in float64 and 100 epsilons in float32."""
    assert feasibility_gate(torch.float64) == 1e-9
    assert feasibility_gate(torch.float32) == 100 * torch.finfo(
        torch.float32).eps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f32_round_trip_defects_match_jax(seed):
    """`state_difference(state_integrate(x, 0), x)` in float32 at 16 states
    of random base orientation (seed 0's first: the base pitched at pi/2):
    the port's and JAX's defects agree to 1e-6, each lies under the port's
    gate, and the largest of each above JAX's 1e-9 gate."""
    rng = np.random.default_rng(seed)
    model, _ = jax_load_panda(dtype=np.float32, free_flyer=True)
    nv = model.nj
    quats = rng.normal(size=(16, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    if seed == 0:
        quats[0] = [0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)]
    zero = np.zeros(2 * nv, np.float32)
    jint, jdiff = jlie.state_integrate(model), jlie.state_difference(model)
    tint, tdiff = lie.state_integrate(model), lie.state_difference(model)
    want, got = [], []
    for quat in quats:
        x = np.concatenate([rng.normal(size=3), quat,
                            rng.normal(size=nv - 6) * 0.5,
                            rng.normal(size=nv)]).astype(np.float32)
        jx, tx = jnp.asarray(x), torch.as_tensor(x)
        want.append(np.asarray(jdiff(jint(jx, jnp.asarray(zero)), jx)))
        got.append(tdiff(tint(tx, torch.as_tensor(zero)), tx).numpy())
    want, got = np.abs(want), np.abs(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for d in (got, want):
        assert 1e-9 < d.max() < feasibility_gate(torch.float32)


def check_follows_f64(problems, want, xs, cost, iters, converged):
    """The float32 solve converged in the float64 solve's iterations and
    ends with the hand within 1e-5 m of the float64 solve's, its cost
    within 1e-5 relative, under 2 cm from the goal."""
    p, p64 = problems[torch.float32], problems[torch.float64]
    assert bool(converged) and bool(want.converged)
    assert int(iters) == int(want.iters)
    np.testing.assert_allclose(p.hand(xs[-1]).double().numpy(),
                               p64.hand(want.xs[-1]).numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(cost), float(want.cost), rtol=1e-5)
    assert p.end_error(xs[-1]) < 0.02


def test_f32_manifold_solve_fddp_follows_f64(problems, f64_solution):
    """`solve_fddp` in float32 follows its float64 solve
    (`check_follows_f64`)."""
    p = problems[torch.float32]
    got = solve_fddp(p.cf, p.x0, p.refs, p.xs0, p.us0,
                     SolverSettings(**SETTINGS))
    check_follows_f64(problems, f64_solution, got.xs, got.cost, got.iters,
                      got.converged)


@pytest.mark.slow
def test_f32_solve_fddp_against_jax(problems):
    """JAX's float32 `solve_fddp` and the port's agree through iteration 3
    (cost within 1e-5 relative, states within 1e-3, controls within 1e-2
    on forces of ~100 N); at iteration 4 JAX's 1e-9 gate takes a full step
    that raises its cost, and the port's cost falls."""
    p = problems[torch.float32]
    jm, jp = jax_load_panda(dtype=np.float32, free_flyer=True)
    jcf = jax_ff(jm, jp, p.spec, dtype=jnp.float32, actuation="full")
    J = lambda a: jnp.asarray(a.numpy())
    jrefs = {k: J(v) for k, v in p.refs.items()}
    costs = {}
    for k in (3, 4):
        want = jax.jit(lambda x0, xs, us: jax_solve_fddp(
            jcf, x0, jrefs, xs, us, JaxSettings(max_iters=k,
                                                termination_tolerance=1e-4)))(
            J(p.x0), J(p.xs0), J(p.us0))
        got = solve_fddp(p.cf, p.x0, p.refs, p.xs0, p.us0,
                         SolverSettings(max_iters=k,
                                        termination_tolerance=1e-4))
        costs[k] = float(want.cost), float(got.cost)
        if k == 3:
            np.testing.assert_allclose(costs[k][1], costs[k][0], rtol=1e-5)
            np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs),
                                       rtol=0, atol=1e-3)
            np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us),
                                       rtol=0, atol=1e-2)
    assert costs[4][0] > costs[3][0] and costs[4][1] < costs[3][1]
