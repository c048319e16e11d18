"""The port's single-scenario solvers vs the JAX package's, f64 on the CPU.

`solve_fddp` and `solve_csqp` over `build_cost_functions` against JAX
`solve_fddp`/`solve_csqp` over its `build_cost_functions`, on the 2-DoF arm
of `_torch_csqp_cases.py` (T=8, dt = 2^-6), from a perturbed start:

- `solve_fddp` on the flagship-shaped goal reaching (`elbow_band`'s costs
  without the constraint), with the filter line search and with the
  Goldstein acceptance (`use_filter_line_search=False`);
- `solve_csqp` on the same costs unconstrained, on the elbow band (a
  frame-translation box on `l2`, nc=3) and on the shipped
  collision-avoidance YAML (the hard 1 cm distance constraint, nc=1).

Iterates, gains, costs and norms agree to `ATOL` of `test_torch_tick.py`
(1e-8); iteration counts, ADMM iteration counts and convergence flags are
equal. Each case is one JAX solver compile (~15 s); the constrained ones
run in `test_torch_solvers_constrained.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.ocp.costs import build_cost_functions as jax_build_cf
from agimus_controller_tpu.solver.csqp import CSQPSettings as JaxCSQPSettings
from agimus_controller_tpu.solver.csqp import solve_csqp as jax_solve_csqp
from agimus_controller_tpu.solver.fddp import SolverSettings as JaxSettings
from agimus_controller_tpu.solver.fddp import solve_fddp as jax_solve_fddp
from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings, solve_csqp
from agimus_controller_tpu_torch.solver.fddp import SolverSettings, solve_fddp
from tests._torch_csqp_cases import Case, to_port_spec
from tests.test_torch_tick import ATOL

# case: (Case name, drop the constraints, solver, settings)
CASES = {
    "fddp_filter": ("elbow_band", True, "fddp",
                    dict(max_iters=12, termination_tolerance=1e-8)),
    "fddp_goldstein": ("elbow_band", True, "fddp",
                       dict(max_iters=12, termination_tolerance=1e-8,
                            use_filter_line_search=False)),
    "csqp_unconstrained": ("elbow_band", True, "csqp",
                           dict(max_iters=10, termination_tolerance=1e-8)),
    "csqp_elbow_band": ("elbow_band", False, "csqp",
                        dict(max_iters=10, max_qp_iters=60, eps_abs=1e-8,
                             termination_tolerance=1e-6, reg_min=1e-8)),
    "csqp_yaml": ("yaml", False, "csqp",
                  dict(max_iters=10, max_qp_iters=40,
                       termination_tolerance=1e-5)),
}
FIELDS = {"fddp": ("xs", "us", "K", "k", "cost", "kkt", "gap_norm", "reg",
                   "iters", "converged"),
          "csqp": ("xs", "us", "K", "k", "cost", "kkt", "gap_norm",
                   "constraint_norm", "iters", "qp_iters", "converged")}
COUNTS = ("iters", "qp_iters", "converged")


def solve_both(case):
    """(case, solver, JAX solution, port solution) of one case."""
    name, unconstrained, solver, kw = CASES[case]
    c = Case(name)
    js = c.js
    if unconstrained:
        js = dataclasses.replace(js, constraints=())
    refs = c.refs()
    x0s, xs0, us0 = c.start(1, seed=3)
    jcf = jax_build_cf(c.jm, c.jp, js, dtype=jnp.float64)
    pcf = build_cost_functions(c.jm, c.p, to_port_spec(js),
                               dtype=torch.float64)
    if solver == "fddp":
        jsolve, psolve = jax_solve_fddp, solve_fddp
        jset, pset = JaxSettings(**kw), SolverSettings(**kw)
    else:
        jsolve, psolve = jax_solve_csqp, solve_csqp
        jset, pset = JaxCSQPSettings(**kw), CSQPSettings(**kw)
    want = jax.jit(lambda x0, r, xs, us: jsolve(jcf, x0, r, xs, us, jset))(
        jnp.asarray(x0s[0]), {k: jnp.asarray(v) for k, v in refs.items()},
        jnp.asarray(xs0[0]), jnp.asarray(us0[0]))
    t = torch.as_tensor
    got = psolve(pcf, t(x0s[0]), refs_from_numpy(refs, device="cpu"),
                 t(xs0[0]), t(us0[0]), pset)
    return case, solver, want, got


ALL_FIELDS = sorted(set(FIELDS["fddp"] + FIELDS["csqp"]))


def check_field(solved, field):
    name, solver, want, got = solved
    if field not in FIELDS[solver]:
        assert not hasattr(got, field) or field == "reg"
        return
    g, w = getattr(got, field), np.asarray(getattr(want, field))
    g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
    assert g.shape == w.shape, (field, g.shape, w.shape)
    if field in COUNTS:
        np.testing.assert_array_equal(g, w, err_msg=f"{name} {field}")
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL,
                                   err_msg=f"{name} {field}")


def check_loops(solved):
    """The cases exercise what they are for: the constrained ones run the
    ADMM, the loops read their flags on the host once per pass, and the
    goal problems converge."""
    name, solver, want, got = solved
    iters = int(got.iters)
    assert iters >= 2, name
    if name in ("csqp_elbow_band", "csqp_yaml"):
        assert int(got.qp_iters) > iters
        assert got.host_syncs == iters + int(got.qp_iters) + (
            iters < CASES[name][3]["max_iters"])
    else:
        assert bool(got.converged), name
        assert got.host_syncs == iters + (
            iters < CASES[name][3]["max_iters"])


@pytest.fixture(scope="module",
                params=["fddp_filter", "fddp_goldstein", "csqp_unconstrained"])
def solved(request):
    return solve_both(request.param)


@pytest.mark.parametrize("field", ALL_FIELDS)
def test_single_solver_matches_jax(solved, field):
    check_field(solved, field)


def test_single_solver_runs_its_loops(solved):
    check_loops(solved)
