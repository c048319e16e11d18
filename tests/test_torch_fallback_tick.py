"""The "xla" backend on the `CostFunctions` route with constraints, and a
fused-tick chain over that spec, vs the JAX package, f64 on the CPU (the
cases of `test_torch_fallback.py`):

- `make_batch_sqp` on the shipped collision YAML with its state items under
  quad_exp (neither K1-K4 nor the cost pack take the spec), against JAX
  `make_batch_sqp(..., backend="xla")`;
- a chained `FusedTickRunner` run on the same spec (first solve, four ticks
  with a drifting measured state, duals carried) against the JAX runner:
  controls, gains, KKT and duals tick by tick.

Iterates, gains, duals and reports agree to `ATOL` (1e-8); iteration and
ADMM counts and convergence flags are equal.
"""

import numpy as np
import pytest

from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp
from tests._torch_csqp_cases import SETTINGS
from tests.test_torch_fallback import (
    check_solution,
    declined_case,
    solve_sqp_both,
)
from tests.test_torch_tick import ATOL


def test_xla_backend_constrained_cost_functions_matches_jax():
    ref, sol, port = solve_sqp_both("cost_functions", constrained=True)
    check_solution("cost_functions", ref, sol, port, constrained=True)


@pytest.fixture(scope="module")
def chained():
    c = declined_case("cost_functions", constrained=True)
    tick_solver = make_batch_sqp(c.jm, c.p, c.ps, CSQPSettings(**SETTINGS),
                                 device="cpu")
    return tick_solver.backend, c.chain_both(n_ticks=4)


@pytest.mark.parametrize("tick", range(5))
def test_chained_ticks_on_xla_match_jax(chained, tick):
    backend, out = chained
    assert backend == "xla"
    (jK0, ju0, jkkt, jit, jconv), (K0, u0, kkt, it, conv), jy, y = out[tick]
    np.testing.assert_allclose(K0, jK0, rtol=0, atol=ATOL)
    np.testing.assert_allclose(u0, ju0, rtol=0, atol=ATOL)
    np.testing.assert_allclose(y, jy, rtol=0, atol=ATOL)
    assert abs(kkt - jkkt) <= ATOL
    assert (it, conv) == (jit, jconv)
