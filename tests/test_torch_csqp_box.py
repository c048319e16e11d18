"""The port's constrained batch SQP and fused tick vs the JAX package: a
`control_limit` box (nc=2) the solution rides, 2-DoF arm, T=8, f64.

Same comparisons and tolerances as `test_torch_csqp.py` (atol 1e-8, equal
iteration and ADMM counts); the case is in `_torch_csqp_cases.py`.
"""

import numpy as np
import pytest

from tests._torch_csqp_cases import Case, assert_solutions_match, assert_ticks_match

N_TICKS = 4


@pytest.fixture(scope="module")
def case():
    return Case("control_box")


@pytest.mark.parametrize("B", [1, 3])
def test_batch_sqp_matches_jax(case, B):
    ref, sol = case.solve_both(B)
    assert_solutions_match(ref, sol)
    assert int(sol.qp_iters.min()) > 0
    # the box is active: some control sits on its bound
    assert float(np.abs(sol.us.numpy()).max()) > 1.3 - 1e-4


@pytest.fixture(scope="module")
def chained(case):
    return case.chain_both(N_TICKS)


@pytest.mark.parametrize("tick", range(N_TICKS + 1))
def test_chained_ticks_match_jax(chained, tick):
    assert_ticks_match(chained[tick])
