"""`solve_csqp` vs JAX `solve_csqp` on the constrained cases of
`test_torch_solvers_single.py` (the elbow band and the collision YAML on the
2-DoF arm, f64): iterates to 1e-8, equal SQP and ADMM iteration counts."""

import pytest

from tests.test_torch_solvers_single import (
    ALL_FIELDS,
    check_field,
    check_loops,
    solve_both,
)


@pytest.fixture(scope="module", params=["csqp_elbow_band", "csqp_yaml"])
def solved(request):
    return solve_both(request.param)


@pytest.mark.parametrize("field", ALL_FIELDS)
def test_constrained_solver_matches_jax(solved, field):
    check_field(solved, field)


def test_constrained_solver_runs_its_loops(solved):
    check_loops(solved)
