"""The port's `CostFunctions` vs the JAX package's on constraints and on
the Panda, f64 on the CPU (the checks of `test_torch_cost_functions.py`).

- `constraints`: the 2-DoF arm with every constraint kind the port takes
  (`CONSTRAINTS`): control_limit, state, control and, new with the
  single-scenario solvers, control_grav, frame_velocity and visual_servoing
  (the latter reading the object transform `wMo_*:None`, as the JAX
  constraint does), beside a frame-translation band and the collision
  distance, some rows not enforced at the terminal node; `constraints` and
  `constraint_derivs` at atol 1e-10 / 1e-9, the row counts and masks equal.
- `panda`: the flagship spec with quad_exp goal items (alpha 0.02), the
  declined spec of `chip_smoke.py` phase 5a, at T=6.
"""

import pytest

from tests.test_torch_cost_functions import (  # noqa: F401 (fixture)
    FIELDS,
    arm_model,
    check_field,
    check_metadata,
    make_case,
)


@pytest.fixture(scope="module", params=["constraints", "panda"])
def case(request, arm_model):
    return make_case(request.param, arm_model)


@pytest.mark.parametrize("field", FIELDS)
def test_constraint_kinds_match_jax(case, field):
    check_field(case, field)


def test_constraint_kind_metadata_match_jax(case):
    check_metadata(case)
