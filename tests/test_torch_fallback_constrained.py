"""The "xla" backend with constraints on the "pack" route, and the batch
FDDP's `CostFunctions` fallback, vs the JAX package, f64 on the CPU (the
cases of `test_torch_fallback.py`):

- `make_batch_sqp` on the shipped collision YAML with its goal items under
  quad_exp (the cost pack takes the spec, K1-K4 do not), against JAX
  `make_batch_sqp(..., backend="xla")`: the ADMM branch with the collision
  constraint rows of `ConstraintFunctions`;
- `make_batch_fddp` on the flagship-shaped costs with the state items under
  quad_exp (the pack declines them) against JAX `make_batch_fddp`, which
  falls back to `vmap(cf.cost_derivs)` (B=3, 10 iterations, tolerance
  1e-8).

Iterates, gains, duals and reports agree to `ATOL` (1e-8); iteration and
ADMM counts and convergence flags are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from agimus_controller_tpu.solver.fddp import SolverSettings as JaxFddpSettings
from agimus_controller_tpu.solver.fddp_batch import (
    make_batch_fddp as jax_make_batch_fddp,
)
from agimus_controller_tpu_torch.ocp.costs import CostFunctions
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.solver.fddp import SolverSettings
from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp
from tests.test_torch_fallback import (
    COUNTS,
    check_solution,
    declined_case,
    solve_sqp_both,
)
from tests.test_torch_tick import ATOL


def test_xla_backend_constrained_pack_matches_jax():
    ref, sol, port = solve_sqp_both("pack", constrained=True)
    check_solution("pack", ref, sol, port, constrained=True)


def test_batch_fddp_cost_functions_fallback_matches_jax():
    """The pack declines the spec: `make_batch_fddp` evaluates the costs
    through `CostFunctions`, as JAX `make_batch_fddp` through its
    `vmap(cf.cost_derivs)`."""
    c = declined_case("cost_functions", constrained=False)
    refs = c.refs()
    x0s, xs, us = c.start(3, seed=5)
    kw = dict(max_iters=10, termination_tolerance=1e-8)
    solve = jax.jit(jax_make_batch_fddp(c.jm, c.jp, c.js, c.cf,
                                        JaxFddpSettings(**kw)))
    j = jnp.asarray
    ref = solve(j(x0s), {k: j(v) for k, v in refs.items()}, j(xs), j(us))
    port = make_batch_fddp(c.jm, c.p, c.ps, SolverSettings(**kw),
                           device="cpu")
    assert isinstance(port.pack, CostFunctions)
    t = torch.as_tensor
    sol = port(t(x0s), refs_from_numpy(refs, device="cpu"), t(xs), t(us))
    for f in ("xs", "us", "K", "k", "cost", "kkt", "gap_norm", "reg",
              "iters", "converged"):
        g, w = getattr(sol, f).numpy(), np.asarray(getattr(ref, f))
        if f in COUNTS:
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=f)
    assert int(sol.iters.min()) >= 2
