"""The port's manifold `BatchFDDP` in float32 on the quaternion
free-flyer: its rows follow the float64 `solve_fddp` (the problem, the
fixtures and the check of `test_torch_ff_f32.py`, where the float32
feasibility gate is explained)."""

import torch

from agimus_controller_tpu_torch.solver.fddp import SolverSettings
from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp
from tests.test_torch_ff_f32 import (  # noqa: F401 (fixtures)
    SETTINGS,
    check_follows_f64,
    f64_solution,
    problems,
)


def test_f32_manifold_batch_fddp_follows_f64(problems, f64_solution):
    """`BatchFDDP` at B = 2 in float32: equal rows, each following the
    float64 solve (`check_follows_f64`)."""
    p, B = problems[torch.float32], 2
    sol = make_batch_fddp(p.model, p.params, p.spec,
                          SolverSettings(**SETTINGS), device="cpu", cf=p.cf)(
        p.x0[None].expand(B, -1), p.refs, p.xs0[None].expand(B, -1, -1),
        p.us0[None].expand(B, -1, -1))
    assert torch.equal(sol.xs[0], sol.xs[1])
    check_follows_f64(problems, f64_solution, sol.xs[0], sol.cost[0],
                      sol.iters[0], sol.converged[0])
