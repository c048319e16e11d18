"""The sharded solvers over slots of one card (`parallel/mesh.py`).

Marked `cuda`: skips without a CUDA device (the CPU holds of the same
solvers, slot counts 1, 2 and 8, are `test_torch_mesh.py`). On the card,
f32, `chip_smoke.keep_away_problem` (the keep-away collision CSQP, T=24)
at B=8 over four slots of `cuda:0`: the sharded batch SQP on the stage
kernels and the sharded batch CSQP on the step kernels against their
unsharded solves, by phase 4's rule (iterations and flags equal, us within
1e-3); the batch CSQP's ADMM counts equal. On a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_mesh.py
"""

import pytest
import torch

import chip_smoke as smoke

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh's slots lie on the card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def problem(device):
    return smoke.keep_away_problem(device, 8, seed=0)


def test_sharded_sqp_on_the_stage_kernels(device, problem):
    from agimus_controller_tpu_torch.parallel.mesh import (
        make_mesh,
        sharded_batch_sqp,
    )
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
    from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp

    model, params, spec, refs, x0s, xs0, us0 = problem
    s = CSQPSettings(max_iters=2, max_qp_iters=10, reg_init=1e-7)
    mesh = make_mesh(4, devices=[device] * 4)
    sharded = sharded_batch_sqp(model, params, spec, None, s, mesh)
    solver = sharded.solver(device)
    assert solver.backend == "kernels"
    for k in solver.kernels:
        k.launches = 0
    got = sharded(x0s, refs, xs0, us0)
    assert min(k.launches for k in solver.kernels) > 0
    smoke._rows_agree("sqp", got, make_batch_sqp(
        model, params, spec, s, device=device)(x0s, refs, xs0, us0))


def test_sharded_csqp_on_the_step_kernels(device, problem):
    from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
    from agimus_controller_tpu_torch.parallel.mesh import (
        make_mesh,
        sharded_batch_csqp,
    )
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
    from agimus_controller_tpu_torch.solver.csqp_batch import make_batch_csqp

    model, params, spec, refs, x0s, xs0, us0 = problem
    cf = build_cost_functions(model, params, spec)
    s = CSQPSettings(**smoke.CSQP_SETTINGS)
    mesh = make_mesh(4, devices=[device] * 4)
    sharded = sharded_batch_csqp(model, params, spec, cf, s, mesh)
    solver = sharded.solver(device)
    for k in solver.kernels:
        k.launches = 0
    got = sharded(x0s, refs, xs0, us0)
    assert min(k.launches for k in solver.kernels) > 0
    want = make_batch_csqp(model, params, spec, cf, s, device=device)(
        x0s, refs, xs0, us0)
    smoke._rows_agree("csqp", got, want)
    assert torch.equal(got.qp_iters, want.qp_iters)
