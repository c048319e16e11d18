"""The port's constrained batch SQP and fused tick vs the JAX package: the
elbow band (nc=3), 2-DoF arm, T=8, f64.

On the CPU the port runs the plain versions of the stage kernels and the
`torch.func` constraint Jacobians; the JAX solver runs its XLA path. The
batch solve (B=1 and B=3, warm-started duals) and a 4-tick chained fused-tick
run with the duals carried agree to atol 1e-8, with equal iteration and ADMM
counts and convergence flags. The cases are in `_torch_csqp_cases.py`; the
control box and the shipped YAML run in `test_torch_csqp_box.py` and
`test_torch_csqp_yaml.py`, so the three JAX compiles spread over workers.
"""

import numpy as np
import pytest
import torch

from agimus_controller_tpu_torch.mpc.buffer import DTFactorsNSeq
from agimus_controller_tpu_torch.mpc.ring import PackedTrajectoryBuffer, RowLayout
from agimus_controller_tpu_torch.mpc.tick import FusedTickRunner
from agimus_controller_tpu_torch.ocp import spec as tspec
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from tests._torch_csqp_cases import (
    SETTINGS,
    T,
    Case,
    assert_solutions_match,
    assert_ticks_match,
)

N_TICKS = 4


@pytest.fixture(scope="module")
def case():
    return Case("elbow_band")


@pytest.mark.parametrize("B", [1, 3])
def test_batch_sqp_matches_jax(case, B):
    ref, sol = case.solve_both(B)
    assert_solutions_match(ref, sol)
    # the comparison covers real ADMM work on an active band
    assert int(sol.qp_iters.min()) > 0
    assert float(np.abs(sol.y.numpy()).max()) > 0.0


@pytest.fixture(scope="module")
def chained(case):
    return case.chain_both(N_TICKS)


@pytest.mark.parametrize("tick", range(N_TICKS + 1))
def test_chained_ticks_match_jax(chained, tick):
    assert_ticks_match(chained[tick])


def test_tick_carries_duals_of_every_row(case):
    """The fused tick's dual carry is [T+1, nc] for a spec with nc > 1 (it
    was fixed at one column, which broke every such spec)."""
    seq = DTFactorsNSeq(factors=[1], n_steps=[T])
    buf = PackedTrajectoryBuffer(seq, RowLayout(case.ps, case.jm),
                                 dtype=torch.float64, device="cpu")
    for i in range(3 * T):
        buf.append(case._point(i))
    refs = tspec.default_references(case.ps, case.jm, dtype=torch.float64,
                                    device="cpu")
    refs.update(refs_from_numpy(case.base_refs(), device="cpu"))
    runner = FusedTickRunner(case.jm, case.p, case.ps, buf.ring, refs,
                             CSQPSettings(**SETTINGS), dtype=torch.float64,
                             device="cpu")
    out = runner.initialize(case.x0, np.tile(case.x0[None], (T + 1, 1)),
                            np.tile(case.tau_g[None], (T, 1)), limit=5)
    assert tuple(out.y.shape) == (T + 1, 3)
    out = runner.step(case.x0, limit=2)
    assert tuple(out.y.shape) == (T + 1, 3)
    assert bool(torch.isfinite(out.u0).all())
