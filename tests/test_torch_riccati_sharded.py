"""The horizon-sharded Riccati (`solver/riccati_sharded.py`) of the port.

- `make_tsharded_riccati` over 8 CPU slots against the JAX package's on
  its 8-device mesh (T = 64, nx = 14, nu = 7; rtol 1e-9, atol 1e-10, the
  JAX test's), and against the port's `parallel_riccati` (the JAX test's
  check), over 1, 2 and 8 slots.
- `solve_fddp_tsharded` against the port's `solve_fddp` on the Panda
  flagship OCP in f64 at T = 16 over 8 slots; T not divisible raises.
- `-m slow`: `solve_fddp_tsharded` against the JAX package's at T = 64
  (the JAX Panda solver compiles for minutes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.parallel.mesh import make_mesh as jax_make_mesh
from agimus_controller_tpu.solver.riccati_sharded import (
    make_tsharded_riccati as jax_make_tsharded_riccati,
)
from agimus_controller_tpu_torch.parallel.mesh import make_mesh
from agimus_controller_tpu_torch.solver.fddp import SolverSettings, solve_fddp
from agimus_controller_tpu_torch.solver.riccati_pscan import parallel_riccati
from agimus_controller_tpu_torch.solver.riccati_sharded import (
    make_tsharded_riccati,
    solve_fddp_tsharded,
)
from tests.test_riccati_sharded import _random_lqr

T, NX, NU = 64, 14, 7
REG = 1e-6
OUT = ("ks", "Ks", "Qus", "Vx", "Vxx", "d1", "d2")


def cpu_mesh(n):
    return make_mesh(n, axis_name="t", devices=["cpu"] * n)


@pytest.fixture(scope="module")
def lqr():
    a = _random_lqr(T, NX, NU)
    return a, [torch.tensor(np.asarray(x)) for x in a]


@pytest.fixture(scope="module")
def jax_sharded(lqr):
    a, _ = lqr
    riccati = jax.jit(jax_make_tsharded_riccati(
        jax_make_mesh(8, axis_name="t"), "t"))
    return riccati(*a[:7], a[7][1:], a[8], a[9], jnp.asarray(REG, a[0].dtype))


@pytest.fixture(scope="module")
def port_sharded(lqr):
    _, ta = lqr
    return make_tsharded_riccati(cpu_mesh(8))(*ta[:7], ta[7][1:], ta[8],
                                              ta[9], REG)


@pytest.mark.parametrize("i", range(len(OUT)), ids=OUT)
def test_tsharded_riccati_matches_jax(jax_sharded, port_sharded, i):
    np.testing.assert_allclose(port_sharded[i].numpy(),
                               np.asarray(jax_sharded[i]), rtol=1e-9,
                               atol=1e-10)


@pytest.mark.parametrize("n_slots", (1, 2, 8))
def test_tsharded_riccati_matches_parallel_riccati(lqr, n_slots):
    """Every slot count gives the port's one-device scan (B = 1): gains, V
    at nodes 0..T-1, d1 and d2."""
    _, ta = lqr
    got = make_tsharded_riccati(cpu_mesh(n_slots))(*ta[:7], ta[7][1:],
                                                   ta[8], ta[9], REG)
    b = lambda x: x[:, None]
    ks, Ks, Qus, d1, d2, bad = parallel_riccati(
        *(b(x) for x in ta[:8]), ta[8][None], ta[9][None],
        torch.tensor([REG], dtype=torch.float64))
    assert not bool(bad.any())
    for g, w in zip(got, (ks[:, 0], Ks[:, 0], Qus[:, 0])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-10)
    np.testing.assert_allclose(float(got[5]), float(d1[0]), rtol=1e-9)
    np.testing.assert_allclose(float(got[6]), float(d2[0]), rtol=1e-9)


def test_tsharded_riccati_refuses_a_ragged_horizon(lqr):
    _, ta = lqr
    riccati = make_tsharded_riccati(cpu_mesh(3))
    with pytest.raises(ValueError, match="must divide"):
        riccati(*ta[:7], ta[7][1:], ta[8], ta[9], REG)


def flagship(T):
    """The Panda flagship OCP of `__graft_entry__._build_problem` on the
    port, f64 on the CPU: (cf, x0, refs, xs0, us0)."""
    import chip_smoke
    from agimus_controller_tpu_torch.models.panda import (
        PANDA_Q_READY,
        load_panda,
    )
    from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
    from agimus_controller_tpu_torch.ocp.spec import default_references

    model, params = load_panda(dtype=torch.float64, device="cpu")
    spec = chip_smoke.flagship_spec(T)
    cf = build_cost_functions(model, params, spec, torch.float64)
    refs = default_references(spec, model, dtype=torch.float64, device="cpu")
    x0 = torch.cat([torch.as_tensor(PANDA_Q_READY, dtype=torch.float64),
                    torch.zeros(7, dtype=torch.float64)])
    refs["xref"] = x0[None].repeat(T + 1, 1)
    return (cf, x0, refs, x0[None].repeat(T + 1, 1),
            torch.zeros((T, 7), dtype=torch.float64))


FDDP_FIELDS = ("xs", "us", "K", "k", "cost", "kkt", "gap_norm", "reg")


def test_tsharded_fddp_matches_solve_fddp():
    """The same math, the same answer: in f64 the block composition and the
    sequential sweep differ only by round-off, and the iterates stay
    together (three iterations, four step lengths, the JAX slow test's
    settings)."""
    problem = flagship(16)
    settings = SolverSettings(max_iters=3, n_alphas=4)
    ref = solve_fddp(*problem, settings)
    sol = solve_fddp_tsharded(*problem, settings, cpu_mesh(8))
    for f in FDDP_FIELDS:
        np.testing.assert_allclose(getattr(sol, f).numpy(),
                                   getattr(ref, f).numpy(), rtol=0,
                                   atol=1e-9, err_msg=f)
    assert int(sol.iters) == int(ref.iters) == 3


def test_tsharded_fddp_refuses_a_ragged_horizon():
    with pytest.raises(ValueError, match="must divide"):
        solve_fddp_tsharded(*flagship(6), SolverSettings(max_iters=1),
                            cpu_mesh(4))


@pytest.mark.slow  # the JAX Panda FDDP compiles for minutes
def test_tsharded_fddp_matches_jax():
    from __graft_entry__ import _build_problem
    from agimus_controller_tpu.solver.fddp import SolverSettings as JaxSettings
    from agimus_controller_tpu.solver.riccati_sharded import (
        solve_fddp_tsharded as jax_solve_fddp_tsharded,
    )

    n = 64
    settings = dict(max_iters=3, n_alphas=4)
    jproblem = _build_problem(n, jnp.float64)
    want = jax.jit(lambda: jax_solve_fddp_tsharded(
        *jproblem, JaxSettings(**settings),
        jax_make_mesh(8, axis_name="t")))()
    got = solve_fddp_tsharded(*flagship(n), SolverSettings(**settings),
                              cpu_mesh(8))
    for f in FDDP_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-8, err_msg=f)
    assert int(got.iters) == int(want.iters)
    assert bool(got.converged) == bool(want.converged)
