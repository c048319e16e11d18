"""The port's solvers on the force-augmented (soft-contact) state vs the
JAX package, f64.

The force OCP of `test_force_feedback.py` (`force_ocp`: state and
gravity-torque regularisation and force tracking on a 3-D contact at the
Panda's hand) at T = 4: `BatchSQP` (B = 2, the "xla" backend on the soft
step), `BatchFDDP` (B = 2) and `solve_fddp` against their JAX counterparts
iterate for iterate at 1e-8, iterations equal; `contact_active` taken from
the refs (zero on every node: the force state rides along). The JAX
solvers' compiles are most of the time; the two FDDP comparisons are
marked slow, and beside them a tier-1 case holds the port's batch FDDP
against its single-scenario FDDP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import PANDA_Q_READY
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.costs import build_cost_functions as jax_build_cf
from agimus_controller_tpu.ops import dynamics as jdyn
from agimus_controller_tpu.solver.csqp import CSQPSettings as JaxCSQPSettings
from agimus_controller_tpu.solver.fddp import SolverSettings as JaxSettings
from agimus_controller_tpu.solver.fddp import solve_fddp as jax_solve_fddp
from agimus_controller_tpu.solver.fddp_batch import make_batch_fddp as jax_batch_fddp
from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp as jax_batch_sqp
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.ops.soft_contact import SoftContactConfig
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from agimus_controller_tpu_torch.solver.fddp import SolverSettings, solve_fddp
from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp
from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp
from tests.test_torch_soft_contact import SC3, force_jax_spec, port_spec

T, B = 4, 2
ATOL = 1e-8
FIELDS = ("xs", "us", "K", "k", "cost", "kkt", "gap_norm")
SQP = dict(max_iters=10, termination_tolerance=1e-7)
FDDP = dict(max_iters=10, termination_tolerance=1e-7)
t = torch.as_tensor


@pytest.fixture(scope="module")
def problem():
    """The JAX test's force OCP at T = 4 with its refs, B = 2 starts."""
    jm, jp = jax_load_panda(dtype=np.float64)
    js = force_jax_spec(T)
    ps = port_spec(js, SoftContactConfig(**SC3))
    x0 = np.concatenate([PANDA_Q_READY, np.zeros(7), np.zeros(3)])
    refs = jspec.default_references(js, jm, dtype=jnp.float64)
    refs["xref"] = jnp.tile(x0[None], (T + 1, 1))
    refs["w_x"] = jnp.tile(np.concatenate(
        [np.full(7, 0.05), np.full(7, 0.5), np.zeros(3)])[None], (T + 1, 1))
    refs["f_des"] = jnp.tile(jnp.asarray([0.0, 0.0, -10.0])[None], (T + 1, 1))
    refs["w_force"] = jnp.full((T + 1, 3), 2.0)
    us0 = np.tile(np.asarray(jdyn.generalized_gravity(
        jm, jp, jnp.asarray(PANDA_Q_READY)))[None], (T, 1))
    rng = np.random.default_rng(0)
    x0s = np.tile(x0[None], (B, 1))
    x0s[1, :7] += rng.normal(size=7) * 0.02
    return dict(jm=jm, jp=jp, js=js, ps=ps, x0s=x0s, refs=refs,
                p=params_from_numpy(jp, dtype=torch.float64, device="cpu"),
                xs0=np.tile(x0[None, None], (B, T + 1, 1)),
                us0=np.tile(us0[None], (B, 1, 1)),
                jcf=jax_build_cf(jm, jp, js, dtype=jnp.float64))


def _check(got, want, fields=FIELDS):
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))


@pytest.fixture(scope="module")
def jax_sqp(problem):
    pr = problem
    return jax.jit(jax_batch_sqp(pr["jm"], pr["jp"], pr["js"], pr["jcf"],
                                 JaxCSQPSettings(**SQP)))


@pytest.mark.parametrize("contact", ["active", "inactive"])
def test_batch_sqp_matches_jax(problem, jax_sqp, contact):
    """`BatchSQP` on the soft step ("xla") iterate for iterate; with
    `contact_active` zero on every node (and no force weight) the force
    state stays at its start on both sides."""
    pr = problem
    refs = dict(pr["refs"])
    x0s = pr["x0s"].copy()
    if contact == "inactive":  # the same shapes and types: no recompile
        refs["contact_active"] = jnp.zeros_like(refs["contact_active"])
        refs["w_force"] = jnp.zeros_like(refs["w_force"])
        x0s[:, 14:] = [0.0, 0.0, 5.0]
    xs0 = np.repeat(x0s[:, None], T + 1, 1)
    want = jax_sqp(jnp.asarray(x0s), refs, jnp.asarray(xs0),
                   jnp.asarray(pr["us0"]))
    solver = make_batch_sqp(pr["jm"], pr["p"], pr["ps"], CSQPSettings(**SQP),
                            device="cpu")
    assert (solver.backend, solver.kernels) == ("xla", ())
    got = solver(t(x0s), refs_from_numpy(refs, device="cpu"), t(xs0),
                 t(pr["us0"]))
    _check(got, want)
    assert int(got.iters.max()) >= 2  # the comparison covers iterations
    if contact == "inactive":
        np.testing.assert_allclose(got.xs[:, :, 14:].numpy(),
                                   np.broadcast_to([0.0, 0.0, 5.0],
                                                   (B, T + 1, 3)), atol=1e-12)


def test_batch_fddp_matches_single_fddp(problem):
    """Tier-1 beside the slow JAX comparisons: the port's `BatchFDDP` rows
    equal its `solve_fddp` per start (iterations equal, 1e-8)."""
    pr = problem
    refs = refs_from_numpy(pr["refs"], device="cpu")
    got = make_batch_fddp(pr["jm"], pr["p"], pr["ps"], SolverSettings(**FDDP),
                          device="cpu")(t(pr["x0s"]), refs, t(pr["xs0"]),
                                        t(pr["us0"]))
    cf = build_cost_functions(pr["jm"], pr["p"], pr["ps"], torch.float64)
    for b in range(B):
        one = solve_fddp(cf, t(pr["x0s"][b]), refs, t(pr["xs0"][b]),
                         t(pr["us0"][b]), SolverSettings(**FDDP))
        for f in ("xs", "us", "K", "k"):
            np.testing.assert_allclose(getattr(got, f)[b].numpy(),
                                       getattr(one, f).numpy(), rtol=0,
                                       atol=ATOL, err_msg=f)
        assert int(got.iters[b]) == int(one.iters) >= 2


@pytest.mark.slow
def test_batch_fddp_matches_jax(problem):
    pr = problem
    want = jax.jit(jax_batch_fddp(pr["jm"], pr["jp"], pr["js"], pr["jcf"],
                                  JaxSettings(**FDDP)))(
        jnp.asarray(pr["x0s"]), pr["refs"], jnp.asarray(pr["xs0"]),
        jnp.asarray(pr["us0"]))
    got = make_batch_fddp(pr["jm"], pr["p"], pr["ps"], SolverSettings(**FDDP),
                          device="cpu")(
        t(pr["x0s"]), refs_from_numpy(pr["refs"], device="cpu"),
        t(pr["xs0"]), t(pr["us0"]))
    _check(got, want)


@pytest.mark.slow
def test_solve_fddp_matches_jax(problem):
    pr = problem
    want = jax.jit(lambda x0, xs, us: jax_solve_fddp(
        pr["jcf"], x0, pr["refs"], xs, us, JaxSettings(**FDDP)))(
        jnp.asarray(pr["x0s"][0]), jnp.asarray(pr["xs0"][0]),
        jnp.asarray(pr["us0"][0]))
    got = solve_fddp(build_cost_functions(pr["jm"], pr["p"], pr["ps"],
                                          torch.float64),
                     t(pr["x0s"][0]), refs_from_numpy(pr["refs"],
                                                      device="cpu"),
                     t(pr["xs0"][0]), t(pr["us0"][0]), SolverSettings(**FDDP))
    _check(got, want)
