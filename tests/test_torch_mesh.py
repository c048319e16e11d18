"""The mesh and the sharded batch solvers (`parallel/mesh.py`) of the port.

Every sharded solver over 1, 2 and 8 CPU slots (the JAX tests' eight
virtual CPU devices) against the unsharded port solver on the same
batch, f64, on the 2-DoF arm of `tests/_torch_csqp_cases.py` (T = 8,
B = 8): every value within 1e-12, iterations, ADMM counts and flags equal.
The batch SQP and the batch CSQP solve the elbow band (early ADMM exits;
the batch CSQP's shards exit together, `run_lockstep`); the batch FDDP and
the per-scenario `solve_fddp` its costs without the band. Then the JAX
tests' shapes on the Panda: `sharded_batch_solver`'s row 3 against
`solve_fddp`, and identical scenarios giving identical rows. `-m slow`:
against the JAX package's sharded solvers on its 8-device mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    run_lockstep,
    shard_batch,
    sharded_batch_csqp,
    sharded_batch_fddp,
    sharded_batch_solver,
    sharded_batch_sqp,
)
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from agimus_controller_tpu_torch.solver.csqp_batch import make_batch_csqp
from agimus_controller_tpu_torch.solver.fddp import SolverSettings, solve_fddp
from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp
from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp
from tests._torch_csqp_cases import Case

CPU = dict(device="cpu")
B = 8
# the elbow band at fixed rho 10: rows converge after early ADMM exits and
# stay frozen while a batch mate runs on to the iteration cap
BAND = dict(max_iters=6, max_qp_iters=25, eps_abs=1e-4,
            termination_tolerance=1e-3, rho=10.0)
FDDP = dict(max_iters=6, termination_tolerance=1e-7)


def cpu_mesh(n, axis_name="batch"):
    return make_mesh(n, axis_name=axis_name, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def band():
    """(case, refs, inputs) of the elbow band at B = 8, and its spec
    without the band."""
    case = Case("elbow_band")
    refs = refs_from_numpy(case.refs(), **CPU)
    inputs = tuple(torch.as_tensor(a) for a in case.start(B, 0))
    free = dataclasses.replace(case.ps, constraints=())
    return case, refs, inputs, free


# kind -> (unsharded solver, sharded solver), each of (case, free spec, mesh)
SOLVERS = {
    "sqp": (lambda c, _: make_batch_sqp(c.jm, c.p, c.ps,
                                        CSQPSettings(**BAND), **CPU),
            lambda c, _, m: sharded_batch_sqp(c.jm, c.p, c.ps, None,
                                              CSQPSettings(**BAND), m)),
    "csqp": (lambda c, _: make_batch_csqp(
                 c.jm, c.p, c.ps, build_cost_functions(c.jm, c.p, c.ps,
                                                       torch.float64),
                 CSQPSettings(**BAND), **CPU),
             lambda c, _, m: sharded_batch_csqp(
                 c.jm, c.p, c.ps, build_cost_functions(c.jm, c.p, c.ps,
                                                       torch.float64),
                 CSQPSettings(**BAND), m)),
    "fddp": (lambda c, f: make_batch_fddp(c.jm, c.p, f,
                                          SolverSettings(**FDDP), **CPU),
             lambda c, f, m: sharded_batch_fddp(c.jm, c.p, f, None,
                                                SolverSettings(**FDDP), m)),
    "solve_fddp": (
        lambda c, f: _per_row(build_cost_functions(c.jm, c.p, f,
                                                   torch.float64)),
        lambda c, f, m: sharded_batch_solver(
            build_cost_functions(c.jm, c.p, f, torch.float64),
            SolverSettings(**FDDP), m)),
}


def _per_row(cf):
    from agimus_controller_tpu_torch.parallel.mesh import make_batch_solver

    return make_batch_solver(cf, SolverSettings(**FDDP))


@pytest.fixture(scope="module")
def unsharded(band):
    case, refs, inputs, free = band
    x0s, xs, us = inputs
    return {k: mk(case, free)(x0s, refs, xs, us)
            for k, (mk, _) in SOLVERS.items()}


def assert_rows_equal(got, want):
    for f, g in zip(want._fields, got):
        w = getattr(want, f)
        if not isinstance(w, torch.Tensor):
            continue
        if w.dtype in (torch.bool, torch.int32, torch.int64):
            assert torch.equal(g, w), f
        else:  # the gains reach 1e2-1e3: 1e-12 relative there
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                       atol=1e-12, err_msg=f)


@pytest.mark.parametrize("n_slots", (1, 2, 8))
@pytest.mark.parametrize("kind", sorted(SOLVERS))
def test_sharded_rows_equal_unsharded(band, unsharded, kind, n_slots):
    case, refs, inputs, free = band
    solver = SOLVERS[kind][1](case, free, cpu_mesh(n_slots))
    got = solver(*shard_batch(cpu_mesh(n_slots), inputs[:1]), refs,
                 *inputs[1:])
    assert_rows_equal(got, unsharded[kind])


def test_unsharded_band_runs_the_admm_loops(band, unsharded):
    """The comparisons above see rows converged and frozen while a batch
    mate runs on, early ADMM exits of the batch SQP's rows, and batch CSQP
    ADMM counts that are the batch's: a converged row solved alone exits
    its ADMM loops earlier, so a shard would count differently unless the
    shards exit together."""
    for kind in ("sqp", "csqp"):
        sol = unsharded[kind]
        assert bool(sol.converged.any()), (kind, sol.converged)
        assert int(sol.iters.max()) > int(sol.iters.min()), (kind, sol.iters)
    sqp = unsharded["sqp"]
    assert bool((sqp.qp_iters < sqp.iters * BAND["max_qp_iters"]).any())
    assert bool(unsharded["fddp"].converged.all())
    case, refs, (x0s, xs, us), free = band
    csqp = unsharded["csqp"]
    i = int(torch.nonzero(csqp.converged)[0])
    alone = SOLVERS["csqp"][0](case, free)(x0s[i:i + 1], refs, xs[i:i + 1],
                                           us[i:i + 1])
    assert int(alone.qp_iters[0]) < int(csqp.qp_iters[i])


def test_run_lockstep_shares_each_exit():
    """Two generators, one done at its first exit and one at its third: both
    loops run until the whole batch is done, and a finished generator
    counts as done."""
    seen = {0: [], 1: []}

    def gen(i, done_at, loops):
        for _ in range(loops):
            n = 0
            while True:
                flag = torch.tensor([n >= done_at])
                if (yield flag):
                    break
                n += 1
            seen[i].append(n)
        return i

    assert run_lockstep([gen(0, 0, 2), gen(1, 2, 1)]) == [0, 1]
    assert seen == {0: [2, 0], 1: [2]}


def test_mesh_layout_and_refusals(band):
    mesh = cpu_mesh(8)
    assert mesh.devices.size == 8 and mesh.shape == {"batch": 8}
    assert [d for d, _ in mesh.slots("batch")] == [torch.device("cpu")] * 8
    grid = Mesh([["cpu"] * 2] * 4, ("batch", "t"))
    assert grid.shape == {"batch": 4, "t": 2}
    assert len(grid.slots("batch")) == 4 and len(grid.slots("t")) == 2
    with pytest.raises(ValueError, match="slots asked"):
        make_mesh(9, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh(["cuda:0"], ("batch",))
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(cpu_mesh(3), (torch.zeros(8, 2),))
    case, refs, inputs, free = band
    solver = SOLVERS["fddp"][1](case, free, cpu_mesh(3))
    with pytest.raises(ValueError, match="does not split"):
        solver(*inputs[:1], refs, *inputs[1:])


# -- the JAX tests' shapes, on the Panda --------------------------------------
@pytest.fixture(scope="module")
def panda_goal():
    """`tests/test_mesh.py`'s problem on the port: the Panda goal-reaching
    OCP at T = 6, dt 0.02, f64, the state reference at the ready pose."""
    import chip_smoke
    from agimus_controller_tpu_torch.models.panda import (
        PANDA_Q_READY,
        load_panda,
    )
    from agimus_controller_tpu_torch.ocp.spec import default_references

    T = 6
    model, params = load_panda(dtype=torch.float64, **CPU)
    spec = dataclasses.replace(chip_smoke.flagship_spec(T), dt=0.02)
    refs = default_references(spec, model, dtype=torch.float64, **CPU)
    x0 = torch.cat([torch.as_tensor(PANDA_Q_READY, dtype=torch.float64),
                    torch.zeros(7, dtype=torch.float64)])
    refs["xref"] = x0[None].repeat(T + 1, 1)
    return model, params, spec, refs, x0


def test_sharded_solver_row_matches_single_solve(panda_goal):
    model, params, spec, refs, x0 = panda_goal
    T = spec.horizon
    rng = np.random.default_rng(0)
    x0s = x0[None] + 0.02 * torch.as_tensor(np.concatenate(
        [rng.normal(size=(B, 7)), np.zeros((B, 7))], 1))
    xs0, us0 = x0s[:, None].repeat(1, T + 1, 1), torch.zeros(
        (B, T, 7), dtype=torch.float64)
    cf = build_cost_functions(model, params, spec, torch.float64)
    settings = SolverSettings(max_iters=3)
    sol = sharded_batch_solver(cf, settings, cpu_mesh(8))(x0s, refs, xs0, us0)
    one = solve_fddp(cf, x0s[3], refs, xs0[3], us0[3], settings)
    np.testing.assert_allclose(sol.us[3].numpy(), one.us.numpy(), atol=1e-9)


def test_sharded_batch_fddp_replicated_rows(panda_goal):
    model, params, spec, refs, x0 = panda_goal
    T = spec.horizon
    x0s = x0[None].repeat(B, 1)
    solver = sharded_batch_fddp(model, params, spec, None,
                                SolverSettings(max_iters=4), cpu_mesh(2))
    sol = solver(x0s, refs, x0s[:, None].repeat(1, T + 1, 1),
                 torch.zeros((B, T, 7), dtype=torch.float64))
    assert bool(torch.isfinite(sol.us).all())
    np.testing.assert_allclose(sol.us[0].numpy(), sol.us[7].numpy(),
                               atol=1e-12)


# -- against the JAX package's sharded solvers --------------------------------
@pytest.mark.slow  # three JAX solver compiles on the 8-device mesh
@pytest.mark.parametrize("kind", ("sqp", "csqp", "fddp"))
def test_sharded_solvers_match_jax(band, kind):
    from agimus_controller_tpu.ocp.costs import build_cost_functions as jcf
    from agimus_controller_tpu.parallel import mesh as jmesh
    from agimus_controller_tpu.solver.csqp import CSQPSettings as JaxCSQP
    from agimus_controller_tpu.solver.fddp import SolverSettings as JaxFDDP

    case, refs, inputs, free = band
    mesh = jmesh.make_mesh(8)
    if kind == "fddp":
        js = dataclasses.replace(case.js, constraints=())
        jsolve = jmesh.sharded_batch_fddp(
            case.jm, case.jp, js, jcf(case.jm, case.jp, js,
                                      dtype=jnp.float64),
            JaxFDDP(**FDDP), mesh)
    else:
        make = (jmesh.sharded_batch_sqp if kind == "sqp"
                else jmesh.sharded_batch_csqp)
        jsolve = make(case.jm, case.jp, case.js, case.cf, JaxCSQP(**BAND),
                      mesh)
    x0s, xs, us = (jnp.asarray(a.numpy()) for a in inputs)
    want = jax.jit(jsolve)(*jmesh.shard_batch(mesh, (x0s,)),
                           {k: jnp.asarray(v) for k, v in
                            case.refs().items()},
                           *jmesh.shard_batch(mesh, (xs, us)))
    got = SOLVERS[kind][1](case, free, cpu_mesh(8))(*inputs[:1], refs,
                                                    *inputs[1:])
    for f in ("xs", "us", "K", "k", "cost", "kkt", "gap_norm"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-8, err_msg=f)
    for f in ("iters", "converged") + (("qp_iters",) if kind != "fddp"
                                       else ()):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
