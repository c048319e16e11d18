"""The port's horizon-parallel Riccati (`solver/riccati_pscan.py`) vs the
JAX package, f64 on the CPU.

- `parallel_riccati` against JAX `parallel_riccati` and the JAX sequential
  sweep on `test_riccati_pscan.py`'s `random_lqr_data`, with and without
  gaps: T=40, nx=6, nu=3 at 1e-8 (d1/d2 at 1e-7, the JAX test's), T=200 at
  1e-6; the scenarios of one call are seeds of their own, each with its
  own regularisation; also against the port's `backward_components`;
- `value_scan`'s terminal value function is the terminal cost's;
- a scenario whose Quu is indefinite comes back `bad` with non-finite
  gains, no exception, and leaves the other scenarios as they were;
- `make_batch_fddp(riccati="pscan")` against the JAX
  `make_batch_fddp(riccati="pscan")` on the flagship spec (Panda, T=6, B=2)
  at the port's component test's 1e-8, iterations and flags equal. The JAX
  solver's compile takes ~5 minutes on the CPU, so these cases are marked
  slow; tier 1 holds the port's pscan FDDP against the JAX FDDP on the
  2-DoF arm (`test_torch_fddp.py`, case "pscan").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import PANDA_Q_READY
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.costs import build_cost_functions
from agimus_controller_tpu.ops import kinematics
from agimus_controller_tpu.solver.fddp import SolverSettings as JaxSettings
from agimus_controller_tpu.solver.fddp import _backward
from agimus_controller_tpu.solver.fddp_batch import (
    make_batch_fddp as jax_make_batch_fddp,
)
from agimus_controller_tpu.solver.riccati_pscan import (
    parallel_riccati as jax_parallel_riccati,
)
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.solver.fddp import SolverSettings
from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp
from agimus_controller_tpu_torch.solver.riccati_components import (
    backward_components,
)
from agimus_controller_tpu_torch.solver.riccati_pscan import (
    parallel_riccati,
    value_scan,
)
from tests.test_riccati_pscan import random_lqr_data
from tests.test_torch_stage import flagship_jax_spec, to_port_spec

SEEDS = (0, 1, 2)
REGS = (1e-9, 1e-6, 1e-3)
OUT = ("ks", "Ks", "Qus", "d1", "d2")


def _batch(T, with_gaps, seeds=SEEDS):
    """(the JAX data per seed, the port's time-major [T, B, ...] args)."""
    data = [random_lqr_data(T=T, seed=s, with_gaps=with_gaps) for s in seeds]
    # stage fields stacked on axis 1 (time-major), terminal ones on axis 0
    st = lambda get, axis: torch.as_tensor(np.stack(
        [np.asarray(get(*x)) for x in data], axis))
    args = {f: st(lambda d, t, fs, f=f: getattr(d, f), 1)
            for f in ("lx", "lu", "lxx", "lxu", "luu", "Fx", "Fu")}
    args.update(fs=st(lambda d, t, fs: fs, 1),
                term_lx=st(lambda d, t, fs: t.lx, 0),
                term_lxx=st(lambda d, t, fs: t.lxx, 0),
                reg=torch.as_tensor(REGS[:len(seeds)]))
    return data, args


def _jax_pscan(data, reg):
    d, term, fs = data
    ks, Ks, Qus, _, _, d1, d2 = jax_parallel_riccati(
        d.lx, d.lu, d.lxx, d.lxu, d.luu, d.Fx, d.Fu, fs, term.lx, term.lxx,
        reg=reg)
    return ks, Ks, Qus, d1, d2


def _jax_sequential(data, reg):
    d, term, fs = data
    return _backward(d, term, fs, reg)[:5]


def _check(got, want_per_seed, atol, atol_d):
    for b, want in enumerate(want_per_seed):
        for name, g, w in zip(OUT, got, want):
            tol = atol_d if name in ("d1", "d2") else atol
            np.testing.assert_allclose(g[b].numpy() if g.ndim == 1 else
                                       g[:, b].numpy(), np.asarray(w), rtol=0,
                                       atol=tol, err_msg=f"{name} seed {b}")


@pytest.mark.parametrize("with_gaps", [False, True])
@pytest.mark.parametrize("reference", ["pscan", "sequential"])
def test_parallel_riccati_matches_jax(with_gaps, reference):
    data, args = _batch(40, with_gaps)
    got = parallel_riccati(**args)
    ref = _jax_pscan if reference == "pscan" else _jax_sequential
    _check(got[:5], [ref(d, r) for d, r in zip(data, REGS)], 1e-8, 1e-7)
    assert not bool(got[5].any())


def test_parallel_riccati_long_horizon():
    data, args = _batch(200, True, seeds=(3, 4))
    got = parallel_riccati(**args)
    _check(got[:2], [_jax_pscan(d, r)[:2] for d, r in zip(data, REGS)], 1e-6,
           1e-6)


@pytest.mark.parametrize("with_gaps", [False, True])
def test_parallel_riccati_matches_component_sweep(with_gaps):
    _, args = _batch(40, with_gaps)
    got = parallel_riccati(**args)
    want = backward_components(args["Fx"], args["Fu"], args["lx"], args["lu"],
                               args["lxx"], args["lxu"], args["luu"],
                               args["fs"], args["term_lx"], args["term_lxx"],
                               args["reg"])
    for name, g, w in zip(OUT + ("bad",), got, want):
        tol = 1e-7 if name in ("d1", "d2") else 1e-8
        if name == "bad":
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=tol,
                                       err_msg=name)


def test_value_scan_terminal_boundary():
    _, args = _batch(40, True)
    Vx, Vxx = value_scan(**args)
    assert Vx.shape == (41, 3, 6) and Vxx.shape == (41, 3, 6, 6)
    np.testing.assert_allclose(Vxx[-1].numpy(), args["term_lxx"].numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(Vx[-1].numpy(), args["term_lx"].numpy(),
                               rtol=0, atol=1e-12)


def test_failed_factor_is_flagged_not_raised():
    """An indefinite Quu in scenario 1 gives NaN gains there and `bad`; the
    other scenarios' gains are unchanged."""
    _, args = _batch(40, True)
    ok = parallel_riccati(**args)
    args["luu"] = args["luu"].clone()
    args["luu"][7, 1] = -10.0 * torch.eye(3, dtype=torch.float64)
    got = parallel_riccati(**args)
    assert got[5].tolist() == [False, True, False]
    assert not bool(torch.isfinite(got[0][:, 1]).all())
    for g, w in zip(got[:2], ok[:2]):
        assert torch.equal(g[:, [0, 2]], w[:, [0, 2]])


# -- the batch FDDP on the pscan sweep ---------------------------------------
FDDP_SETTINGS = dict(max_iters=10, termination_tolerance=1e-8)
FIELDS = ("xs", "us", "K", "k", "cost", "kkt", "gap_norm", "reg")


@pytest.fixture(scope="module")
def flagship_pscan():
    """JAX's and the port's pscan FDDP on the flagship spec, Panda, T=6,
    B=2, two starts around the ready pose, the goal 5 cm from the hand."""
    import dataclasses

    jm, jp = jax_load_panda(dtype=np.float64)
    js = dataclasses.replace(flagship_jax_spec(), horizon=6)
    q0 = jnp.asarray(PANDA_Q_READY)
    x0 = np.concatenate([PANDA_Q_READY, np.zeros(7)])
    R0, p0 = kinematics.frame_placement(jm, jp, q0,
                                        jm.frame_id("panda_hand_tcp"))
    T1 = js.horizon + 1
    refs = jspec.default_references(js, jm, dtype=jnp.float64)
    refs["xref"] = jnp.tile(jnp.asarray(x0)[None], (T1, 1))
    refs["ee_rot:panda_hand_tcp"] = jnp.tile(R0[None], (T1, 1, 1))
    refs["ee_trans:panda_hand_tcp"] = jnp.tile(
        (p0 + jnp.asarray([0.05, 0.0, -0.03]))[None], (T1, 1))
    rng = np.random.default_rng(5)
    x0s = np.tile(x0[None], (2, 1))
    x0s[:, :7] += rng.normal(size=(2, 7)) * 0.02
    xs0 = np.tile(x0s[:, None], (1, T1, 1))
    us0 = np.zeros((2, js.horizon, 7))
    cf = build_cost_functions(jm, jp, js, dtype=jnp.float64)
    want = jax.jit(jax_make_batch_fddp(jm, jp, js, cf,
                                       JaxSettings(**FDDP_SETTINGS),
                                       riccati="pscan"))(
        jnp.asarray(x0s), refs, jnp.asarray(xs0), jnp.asarray(us0))
    p = params_from_numpy(jp, dtype=torch.float64, device="cpu")
    solver = make_batch_fddp(jm, p, to_port_spec(js),
                             SolverSettings(**FDDP_SETTINGS), riccati="pscan",
                             device="cpu")
    t = torch.as_tensor
    got = solver(t(x0s), refs_from_numpy(
        {k: np.asarray(v) for k, v in refs.items()}, device="cpu"),
        t(xs0), t(us0))
    return want, got


@pytest.mark.slow
@pytest.mark.parametrize("field", FIELDS)
def test_batch_fddp_pscan_matches_jax(flagship_pscan, field):
    want, got = flagship_pscan
    np.testing.assert_allclose(getattr(got, field).numpy(),
                               np.asarray(getattr(want, field)), rtol=0,
                               atol=1e-8, err_msg=field)


@pytest.mark.slow
def test_batch_fddp_pscan_iterations_match_jax(flagship_pscan):
    want, got = flagship_pscan
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert int(got.iters.min()) >= 2
