"""The port's whole slice vs the JAX package, on the 2-DoF planar arm, f64.

Ring gather, batch SQP (B=1 and B=3 from the same warm start) and a chained
fused-tick run with a drifting state, tick by tick. On the CPU the port's
solver runs the plain versions of the stage kernels; the JAX solver runs
its XLA stage path. Iterates, gains and controls agree to atol 1e-8, and
the iteration counts and convergence flags are equal.

The spec is the flagship-shaped spec of `test_ring_control_loop.py` with a
power-of-two dt: the JAX XLA cost pack scales running costs by a float32
copy of dt (`make_batched_cost_pack`'s default dtype) even in f64 runs, so a
dt that f32 holds exactly keeps both sides on the same problem.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.mpc.ring import (
    PackedTrajectoryBuffer as JaxBuffer,
    RowLayout as JaxRowLayout,
    gather_horizon_rows as jax_gather,
)
from agimus_controller_tpu.mpc.tick import FusedTickRunner as JaxRunner
from agimus_controller_tpu.models.urdf import build_model_from_urdf as jax_build
from agimus_controller_tpu.ocp.costs import build_cost_functions
from agimus_controller_tpu.ocp.spec import default_references as jax_default_refs
from agimus_controller_tpu.ops import dynamics, integrator, kinematics
from agimus_controller_tpu.solver.csqp import CSQPSettings as JaxSettings
from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp as jax_make_batch_sqp
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.mpc.buffer import (
    DTFactorsNSeq,
    TrajectoryPoint,
    TrajectoryPointWeights,
    WeightedTrajectoryPoint,
)
from agimus_controller_tpu_torch.mpc.ring import (
    PackedTrajectoryBuffer,
    RowLayout,
    gather_horizon_rows,
)
from agimus_controller_tpu_torch.mpc.tick import FusedTickRunner, make_fused_tick
from agimus_controller_tpu_torch.ocp.spec import default_references
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp
from tests.test_ring_control_loop import Q0, T, URDF_2DOF, _spec
from tests.test_torch_stage import to_port_spec

SETTINGS = dict(max_iters=10, termination_tolerance=1e-6, reg_init=1e-7)
ATOL = 1e-8
DT_EXACT = 2.0 ** -6  # exact in f32 (see the module docstring)


@pytest.fixture(scope="module")
def arm():
    jm, jp = jax_build(URDF_2DOF, armature=np.array([0.1, 0.1]),
                       dtype=np.float64)
    js = dataclasses.replace(_spec(), dt=DT_EXACT)
    R0, p0 = (np.asarray(a) for a in kinematics.frame_placement(
        jm, jp, jnp.asarray(Q0), jm.frame_id("tip")))
    tau_g = np.asarray(dynamics.rnea(jm, jp, jnp.asarray(Q0), jnp.zeros(2),
                                     jnp.zeros(2)))
    return dict(jm=jm, jp=jp, p=params_from_numpy(jp, dtype=torch.float64),
                js=js, ps=to_port_spec(js), R0=R0, p0=p0, tau_g=tau_g,
                cf=build_cost_functions(jm, jp, js, dtype=jnp.float64))


def _point(i, arm):
    """Streamed point i: the goal drifts along x with i."""
    pt = TrajectoryPoint(
        id=i, time_ns=int(i * DT_EXACT * 1e9), robot_configuration=Q0.copy(),
        robot_velocity=np.zeros(2), robot_acceleration=np.zeros(2),
        robot_effort=arm["tau_g"].copy(),
        end_effector_poses={"tip": (arm["R0"], arm["p0"] + np.asarray(
            [0.02 + 0.001 * (i % 7), 0.0, -0.03]))})
    w = TrajectoryPointWeights(
        w_robot_configuration=np.full(2, 0.5), w_robot_velocity=np.full(2, 1.0),
        w_robot_effort=np.ones(2), w_end_effector_poses={"tip": np.ones(6)})
    return WeightedTrajectoryPoint(point=pt, weights=w)


def _buffers(arm, n):
    seq = DTFactorsNSeq(factors=[1], n_steps=[T])
    jbuf = JaxBuffer(seq, JaxRowLayout(arm["js"], arm["jm"]), dtype=jnp.float64)
    pbuf = PackedTrajectoryBuffer(seq, RowLayout(arm["ps"], arm["jm"]),
                                  dtype=torch.float64)
    for i in range(n):
        jbuf.append(_point(i, arm))
        pbuf.append(_point(i, arm))
    return jbuf, pbuf


@pytest.fixture(scope="module")
def horizon(arm):
    """(JAX refs, port refs, JAX rows, port rows) at a consumed ring head."""
    jbuf, pbuf = _buffers(arm, 3 * T)
    for _ in range(3):
        jbuf.clear_past()
        pbuf.clear_past()
    jarr, jslot = jbuf.ring.device_state()
    hidx, mask = jbuf.ring.gather_spec()
    jrows = jax_gather(jarr, jslot, hidx, mask)
    parr, pslot = pbuf.ring.device_state()
    phidx, pmask = pbuf.ring.gather_spec()
    prows = gather_horizon_rows(parr, torch.as_tensor(pslot),
                                torch.as_tensor(phidx), pmask)
    jrefs = jbuf.ring.layout.unpack_refs(
        jrows, jax_default_refs(arm["js"], arm["jm"], dtype=jnp.float64))
    prefs = pbuf.ring.layout.unpack_refs(
        prows, default_references(arm["ps"], arm["jm"], dtype=torch.float64))
    return jrefs, prefs, np.asarray(jrows), prows.numpy()


def test_ring_rows_match_jax(horizon):
    _, _, jrows, prows = horizon
    np.testing.assert_array_equal(prows, jrows)


def test_refs_match_jax(horizon):
    jrefs, prefs, _, _ = horizon
    assert set(prefs) == set(jrefs)
    for k in jrefs:
        np.testing.assert_array_equal(prefs[k].numpy(), np.asarray(jrefs[k]))


@pytest.mark.parametrize("B", [1, 3])
def test_batch_sqp_matches_jax(arm, horizon, B):
    jrefs, prefs, _, _ = horizon
    rng = np.random.default_rng(B)
    x0s = np.concatenate([Q0 + rng.normal(size=(B, 2)) * 0.05,
                          rng.normal(size=(B, 2)) * 0.1], 1)
    xs = np.tile(np.concatenate([Q0, np.zeros(2)])[None, None], (B, T + 1, 1))
    us = np.tile(arm["tau_g"][None, None], (B, T, 1))
    solve = jax.jit(jax_make_batch_sqp(arm["jm"], arm["jp"], arm["js"],
                                       arm["cf"], JaxSettings(**SETTINGS)))
    ref = solve(jnp.asarray(x0s), jrefs, jnp.asarray(xs), jnp.asarray(us))
    port = make_batch_sqp(arm["jm"], arm["p"], arm["ps"], CSQPSettings(**SETTINGS))
    t = torch.as_tensor
    sol = port(t(x0s), prefs, t(xs), t(us))
    for f in ("xs", "us", "K", "k", "cost", "kkt", "gap_norm"):
        np.testing.assert_allclose(getattr(sol, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(sol.converged.numpy(),
                                  np.asarray(ref.converged))
    assert sol.iters.min() >= 2  # the comparison covers real iterations


@pytest.fixture(scope="module")
def chained(arm):
    """10 fused ticks with a drifting measured state, port and JAX."""
    jbuf, pbuf = _buffers(arm, 3 * T)
    jrun = JaxRunner(arm["jm"], arm["jp"], arm["js"], arm["cf"], jbuf.ring,
                     jax_default_refs(arm["js"], arm["jm"], dtype=jnp.float64),
                     JaxSettings(**SETTINGS), dtype=jnp.float64)
    prun = FusedTickRunner(arm["jm"], arm["p"], arm["ps"], pbuf.ring,
                           default_references(arm["ps"], arm["jm"],
                                              dtype=torch.float64),
                           CSQPSettings(**SETTINGS), dtype=torch.float64)
    x0 = np.concatenate([Q0, np.zeros(2)])
    xs0 = np.tile(x0[None], (T + 1, 1))
    us0 = np.tile(arm["tau_g"][None], (T, 1))
    jrun.initialize(x0, xs0, us0, limit=50)
    prun.initialize(x0, xs0, us0, limit=50)
    out = [(jrun.fetch(), prun.fetch())]
    rng = np.random.default_rng(0)
    for k in range(10):
        jbuf.append(_point(3 * T + k, arm))
        pbuf.append(_point(3 * T + k, arm))
        xk = x0 + np.concatenate([rng.normal(size=2) * 0.01,
                                  rng.normal(size=2) * 0.05])
        jrun.step(xk, limit=3)
        prun.step(xk, limit=3)
        out.append((jrun.fetch(), prun.fetch()))
    return out


@pytest.mark.parametrize("tick", range(11))
def test_chained_ticks_match_jax(chained, tick):
    (jK0, ju0, jkkt, jit, jconv), (K0, u0, kkt, it, conv) = chained[tick]
    np.testing.assert_allclose(K0, jK0, rtol=0, atol=ATOL)
    np.testing.assert_allclose(u0, ju0, rtol=0, atol=ATOL)
    assert abs(kkt - jkkt) <= ATOL
    assert (it, conv) == (jit, jconv)


def test_nonuniform_shift_matches_jax_integrator(arm):
    """Warm-start shift of a multi-resolution horizon: uniform nodes copy
    their successor, coarse nodes re-integrate one base dt (JAX
    `integrator.euler_step`) with the held control."""
    spec = dataclasses.replace(arm["ps"], horizon=6,
                               dt_factor_n_seq=((1, 4), (2, 2)))
    seq = DTFactorsNSeq(factors=[1, 2], n_steps=[4, 2])
    buf = PackedTrajectoryBuffer(seq, RowLayout(spec, arm["jm"]),
                                 dtype=torch.float64)
    tick = make_fused_tick(arm["jm"], arm["p"], spec, buf.ring,
                           CSQPSettings(**SETTINGS))
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(7, 4)) * 0.3
    us = rng.normal(size=(6, 2))
    xs_sh, us_sh = tick.shift(torch.as_tensor(xs), torch.as_tensor(us))
    dt = spec.timesteps()[0]
    want_x = [xs[i + 1] if i < 4 else np.asarray(integrator.euler_step(
        arm["jm"], arm["jp"], jnp.asarray(xs[i]), jnp.asarray(us[i]), dt))
        for i in range(6)] + [xs[6]]
    want_u = [us[i + 1] for i in range(4)] + [us[4], us[5]]
    np.testing.assert_allclose(xs_sh.numpy(), np.stack(want_x), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(us_sh.numpy(), np.stack(want_u), rtol=0,
                               atol=0)
