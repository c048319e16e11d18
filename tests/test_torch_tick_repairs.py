"""The fused tick's cost functions and soft contact, the batch SQP's
per-iteration trace and `make_timesteps`: the port vs the JAX package, f64
on the CPU.

- **Soft contact through the tick.** A soft-contact spec on the 2-DoF arm
  (state regularisation, gravity torque and force tracking on a 3-D
  contact at the tip) streamed through the ring (`f_des`, `w_force`,
  `contact_active`, the contact off on every seventh point): the port's
  `FusedTickRunner` against JAX's, an initial solve and six chained ticks
  with a drifting state; gains, controls and kkt at 1e-8, iterations and
  flags equal (the tolerance of `test_torch_tick.py`).
- **`cf=` on the tick.** A free-flyer spec (`build_ff_cost_functions`, the
  "manifold" backend; the Panda on a quaternion base in zero gravity):
  the port's ticks against JAX's `FusedTickRunner` with the same
  `FFCostFunctions` (an initial solve and two ticks, 1e-8; the JAX
  manifold solver's compile is most of the file's time), and each tick,
  bit for bit, against the port's manifold `BatchSQP` on the ring's refs
  and the shifted warm start. The spec has no state cost: both packages'
  ring rows carry
  `xref` at the model's nx, the tangent width, where the quaternion state
  is one wider (ROADMAP queue 3).
- **The trace.** `make_batch_sqp(trace=True)` on `test_torch_tick.py`'s
  arm problem, three starts stopping at different iterations (one at the
  iteration cap): `trace_cost`, `trace_kkt` and `trace_gap` equal JAX's at
  1e-8 with NaN in the same places; without `trace` they are None.
- **`make_timesteps`** of a multi-resolution spec, as JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import (
    PANDA_DEFAULT_ARMATURE,
    PANDA_Q_READY,
    PANDA_URDF,
)
from agimus_controller_tpu.models.urdf import build_model_from_urdf as jax_build
from agimus_controller_tpu.mpc.ring import PackedTrajectoryBuffer as JaxBuffer
from agimus_controller_tpu.mpc.ring import RowLayout as JaxRowLayout
from agimus_controller_tpu.mpc.tick import FusedTickRunner as JaxRunner
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.costs import build_cost_functions as jax_cf
from agimus_controller_tpu.ocp.ff_costs import build_ff_cost_functions as jax_ff
from agimus_controller_tpu.ops import dynamics, kinematics
from agimus_controller_tpu.ops import lie as jlie
from agimus_controller_tpu.ops import soft_contact as jsc
from agimus_controller_tpu.solver.csqp import CSQPSettings as JaxSettings
from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp as jax_sqp
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
from agimus_controller_tpu_torch.mpc.tick import FusedTickRunner
from agimus_controller_tpu_torch.ocp import make_timesteps
from agimus_controller_tpu_torch.ocp.ff_costs import build_ff_cost_functions
from agimus_controller_tpu_torch.ocp.spec import default_references
from agimus_controller_tpu_torch.ops.soft_contact import SoftContactConfig
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp
from tests.test_ring_control_loop import Q0, URDF_2DOF
from tests.test_torch_soft_contact import port_spec
from tests.test_torch_tick import SETTINGS, arm, horizon  # noqa: F401

ATOL = 1e-8
C = jspec.CostItem


def _check_ticks(got, want):
    for (jK0, ju0, jkkt, jit, jconv), (K0, u0, kkt, it, conv) in zip(want, got):
        np.testing.assert_allclose(K0, jK0, rtol=0, atol=ATOL)
        np.testing.assert_allclose(u0, ju0, rtol=0, atol=ATOL)
        assert abs(kkt - jkkt) <= ATOL
        assert (it, conv) == (jit, jconv)


def _run_chain(runner, buf, point, x0, xs0, us0, n_fill, n_ticks, seed):
    """Initial solve, then `n_ticks` ticks each after one more streamed
    point, with a drifting measured state; the control messages."""
    runner.initialize(x0, xs0, us0, limit=50)
    out = [runner.fetch()]
    rng = np.random.default_rng(seed)
    for k in range(n_ticks):
        buf.append(point(n_fill + k))
        xk = x0.copy()
        xk[:2] += rng.normal(size=2) * 0.01
        runner.step(xk, limit=4)
        out.append(runner.fetch())
    return out


# -- soft contact through the tick (2-DoF arm) --------------------------------
T_SOFT = 6
SC_ARM = dict(frame="tip", Kp=(200.0,) * 3, Kv=(20.0,) * 3,
              ref="local_world_aligned")


def soft_arm_spec():
    state = C(name="state_reg", kind="state", weight=0.1, update=True)
    force = C(name="force", kind="force_tracking", weight=1.0, update=True)
    return jspec.ProblemSpec(
        running_costs=(state, C(name="grav", kind="control_grav",
                                weight=5e-3), force),
        terminal_costs=(state, force), horizon=T_SOFT, dt=2.0 ** -6,
        soft_contact=jsc.SoftContactConfig(**SC_ARM))


def _soft_point(i):
    """Streamed point i: hold Q0, track a force along z that drifts with i;
    the contact is off on every seventh point (zero force weight)."""
    on = i % 7 != 3
    pt = TrajectoryPoint(
        id=i, time_ns=int(i * 2.0 ** -6 * 1e9), robot_configuration=Q0.copy(),
        robot_velocity=np.zeros(2), robot_effort=np.zeros(2),
        forces={"tip": np.asarray([0.0, 0.0, 0.0, 0.0, 0.5,
                                   -2.0 - 0.1 * (i % 5)])})
    w = TrajectoryPointWeights(
        w_robot_configuration=np.full(2, 0.5),
        w_robot_velocity=np.full(2, 1.0), w_robot_effort=np.ones(2),
        w_forces={"tip": np.asarray([1.0, 1.0, 2.0, 0.0, 0.0, 0.0])
                  * float(on)})
    return WeightedTrajectoryPoint(point=pt, weights=w)


@pytest.fixture(scope="module")
def soft_chains():
    jm, jp = jax_build(URDF_2DOF, armature=np.array([0.1, 0.1]),
                       dtype=np.float64)
    js = soft_arm_spec()
    ps = port_spec(js, SoftContactConfig(**SC_ARM))
    p = params_from_numpy(jp, dtype=torch.float64, device="cpu")
    seq = DTFactorsNSeq(factors=[1], n_steps=[T_SOFT])
    jbuf = JaxBuffer(seq, JaxRowLayout(js, jm), dtype=jnp.float64)
    pbuf = PackedTrajectoryBuffer(seq, RowLayout(ps, jm), dtype=torch.float64,
                                  device="cpu")
    n_fill = 3 * T_SOFT
    for i in range(n_fill):
        jbuf.append(_soft_point(i))
        pbuf.append(_soft_point(i))
    tau_g = np.asarray(dynamics.rnea(jm, jp, jnp.asarray(Q0), jnp.zeros(2),
                                     jnp.zeros(2)))
    x0 = np.concatenate([Q0, np.zeros(2), np.zeros(3)])
    xs0 = np.tile(x0[None], (T_SOFT + 1, 1))
    us0 = np.tile(tau_g[None], (T_SOFT, 1))
    settings = dict(max_iters=10, termination_tolerance=1e-7)
    jrun = JaxRunner(jm, jp, js, jax_cf(jm, jp, js, dtype=jnp.float64),
                     jbuf.ring, jspec.default_references(js, jm,
                                                         dtype=jnp.float64),
                     JaxSettings(**settings), dtype=jnp.float64)
    prun = FusedTickRunner(jm, p, ps, pbuf.ring, default_references(
        ps, jm, dtype=torch.float64, device="cpu"), CSQPSettings(**settings),
        dtype=torch.float64, device="cpu")
    assert (prun.solver.backend, prun.solver.soft) == ("xla", True)
    args = (x0, xs0, us0, n_fill, 6, 1)
    return (_run_chain(jrun, jbuf, _soft_point, *args),
            _run_chain(prun, pbuf, _soft_point, *args), prun)


def test_soft_contact_ticks_match_jax(soft_chains):
    want, got, prun = soft_chains
    _check_ticks(got, want)
    assert max(it for *_, it, _ in got) >= 2
    # the force state moved: the contact was live through the tick
    assert float(prun.last.xs[:, 4:].abs().max()) > 1e-3


# -- cf= on the tick (quaternion free-flyer) ----------------------------------
T_FF = 3
FRAME = "panda_hand_tcp"


def ff_tick_spec():
    """A free-flyer goal spec without a state cost (see the docstring)."""
    return jspec.ProblemSpec(
        running_costs=(C(name="ctrl", kind="control", weight=1e-2,
                         update=True),),
        terminal_costs=(C(name="goal", kind="frame_placement", weight=100.0,
                          update=True, frame=FRAME),),
        horizon=T_FF, dt=0.02)


@pytest.fixture(scope="module")
def ff_tick():
    jm, jp = jax_build(PANDA_URDF, armature=PANDA_DEFAULT_ARMATURE,
                       collision_as_capsule=True, gravity=(0.0, 0.0, 0.0),
                       dtype=np.float64, free_flyer=True)
    js = ff_tick_spec()
    ps = port_spec(js)
    p = params_from_numpy(jp, dtype=torch.float64, device="cpu")
    nv = jm.nj
    quat = jnp.asarray([0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)])
    x0 = jlie.join_state(jnp.zeros(3), quat, jnp.asarray(PANDA_Q_READY),
                         jnp.zeros(nv))
    R0, p0 = (np.asarray(a) for a in jlie.ff_frame_placement(
        jm, jp, x0, jm.frame_id(FRAME)))

    def point(i):
        goal = p0 + np.asarray([0.03, 0.02 - 0.002 * (i % 5), -0.02])
        pt = TrajectoryPoint(
            id=i, time_ns=int(i * 0.02 * 1e9),
            robot_configuration=np.zeros(jm.nq),
            robot_velocity=np.zeros(jm.nv), robot_effort=np.zeros(jm.nv),
            end_effector_poses={FRAME: (R0, goal)})
        w = TrajectoryPointWeights(
            w_robot_configuration=np.zeros(jm.nq),
            w_robot_velocity=np.zeros(jm.nv), w_robot_effort=np.ones(jm.nv),
            w_end_effector_poses={FRAME: np.ones(6)})
        return WeightedTrajectoryPoint(point=pt, weights=w)

    seq = DTFactorsNSeq(factors=[1], n_steps=[T_FF])
    n_fill = 3 * T_FF

    def buffers():
        """Fresh (port, JAX) rings holding the first n_fill points."""
        pbuf = PackedTrajectoryBuffer(seq, RowLayout(ps, jm),
                                      dtype=torch.float64, device="cpu")
        jbuf = JaxBuffer(seq, JaxRowLayout(js, jm), dtype=jnp.float64)
        for i in range(n_fill):
            pbuf.append(point(i))
            jbuf.append(point(i))
        return pbuf, jbuf

    pcf = build_ff_cost_functions(jm, p, ps, torch.float64)
    x0 = np.asarray(x0)
    return dict(jm=jm, jp=jp, js=js, ps=ps, p=p, pcf=pcf, point=point,
                buffers=buffers, n_fill=n_fill, x0=x0,
                xs0=np.tile(x0[None], (T_FF + 1, 1)),
                us0=np.zeros((T_FF, pcf.nu)),
                settings=dict(max_iters=8, termination_tolerance=1e-7,
                              reg_init=1e-8))


def _ff_runner(ff, pbuf):
    return FusedTickRunner(
        ff["jm"], ff["p"], ff["ps"], pbuf.ring, default_references(
            ff["ps"], ff["jm"], dtype=torch.float64, device="cpu"),
        CSQPSettings(**ff["settings"]), dtype=torch.float64, device="cpu",
        cf=ff["pcf"])


def test_ff_tick_matches_manifold_batch_sqp(ff_tick):
    """Each tick of the port's runner with `cf=` is the port's manifold
    `BatchSQP` on the ring's refs at the tick's read slot, from the
    shifted previous solution."""
    ff = ff_tick
    pbuf, _ = ff["buffers"]()
    runner = _ff_runner(ff, pbuf)
    assert runner.solver.backend == "manifold"
    sqp = make_batch_sqp(ff["jm"], ff["p"], ff["ps"],
                         CSQPSettings(**ff["settings"]), device="cpu",
                         cf=ff["pcf"])
    ring = pbuf.ring
    hidx, mask = ring.gather_spec()
    layout = ring.layout
    base = default_references(ff["ps"], ff["jm"], dtype=torch.float64,
                              device="cpu")
    t = torch.as_tensor
    xs, us, x0 = t(ff["xs0"]), t(ff["us0"]), t(ff["x0"])
    for k in range(3):
        if k == 0:
            slot, limit = t(ring.device_state()[1]), 50
            out = runner.initialize(ff["x0"], ff["xs0"], ff["us0"], limit)
        else:
            pbuf.append(ff["point"](ff["n_fill"] + k))
            slot, limit = runner._slot, 4
            out = runner.step(ff["x0"], limit)
            # the uniform horizon's warm-start shift: a pure roll
            xs, us = (torch.cat([a[1:], a[-1:]], 0) for a in (xs, us))
        rows = gather_horizon_rows(ring.sync(), slot, t(hidx), mask)
        sol = sqp(x0[None], layout.unpack_refs(rows, base), xs[None],
                  us[None], limit)
        np.testing.assert_array_equal(out.us.numpy(), sol.us[0].numpy())
        np.testing.assert_array_equal(out.K0.numpy(), sol.K[0, 0].numpy())
        xs, us = sol.xs[0], sol.us[0]
    assert bool(out.converged) and int(out.iters) >= 1


def test_ff_ticks_match_jax(ff_tick):
    ff = ff_tick
    pbuf, jbuf = ff["buffers"]()
    jcf = jax_ff(ff["jm"], ff["jp"], ff["js"], dtype=jnp.float64)
    jrun = JaxRunner(ff["jm"], ff["jp"], ff["js"], jcf, jbuf.ring,
                     jspec.default_references(ff["js"], ff["jm"],
                                              dtype=jnp.float64),
                     JaxSettings(**ff["settings"]), dtype=jnp.float64)
    prun = _ff_runner(ff, pbuf)
    want, got = [], []
    for run, buf, out in ((jrun, jbuf, want), (prun, pbuf, got)):
        run.initialize(ff["x0"], ff["xs0"], ff["us0"], limit=50)
        out.append(run.fetch())
        for k in range(2):
            buf.append(ff["point"](ff["n_fill"] + k))
            run.step(ff["x0"], limit=4)
            out.append(run.fetch())
    _check_ticks(got, want)


# -- the trace ----------------------------------------------------------------
TRACE_SETTINGS = dict(max_iters=3, termination_tolerance=1e-6, reg_init=1e-7)


@pytest.fixture(scope="module")
def traced(arm, horizon):  # noqa: F811
    """Three starts: the first warm-started at its optimum (it stops after
    one iteration), the other two stopped by the iteration cap."""
    jrefs, prefs, _, _ = horizon
    B = 3
    x0s = np.tile(np.concatenate([Q0, np.zeros(2)])[None], (B, 1))
    x0s[:, :2] += np.asarray([[0.0, 0.0], [0.3, -0.3], [0.6, 0.6]])
    xs = np.repeat(x0s[:, None], arm["js"].horizon + 1, 1)
    us = np.tile(arm["tau_g"][None, None], (B, arm["js"].horizon, 1))
    t = torch.as_tensor
    opt = make_batch_sqp(arm["jm"], arm["p"], arm["ps"],
                         CSQPSettings(**SETTINGS), device="cpu")(
        t(x0s[:1]), prefs, t(xs[:1]), t(us[:1]))
    xs[0], us[0] = opt.xs[0].numpy(), opt.us[0].numpy()
    want = jax.jit(jax_sqp(arm["jm"], arm["jp"], arm["js"], arm["cf"],
                           JaxSettings(**TRACE_SETTINGS), trace=True))(
        jnp.asarray(x0s), jrefs, jnp.asarray(xs), jnp.asarray(us))
    got = make_batch_sqp(arm["jm"], arm["p"], arm["ps"],
                         CSQPSettings(**TRACE_SETTINGS), device="cpu",
                         trace=True)(t(x0s), prefs, t(xs), t(us))
    plain = make_batch_sqp(arm["jm"], arm["p"], arm["ps"],
                           CSQPSettings(**TRACE_SETTINGS), device="cpu")(
        t(x0s), prefs, t(xs), t(us))
    return want, got, plain


@pytest.mark.parametrize("field", ["trace_cost", "trace_kkt", "trace_gap"])
def test_trace_matches_jax(traced, field):
    want, got, _ = traced
    g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
    assert g.shape == w.shape == (TRACE_SETTINGS["max_iters"], 3)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_trace_covers_early_stops_and_the_cap(traced):
    want, got, plain = traced
    iters = got.iters.numpy()
    np.testing.assert_array_equal(iters, np.asarray(want.iters))
    cap = TRACE_SETTINGS["max_iters"]
    assert iters.min() < cap and iters.max() == cap
    for b, n in enumerate(iters):
        assert np.isfinite(got.trace_kkt[:n, b].numpy()).all()
        assert np.isnan(got.trace_kkt[n:, b].numpy()).all()
    # the last traced cost is the solution's; the trace changes nothing
    np.testing.assert_array_equal(
        got.trace_cost[iters - 1, np.arange(3)].numpy(), got.cost.numpy())
    for f in ("xs", "us", "K", "k", "cost", "kkt", "iters"):
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
    assert (plain.trace_cost, plain.trace_kkt, plain.trace_gap) == (
        None, None, None)


# -- make_timesteps -----------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_make_timesteps_matches_jax(dtype):
    js = jspec.ProblemSpec(running_costs=(), terminal_costs=(), horizon=6,
                           dt=0.01, dt_factor_n_seq=((1, 3), (2, 2), (4, 1)))
    got = make_timesteps(port_spec(js), dtype, "cpu")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    want = np.asarray(jspec.make_timesteps(js, jdt))
    assert got.dtype == dtype and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
