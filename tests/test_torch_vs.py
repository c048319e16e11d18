"""The port's batch SQP and fused tick on a visual-servoing spec vs the JAX
package, on the 2-DoF planar arm, T=8, f64.

The spec has the two kinds the stage kernels gained with the
visual-servoing path: a visual-servoing pose term on `tip` (target
`wMo · oMf_ref` with a non-identity object transform) and a static-weight
frame-velocity damping of `tip` (local-world-aligned), next to the streamed
state and control references. dt = 2^-6 (exact in f32: the JAX XLA cost
pack scales running costs by a float32 dt, see `test_torch_tick.py`).

- Batch solve, B=1 and B=3 from the same warm start: xs, us, K, k, cost,
  kkt and gap norm agree to atol 1e-8; iteration counts and convergence
  flags are equal.
- A 4-tick chained fused-tick run, each side fed by its own package's
  `GenericVisualServoingTrajectory` over a quintic move, with the object
  detected 1 cm from where the references were re-expressed: the control
  message agrees to atol 1e-8 on every tick, with equal iteration counts.

On the CPU the port runs the plain versions of the stage kernels; the JAX
solver runs its XLA stage path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu import trajectories as jtraj
from agimus_controller_tpu.models.urdf import build_model_from_urdf as jax_build
from agimus_controller_tpu.mpc.ring import (
    PackedTrajectoryBuffer as JaxBuffer,
    RowLayout as JaxRowLayout,
)
from agimus_controller_tpu.mpc.tick import FusedTickRunner as JaxRunner
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.costs import build_cost_functions
from agimus_controller_tpu.ops import dynamics, kinematics
from agimus_controller_tpu.ops.spatial import exp3 as jexp3
from agimus_controller_tpu.solver.csqp import CSQPSettings as JaxSettings
from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp as jax_make_batch_sqp
from agimus_controller_tpu_torch import trajectories as ptraj
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.mpc.buffer import DTFactorsNSeq
from agimus_controller_tpu_torch.mpc.ring import PackedTrajectoryBuffer, RowLayout
from agimus_controller_tpu_torch.mpc.tick import FusedTickRunner
from agimus_controller_tpu_torch.ocp import spec as tspec
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp
from tests.test_ring_control_loop import Q0, URDF_2DOF
from tests.test_torch_stage import to_port_spec

T = 8
DT = 2.0 ** -6
ATOL = 1e-8
N_TICKS = 4
SETTINGS = dict(max_iters=10, termination_tolerance=1e-6, reg_init=1e-7)
WMO = (np.array(jexp3(jnp.asarray([0.2, -0.1, 0.3]))), np.array([0.4, 0.1, 0.2]))
DETECTED = (WMO[0], WMO[1] + np.array([0.01, 0.0, 0.0]))
GOAL_OFFSET = np.array([0.02, 0.0, -0.03])
MOVE = np.array([0.1, -0.15])


def _jax_spec():
    C = jspec.CostItem
    vs = dict(kind="visual_servoing", update=True, frame="tip",
              object_frame="object")
    damping = dict(name="ee_vel", kind="frame_velocity", weight=0.1,
                   frame="tip", reference_frame="local_world_aligned",
                   act_weights=(1.0,) * 6)
    return jspec.ProblemSpec(
        running_costs=(
            C(name="state_reg", kind="state", weight=0.1, update=True),
            C(name="ctrl", kind="control", weight=1e-3, update=True),
            C(name="vs", weight=10.0, **vs), C(**damping)),
        terminal_costs=(
            C(name="state_reg", kind="state", weight=0.1, update=True),
            C(name="vs", weight=100.0, **vs), C(**damping)),
        horizon=T, dt=DT)


@pytest.fixture(scope="module")
def arm():
    jm, jp = jax_build(URDF_2DOF, armature=np.array([0.1, 0.1]),
                       dtype=np.float64)
    js = _jax_spec()
    R0, p0 = (np.asarray(a) for a in kinematics.frame_placement(
        jm, jp, jnp.asarray(Q0), jm.frame_id("tip")))
    tau_g = np.asarray(dynamics.rnea(jm, jp, jnp.asarray(Q0), jnp.zeros(2),
                                     jnp.zeros(2)))
    return dict(jm=jm, jp=jp, p=params_from_numpy(jp, dtype=torch.float64,
                                                  device="cpu"),
                js=js, ps=to_port_spec(js), R0=R0, p0=p0, tau_g=tau_g,
                cf=build_cost_functions(jm, jp, js, dtype=jnp.float64))


def _batch_refs(arm):
    """Neutral refs, the state and control references at Q0, the goal
    (the tip at Q0 moved by GOAL_OFFSET) in the object frame of the first
    detection, the detected object transform."""
    x0 = np.concatenate([Q0, np.zeros(2)])
    refs = {k: np.array(v) for k, v in jspec.default_references(
        arm["js"], arm["jm"], dtype=jnp.float64).items()}
    wR, wp = WMO
    refs["xref"] = np.tile(x0[None], (T + 1, 1))
    refs["uref"] = np.tile(arm["tau_g"][None], (T + 1, 1))
    refs["ee_rot:tip"] = np.tile((wR.T @ arm["R0"])[None], (T + 1, 1, 1))
    refs["ee_trans:tip"] = np.tile(
        (wR.T @ (arm["p0"] + GOAL_OFFSET - wp))[None], (T + 1, 1))
    refs["w_ee:tip"] = np.tile(np.array([1.0, 1.0, 1.0, 5.0, 5.0, 5.0]),
                               (T + 1, 1))
    refs["wMo_rot:object"], refs["wMo_trans:object"] = DETECTED
    return refs


@pytest.mark.parametrize("B", [1, 3])
def test_batch_sqp_matches_jax(arm, B):
    refs = _batch_refs(arm)
    rng = np.random.default_rng(B)
    x0s = np.concatenate([Q0 + rng.normal(size=(B, 2)) * 0.05,
                          rng.normal(size=(B, 2)) * 0.1], 1)
    xs = np.tile(np.concatenate([Q0, np.zeros(2)])[None, None], (B, T + 1, 1))
    us = np.tile(arm["tau_g"][None, None], (B, T, 1))
    solve = jax.jit(jax_make_batch_sqp(arm["jm"], arm["jp"], arm["js"],
                                       arm["cf"], JaxSettings(**SETTINGS)))
    ref = solve(jnp.asarray(x0s), {k: jnp.asarray(v) for k, v in refs.items()},
                jnp.asarray(xs), jnp.asarray(us))
    port = make_batch_sqp(arm["jm"], arm["p"], arm["ps"],
                          CSQPSettings(**SETTINGS), device="cpu")
    t = torch.as_tensor
    sol = port(t(x0s), refs_from_numpy(refs, device="cpu"), t(xs), t(us))
    for f in ("xs", "us", "K", "k", "cost", "kkt", "gap_norm"):
        np.testing.assert_allclose(getattr(sol, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(sol.converged.numpy(),
                                  np.asarray(ref.converged))
    assert sol.iters.min() >= 2  # the comparison covers real iterations


def _vs_points(pkg, arm, params, n):
    """n streamed points of one package's visual-servoing generator over a
    quintic move from Q0, its window covering every point."""
    ramp = pkg.QuinticTrajectory([0.6 * n * DT] * 2)
    pva = [ramp.get_value_at_t(i * DT) for i in range(n)]
    w = dict(w_q=np.full(2, 0.5), w_qdot=np.ones(2), w_qddot=np.zeros(2),
             w_robot_effort=np.ones(2), w_pose=np.ones(6))
    gt = pkg.GenericTrajectory("tip", **w)
    gt.initialize(arm["jm"], params, Q0)
    traj = gt.build_trajectory_from_q_dq_ddq_arrays(
        [Q0 + MOVE * p for p, _, _ in pva], [MOVE * v for _, v, _ in pva],
        [MOVE * a for _, _, a in pva])
    vs = pkg.GenericVisualServoingTrajectory(
        "tip", DT, **w, w_increasing=pkg.WeightIncreasing(50.0, 0.95, 0.1),
        w_increasing_max_rotation=10.0,
        w_increasing_max_collision_avoidance=1.0)
    vs.initialize(arm["jm"], params, Q0)
    vs.add_trajectory(traj, visual_servoing_idx_range=(0, n),
                      init_in_world_M_object=WMO)
    return [vs.get_traj_point_at_t(i * DT) for i in range(n)]


@pytest.fixture(scope="module")
def chained(arm):
    n = 3 * T + N_TICKS + 1
    seq = DTFactorsNSeq(factors=[1], n_steps=[T])
    jbuf = JaxBuffer(seq, JaxRowLayout(arm["js"], arm["jm"]), dtype=jnp.float64)
    pbuf = PackedTrajectoryBuffer(seq, RowLayout(arm["ps"], arm["jm"]),
                                  dtype=torch.float64, device="cpu")
    jbuf.extend(_vs_points(jtraj, arm, arm["jp"], n))
    pbuf.extend(_vs_points(ptraj, arm, arm["p"], n))
    base = {"wMo_rot:object": DETECTED[0], "wMo_trans:object": DETECTED[1]}
    jrefs = dict(jspec.default_references(arm["js"], arm["jm"],
                                          dtype=jnp.float64))
    jrefs.update({k: jnp.asarray(v) for k, v in base.items()})
    prefs = tspec.default_references(arm["ps"], arm["jm"], dtype=torch.float64,
                                     device="cpu")
    prefs.update(refs_from_numpy(base, device="cpu"))
    jrun = JaxRunner(arm["jm"], arm["jp"], arm["js"], arm["cf"], jbuf.ring,
                     jrefs, JaxSettings(**SETTINGS), dtype=jnp.float64)
    prun = FusedTickRunner(arm["jm"], arm["p"], arm["ps"], pbuf.ring, prefs,
                           CSQPSettings(**SETTINGS), dtype=torch.float64,
                           device="cpu")
    x0 = np.concatenate([Q0, np.zeros(2)])
    xs0 = np.tile(x0[None], (T + 1, 1))
    us0 = np.tile(arm["tau_g"][None], (T, 1))
    jrun.initialize(x0, xs0, us0, limit=50)
    prun.initialize(x0, xs0, us0, limit=50)
    out = [(jrun.fetch(), prun.fetch())]
    rng = np.random.default_rng(0)
    for _ in range(N_TICKS):
        xk = x0 + np.concatenate([rng.normal(size=2) * 0.01,
                                  rng.normal(size=2) * 0.05])
        jrun.step(xk, limit=3)
        prun.step(xk, limit=3)
        out.append((jrun.fetch(), prun.fetch()))
    return out


@pytest.mark.parametrize("tick", range(N_TICKS + 1))
def test_chained_ticks_match_jax(chained, tick):
    (jK0, ju0, jkkt, jit, jconv), (K0, u0, kkt, it, conv) = chained[tick]
    np.testing.assert_allclose(K0, jK0, rtol=0, atol=ATOL)
    np.testing.assert_allclose(u0, ju0, rtol=0, atol=ATOL)
    assert abs(kkt - jkkt) <= ATOL
    assert (it, conv) == (jit, jconv)
