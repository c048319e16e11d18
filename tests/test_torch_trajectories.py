"""The port's `GenericTrajectory` and `GenericVisualServoingTrajectory` vs
the JAX package's, on the Panda, f64.

The run of the JAX package's visual-servoing state-machine test (dt 0.1,
ten points, the window (3, 7), the tanh ramp to 50 in 0.5 s, one overrun
step), here over a moving (q, dq, ddq) so that every point has its own
pose and effort, under the test's object transform and under a rotated
one. At every step the state, the ramp time, the done flag and every weight
are equal; the re-expressed poses and the RNEA efforts agree to atol 1e-9.
The rows the two packages' ring layouts pack from the streamed points are
equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu import trajectories as jtraj
from agimus_controller_tpu.models.panda import PANDA_Q_READY
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.mpc.ring import RowLayout as JaxRowLayout
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ops.spatial import exp3 as jexp3
from agimus_controller_tpu_torch import trajectories as ptraj
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.mpc.ring import RowLayout
from tests.test_torch_stage import to_port_spec

ATOL = 1e-9
N_POINTS = 10
N_STEPS = N_POINTS + 1  # the last step overruns the trajectory
W7 = dict(w_q=np.ones(7), w_qdot=np.ones(7), w_qddot=np.zeros(7),
          w_robot_effort=np.full(7, 1e-3), w_pose=np.full(6, 10.0))
WMO = {"identity": (np.eye(3), np.asarray([0.4, 0.0, 0.3])),
       "rotated": (np.array(jexp3(jnp.asarray([0.2, -0.1, 0.3]))),
                   np.asarray([0.4, 0.1, 0.2]))}


def _arrays():
    rng = np.random.default_rng(0)
    q = [np.asarray(PANDA_Q_READY) + 0.03 * i + rng.normal(size=7) * 0.01
         for i in range(N_POINTS)]
    dq = [rng.normal(size=7) * 0.3 for _ in range(N_POINTS)]
    ddq = [rng.normal(size=7) for _ in range(N_POINTS)]
    return q, dq, ddq


def _run(pkg, model, params, wMo):
    """The state-machine run with one package's generators: (trajectory,
    [(state, ramp time, done, weighted point)] per step)."""
    vs = pkg.GenericVisualServoingTrajectory(
        "panda_hand_tcp", dt=0.1, **W7,
        w_increasing=pkg.WeightIncreasing(max_weight=50.0, percent=0.95,
                                          time_reach_percent=0.5),
        w_increasing_max_rotation=25.0,
        w_increasing_max_collision_avoidance=4.0, w_collision_avoidance=1.0)
    vs.initialize(model, params, PANDA_Q_READY)
    gt = pkg.GenericTrajectory("panda_hand_tcp", **W7)
    gt.initialize(model, params, PANDA_Q_READY)
    traj = gt.build_trajectory_from_q_dq_ddq_arrays(*_arrays())
    vs.add_trajectory(traj, visual_servoing_idx_range=(3, 7),
                      init_in_world_M_object=wMo)
    steps = []
    for i in range(N_STEPS):
        wp = vs.get_traj_point_at_t(i * 0.1)
        steps.append((vs.visual_servoing_state.name, vs.visual_servoing_time,
                      vs.trajectory_is_done, wp))
    return traj, steps


@pytest.fixture(scope="module")
def panda():
    jm, jp = jax_load_panda(dtype=np.float64)
    return jm, jp, params_from_numpy(jp, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module", params=sorted(WMO))
def runs(request, panda):
    jm, jp, p = panda
    wMo = WMO[request.param]
    return _run(jtraj, jm, jp, wMo), _run(ptraj, jm, p, wMo)


@pytest.mark.parametrize("i", range(N_POINTS))
def test_built_points_match_jax(runs, i):
    """The built points, read after the run: re-expression works on a copy,
    so they keep their world poses, the overrun steps included."""
    (jtr, _), (ptr, _) = runs
    j, p = jtr[i], ptr[i]
    for f in ("robot_configuration", "robot_velocity", "robot_acceleration"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f))
    np.testing.assert_allclose(p.robot_effort, np.asarray(j.robot_effort),
                               rtol=0, atol=ATOL)
    (jR, jp_), = j.end_effector_poses.values()
    (pR, pp), = p.end_effector_poses.values()
    assert list(p.end_effector_poses) == list(j.end_effector_poses)
    np.testing.assert_allclose(pR, np.asarray(jR), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pp, np.asarray(jp_), rtol=0, atol=ATOL)


@pytest.mark.parametrize("step", range(N_STEPS))
def test_streamed_points_match_jax(runs, step):
    (_, jsteps), (_, psteps) = runs
    jstate, jtime, jdone, jwp = jsteps[step]
    pstate, ptime, pdone, pwp = psteps[step]
    assert (pstate, ptime, pdone) == (jstate, jtime, jdone)
    jw, pw = jwp.weights, pwp.weights
    for f in dataclasses.fields(jw):
        a, b = getattr(pw, f.name), getattr(jw, f.name)
        if isinstance(b, dict):
            assert list(a) == list(b), f.name
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    # the object-frame poses (re-expressed on a copy of the stored point)
    (key, (jR, jp_)), = jwp.point.end_effector_poses.items()
    (pkey, (pR, pp)), = pwp.point.end_effector_poses.items()
    assert pkey == key
    np.testing.assert_allclose(pR, jR, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pp, jp_, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pwp.point.robot_effort,
                               np.asarray(jwp.point.robot_effort), rtol=0,
                               atol=ATOL)


def _vs_spec():
    C = jspec.CostItem
    hand = dict(update=True, frame="panda_hand_tcp")
    return jspec.ProblemSpec(
        running_costs=(C(name="x", kind="state", update=True),
                       C(name="u", kind="control", update=True),
                       C(name="vs", kind="visual_servoing",
                         object_frame="object", **hand)),
        terminal_costs=(C(name="vs", kind="visual_servoing",
                          object_frame="object", **hand),),
        horizon=4, dt=0.1)


def test_ring_rows_match_jax(panda, runs):
    """The streamed points packed into ring rows: the port's layout packs
    each point exactly as the JAX layout does, and the rows of the two runs
    agree to atol 1e-9 (the poses come from two FK implementations)."""
    jm, _, _ = panda
    js = _vs_spec()
    jlay, play = JaxRowLayout(js, jm), RowLayout(to_port_spec(js), jm)
    (_, jsteps), (_, psteps) = runs
    prow = np.stack([play.pack_point(s[3]) for s in psteps])
    np.testing.assert_array_equal(
        prow, np.stack([jlay.pack_point(s[3]) for s in psteps]))
    np.testing.assert_allclose(
        prow, np.stack([jlay.pack_point(s[3]) for s in jsteps]), rtol=0,
        atol=ATOL)


def test_generic_playback_matches_jax(panda):
    """The plain generic trajectory: clamped playback with its done flag
    and constant weights."""
    jm, jp, p = panda
    out = []
    for pkg, params in ((jtraj, jp), (ptraj, p)):
        gt = pkg.GenericTrajectory("panda_hand_tcp", w_collision_avoidance=2.0,
                                   **W7)
        gt.initialize(jm, params, PANDA_Q_READY)
        gt.add_trajectory(gt.build_trajectory_from_q_dq_ddq_arrays(*_arrays()))
        seen = []
        for i in range(N_STEPS + 2):
            wp = gt.get_traj_point_at_t(i * 0.01)
            seen.append((gt.traj_idx, gt.trajectory_is_done,
                         wp.point.robot_configuration.tolist(),
                         wp.weights.w_collision_avoidance))
        out.append(seen)
    assert out[1] == out[0]


@pytest.mark.parametrize("pkg", [jtraj, ptraj], ids=["jax", "port"])
def test_missing_detection_raises(pkg):
    vs = pkg.GenericVisualServoingTrajectory(
        "panda_hand_tcp", dt=0.1, w_q=np.ones(7), w_qdot=np.ones(7),
        w_qddot=np.zeros(7), w_robot_effort=np.ones(7), w_pose=np.ones(6),
        w_increasing=pkg.WeightIncreasing(1.0, 0.9, 1.0),
        w_increasing_max_rotation=1.0, w_increasing_max_collision_avoidance=1.0)
    with pytest.raises(ValueError, match="Init pose detection not set"):
        vs.add_trajectory([], visual_servoing_idx_range=(1, 3))
