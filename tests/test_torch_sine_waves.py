"""The port's sine-wave generators vs the JAX package, Panda, f64.

`SinusWaveConfigurationSpace` (analytic derivatives, RNEA effort, FK pose),
`SinusWaveCartesianSpace` (Gauss-Newton IK, all six and three masked DoF,
velocity IK) and `SinusWaveCartesianSpaceWeightIncreasing` (targets at the
sine extrema, tanh-ramped weights): the streamed points of both packages
equal at 1e-8 along a run in which the IK warm-starts from its last
solution, and every IK solve takes the same number of iterations as the
JAX `lax.while_loop` from the same start.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu import trajectories as jtraj
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu_torch import trajectories as ptraj
from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda

ATOL = 1e-8
W7 = dict(w_q=np.ones(7), w_qdot=np.ones(7), w_qddot=np.zeros(7),
          w_robot_effort=np.full(7, 1e-3))
TIMES = (0.0, 0.35, 0.9, 1.3, 1.7, 2.6, 3.9)


@pytest.fixture(scope="module")
def panda():
    return (jax_load_panda(dtype=np.float64),
            load_panda(dtype=torch.float64, device="cpu"))


def _pair(panda, cls_name, sine, *args, **kw):
    (jm, jp), (pm, pp) = panda
    jg = getattr(jtraj, cls_name)(jtraj.SinWaveParams(**sine), "panda_hand_tcp",
                                  *args, **kw)
    pg = getattr(ptraj, cls_name)(ptraj.SinWaveParams(**sine), "panda_hand_tcp",
                                  *args, **kw)
    jg.initialize(jm, jp, PANDA_Q_READY)
    pg.initialize(pm, pp, PANDA_Q_READY)
    return jg, pg


def _same_point(pw, jw):
    p, j = pw.point, jw.point
    for f in ("robot_configuration", "robot_velocity", "robot_acceleration",
              "robot_effort"):
        np.testing.assert_allclose(getattr(p, f), getattr(j, f), rtol=0,
                                   atol=ATOL, err_msg=f)
    assert p.time_ns == j.time_ns
    (pR, pp), (jR, jp) = (x.end_effector_poses["panda_hand_tcp"] for x in (p, j))
    np.testing.assert_allclose(pR, jR, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=ATOL)
    for f in ("w_robot_configuration", "w_robot_velocity",
              "w_robot_acceleration", "w_robot_effort"):
        np.testing.assert_array_equal(getattr(pw.weights, f),
                                      getattr(jw.weights, f))
    np.testing.assert_allclose(
        pw.weights.w_end_effector_poses["panda_hand_tcp"],
        jw.weights.w_end_effector_poses["panda_hand_tcp"], rtol=0, atol=ATOL)


def _run_ik_pair(jg, pg):
    """Stream the points at TIMES; before each, the JAX IK's iteration count
    from the port's warm start (the same start as the port's solve)."""
    counts = []
    for t in TIMES:
        q_start = pg.ik_q.copy()
        pw = pg.get_traj_point_at_t(t)
        jw = jg.get_traj_point_at_t(t)
        des_rot, des_trans = jw.point.end_effector_poses["panda_hand_tcp"]
        _, _, j_iters = jg._ik(jnp.asarray(q_start), jnp.asarray(des_rot),
                               jnp.asarray(des_trans), 1e-5, 10000)
        counts.append((pg.last_ik_iters, int(j_iters)))
        _same_point(pw, jw)
    return counts


def test_configuration_space_matches_jax(panda):
    jg, pg = _pair(panda, "SinusWaveConfigurationSpace",
                   dict(amplitude=[0.3] * 7, period=[4.0] * 7,
                        scale_duration=[1.0] * 7), w_pose=np.full(6, 10.0),
                   **W7)
    for t in TIMES:
        _same_point(pg.get_traj_point_at_t(t), jg.get_traj_point_at_t(t))


@pytest.mark.parametrize("amp, mask", [
    ([0.1, 0.05, 0.08], (True,) * 6),
    ([0.1, 0.0, 0.1], (True, True, True, False, False, False)),
], ids=["six_dof", "translation_only"])
def test_cartesian_space_matches_jax(panda, amp, mask):
    jg, pg = _pair(panda, "SinusWaveCartesianSpace",
                   dict(amplitude=amp, period=[4.0] * 3,
                        scale_duration=[1.0] * 3), w_pose=np.full(6, 10.0),
                   mask=mask, **W7)
    counts = _run_ik_pair(jg, pg)
    assert all(p == j for p, j in counts), counts
    assert max(p for p, _ in counts) > 0
    np.testing.assert_allclose(pg.ik_q, np.asarray(jg.ik_q), rtol=0, atol=ATOL)


def test_cartesian_weight_increasing_matches_jax(panda):
    ramp = dict(max_weight=50.0, percent=0.95, time_reach_percent=0.5)
    (jm, jp), (pm, pp) = panda
    sine = dict(amplitude=[0.08, 0.04, 0.06], period=[3.0, 4.0, 5.0],
                scale_duration=[1.0] * 3)
    jg = jtraj.SinusWaveCartesianSpaceWeightIncreasing(
        jtraj.SinWaveParams(**sine), "panda_hand_tcp",
        weight_increasing=jtraj.WeightIncreasing(**ramp), **W7)
    pg = ptraj.SinusWaveCartesianSpaceWeightIncreasing(
        ptraj.SinWaveParams(**sine), "panda_hand_tcp",
        weight_increasing=ptraj.WeightIncreasing(**ramp), **W7)
    jg.initialize(jm, jp, PANDA_Q_READY)
    pg.initialize(pm, pp, PANDA_Q_READY)
    for t in (0.4, 1.1, 2.3):
        for a, b in zip(pg.get_targets_time(t), jg.get_targets_time(t)):
            np.testing.assert_array_equal(a, b)
    counts = _run_ik_pair(jg, pg)
    assert all(p == j for p, j in counts), counts


def test_ik_failure_raises(panda):
    """An unreachable target raises after the iteration cap, as in JAX."""
    _, pg = _pair(panda, "SinusWaveCartesianSpace",
                  dict(amplitude=[0.1] * 3, period=[4.0] * 3,
                       scale_duration=[1.0] * 3), w_pose=np.full(6, 10.0),
                  **W7)
    R, p = pg.ee_init_pos
    with pytest.raises(RuntimeError, match="failed to converge"):
        pg.inverse_kinematics(R, p + np.array([3.0, 0.0, 0.0]), np.zeros(6),
                              it_max=5)
    assert pg.last_ik_iters == 5
