"""The port's quaternion free-flyer state (`ops/lie.py`) vs the JAX
package, f64.

Every function of `lie.py` against the JAX `ops/lie.py` on inputs from
numpy seeds (atol 1e-12; 1e-10 where dynamics run): the quaternion and
rotation maps (each branch of `matrix_to_quat`, `so3_exp`/`so3_log` at
0, small, generic and near-pi angles), the state layout, the chart
re-centering, the retraction and the difference, `ff_step` and
`ff_frame_placement`. Then the JAX `test_freeflyer_quaternion.py`
properties on the port: the integrate/difference round trip at pitch
+-pi/2, `ff_step` equal to the chart step at the identity base, and finite
reverse-mode derivatives of the difference at the identity in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.ops import lie as jlie
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.models.panda import load_panda
from agimus_controller_tpu_torch.ops import integrator, lie

ATOL = 1e-12
SEEDS = range(4)
t = torch.as_tensor


@pytest.fixture(scope="module")
def ff():
    jm, jp = jax_load_panda(dtype=np.float64, free_flyer=True)
    return jm, jp, params_from_numpy(jp, dtype=torch.float64, device="cpu")


def _quat(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def _quat_pitch(theta):
    return np.asarray([0.0, np.sin(theta / 2), 0.0, np.cos(theta / 2)])


def _state(model, rng, quat=None):
    n = model.nj - lie.N_FF
    return np.concatenate([rng.normal(size=3),
                           _quat(rng) if quat is None else quat,
                           rng.normal(size=n) * 0.5,
                           rng.normal(size=model.nj) * 0.3])


def _close(got, want, atol=ATOL):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, atol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("seed", SEEDS)
def test_rotation_maps_match_jax(seed):
    rng = np.random.default_rng(seed)
    q = _quat(rng)
    _close(lie.quat_to_matrix(t(q)), jlie.quat_to_matrix(jnp.asarray(q)))
    raw = rng.normal(size=4) * 3.0
    _close(lie.quat_normalize(t(raw)), jlie.quat_normalize(jnp.asarray(raw)))
    e = rng.normal(size=3) * 0.5
    R = jlie._euler_zyx_to_matrix(jnp.asarray(e))
    _close(lie._euler_zyx_to_matrix(t(e)), R)
    _close(lie._matrix_to_euler_zyx(t(np.asarray(R))),
           jlie._matrix_to_euler_zyx(R))


# rotations whose largest of (m00, m11, m22, trace) picks each candidate of
# matrix_to_quat: about x, y, z by ~pi, and near the identity
BRANCH_ROTATIONS = {"x": [1.0, 0.05, 0.02], "y": [0.03, 1.0, -0.02],
                    "z": [0.01, -0.04, 1.0], "trace": [0.3, -0.2, 0.1]}


@pytest.mark.parametrize("branch", sorted(BRANCH_ROTATIONS))
def test_matrix_to_quat_branches_match_jax(branch):
    axis = np.asarray(BRANCH_ROTATIONS[branch])
    angle = 0.4 if branch == "trace" else np.pi - 0.05
    w = axis / np.linalg.norm(axis) * angle
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    _close(lie.matrix_to_quat(t(R)), jlie.matrix_to_quat(jnp.asarray(R)))


@pytest.mark.parametrize("angle", [0.0, 1e-7, 1e-3, 0.7, 2.5, np.pi - 1e-4])
def test_so3_exp_log_match_jax(angle):
    rng = np.random.default_rng(11)
    axis = rng.normal(size=3)
    w = axis / np.linalg.norm(axis) * angle
    R = jlie.so3_exp(jnp.asarray(w))
    _close(lie.so3_exp(t(w)), R)
    _close(lie.so3_log(t(np.asarray(R))), jlie.so3_log(R), atol=1e-10)


def test_state_layout_matches_jax(ff):
    jm, _, _ = ff
    assert lie.ff_dims(jm) == jlie.ff_dims(jm) == (14, 13, 27)
    x = _state(jm, np.random.default_rng(0))
    parts = lie.split_state(jm, t(x))
    _close(parts, jlie.split_state(jm, jnp.asarray(x)))
    _close(lie.join_state(*parts), jlie.join_state(*jlie.split_state(
        jm, jnp.asarray(x))))
    qj = x[7:14]
    _close(lie.chart_q(jm, t(qj)), jlie.chart_q(jm, jnp.asarray(qj)))


@pytest.mark.parametrize("seed", SEEDS)
def test_recenter_params_match_jax(ff, seed):
    jm, jp, p = ff
    rng = np.random.default_rng(seed)
    pos, q = rng.normal(size=3), _quat(rng)
    got = lie.recenter_params(jm, p, t(pos), t(q))
    want = jlie.recenter_params(jm, jp, jnp.asarray(pos), jnp.asarray(q))
    for f in ("joint_rot", "joint_trans"):
        _close(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("seed", SEEDS)
def test_integrate_and_difference_match_jax(ff, seed):
    jm, _, _ = ff
    rng = np.random.default_rng(seed)
    x0, x1 = _state(jm, rng), _state(jm, rng)
    dx = rng.normal(size=2 * jm.nj) * 0.4
    _close(lie.state_integrate(jm)(t(x0), t(dx)),
           jlie.state_integrate(jm)(jnp.asarray(x0), jnp.asarray(dx)))
    _close(lie.state_difference(jm)(t(x1), t(x0)),
           jlie.state_difference(jm)(jnp.asarray(x1), jnp.asarray(x0)),
           atol=1e-10)
    p, q, qj = x0[:3], x0[3:7], x0[7:14]
    _close(lie.q_integrate(jm, t(p), t(q), t(qj), t(dx[:13])),
           jlie.q_integrate(jm, *(jnp.asarray(a) for a in (p, q, qj,
                                                             dx[:13]))))


@pytest.mark.parametrize("seed", SEEDS)
def test_ff_step_and_placement_match_jax(ff, seed):
    jm, jp, p = ff
    rng = np.random.default_rng(seed)
    x = _state(jm, rng)
    u = rng.normal(size=jm.nj) * 2.0
    _close(lie.ff_step(jm, p, t(x), t(u), 0.01),
           jlie.ff_step(jm, jp, jnp.asarray(x), jnp.asarray(u), 0.01),
           atol=1e-10)
    fid = jm.frame_id("panda_hand_tcp")
    _close(lie.ff_frame_placement(jm, p, t(x), fid),
           jlie.ff_frame_placement(jm, jp, jnp.asarray(x), fid))


@pytest.mark.parametrize("theta", [np.pi / 2, -np.pi / 2, 0.3, np.pi * 0.95])
def test_integrate_difference_roundtrip_at_singular_pitch(ff, theta):
    """The JAX test's round trip on the port: difference inverts integrate,
    and integrate(x0, difference(x2, x0)) returns x2's pose, at the euler
    chart's singular pitch too."""
    jm, _, _ = ff
    sint, sdiff = lie.state_integrate(jm), lie.state_difference(jm)
    rng = np.random.default_rng(0)
    x0 = t(_state(jm, rng, _quat_pitch(theta)))
    dx = t(rng.normal(size=2 * jm.nj) * 0.2)
    np.testing.assert_allclose(sdiff(sint(x0, dx), x0).numpy(), dx.numpy(),
                               atol=1e-10)
    x2 = t(_state(jm, rng))
    back = sint(x0, sdiff(x2, x0))
    p2, q2, qj2, _ = lie.split_state(jm, x2)
    pb, qb, qjb, _ = lie.split_state(jm, back)
    np.testing.assert_allclose(pb.numpy(), p2.numpy(), atol=1e-10)
    np.testing.assert_allclose(lie.quat_to_matrix(qb).numpy(),
                               lie.quat_to_matrix(q2).numpy(), atol=1e-9)
    np.testing.assert_allclose(qjb.numpy(), qj2.numpy(), atol=1e-10)


def test_ff_step_matches_chart_at_identity_base():
    """At the identity base the re-centered chart is the chart model: one
    `ff_step` equals the chart model's Euler step (JAX
    `test_ff_step_matches_chart_at_identity_base`)."""
    model, params = load_panda(dtype=torch.float64, device="cpu",
                               free_flyer=True)
    n = model.nj - lie.N_FF
    rng = np.random.default_rng(1)
    qj = t(rng.normal(size=n) * 0.4)
    v = t(rng.normal(size=model.nj) * 0.3)
    u = t(rng.normal(size=model.nj) * 2.0)
    dt = 1e-3
    x_ff = lie.join_state(torch.zeros(3, dtype=torch.float64),
                          t([0.0, 0.0, 0.0, 1.0], dtype=torch.float64), qj, v)
    x_ch = torch.cat([torch.zeros(lie.N_FF, dtype=torch.float64), qj, v])
    p, quat, qjn, vn = lie.split_state(model, lie.ff_step(model, params,
                                                          x_ff, u, dt))
    xn = integrator.euler_step(model, params, x_ch, u, dt)
    np.testing.assert_allclose(vn.numpy(), xn[model.nj:].numpy(), atol=1e-12)
    np.testing.assert_allclose(qjn.numpy(), xn[lie.N_FF:model.nj].numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(p.numpy(), xn[:3].numpy(), atol=1e-12)
    inc = float(torch.linalg.vector_norm(xn[3:6]))
    np.testing.assert_allclose(
        lie.quat_to_matrix(quat).numpy(),
        lie._euler_zyx_to_matrix(xn[3:6]).numpy(), atol=10 * inc ** 2 + 1e-12)


def test_difference_derivative_finite_at_identity_f32():
    """Reverse-mode derivatives of difference(integrate(x, dx), x) at
    dx = 0 are finite in float32 (where the JAX package's `+ 1e-300` would
    underflow), and close to the identity."""
    model, _ = load_panda(dtype=torch.float32, device="cpu", free_flyer=True)
    x = t(_state(model, np.random.default_rng(3), _quat_pitch(np.pi / 2)),
          dtype=torch.float32)
    sint, sdiff = lie.state_integrate(model), lie.state_difference(model)
    J = torch.func.jacrev(lambda dx: sdiff(sint(x, dx), x))(
        torch.zeros(2 * model.nj))
    assert bool(torch.isfinite(J).all())
    np.testing.assert_allclose(J.numpy(), np.eye(2 * model.nj), atol=1e-5)
