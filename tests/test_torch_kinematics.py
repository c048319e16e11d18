"""The port's frame Jacobian and velocity, frame-velocity and
visual-servoing residuals, component-form frame velocity, RNEA and the
generalized gravity vs the JAX package, on the Panda, f64.

Random (q, v) around the ready pose (q spread 0.5 rad, v scale 0.5), in the
three pinocchio conventions; the visual-servoing residual with a
non-identity object transform. Tolerance: atol 1e-10 (the same f64
arithmetic in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import PANDA_Q_READY
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.ops import dynamics as jdynamics
from agimus_controller_tpu.ops import kinematics as jkinematics
from agimus_controller_tpu.ops import residuals as jresiduals
from agimus_controller_tpu.ops.spatial import exp3 as jexp3
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.ops import dynamics, kinematics, residuals
from agimus_controller_tpu_torch.ops.batched_costs import (
    _fk_world,
    _frame_pose_c,
    _frame_velocity_c,
)
from agimus_controller_tpu_torch.ops.batched_dynamics import _StaticModel

ATOL = 1e-10
CONVENTIONS = ("world", "local", "local_world_aligned")
FRAMES = ("panda_hand_tcp", "panda_link4")
SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def panda():
    jm, jp = jax_load_panda(dtype=np.float64)
    return jm, jp, params_from_numpy(jp, dtype=torch.float64, device="cpu")


def _qv(seed):
    rng = np.random.default_rng(seed)
    return (np.asarray(PANDA_Q_READY) + rng.normal(size=7) * 0.5,
            rng.normal(size=7) * 0.5)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("conv", CONVENTIONS)
@pytest.mark.parametrize("frame", FRAMES)
def test_frame_jacobian(panda, frame, conv, seed):
    jm, jp, p = panda
    q, _ = _qv(seed)
    fid = jm.frame_id(frame)
    _close(kinematics.frame_jacobian(jm, p, torch.as_tensor(q), fid, conv),
           jkinematics.frame_jacobian(jm, jp, jnp.asarray(q), fid, conv))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("conv", CONVENTIONS)
@pytest.mark.parametrize("frame", FRAMES)
def test_frame_velocity(panda, frame, conv, seed):
    jm, jp, p = panda
    q, v = _qv(seed)
    fid = jm.frame_id(frame)
    _close(kinematics.frame_velocity(jm, p, torch.as_tensor(q),
                                     torch.as_tensor(v), fid, conv),
           jkinematics.frame_velocity(jm, jp, jnp.asarray(q), jnp.asarray(v),
                                      fid, conv))


@pytest.mark.parametrize("conv", CONVENTIONS)
def test_component_frame_velocity(panda, conv):
    """`batched_costs._frame_velocity_c` over a batch of nodes, each node
    against the JAX `kinematics.frame_velocity`."""
    jm, jp, p = panda
    fid = jm.frame_id("panda_hand_tcp")
    qv = [_qv(s) for s in range(4)]
    q = [torch.as_tensor(np.array([a[0][i] for a in qv])) for i in range(7)]
    v = [torch.as_tensor(np.array([a[1][i] for a in qv])) for i in range(7)]
    sm = _StaticModel(jm, p)
    oR, op = _fk_world(sm, q)
    Rf, pf = _frame_pose_c(jm, p, oR, op, fid)
    got = torch.stack(_frame_velocity_c(jm, sm, oR, op, v, fid, conv, Rf, pf),
                      1)
    want = np.stack([np.asarray(jkinematics.frame_velocity(
        jm, jp, jnp.asarray(a), jnp.asarray(b), fid, conv)) for a, b in qv])
    _close(got, want)


@pytest.mark.parametrize("conv", CONVENTIONS)
def test_frame_velocity_residual(panda, conv):
    jm, jp, p = panda
    q, v = _qv(3)
    x = np.concatenate([q, v])
    ref = np.random.default_rng(4).normal(size=6)
    fid = jm.frame_id("panda_hand_tcp")
    _close(residuals.frame_velocity_residual(
        jm, p, torch.as_tensor(x), fid, torch.as_tensor(ref), conv),
        jresiduals.frame_velocity_residual(jm, jp, jnp.asarray(x), fid,
                                           jnp.asarray(ref), conv))


@pytest.mark.parametrize("seed", SEEDS)
def test_visual_servoing_residual(panda, seed):
    jm, jp, p = panda
    rng = np.random.default_rng(10 + seed)
    q, v = _qv(seed)
    x = np.concatenate([q, v])
    wR = np.array(jexp3(jnp.asarray([0.2, -0.1, 0.3])))
    wp = np.asarray([0.4, 0.1, 0.2])
    oR = np.array(jexp3(jnp.asarray(rng.normal(size=3) * 0.3)))
    op = rng.normal(size=3) * 0.2
    fid = jm.frame_id("panda_hand_tcp")
    t = torch.as_tensor
    _close(residuals.visual_servoing_residual(jm, p, t(x), fid, t(wR), t(wp),
                                              t(oR), t(op)),
           jresiduals.visual_servoing_residual(
               jm, jp, jnp.asarray(x), fid, jnp.asarray(wR), jnp.asarray(wp),
               jnp.asarray(oR), jnp.asarray(op)))


@pytest.mark.parametrize("seed", SEEDS)
def test_rnea(panda, seed):
    jm, jp, p = panda
    q, v = _qv(seed)
    a = np.random.default_rng(20 + seed).normal(size=7)
    t = torch.as_tensor
    _close(dynamics.rnea(jm, p, t(q), t(v), t(a)),
           jdynamics.rnea(jm, jp, jnp.asarray(q), jnp.asarray(v),
                          jnp.asarray(a)))


@pytest.mark.parametrize("seed", SEEDS)
def test_generalized_gravity(panda, seed):
    jm, jp, p = panda
    q, _ = _qv(seed)
    _close(dynamics.generalized_gravity(jm, p, torch.as_tensor(q)),
           jdynamics.generalized_gravity(jm, jp, jnp.asarray(q)))
