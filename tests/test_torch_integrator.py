"""The port's plain numerics of slice 4 vs the JAX package, f64 on the CPU.

The spatial additions (`exp6`, `se3_identity`, `se3_act_point`,
`rpy_to_matrix`, `quat_to_matrix`, `force_act_inv`) on seeded random
inputs with leading batch dimensions, and on the 2-DoF arm and the Panda
at seeded random states: `rnea` with and without external forces, `crba`,
`mass_matrix`, `nonlinear_effects`, `generalized_gravity`,
`forward_dynamics` with and without `fext`, `kinetic_energy`,
`potential_energy`, `kinematics.integrate`/`difference`,
`integrator.state_integrate`/`state_difference`, `euler_step` (with
`fext`) and `euler_step_with_derivatives`, and
`residuals.control_grav_residual`. Values agree to atol 1e-10, the step's
Jacobians Fx/Fu to atol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import PANDA_Q_READY
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.models.urdf import build_model_from_urdf as jax_build
from agimus_controller_tpu.ops import dynamics as jdyn
from agimus_controller_tpu.ops import integrator as jint
from agimus_controller_tpu.ops import kinematics as jkin
from agimus_controller_tpu.ops import residuals as jres
from agimus_controller_tpu.ops import spatial as jsp
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.ops import dynamics, integrator, kinematics
from agimus_controller_tpu_torch.ops import residuals, spatial
from tests.test_ring_control_loop import Q0, URDF_2DOF

ATOL = 1e-10  # values
ATOL_D = 1e-9  # Jacobians
DT = 0.01


def _close(got, want, atol=ATOL):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# spatial
# ---------------------------------------------------------------------------

def _spatial_inputs(rng):
    R = np.array(jsp.exp3(jnp.asarray(rng.normal(size=(5, 3)))))
    return dict(nu=rng.normal(size=(5, 6)),
                nu_small=rng.normal(size=(5, 6)) * 1e-5,
                R=R, p=rng.normal(size=(5, 3)), x=rng.normal(size=(5, 3)),
                rpy=rng.normal(size=(4, 3)) * 2.0,
                quat=rng.normal(size=(4, 4)), f=rng.normal(size=(5, 6)))


SPATIAL = {
    "exp6": (lambda m, a: m.exp6(a["nu"]), None),
    "exp6_small": (lambda m, a: m.exp6(a["nu_small"]), None),
    "se3_act_point": (lambda m, a: m.se3_act_point((a["R"], a["p"]), a["x"]),
                      None),
    "rpy_to_matrix": (lambda m, a: m.rpy_to_matrix(a["rpy"]), None),
    "quat_to_matrix": (lambda m, a: m.quat_to_matrix(a["quat"]), None),
    "force_act_inv": (lambda m, a: m.force_act_inv((a["R"], a["p"]), a["f"]),
                      None),
    # force_act_inv undoes force_act
    "force_act_roundtrip": (lambda m, a: m.force_act_inv(
        (a["R"], a["p"]), m.force_act((a["R"], a["p"]), a["f"])), "f"),
}


@pytest.mark.parametrize("name", sorted(SPATIAL))
def test_spatial_matches_jax(name):
    fn, identity = SPATIAL[name]
    a = _spatial_inputs(np.random.default_rng(0))
    got = fn(spatial, {k: torch.as_tensor(v) for k, v in a.items()})
    want = fn(jsp, {k: jnp.asarray(v) for k, v in a.items()})
    _close(got, want)
    if identity is not None:
        _close(got, a[identity])


def test_se3_identity_matches_jax():
    _close(spatial.se3_identity(torch.float64), jsp.se3_identity(jnp.float64))


# ---------------------------------------------------------------------------
# dynamics and integration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["arm", "panda"])
def robot(request):
    if request.param == "arm":
        jm, jp = jax_build(URDF_2DOF, armature=np.array([0.1, 0.1]),
                           dtype=np.float64)
        q0 = Q0
    else:
        jm, jp = jax_load_panda(dtype=np.float64)
        q0 = np.asarray(PANDA_Q_READY)
    p = params_from_numpy(jp, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(1)
    nj = jm.nj
    inputs = dict(q=q0 + rng.normal(size=nj) * 0.3, v=rng.normal(size=nj),
                  a=rng.normal(size=nj), tau=rng.normal(size=nj) * 3.0,
                  fext=rng.normal(size=(nj, 6)), dq=rng.normal(size=nj))
    inputs["x"] = np.concatenate([inputs["q"], inputs["v"]])
    inputs["dx"] = rng.normal(size=2 * nj)
    return jm, jp, p, inputs


DYNAMICS = {
    "rnea": lambda d, m, p, a: d.rnea(m, p, a["q"], a["v"], a["a"]),
    "rnea_fext": lambda d, m, p, a: d.rnea(m, p, a["q"], a["v"], a["a"],
                                           fext=a["fext"]),
    "crba": lambda d, m, p, a: d.crba(m, p, a["q"]),
    "mass_matrix": lambda d, m, p, a: d.mass_matrix(m, p, a["q"]),
    "nonlinear_effects": lambda d, m, p, a: d.nonlinear_effects(
        m, p, a["q"], a["v"]),
    "generalized_gravity": lambda d, m, p, a: d.generalized_gravity(
        m, p, a["q"]),
    "forward_dynamics": lambda d, m, p, a: d.forward_dynamics(
        m, p, a["q"], a["v"], a["tau"]),
    "forward_dynamics_fext": lambda d, m, p, a: d.forward_dynamics(
        m, p, a["q"], a["v"], a["tau"], fext=a["fext"]),
    "kinetic_energy": lambda d, m, p, a: d.kinetic_energy(m, p, a["q"],
                                                          a["v"]),
    "potential_energy": lambda d, m, p, a: d.potential_energy(m, p, a["q"]),
}


def _args(a, lib):
    f = torch.as_tensor if lib == "torch" else jnp.asarray
    return {k: f(v) for k, v in a.items()}


@pytest.mark.parametrize("name", sorted(DYNAMICS))
def test_dynamics_match_jax(robot, name):
    jm, jp, p, a = robot
    fn = DYNAMICS[name]
    _close(fn(dynamics, jm, p, _args(a, "torch")),
           fn(jdyn, jm, jp, _args(a, "jax")))


def test_forward_dynamics_inverts_rnea(robot):
    """M~(q) a + b(q, v) = tau at a = fd(q, v, tau) (the armature enters
    the mass matrix, not rnea)."""
    jm, _, p, a = robot
    t = _args(a, "torch")
    acc = dynamics.forward_dynamics(jm, p, t["q"], t["v"], t["tau"])
    tau = (dynamics.mass_matrix(jm, p, t["q"]) @ acc
           + dynamics.nonlinear_effects(jm, p, t["q"], t["v"]))
    _close(tau, a["tau"])


INTEGRATION = {
    "kinematics.integrate": (
        lambda k, i, m, p, a: k.integrate(m, a["q"], a["dq"])),
    "kinematics.difference": (
        lambda k, i, m, p, a: k.difference(m, a["q"], a["dq"])),
    "state_integrate": (
        lambda k, i, m, p, a: i.state_integrate(m, a["x"], a["dx"])),
    "state_difference": (
        lambda k, i, m, p, a: i.state_difference(m, a["x"], a["dx"])),
    "euler_step": (lambda k, i, m, p, a: i.euler_step(m, p, a["x"], a["tau"],
                                                      DT)),
    "euler_step_fext": (lambda k, i, m, p, a: i.euler_step(
        m, p, a["x"], a["tau"], DT, fext=a["fext"])),
    "euler_step_with_derivatives": (
        lambda k, i, m, p, a: i.euler_step_with_derivatives(
            m, p, a["x"], a["tau"], DT)),
}


@pytest.mark.parametrize("name", sorted(INTEGRATION))
def test_integration_matches_jax(robot, name):
    jm, jp, p, a = robot
    fn = INTEGRATION[name]
    got = fn(kinematics, integrator, jm, p, _args(a, "torch"))
    want = fn(jkin, jint, jm, jp, _args(a, "jax"))
    if name == "euler_step_with_derivatives":
        _close(got[0], want[0])
        _close(got[1:], want[1:], ATOL_D)
    else:
        _close(got, want)


def test_control_grav_residual_matches_jax(robot):
    jm, jp, p, a = robot
    t, j = _args(a, "torch"), _args(a, "jax")
    _close(residuals.control_grav_residual(jm, p, t["x"], t["tau"]),
           jres.control_grav_residual(jm, jp, j["x"], j["tau"]))


def test_euler_step_vmaps_in_float32(robot):
    """The batched step and its Jacobians in float32 under `vmap` (the
    card's dtype) agree with the float64 step to float32 precision."""
    jm, jp, p, a = robot
    p32 = params_from_numpy(jp, dtype=torch.float32, device="cpu")
    x = torch.as_tensor(np.stack([a["x"], a["x"] * 0.9]))
    u = torch.as_tensor(np.stack([a["tau"], a["tau"] * 1.1]))
    f = lambda pp: torch.func.vmap(
        lambda xx, uu: integrator.euler_step_with_derivatives(
            jm, pp, xx, uu, DT))
    got = f(p32)(x.float(), u.float())
    want = f(p)(x, u)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.double().numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-4)
