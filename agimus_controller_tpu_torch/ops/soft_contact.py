"""Soft-contact (force-augmented) dynamics: the force_feedback_mpc
`DAMSoftContact{1,3}DAugmentedFwdDynamics` + `IAMSoftContactAugmented`
equivalent.

Port of the JAX package's `ops/soft_contact.py`. The state is augmented with
the contact force, x = [q; v; f] (nc = 1 or 3 enabled linear directions).
The visco-elastic contact at frame `frame` with anchor `oPc` gives

    tau_total = tau + J_c^T f               (f applied at the contact frame)
    a         = fd(q, v, tau_total)
    f_dot     = -Kp * v_c - Kv * a_c        (spring-damper differentiated)

where v_c / a_c are the contact point's linear velocity / acceleration in
the chosen reference frame ("local", or "local_world_aligned"/"world").
The per-node contact activation is a runtime value (`active`, 0 or 1), not
a mutation of the model (the reference's `dam.active_contact`).

Single-sample functions; the batched step and its Jacobians are
`ops.batched_dynamics.make_batched_soft_step(_with_derivs)`. The contact
point's acceleration takes the derivative of J(q) v along v as the
q-Jacobian of J(q) v (`torch.func.jacrev`) times v, where the JAX package
takes `jax.jvp`: torch's forward mode gives a float64 tangent for a 0-d
float32 tensor divided by a Python scalar. In the JAX package this is XLA
(the Pallas kernels decline soft contact), so it is plain PyTorch here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..models.model import ModelParams, RobotModel
from . import dynamics, kinematics


@dataclasses.dataclass(frozen=True)
class SoftContactConfig:
    """Static soft-contact configuration (the reference DAM's fields)."""

    frame: str
    Kp: Tuple[float, ...] = (100.0, 100.0, 100.0)
    Kv: Tuple[float, ...] = (10.0, 10.0, 10.0)
    oPc: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    enabled_directions: Tuple[bool, bool, bool] = (True, True, True)
    ref: str = "local"  # frame the force/vel are expressed in
    with_gravity_torque_reg: bool = False
    force_lb: Tuple[float, ...] = ()
    force_ub: Tuple[float, ...] = ()

    @property
    def nc(self) -> int:
        n = sum(self.enabled_directions)
        assert n in (1, 3), "Soft contact is either 1D or 3D."
        return n

    def mask_indices(self):
        return tuple(i for i, e in enumerate(self.enabled_directions) if e)


def _contact_kinematics(model: RobotModel, params: ModelParams,
                        sc: SoftContactConfig, q, v):
    """(J_lin [3, nv], v_c [3]) of the contact frame in the sc.ref frame."""
    fid = model.frame_id(sc.frame)
    ref = "local" if sc.ref == "local" else "local_world_aligned"
    J_lin = kinematics.frame_jacobian(model, params, q, fid, ref)[3:]
    return J_lin, J_lin @ v


def _contact_terms(model, params, sc, q, v, u, f, active):
    """(a [nv], f_dot [nc]) at the chart configuration q with the full
    torque u (the body of both dynamics functions)."""
    idx = list(sc.mask_indices())
    zero = f.new_zeros(())
    f3 = torch.stack([f[idx.index(i)] if i in idx else zero
                      for i in range(3)]) * active
    J_lin, v_c = _contact_kinematics(model, params, sc, q, v)
    a = dynamics.forward_dynamics(model, params, q, v, u + J_lin.T @ f3)
    # contact-point acceleration in the sc.ref frame: d/dt (J v) along
    # (v, a); the q-derivative of J v from `jacrev`, applied to v
    dvc_dq = torch.func.jacrev(
        lambda qq: _contact_kinematics(model, params, sc, qq, v)[1])(q)
    a_c = dvc_dq @ v + J_lin @ a
    Kp = torch.as_tensor(sc.Kp, dtype=f.dtype, device=f.device)[idx]
    Kv = torch.as_tensor(sc.Kv, dtype=f.dtype, device=f.device)[idx]
    f_dot = active * (-Kp * v_c[idx] - Kv * a_c[idx])
    return a, f_dot


def soft_contact_dynamics(model: RobotModel, params: ModelParams,
                          sc: SoftContactConfig, x, u, active=1.0):
    """(a [nv], f_dot [nc]) of the augmented dynamics; ``active`` is the
    0/1 contact activation."""
    nq, nv = model.nq, model.nv
    return _contact_terms(model, params, sc, x[:nq], x[nq:nq + nv], u,
                          x[nq + nv:], active)


def soft_contact_step(model: RobotModel, params: ModelParams,
                      sc: SoftContactConfig, x, u, dt, active=1.0):
    """Semi-implicit Euler on the augmented state (`IAMSoftContactAugmented`
    integration)."""
    nq, nv = model.nq, model.nv
    q, v, f = x[:nq], x[nq:nq + nv], x[nq + nv:]
    a, f_dot = soft_contact_dynamics(model, params, sc, x, u, active)
    v_next = v + a * dt
    q_next = q + v_next * dt
    f_next = f + f_dot * dt
    return torch.cat([q_next, v_next, f_next])


# ----------------------------------------------------------------------
# quaternion free-flyer variants (manifold state + force augmentation: the
# reference composes DAMSoftContactAugmented with a StateMultibody
# free-flyer model)
# ----------------------------------------------------------------------
def ff_soft_contact_dynamics(model: RobotModel, params: ModelParams,
                             sc: SoftContactConfig, x, u, active=1.0):
    """(a [nv], f_dot [nc]) on the free-flyer augmented state
    x = [p(3); quat(4); qj; v(nv); f(nc)].

    The dynamics run on the chart re-centered at the current base pose
    (`ops/lie.py::ff_step`'s convention); ``u`` is the FULL nv torque
    (already through the actuation map). At the chart center the chart
    velocity equals v, the assumption `ff_step` makes for the configuration
    update."""
    from . import lie

    nxr = lie.ff_dims(model)[2]  # rigid (quaternion) ambient dim
    p, quat, qj, v = lie.split_state(model, x[:nxr])
    pr = lie.recenter_params(model, params, p, quat)
    return _contact_terms(model, pr, sc, lie.chart_q(model, qj), v, u,
                          x[nxr:], active)


def ff_soft_contact_step(model: RobotModel, params: ModelParams,
                         sc: SoftContactConfig, x, u, dt, active=1.0):
    """Semi-implicit Euler on the free-flyer augmented state: velocity and
    force integrate additively, the configuration through the singularity-
    free retraction (`lie.q_integrate`)."""
    from . import lie

    nxr = lie.ff_dims(model)[2]
    p, quat, qj, v = lie.split_state(model, x[:nxr])
    a, f_dot = ff_soft_contact_dynamics(model, params, sc, x, u, active)
    v_new = v + dt * a
    p2, quat2, qj2 = lie.q_integrate(model, p, quat, qj, dt * v_new)
    return torch.cat([lie.join_state(p2, quat2, qj2, v_new),
                      x[nxr:] + dt * f_dot])
