"""State-space integration: the semi-implicit Euler step of Crocoddyl's
`IntegratedActionModelEuler` over `DifferentialActionModelFreeFwdDynamics`.

Port of the JAX package's `ops/integrator.py`. The state is the vector
`x = [q; v]`, the control the joint torque `u`:

    a      = fd(q, v, u)
    v_next = v + a * dt
    q_next = q + v_next * dt

Single-sample; the Jacobians come from `torch.func.jacrev` of the step
(the JAX package takes `jax.jacfwd`; the Jacobians are the same). Forward
mode is not used because `torch.func.jvp` (torch 2.13) gives a float64 tangent for a
0-d float32 tensor divided by a Python scalar, so an f32 step would not
stay f32.
"""

from __future__ import annotations

import torch

from ..models.model import ModelParams, RobotModel
from . import dynamics


def state_integrate(model: RobotModel, x, dx):
    """x (+) dx on the state manifold (`StateMultibody.integrate`)."""
    return x + dx


def state_difference(model: RobotModel, x0, x1):
    """x1 (-) x0 tangent difference (`StateMultibody.diff`)."""
    return x1 - x0


def euler_step(model: RobotModel, params: ModelParams, x, u, dt, fext=None):
    """Semi-implicit Euler step of the free forward dynamics."""
    nq = model.nq
    q, v = x[..., :nq], x[..., nq:]
    a = dynamics.forward_dynamics(model, params, q, v, u, fext=fext)
    v_next = v + a * dt
    q_next = q + v_next * dt
    return torch.cat([q_next, v_next], dim=-1)


def euler_step_with_derivatives(model: RobotModel, params: ModelParams, x, u,
                                dt):
    """(x_next, Fx, Fu): the step and its state and control Jacobians
    (`IntegratedActionModelEuler.calc` + `.calcDiff`)."""
    def step(xx, uu):
        xn = euler_step(model, params, xx, uu, dt)
        return xn, xn
    (Fx, Fu), x_next = torch.func.jacrev(step, argnums=(0, 1),
                                         has_aux=True)(x, u)
    return x_next, Fx, Fu
