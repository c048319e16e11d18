"""The port's batched soft-contact step and its Jacobians vs the JAX
package, f64: `ops.batched_dynamics.make_batched_soft_step(_with_derivs)`
against the JAX `make_batched_soft_step(_with_derivs)` on the Panda with a
3-D and a 1-D contact, over nodes with per-node dt and contact activation
(values at 1e-10, Jacobians at 1e-9; the JAX side takes `jacfwd`, the port
`jacrev`). Inputs from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.ops import batched_dynamics as jbd
from agimus_controller_tpu.ops import soft_contact as jsc
from agimus_controller_tpu_torch.ops import batched_dynamics
from agimus_controller_tpu_torch.ops.soft_contact import SoftContactConfig
from tests.test_torch_soft_contact import (  # noqa: F401 (fixture)
    ATOL,
    ATOL_D,
    CONTACTS,
    _state,
    panda,
    t,
)


@pytest.mark.parametrize("contact", ["nc3", "nc1"])
def test_batched_step_with_derivs_matches_jax(panda, contact):
    """The batched step and its Jacobians over 6 nodes, per-node dt and
    activation."""
    jm, jp, p = panda
    jc, pc = (jsc.SoftContactConfig(**CONTACTS[contact]),
              SoftContactConfig(**CONTACTS[contact]))
    rng = np.random.default_rng(4)
    xs = np.stack([_state(pc.nc, s)[0] for s in range(6)])
    us = rng.normal(size=(6, 7))
    dts = rng.uniform(0.005, 0.03, 6)
    act = np.array([1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
    args = (xs, us, dts, act)
    want = jbd.make_batched_soft_step_with_derivs(jm, jp, jc)(
        *(jnp.asarray(a) for a in args))
    got = batched_dynamics.make_batched_soft_step_with_derivs(jm, p, pc)(
        *(t(a) for a in args))
    for w, g, tol in zip(want, got, (ATOL, ATOL_D, ATOL_D)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
    np.testing.assert_allclose(
        batched_dynamics.make_batched_soft_step(jm, p, pc)(
            *(t(a) for a in args)).numpy(), np.asarray(want[0]), rtol=0,
        atol=ATOL)
