"""Port's plain `dynamics_terms` (the K1/K2 step math) vs the JAX package.

Two references, on 16 random Panda nodes in f64: the Pallas kernel body
(`pallas_dynamics.dynamics_terms` on component arrays, as the Pallas tests
run it on the CPU) and the XLA step `make_batched_step_with_derivs`. The
port's Jacobians come from the closed-form RNEA derivatives, the JAX body's
from `jax.vjp`, so agreement is to f64 rounding: x+ atol 1e-10, Fx/Fu 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.ops import analytic_derivs as jax_ad
from agimus_controller_tpu.ops.batched_dynamics import (
    _StaticModel as JaxStaticModel,
    make_batched_step_with_derivs,
)
from agimus_controller_tpu.ops.pallas_dynamics import (
    dynamics_terms as jax_dynamics_terms,
)
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY
from agimus_controller_tpu_torch.ops import analytic_derivs as ad
from agimus_controller_tpu_torch.ops.batched_dynamics import _StaticModel
from agimus_controller_tpu_torch.ops.cuda_dynamics import dynamics_terms, euler_step
from tests.test_robot_models import ENV_URDF

N = 16
NJ = 7
PAIR = [("panda_link7_capsule", "obstacle_sphere")]


@pytest.fixture(scope="module")
def case():
    jm, jp = jax_load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                            dtype=np.float64)
    p = params_from_numpy(jp, dtype=torch.float64)
    rng = np.random.default_rng(0)
    x = np.concatenate([np.tile(PANDA_Q_READY, (N, 1)), np.zeros((N, NJ))], 1)
    x = x + rng.normal(size=(N, 2 * NJ)) * 0.3
    u = rng.normal(size=(N, NJ)) * 2.0
    dt = rng.uniform(0.005, 0.03, size=N)

    sm = _StaticModel(jm, p)
    tq = lambda a: [torch.as_tensor(a[:, i]) for i in range(a.shape[1])]
    xn, fx, fu = dynamics_terms(sm, tq(x[:, :NJ]), tq(x[:, NJ:]), tq(u),
                                torch.as_tensor(dt), True)
    port = (torch.stack(xn, 1).numpy(),
            torch.stack(fx, 1).numpy().reshape(N, 14, 14),
            torch.stack(fu, 1).numpy().reshape(N, 14, 7))

    jsm = JaxStaticModel(jm, jp)
    jq = lambda a: [jnp.asarray(a[:, i][None]) for i in range(a.shape[1])]
    jxn, jfx, jfu = jax_dynamics_terms(jsm, jq(x[:, :NJ]), jq(x[:, NJ:]),
                                       jq(u), jnp.asarray(dt[None]), True)
    ones = jnp.ones((1, N))
    rows = lambda comps: np.stack([np.asarray(c * ones)[0] for c in comps], 1)
    body = (rows(jxn), rows(jfx).reshape(N, 14, 14),
            rows(jfu).reshape(N, 14, 7))
    xla = tuple(np.asarray(a) for a in make_batched_step_with_derivs(jm, jp)(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(dt)))
    return dict(port=port, pallas_body=body, xla_step=xla, x=x, u=u, dt=dt,
                sm=sm, jsm=jsm)


@pytest.mark.parametrize("reference", ["pallas_body", "xla_step"])
@pytest.mark.parametrize("out,atol", [("xnext", 1e-10), ("Fx", 1e-8),
                                      ("Fu", 1e-8)])
def test_dynamics_terms_matches_jax(case, reference, out, atol):
    i = ("xnext", "Fx", "Fu").index(out)
    np.testing.assert_allclose(case["port"][i], case[reference][i], rtol=0,
                               atol=atol)


def test_euler_step_matches_xla(case):
    xn = euler_step(case["sm"], torch.as_tensor(case["x"]),
                    torch.as_tensor(case["u"]), torch.as_tensor(case["dt"]))
    np.testing.assert_allclose(xn.numpy(), case["xla_step"][0], rtol=0,
                               atol=1e-10)


def test_analytic_derivs_match_jax(case):
    """The ported closed forms give the JAX package's numbers."""
    rng = np.random.default_rng(1)
    q = case["x"][:, :NJ]
    v, a = rng.normal(size=(N, NJ)), rng.normal(size=(N, NJ))
    tl = lambda arr: [torch.as_tensor(arr[:, i]) for i in range(NJ)]
    jl = lambda arr: [jnp.asarray(arr[:, i]) for i in range(NJ)]
    full = lambda M: np.array([[np.broadcast_to(np.asarray(c), (N,))
                                for c in row] for row in M])
    Dq, Dv = ad.rnea_qv_derivatives(case["sm"], tl(q), tl(v), tl(a))
    jDq, jDv = jax_ad.rnea_qv_derivatives(case["jsm"], jl(q), jl(v), jl(a))
    np.testing.assert_allclose(full(Dq), full(jDq), rtol=0, atol=1e-9)
    np.testing.assert_allclose(full(Dv), full(jDv), rtol=0, atol=1e-9)
    g, Dg = ad.gravity_torque_with_dq(case["sm"], tl(q))
    jg, jDg = jax_ad.gravity_torque_with_dq(case["jsm"], jl(q))
    np.testing.assert_allclose(full([g]), full([jg]), rtol=0, atol=1e-10)
    np.testing.assert_allclose(full(Dg), full(jDg), rtol=0, atol=1e-9)
