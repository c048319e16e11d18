"""The port's Tiago-Pro model (`models/tiago_pro.py`) vs the JAX package,
f64.

The reduced single-arm model (the torso lift and the left arm, nj = 8), the
full 17-DoF branched model and the free-flyer reduced one: joint names,
types and parents, frames, collision geometry and every `ModelParams` field
equal to the JAX package's; RNEA, CRBA, gravity and forward dynamics equal
to JAX's at random states; the analytic identities of the JAX
second-robot tests (CRBA columns from RNEA, forward of inverse dynamics,
the locked subtrees' mass merged into the torso); and the fixed-base tick:
`BatchSQP` (B = 2, the stage kernels' plain versions here) against the JAX
`make_batch_sqp` over its generic cost functions on `chip_smoke.tiago_spec`
at T = 4, iterate for iterate at 1e-8 with equal iteration counts (slow: a
JAX compile of ~2 min), and beside it in tier 1 the port's "kernels" and
"xla" backends against each other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from agimus_controller_tpu.models import tiago_pro as jtiago
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.costs import build_cost_functions as jax_build_cf
from agimus_controller_tpu.ops import dynamics as jdyn
from agimus_controller_tpu.ops import kinematics as jkin
from agimus_controller_tpu.solver.csqp import CSQPSettings as JaxSettings
from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp as jax_batch_sqp
from agimus_controller_tpu_torch.models import (
    TIAGO_PRO_LEFT_ARM_JOINTS,
    TIAGO_PRO_Q_READY,
    load_tiago_pro,
    tiago_pro_urdf,
)
from agimus_controller_tpu_torch.models.model import ModelParams
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.ops import dynamics, kinematics
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp
from tests.test_torch_soft_contact import port_spec

VARIANTS = {"reduced": {}, "full": {"moving_joint_names": "all"},
            "free_flyer": {"free_flyer": True}}
t = torch.as_tensor


def _load(variant):
    kw = VARIANTS[variant]
    jm, jp = jtiago.load_tiago_pro(dtype=np.float64, **kw)
    pm, pp = load_tiago_pro(dtype=torch.float64, device="cpu", **kw)
    return jm, jp, pm, pp


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def tiago(request):
    return (request.param,) + _load(request.param)


def test_constants_match_jax():
    assert np.array_equal(TIAGO_PRO_Q_READY, jtiago.TIAGO_PRO_Q_READY)
    assert TIAGO_PRO_LEFT_ARM_JOINTS == jtiago.TIAGO_PRO_LEFT_ARM_JOINTS
    assert tiago_pro_urdf() == jtiago.tiago_pro_urdf()


def test_topology_matches_jax(tiago):
    variant, jm, _, pm, _ = tiago
    for f in ("name", "joint_names", "joint_types", "parents",
              "collision_pairs"):
        assert getattr(pm, f) == getattr(jm, f), f
    assert [dataclasses.asdict(f) for f in pm.frames] == [
        dataclasses.asdict(f) for f in jm.frames]
    assert [dataclasses.asdict(g) for g in pm.geometries] == [
        dataclasses.asdict(g) for g in jm.geometries]
    assert pm.nq == {"reduced": 8, "full": 17, "free_flyer": 14}[variant]


@pytest.mark.parametrize("field", ModelParams._fields)
def test_params_match_jax(tiago, field):
    _, _, jp, _, pp = tiago
    np.testing.assert_array_equal(getattr(pp, field).numpy(),
                                  np.asarray(getattr(jp, field)))


def _random_state(model, seed):
    rng = np.random.default_rng(seed)
    n = model.nj
    q0 = np.zeros(n)
    q0[-8:] = TIAGO_PRO_Q_READY if n != 17 else 0.0
    return (q0 + rng.normal(size=n) * 0.1, rng.normal(size=n) * 0.3,
            rng.normal(size=n) * 0.5, rng.normal(size=n))


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamics_match_jax(tiago, seed):
    """RNEA, CRBA, gravity, forward dynamics and the tool's placement."""
    _, jm, jp, pm, pp = tiago
    q, v, a, tau = _random_state(jm, seed)
    J = lambda *xs: [jnp.asarray(x) for x in xs]
    P = lambda *xs: [t(x) for x in xs]
    pairs = [
        (jdyn.rnea(jm, jp, *J(q, v, a)), dynamics.rnea(pm, pp, *P(q, v, a))),
        (jdyn.crba(jm, jp, jnp.asarray(q)), dynamics.crba(pm, pp, t(q))),
        (jdyn.generalized_gravity(jm, jp, jnp.asarray(q)),
         dynamics.generalized_gravity(pm, pp, t(q))),
        (jdyn.forward_dynamics(jm, jp, *J(q, v, tau)),
         dynamics.forward_dynamics(pm, pp, *P(q, v, tau)))]
    fid = jm.frame_id("left_arm_tool_link")
    pairs += list(zip(jkin.frame_placement(jm, jp, jnp.asarray(q), fid),
                      kinematics.frame_placement(pm, pp, t(q), fid)))
    for w, g in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-10)


def test_dynamics_identities():
    """M from CRBA equals the RNEA columns; forward of inverse dynamics is
    the identity (JAX `test_tiago_dynamics_identities`, on the port)."""
    _, _, m, p = _load("reduced")
    q, v, _, tau = (t(a) for a in _random_state(m, 3))
    M = dynamics.crba(m, p, q)
    g = dynamics.generalized_gravity(m, p, q)
    z = torch.zeros(8, dtype=torch.float64)
    for k in range(8):
        col = dynamics.rnea(m, p, q, z, torch.eye(8, dtype=torch.float64)[k])
        np.testing.assert_allclose(M[:, k].numpy(), (col - g).numpy(),
                                   atol=1e-10)
    acc = dynamics.forward_dynamics(m, p, q, v, tau)
    back = dynamics.rnea(m, p, q, v, acc) + p.armature * acc
    np.testing.assert_allclose(back.numpy(), tau.numpy(), atol=1e-9)


def test_locked_subtrees_merged_into_the_torso():
    """The reduction merges the locked right arm and head into the torso:
    the gravity load on the torso lift equals the full model's (JAX
    `test_tiago_reduced_single_arm`); the full model branches both arms
    from the torso, a prismatic joint."""
    _, _, m, p = _load("reduced")
    _, _, fm, fp = _load("full")
    g_red = dynamics.generalized_gravity(m, p, torch.zeros(8,
                                                           dtype=torch.float64))
    g_full = dynamics.generalized_gravity(fm, fp, torch.zeros(
        17, dtype=torch.float64))
    np.testing.assert_allclose(float(g_red[m.joint_id("torso_lift_joint")]),
                               float(g_full[fm.joint_id("torso_lift_joint")]),
                               rtol=1e-12)
    torso = fm.joint_id("torso_lift_joint")
    assert fm.joint_types[torso] == "prismatic"
    for side in ("left", "right"):
        assert fm.parents[fm.joint_id(f"{side}_arm_1_joint")] == torso


def test_free_flyer_dynamics_are_finite():
    """The free-flyer composes with the branched robot (JAX
    `test_freeflyer_tiago`)."""
    _, _, m, p = _load("free_flyer")
    q = t(np.concatenate([np.zeros(6), TIAGO_PRO_Q_READY]))
    z = torch.zeros(14, dtype=torch.float64)
    assert bool(torch.isfinite(dynamics.forward_dynamics(m, p, q, z,
                                                         z)).all())


T = 4
SETTINGS = dict(max_iters=10, termination_tolerance=1e-6, reg_init=1e-7)


def _tick_problem():
    """The fixed-base Tiago-Pro OCP at T = 4 (JAX and port specs), its
    refs with the tool target `chip_smoke.TIAGO_GOAL` away, B = 2 starts
    around the ready pose, the gravity torque as us."""
    jm, jp, pm, pp = _load("reduced")
    # a dt f32 holds exactly: the cost pack scales by a float32 copy of it
    ps = dataclasses.replace(smoke.tiago_spec(T), dt=2.0 ** -6)
    C = jspec.CostItem
    js = jspec.ProblemSpec(
        running_costs=tuple(C(**dataclasses.asdict(i))
                            for i in ps.running_costs),
        terminal_costs=tuple(C(**dataclasses.asdict(i))
                             for i in ps.terminal_costs),
        horizon=T, dt=ps.dt)
    assert port_spec(js).running_costs == ps.running_costs
    q0 = TIAGO_PRO_Q_READY
    x0 = np.concatenate([q0, np.zeros(8)])
    fid = jm.frame_id(smoke.TIAGO_FRAME)
    p0 = np.asarray(jkin.frame_placement(jm, jp, jnp.asarray(q0), fid)[1])
    refs = jspec.default_references(js, jm, dtype=jnp.float64)
    refs["xref"] = jnp.tile(x0[None], (T + 1, 1))
    refs[f"ee_trans:{smoke.TIAGO_FRAME}"] = jnp.tile(
        (p0 + np.asarray(smoke.TIAGO_GOAL))[None], (T + 1, 1))
    rng = np.random.default_rng(0)
    x0s = np.tile(x0[None], (2, 1))
    x0s[1, :8] += rng.normal(size=8) * 0.02
    tau_g = np.asarray(jdyn.generalized_gravity(jm, jp, jnp.asarray(q0)))
    return dict(jm=jm, jp=jp, pp=pp, js=js, ps=ps, refs=refs, x0s=x0s,
                xs=np.tile(x0[None, None], (2, T + 1, 1)),
                us=np.tile(tau_g[None, None], (2, T, 1)))


def _port_solve(pr, backend, max_iters):
    solver = make_batch_sqp(pr["jm"], pr["pp"], pr["ps"], CSQPSettings(
        **dict(SETTINGS, max_iters=max_iters)), device="cpu", backend=backend)
    assert solver.backend == ("kernels" if backend == "auto" else backend)
    return solver(t(pr["x0s"]), refs_from_numpy(pr["refs"], device="cpu"),
                  t(pr["xs"]), t(pr["us"]))


def test_tick_backends_agree():
    """Tier-1 beside the slow JAX comparison: on the Tiago-Pro arm the
    "kernels" backend (K1-K4's plain versions) and the "xla" backend
    (K5a/K5b's plain versions and the batched cost pack, whose prismatic
    root column the port keeps) take the same iterates."""
    pr = _tick_problem()
    a, b = _port_solve(pr, "auto", 3), _port_solve(pr, "xla", 3)
    for f in ("xs", "us", "K", "k", "cost", "kkt", "gap_norm"):
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   getattr(b, f).numpy(), rtol=0, atol=1e-8,
                                   err_msg=f)
    np.testing.assert_array_equal(a.iters.numpy(), b.iters.numpy())
    assert int(a.iters.min()) == 3


@pytest.mark.slow
def test_tick_batch_sqp_matches_jax(monkeypatch):
    """The fixed-base Tiago-Pro OCP through `BatchSQP` (the stage kernels'
    plain versions on the CPU, nj = 8) against the JAX batch SQP, B = 2
    starts around the ready pose, the tool target 15 cm away. The JAX
    batch SQP runs over its generic cost functions, the path it takes where
    its XLA cost pack declines a spec: that pack drops the prismatic torso
    joint's constant Jacobian column (ROADMAP queue 3), which the JAX
    Pallas kernels and the port do not."""
    from agimus_controller_tpu.solver import sqp_batch as jax_sqp_module

    monkeypatch.setattr(jax_sqp_module, "make_batched_cost_pack",
                        lambda *a, **k: None)
    pr = _tick_problem()
    jm, jp, js = pr["jm"], pr["jp"], pr["js"]
    want = jax.jit(jax_batch_sqp(jm, jp, js, jax_build_cf(
        jm, jp, js, dtype=jnp.float64), JaxSettings(**SETTINGS)))(
        jnp.asarray(pr["x0s"]), pr["refs"], jnp.asarray(pr["xs"]),
        jnp.asarray(pr["us"]))
    got = _port_solve(pr, "auto", SETTINGS["max_iters"])
    for f in ("xs", "us", "K", "k", "cost", "kkt", "gap_norm"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-8, err_msg=f)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert int(got.iters.min()) >= 2


def test_cost_pack_keeps_the_prismatic_root_column():
    """The batched cost pack on the Tiago-Pro arm equals the generic
    `CostFunctions` (jacrev): the torso lift's translation-Jacobian column
    is constant (its world axis) and takes part in lx and lxx. The JAX
    package's pack drops it (ROADMAP queue 3): its terminal lxx misses
    that column's Gauss-Newton term on the torso entry."""
    from agimus_controller_tpu.ops.batched_costs import (
        make_batched_cost_pack as jax_pack,
    )
    from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
    from agimus_controller_tpu_torch.ops.batched_costs import (
        make_batched_cost_pack,
    )

    jm, jp, pm, pp = _load("reduced")
    spec = smoke.tiago_spec(20)
    refs, x, u, _, t_idx = smoke.tiago_inputs(spec, pm, 6, 0, "cpu")
    refs = {k: v.double() for k, v in refs.items()}
    x, u = x.double(), u.double()
    pack = make_batched_cost_pack(pm, pp, spec, device="cpu")
    cf = build_cost_functions(pm, pp, spec, torch.float32)
    for got, want in ((pack.pack(x, u, t_idx, refs),
                       cf.pack(x, u, t_idx, refs)),
                      (pack.term_pack(x, refs), cf.term_pack(x, refs))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-12)
    # the JAX pack's terminal lxx on the torso entry, against the port's
    js = jspec.ProblemSpec(running_costs=(), terminal_costs=tuple(
        jspec.CostItem(**dataclasses.asdict(i)) for i in spec.terminal_costs),
        horizon=20, dt=0.02)
    jl = jax_pack(jm, jp, js)[1](jnp.asarray(x.numpy()), {
        k: jnp.asarray(v.numpy()) for k, v in refs.items()})
    # the torso's column is the world z axis: the missing term is the goal
    # weight times the streamed z-translation weight at the horizon
    missing = spec.terminal_costs[0].weight * float(
        refs[f"w_ee:{smoke.TIAGO_FRAME}"][20, 5])
    torso = pack.term_pack(x, refs)[2][:, 0, 0].numpy()
    np.testing.assert_allclose(torso - np.asarray(jl[2])[:, 0, 0], missing,
                               rtol=1e-9)
