"""The port's free-flyer cost functions (`ocp/ff_costs.py`) and the
manifold backends of its solvers vs the JAX package, f64.

The Panda on a quaternion free-flyer base (zero gravity, as the JAX
manifold tests) with the obstacle sphere of `test_robot_models.py`:

- every cost kind of `FF_COST_KINDS` and constraint kind of
  `FF_CONSTRAINT_KINDS` (`force_tracking` and `force_box` on the
  force-augmented state), under both actuations ("floating_base": nu = nv
  - 6, "full"): the step, the stage and terminal costs, the tangent-space
  Gauss-Newton blocks, Fx/Fu, the constraint rows and their tangent
  Jacobians at three nodes (values at 1e-10, derivative blocks at 1e-9);
  tier 1 takes four kinds under the default actuation, the slow tier
  every kind under both actuations (each case a JAX compile of ~60-75 s);
- the solvers on the manifold at T = 3 from a base pitched at pi/2: the
  tier-1 cases hold the port's `BatchFDDP` against its `solve_fddp`
  iterate for iterate and its manifold `BatchSQP` (B = 2, and with soft
  contact) on the optimum; the JAX comparisons (`solve_fddp`, `BatchSQP`,
  `BatchFDDP` and manifold + soft `BatchSQP`, iterate for iterate at 1e-8,
  iterations equal) are marked slow, as the JAX manifold tests are;
- `BatchFDDP` refuses manifold + soft contact, as the JAX one asserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import (
    PANDA_DEFAULT_ARMATURE,
    PANDA_Q_READY,
    PANDA_URDF,
)
from agimus_controller_tpu.models.urdf import build_model_from_urdf as jax_build
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.ff_costs import build_ff_cost_functions as jax_ff
from agimus_controller_tpu.ops import lie as jlie
from agimus_controller_tpu.ops import soft_contact as jsc
from agimus_controller_tpu.solver.csqp import CSQPSettings as JaxCSQPSettings
from agimus_controller_tpu.solver.fddp import SolverSettings as JaxSettings
from agimus_controller_tpu.solver.fddp import solve_fddp as jax_solve_fddp
from agimus_controller_tpu.solver.fddp_batch import make_batch_fddp as jax_batch_fddp
from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp as jax_batch_sqp
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.ocp.ff_costs import (
    FF_CONSTRAINT_KINDS,
    FF_COST_KINDS,
    build_ff_cost_functions,
)
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.ops.soft_contact import SoftContactConfig
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from agimus_controller_tpu_torch.solver.fddp import SolverSettings, solve_fddp
from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp
from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp
from tests.test_robot_models import ENV_URDF
from tests.test_torch_soft_contact import port_spec

ATOL, ATOL_D, ATOL_S = 1e-10, 1e-9, 1e-8
FRAME = "panda_hand_tcp"
C, K = jspec.CostItem, jspec.ConstraintItem
SC = dict(frame=FRAME, Kp=(200.0,) * 3, Kv=(20.0,) * 3,
          ref="local_world_aligned", force_lb=(-20.0,) * 3,
          force_ub=(20.0,) * 3)
NODES = 3
t = torch.as_tensor


@pytest.fixture(scope="module")
def ff():
    jm, jp = jax_build(PANDA_URDF, armature=PANDA_DEFAULT_ARMATURE,
                       collision_as_capsule=True, gravity=(0.0, 0.0, 0.0),
                       dtype=np.float64, free_flyer=True, env_urdf=ENV_URDF,
                       robot_attachment_frame="panda_link0",
                       collision_pairs=[("panda_link7_capsule",
                                         "obstacle_sphere")])
    return jm, jp, params_from_numpy(jp, dtype=torch.float64, device="cpu")


def _items(w):
    """Every free-flyer cost kind but force_tracking, weights scaled by w."""
    hand = dict(update=True, frame=FRAME)
    return (
        C(name="x", kind="state", weight=0.05 * w, update=True),
        C(name="u", kind="control", weight=1e-2 * w, update=True),
        C(name="grav", kind="control_grav", weight=1e-3 * w, update=True),
        C(name="pose", kind="frame_placement", weight=10.0 * w, **hand),
        C(name="trans", kind="frame_translation", weight=3.0 * w,
          update=True, frame="panda_link5"),
        C(name="rot", kind="frame_rotation", weight=2.0 * w, frame=FRAME),
        C(name="vel", kind="frame_velocity", weight=0.5 * w,
          reference_frame="local", **hand),
        C(name="vs", kind="visual_servoing", weight=4.0 * w,
          object_frame="obj", **hand),
        C(name="coll", kind="collision_distance", weight=2.0 * w,
          update=True, pair_id=0))


def jax_spec(soft: bool, lite: bool = False):
    """Every kind (with soft contact: force_tracking and force_box too);
    `lite`: the state, control, control_grav and frame_placement costs and
    the control limit, for tier 1."""
    force = (C(name="f", kind="force_tracking", weight=2.0, update=True),)
    cons = (K(name="ulim", kind="control_limit"),
            K(name="coll", kind="collision_distance", pair_id=0,
              lower=(0.02,)))
    if soft:
        cons = cons + (K(name="fb", kind="force_box"),)
    running, terminal = _items(1.0), _items(5.0)[:1] + _items(5.0)[3:]
    if lite:
        running, terminal, cons = running[:4], terminal[:2], cons[:1]
    return jspec.ProblemSpec(
        running_costs=running + (force if soft else ()),
        terminal_costs=terminal + (force if soft else ()),
        constraints=cons, horizon=4, dt=0.02,
        soft_contact=jsc.SoftContactConfig(**SC) if soft else None)


def _refs(jm, js, nt, rng, quat):
    """The spec's refs from the seed, per node (vision transform per node
    too), the hand's rotation target a valid rotation."""
    T1 = js.horizon + 1
    nv = jm.nj
    x = np.concatenate([rng.normal(size=3) * 0.1, quat,
                        PANDA_Q_READY + rng.normal(size=7) * 0.1,
                        rng.normal(size=nv) * 0.2])
    rot = lambda: np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3))))
    refs = {"xref": np.tile(x[None], (T1, 1)),
            "w_x": rng.uniform(0.2, 1.5, (T1, nt)),
            "uref": rng.normal(size=(T1, nv)),
            "w_u": rng.uniform(0.2, 1.5, (T1, nv)),
            "w_coll": rng.uniform(0.5, 1.5, T1),
            f"ee_vel:{FRAME}": rng.normal(size=(T1, 6)) * 0.2,
            f"w_ee_vel:{FRAME}": rng.uniform(0.2, 1.5, (T1, 6)),
            "wMo_rot:obj": np.stack([rot() for _ in range(T1)]),
            "wMo_trans:obj": rng.normal(size=(T1, 3)) * 0.1}
    for f in (FRAME, "panda_link5"):
        refs[f"ee_rot:{f}"] = np.stack([rot() for _ in range(T1)])
        refs[f"ee_trans:{f}"] = rng.normal(size=(T1, 3)) * 0.3 + 0.4
        refs[f"w_ee:{f}"] = rng.uniform(0.2, 1.5, (T1, 6))
    if js.soft_contact is not None:
        refs["xref"] = np.concatenate([refs["xref"], np.zeros((T1, 3))], 1)
        refs["f_des"] = rng.normal(size=(T1, 3)) * 5.0
        refs["w_force"] = rng.uniform(0.5, 2.0, (T1, 3))
        refs["contact_active"] = np.asarray([1.0, 0.0, 1.0, 1.0, 1.0])
    return {k: jnp.asarray(v) for k, v in refs.items()}


STAGE = ("cost", "lx", "lu", "lxx", "lxu", "luu", "xnext", "Fx", "Fu")
# tier 1: the default actuation on a lite rigid spec; the slow tier: every
# kind under both actuations, rigid and soft (a JAX compile of ~60-75 s
# each)
CASES = [pytest.param(("lite", "floating_base"), id="lite-floating_base")] + [
    pytest.param((s, a), id=f"{s}-{a}", marks=pytest.mark.slow)
    for s in ("rigid", "soft") for a in ("floating_base", "full")]


@pytest.fixture(scope="module", params=CASES)
def cost_case(request, ff):
    jm, jp, p = ff
    soft = request.param[0] == "soft"
    act = request.param[1]
    js = jax_spec(soft, lite=request.param[0] == "lite")
    ps = port_spec(js, SoftContactConfig(**SC) if soft else None)
    jcf = jax_ff(jm, jp, js, dtype=jnp.float64, actuation=act)
    pcf = build_ff_cost_functions(jm, p, ps, torch.float64, act)
    assert pcf.ntan == jcf.ntan and pcf.n_constraints == jcf.n_constraints
    rng = np.random.default_rng(len(request.param[1]) + soft)
    quat = np.asarray([0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)])
    refs = _refs(jm, js, pcf.ntan, rng, quat)
    prefs = refs_from_numpy(refs, device="cpu")
    nu = pcf.nu
    xs = np.stack([np.asarray(jlie.state_integrate(jm)(
        refs["xref"][n, :27], jnp.asarray(rng.normal(size=26) * 0.1)))
        for n in range(NODES + 1)])
    if soft:
        xs = np.concatenate([xs, rng.normal(size=(NODES + 1, 3)) * 5.0], 1)
    us = rng.normal(size=(NODES, nu))
    ts = np.arange(NODES)
    want, got = {}, {}
    jd, jc, jv = jax.jit(jax.vmap(lambda x, u, n: (
        jcf.stage_derivs(x, u, n, refs), jcf.constraint_derivs(x, u, n, refs),
        (jcf.step(x, u, n, refs), jcf.stage_cost(x, u, n, refs)))))(
            jnp.asarray(xs[:NODES]), jnp.asarray(us), jnp.asarray(ts))
    pd = pcf.stage_derivs_b(t(xs[:NODES]), t(us), t(ts), prefs)
    pc = pcf.constraint_functions.constraint_derivs(t(xs[:NODES]), t(us),
                                                    t(ts), prefs)
    for f in STAGE:
        want[f], got[f] = np.asarray(getattr(jd, f)), getattr(pd, f).numpy()
    for name, w, g in zip(("g", "lb", "ub", "Gx", "Gu"), jc, pc):
        want[name], got[name] = np.asarray(w), g.numpy()
    want["step"] = np.asarray(jv[0])
    got["step"] = pcf.step_b(t(xs[:NODES]), t(us), t(ts), prefs).numpy()
    want["stage_cost"] = np.asarray(jv[1])
    got["stage_cost"] = pcf.value(t(xs[:NODES]), t(us), t(ts), prefs).numpy()
    jT = jcf.terminal_derivs(jnp.asarray(xs[NODES]), refs)
    pT = pcf.terminal_derivs(t(xs[NODES]), prefs)
    for name, w, g in zip(("term_l", "term_lx", "term_lxx"), jT, pT):
        want[name], got[name] = np.asarray(w), g.numpy()
    want["term_cost"] = np.asarray(jcf.terminal_cost(jnp.asarray(xs[NODES]),
                                                     refs))
    got["term_cost"] = pcf.terminal_cost(t(xs[NODES]), prefs).numpy()
    dx = rng.normal(size=pcf.ntan) * 0.2
    want["sint"] = np.asarray(jcf.state_integrate(jnp.asarray(xs[0]),
                                                  jnp.asarray(dx)))
    got["sint"] = pcf.state_integrate(t(xs[0]), t(dx)).numpy()
    want["sdiff"] = np.asarray(jcf.state_diff(jnp.asarray(xs[1]),
                                              jnp.asarray(xs[0])))
    got["sdiff"] = pcf.state_diff(t(xs[1]), t(xs[0])).numpy()
    return want, got


VALUES = ("cost", "xnext", "g", "lb", "ub", "step", "stage_cost", "term_l",
          "term_cost", "sint", "sdiff")


@pytest.mark.parametrize("field", STAGE + (
    "g", "lb", "ub", "Gx", "Gu", "step", "stage_cost", "term_l", "term_lx",
    "term_lxx", "term_cost", "sint", "sdiff"))
def test_ff_cost_functions_match_jax(cost_case, field):
    want, got = cost_case
    assert got[field].shape == want[field].shape
    np.testing.assert_allclose(got[field], want[field], rtol=0,
                               atol=ATOL if field in VALUES else ATOL_D)


def test_ff_kinds_cover_the_jax_kinds():
    from agimus_controller_tpu.ocp import ff_costs as jff

    assert FF_COST_KINDS == jff.FF_COST_KINDS
    assert FF_CONSTRAINT_KINDS == jff.FF_CONSTRAINT_KINDS
    kinds = {i.kind for s in (True, False) for i in
             jax_spec(s).running_costs + jax_spec(s).terminal_costs}
    assert kinds == set(FF_COST_KINDS)
    assert {c.kind for c in jax_spec(True).constraints} == set(
        FF_CONSTRAINT_KINDS)


# -- the solvers on the manifold --------------------------------------------
T = 3
GOAL = (0.03, 0.02, -0.02)


def solve_spec(soft=False):
    """The JAX manifold tests' goal OCP (state and control regularisation,
    a terminal hand placement), with force tracking on a soft contact."""
    force = (C(name="f", kind="force_tracking", weight=1.0, update=True),)
    return jspec.ProblemSpec(
        running_costs=(C(name="state_reg", kind="state", weight=0.05,
                         update=True),
                       C(name="ctrl", kind="control", weight=1e-2,
                         update=True)) + (force if soft else ()),
        terminal_costs=(C(name="goal", kind="frame_placement", weight=100.0,
                          update=True, frame=FRAME),),
        horizon=T, dt=0.02,
        soft_contact=jsc.SoftContactConfig(**SC) if soft else None)


@pytest.fixture(scope="module", params=["rigid", "soft"])
def solve_case(request, ff):
    jm, jp, p = ff
    soft = request.param == "soft"
    js = solve_spec(soft)
    ps = port_spec(js, SoftContactConfig(**SC) if soft else None)
    jcf = jax_ff(jm, jp, js, dtype=jnp.float64)
    pcf = build_ff_cost_functions(jm, p, ps, torch.float64)
    nv, nu = jm.nj, pcf.nu
    quat = jnp.asarray([0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)])
    x0 = jlie.join_state(jnp.zeros(3), quat, jnp.asarray(PANDA_Q_READY),
                         jnp.zeros(nv))
    R0, p0 = jlie.ff_frame_placement(jm, jp, x0, jm.frame_id(FRAME))
    if soft:
        x0 = jnp.concatenate([x0, jnp.zeros(3)])
    T1 = T + 1
    refs = {"xref": jnp.tile(x0[None], (T1, 1)),
            "w_x": jnp.tile(jnp.concatenate([jnp.full(nv, 0.1),
                                             jnp.full(nv, 1.0),
                                             jnp.zeros(pcf.nf)])[None],
                            (T1, 1)),
            "w_u": jnp.ones((T1, nv)), "uref": jnp.zeros((T1, nv)),
            f"ee_rot:{FRAME}": jnp.tile(R0[None], (T1, 1, 1)),
            f"ee_trans:{FRAME}": jnp.tile((p0 + jnp.asarray(GOAL))[None],
                                          (T1, 1)),
            f"w_ee:{FRAME}": jnp.ones((T1, 6))}
    if soft:
        refs["f_des"] = jnp.tile(jnp.asarray([0.0, 0.0, -2.0])[None],
                                 (T1, 1))
        refs["w_force"] = jnp.ones((T1, 3))
        refs["contact_active"] = jnp.ones((T1,))
    xs0 = np.tile(np.asarray(x0)[None], (T1, 1))
    return dict(jm=jm, jp=jp, p=p, js=js, ps=ps, jcf=jcf, pcf=pcf, refs=refs,
                prefs=refs_from_numpy(refs, device="cpu"), x0=np.asarray(x0),
                xs0=xs0, us0=np.zeros((T, nu)), soft=soft)


FDDP = dict(max_iters=8, termination_tolerance=1e-7)
SQP = dict(max_iters=8, termination_tolerance=1e-7, reg_init=1e-8)
FIELDS = ("xs", "us", "K", "k", "cost", "kkt", "gap_norm")


def _check(got, want, fields=FIELDS):
    for f in fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=ATOL_S, err_msg=f)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))


def _rows(sc, B=2):
    return (np.tile(sc["x0"][None], (B, 1)), np.tile(sc["xs0"][None], (B, 1, 1)),
            np.tile(sc["us0"][None], (B, 1, 1)))


def test_manifold_batch_fddp_matches_single(solve_case):
    """Tier-1: the port's manifold `BatchFDDP` rows equal its manifold
    `solve_fddp` iterate for iterate; manifold + soft is refused, as the
    JAX batch FDDP asserts."""
    sc = solve_case
    if sc["soft"]:
        with pytest.raises(NotImplementedError,
                           match="manifold \\+ soft contact"):
            make_batch_fddp(sc["jm"], sc["p"], sc["ps"], device="cpu",
                            cf=sc["pcf"])
        with pytest.raises(AssertionError, match="manifold \\+ soft"):
            jax_batch_fddp(sc["jm"], sc["jp"], sc["js"], sc["jcf"])
        return
    x0s, xs, us = _rows(sc)
    got = make_batch_fddp(sc["jm"], sc["p"], sc["ps"], SolverSettings(**FDDP),
                          device="cpu", cf=sc["pcf"])(
        t(x0s), sc["prefs"], t(xs), t(us))
    one = solve_fddp(sc["pcf"], t(sc["x0"]), sc["prefs"], t(sc["xs0"]),
                     t(sc["us0"]), SolverSettings(**FDDP))
    for f in ("xs", "us", "K", "k"):
        np.testing.assert_allclose(getattr(got, f)[0].numpy(),
                                   getattr(one, f).numpy(), rtol=0,
                                   atol=ATOL_S, err_msg=f)
    assert int(got.iters[0]) == int(one.iters) >= 2


def test_manifold_batch_sqp_reaches_the_optimum(solve_case):
    """Tier-1: the manifold `BatchSQP` (manifold + soft included) converges
    with identical rows, on the FDDP optimum where that solver runs."""
    sc = solve_case
    x0s, xs, us = _rows(sc)
    solver = make_batch_sqp(sc["jm"], sc["p"], sc["ps"], CSQPSettings(**SQP),
                            device="cpu", cf=sc["pcf"])
    assert solver.backend == "manifold" and solver.kernels == ()
    got = solver(t(x0s), sc["prefs"], t(xs), t(us))
    assert bool(got.converged.all())
    np.testing.assert_array_equal(got.us[0].numpy(), got.us[1].numpy())
    if not sc["soft"]:
        one = solve_fddp(sc["pcf"], t(sc["x0"]), sc["prefs"], t(sc["xs0"]),
                         t(sc["us0"]), SolverSettings(**FDDP))
        # two solver families stopped at KKT 1e-7 on a free-floating base
        # in zero gravity (a flat direction): the same optimum to 1e-4
        np.testing.assert_allclose(got.us[0].numpy(), one.us.numpy(),
                                   rtol=0, atol=1e-4)


@pytest.mark.slow
def test_manifold_solve_fddp_matches_jax(solve_case):
    sc = solve_case
    want = jax.jit(lambda x0, xs, us: jax_solve_fddp(
        sc["jcf"], x0, sc["refs"], xs, us, JaxSettings(**FDDP)))(
        jnp.asarray(sc["x0"]), jnp.asarray(sc["xs0"]), jnp.asarray(sc["us0"]))
    got = solve_fddp(sc["pcf"], t(sc["x0"]), sc["prefs"], t(sc["xs0"]),
                     t(sc["us0"]), SolverSettings(**FDDP))
    _check(got, want)


@pytest.mark.slow
def test_manifold_batch_solvers_match_jax(solve_case):
    """`BatchSQP` (manifold + soft included) and `BatchFDDP` (rigid) on the
    manifold vs the JAX batch solvers, B = 2."""
    sc = solve_case
    x0s, xs, us = _rows(sc)
    jargs = (jnp.asarray(x0s), sc["refs"], jnp.asarray(xs), jnp.asarray(us))
    want = jax.jit(jax_batch_sqp(sc["jm"], sc["jp"], sc["js"], sc["jcf"],
                                 JaxCSQPSettings(**SQP)))(*jargs)
    got = make_batch_sqp(sc["jm"], sc["p"], sc["ps"], CSQPSettings(**SQP),
                         device="cpu", cf=sc["pcf"])(
        t(x0s), sc["prefs"], t(xs), t(us))
    _check(got, want)
    if sc["soft"]:
        return
    want = jax.jit(jax_batch_fddp(sc["jm"], sc["jp"], sc["js"], sc["jcf"],
                                  JaxSettings(**FDDP)))(*jargs)
    got = make_batch_fddp(sc["jm"], sc["p"], sc["ps"], SolverSettings(**FDDP),
                          device="cpu", cf=sc["pcf"])(
        t(x0s), sc["prefs"], t(xs), t(us))
    _check(got, want)
