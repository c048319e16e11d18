"""The port's batch FDDP path vs the JAX package, f64 on the CPU.

- the Riccati backward sweeps (`backward_components` and the dense sweep)
  against JAX `backward_components` on seeded random LQ data, one scenario
  with an indefinite Quu (T=5, B=3, nx=4, nu=2; atol 1e-10);
- `make_batched_cost_pack` against JAX `make_batched_cost_pack` on the
  2-DoF arm's goal-reaching spec and on Panda specs that cover every kind
  the pack takes (`PACK_SPECS`), with randomized live references: 16
  nodes, calls at two node times and one call over per-node times;
  `pack`/`term_pack`/`value`/`term_value` to atol 1e-9; `None` for the
  specs JAX declines;
- the K5a/K5b wrappers (`device="cpu"`, their plain versions) against JAX
  `make_batched_step(_with_derivs)` and the Pallas body
  `pallas_dynamics.dynamics_terms` called on arrays, N=13, scalar and
  per-node dt (x+ 1e-10, Fx/Fu 1e-8);
- `make_batch_fddp` against JAX `make_batch_fddp` on the 2-DoF arm: B=4
  with per-scenario x0, T=8, dt 0.01 (both sides scale the running costs by
  the same float32 copy of dt), max_iters 10, tolerance 1e-8, for the
  "component" and "dense" sweeps; the multi-resolution horizon of
  `test_fddp_batch.py` (T=6); and its per-scenario convergence case. xs,
  us, K, k, cost, kkt, gap_norm and reg agree to 1e-8; iterations and
  convergence flags are equal.

JAX runs its cost packs eagerly and compiles each solver once: the file
takes about 3 minutes on one worker, mostly in those compiles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from agimus_controller_tpu.models.panda import PANDA_Q_READY
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.models.urdf import build_model_from_urdf as jax_build
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.costs import build_cost_functions
from agimus_controller_tpu.ops import kinematics
from agimus_controller_tpu.ops.batched_costs import (
    make_batched_cost_pack as jax_cost_pack,
)
from agimus_controller_tpu.ops.batched_dynamics import _StaticModel as JaxStaticModel
from agimus_controller_tpu.ops.batched_dynamics import (
    make_batched_step,
    make_batched_step_with_derivs,
)
from agimus_controller_tpu.ops.pallas_dynamics import (
    dynamics_terms as jax_dynamics_terms,
)
from agimus_controller_tpu.solver.fddp import SolverSettings as JaxSettings
from agimus_controller_tpu.solver.fddp_batch import (
    make_batch_fddp as jax_make_batch_fddp,
)
from agimus_controller_tpu.solver.riccati_components import (
    backward_components as jax_backward_components,
)
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.ops.batched_costs import make_batched_cost_pack
from agimus_controller_tpu_torch.ops.cuda_dynamics import (
    make_cuda_step,
    make_cuda_step_derivs,
)
from agimus_controller_tpu_torch.solver.fddp import SolverSettings
from agimus_controller_tpu_torch.solver.fddp_batch import (
    backward_dense,
    make_batch_fddp,
)
from agimus_controller_tpu_torch.solver.riccati_components import (
    backward_components,
)
from tests.test_ring_control_loop import Q0, URDF_2DOF
from tests.test_robot_models import ENV_URDF
from tests.test_torch_stage import SPECS as PANDA_SPECS
from tests.test_torch_stage import to_port_spec

PAIR = [("panda_link7_capsule", "obstacle_sphere")]
CPU = dict(device="cpu")


# ---------------------------------------------------------------------------
# (a) Riccati backward sweeps
# ---------------------------------------------------------------------------

BACKWARD_OUT = ("ks", "Ks", "Qus", "d1", "d2", "bad")


@pytest.fixture(scope="module")
def lq():
    T, B, nx, nu = 5, 3, 4, 2
    rng = np.random.default_rng(0)
    Fx = np.eye(nx) + 0.1 * rng.normal(size=(T, B, nx, nx))
    Fu = 0.1 * rng.normal(size=(T, B, nx, nu))
    A = rng.normal(size=(T, B, nx + nu, nx + nu))
    H = 0.1 * A @ np.swapaxes(A, -1, -2) + 1e-2 * np.eye(nx + nu)
    H[:, 2, nx:, nx:] -= 20.0 * np.eye(nu)  # scenario 2: Quu indefinite
    C = rng.normal(size=(B, nx, nx))
    args = (Fx, Fu, rng.normal(size=(T, B, nx)), rng.normal(size=(T, B, nu)),
            H[..., :nx, :nx], H[..., :nx, nx:], H[..., nx:, nx:],
            0.1 * rng.normal(size=(T + 1, B, nx)), rng.normal(size=(B, nx)),
            C @ np.swapaxes(C, -1, -2), np.asarray([1e-6, 1e-3, 0.0]))
    want = [np.asarray(a) for a in jax_backward_components(
        *(jnp.asarray(a) for a in args))]
    tt = [torch.as_tensor(a) for a in args]
    got = {"component": [a.numpy() for a in backward_components(*tt)],
           "dense": [a.numpy() for a in backward_dense(*tt)]}
    return want, got


@pytest.mark.parametrize("out", BACKWARD_OUT)
@pytest.mark.parametrize("sweep", ["component", "dense"])
def test_backward_matches_jax(lq, sweep, out):
    want, got = lq
    i = BACKWARD_OUT.index(out)
    np.testing.assert_allclose(got[sweep][i], want[i], rtol=0, atol=1e-10)
    if out == "bad":
        np.testing.assert_array_equal(want[i], [False, False, True])


# ---------------------------------------------------------------------------
# (b) batched cost packs
# ---------------------------------------------------------------------------

PACK_CALLS = ("pack_per_node", "pack_t0", "pack_tlast", "term_pack", "value",
              "term_value")


def arm_spec(T, dt=0.01, dt_factor_n_seq=None):
    """The goal-reaching spec of `test_solver_smoke.py` on the 2-DoF arm."""
    C = jspec.CostItem
    return jspec.ProblemSpec(
        running_costs=(
            C(name="state_reg", kind="state", weight=0.1, update=True),
            C(name="ctrl", kind="control_grav", weight=1e-3),
            C(name="goal", kind="frame_placement", weight=10.0, update=True,
              frame="tip"),
        ),
        terminal_costs=(
            C(name="goal", kind="frame_placement", weight=100.0, update=True,
              frame="tip"),
        ),
        horizon=T, dt=dt, dt_factor_n_seq=dt_factor_n_seq)


@pytest.fixture(scope="module")
def arm():
    jm, jp = jax_build(URDF_2DOF, armature=np.array([0.1, 0.1]),
                       dtype=np.float64)
    return jm, jp, params_from_numpy(jp, dtype=torch.float64, **CPU)


@pytest.fixture(scope="module")
def panda():
    jm, jp = jax_load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                            dtype=np.float64)
    return jm, jp, params_from_numpy(jp, dtype=torch.float64, **CPU)


def _random_refs(js, jm, p, rng, nj):
    """Default references with every streamed term randomized and live."""
    Tn = js.horizon + 1
    refs = {k: np.asarray(v) for k, v in
            jspec.default_references(js, jm, dtype=jnp.float64).items()}
    refs["xref"] = rng.normal(size=(Tn, 2 * nj)) * 0.2
    refs["w_x"] = rng.uniform(0.1, 2.0, (Tn, 2 * nj))
    if "uref" in refs:
        refs["uref"] = rng.normal(size=(Tn, nj))
        refs["w_u"] = rng.uniform(0.1, 2.0, (Tn, nj))
    for k in list(refs):
        if k.startswith("ee_trans:"):
            refs[k] = refs[k] + rng.normal(size=(Tn, 3)) * 0.1
        if k.startswith("w_ee:"):
            refs[k] = rng.uniform(0.1, 2.0, (Tn, 6))
    if "w_coll" in refs:
        refs["w_coll"] = rng.uniform(0.5, 1.5, (Tn,))
        refs["geom_trans"] = chip_smoke.obstacle_near_link7(jm, p).numpy()
    refs.update(chip_smoke.moving_refs(js, rng, Tn))
    return refs


def _pack_case(jm, jp, p, js, nj, q0, N=16):
    """Port and JAX outputs of every pack call on N nodes. JAX runs eagerly
    (a compile of each pack costs more) at two node times, 0 and T-1; the
    port's per-node call takes a mix of both times."""
    rng = np.random.default_rng(11)
    refs = _random_refs(js, jm, p, rng, nj)
    collides = "w_coll" in refs
    x = (np.concatenate([np.tile(q0, (N, 1)), np.zeros((N, nj))], -1)
         + rng.normal(size=(N, 2 * nj)) * (0.02 if collides else 0.2))
    x[:, nj:] = rng.normal(size=(N, nj)) * 0.5
    u = rng.normal(size=(N, nj)) * 2.0
    times = (0, js.horizon - 1)
    t_idx = rng.integers(0, 2, size=N)

    jpack, jterm, _, _ = jax_cost_pack(jm, jp, js)
    jr = {k: jnp.asarray(v) for k, v in refs.items()}
    jx, ju = jnp.asarray(x), jnp.asarray(u)
    at = [[np.asarray(a) for a in jpack(jx, ju, t, jr)] for t in times]
    term = [np.asarray(a) for a in jterm(jx, jr)]
    per_node = [np.where(t_idx.reshape((N,) + (1,) * (a0.ndim - 1)) == 0,
                         a0, a1) for a0, a1 in zip(*at)]
    want = {"pack_per_node": per_node, "pack_t0": at[0],
            "pack_tlast": at[1], "term_pack": term,
            # the JAX value functions return the packs' l
            "value": [at[0][0]], "term_value": [term[0]]}

    cp = make_batched_cost_pack(jm, p, to_port_spec(js), **CPU)
    tr = refs_from_numpy(refs, **CPU)
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    got = {
        "pack_per_node": cp.pack(tx, tu, torch.as_tensor(
            np.asarray(times)[t_idx]), tr),
        "pack_t0": cp.pack(tx, tu, times[0], tr),
        "pack_tlast": cp.pack(tx, tu, times[1], tr),
        "term_pack": cp.term_pack(tx, tr),
        "value": [cp.value(tx, tu, times[0], tr)],
        "term_value": [cp.term_value(tx, tr)],
    }
    got = {k: [a.numpy() for a in v] for k, v in got.items()}
    return want, got


def vel_spec(T):
    """One streamed frame-velocity item on the hand: world convention while
    running, local at the terminal node."""
    C = jspec.CostItem
    item = lambda rf: C(name="vel", kind="frame_velocity", weight=2.0,
                        update=True, frame="panda_hand_tcp",
                        reference_frame=rf)
    return jspec.ProblemSpec(running_costs=(item("world"),),
                             terminal_costs=(item("local"),), horizon=T,
                             dt=0.01)


# the arm's goal reaching, and Panda specs that cover every kind the pack
# takes: state, control_grav and frame_placement (flagship); control,
# collision under quad_exp and exp with the streamed `w_coll` (full);
# visual servoing and static-weight frame velocity in two conventions (vs);
# streamed frame velocity (vel)
PACK_SPECS = {"arm": None, "flagship": PANDA_SPECS["flagship"],
              "full": PANDA_SPECS["full"], "vs": PANDA_SPECS["vs"],
              "vel": lambda jm: vel_spec(4)}


@pytest.fixture(scope="module", params=sorted(PACK_SPECS))
def pack_case(request, arm, panda):
    if request.param == "arm":
        jm, jp, p = arm
        return _pack_case(jm, jp, p, arm_spec(5), 2, np.asarray(Q0))
    jm, jp, p = panda
    return _pack_case(jm, jp, p, PACK_SPECS[request.param](jm), 7,
                      np.asarray(PANDA_Q_READY))


@pytest.mark.parametrize("call", PACK_CALLS)
def test_cost_pack_matches_jax(pack_case, call):
    want, got = pack_case
    assert len(got[call]) == len(want[call])
    for i, (g, w) in enumerate(zip(got[call], want[call])):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9,
                                   err_msg=f"{call} output {i}")


def test_cost_pack_declines_what_jax_declines(panda):
    jm, jp, p = panda
    base = PANDA_SPECS["flagship"](jm)
    C = jspec.CostItem
    declined = {
        "soft_contact": dataclasses.replace(base, soft_contact=object()),
        "force_tracking": dataclasses.replace(
            base, running_costs=base.running_costs + (
                C(name="f", kind="force_tracking"),)),
        "exp_on_state": dataclasses.replace(
            base, running_costs=(C(name="x", kind="state", activation="exp",
                                   act_alpha=0.1),)),
    }
    assert jax_cost_pack(jm, jp, base) is not None
    assert make_batched_cost_pack(jm, p, to_port_spec(base), **CPU) is not None
    for name, js in declined.items():
        assert jax_cost_pack(jm, jp, js) is None, name
        ps = dataclasses.replace(to_port_spec(js),
                                 soft_contact=js.soft_contact)
        assert make_batched_cost_pack(jm, p, ps, **CPU) is None, name


# ---------------------------------------------------------------------------
# (c) K5a / K5b wrappers, plain versions
# ---------------------------------------------------------------------------

STEP_OUT = ("xnext", "Fx", "Fu")
STEP_TOL = {"xnext": 1e-10, "Fx": 1e-8, "Fu": 1e-8}


@pytest.fixture(scope="module", params=["scalar_dt", "per_node_dt"])
def step_case(request, panda):
    jm, jp, p = panda
    N = 13
    rng = np.random.default_rng(5)
    x = (np.concatenate([np.tile(PANDA_Q_READY, (N, 1)), np.zeros((N, 7))], 1)
         + rng.normal(size=(N, 14)) * 0.3)
    u = rng.normal(size=(N, 7)) * 2.0
    dt = (0.01 if request.param == "scalar_dt"
          else rng.uniform(0.005, 0.03, size=N))
    jx, ju, jdt = jnp.asarray(x), jnp.asarray(u), jnp.asarray(dt)
    dt_n = np.broadcast_to(dt, (N,))
    jq = lambda a: [jnp.asarray(a[:, i][None]) for i in range(a.shape[1])]
    xn, fx, fu = jax_dynamics_terms(JaxStaticModel(jm, jp), jq(x[:, :7]),
                                    jq(x[:, 7:]), jq(u),
                                    jnp.asarray(dt_n[None]), True)
    ones = jnp.ones((1, N))
    rows = lambda comps: np.stack([np.asarray(c * ones)[0] for c in comps], 1)
    want = {
        "xla_step": (np.asarray(make_batched_step(jm, jp)(jx, ju, jdt)),)
        + tuple(np.asarray(a) for a in make_batched_step_with_derivs(
            jm, jp)(jx, ju, jdt)),
        "pallas_body": (rows(xn), rows(xn), rows(fx).reshape(N, 14, 14),
                        rows(fu).reshape(N, 14, 7)),
    }
    tdt = dt if np.isscalar(dt) else torch.as_tensor(dt)
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    k5a, k5b = make_cuda_step(jm, p, **CPU), make_cuda_step_derivs(jm, p, **CPU)
    got = (k5a(tx, tu, tdt),) + tuple(k5b(tx, tu, tdt))
    assert k5a.launches == k5b.launches == 0  # CPU tensors: plain versions
    return want, [g.numpy() for g in got]


@pytest.mark.parametrize("reference", ["xla_step", "pallas_body"])
@pytest.mark.parametrize("out", ("k5a_xnext",) + tuple(
    f"k5b_{o}" for o in STEP_OUT))
def test_step_kernels_plain_match_jax(step_case, reference, out):
    want, got = step_case
    i = ("k5a_xnext",) + tuple(f"k5b_{o}" for o in STEP_OUT)
    i = i.index(out)
    np.testing.assert_allclose(got[i], want[reference][i], rtol=0,
                               atol=STEP_TOL[out.split("_", 1)[1]])


def test_step_scalar_dt_forms_agree(panda):
    """A Python float, a 0-d tensor and an [N] tensor of one dt give the
    same step."""
    jm, _, p = panda
    rng = np.random.default_rng(6)
    x = torch.as_tensor(np.concatenate(
        [np.tile(PANDA_Q_READY, (5, 1)), np.zeros((5, 7))], 1)
        + rng.normal(size=(5, 14)) * 0.1)
    u = torch.as_tensor(rng.normal(size=(5, 7)))
    k = make_cuda_step_derivs(jm, p, **CPU)
    ref = k(x, u, torch.full((5,), 0.02, dtype=torch.float64))
    for dt in (0.02, torch.tensor(0.02, dtype=torch.float64)):
        for g, w in zip(k(x, u, dt), ref):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_step_wrapper_never_falls_back(panda):
    """Only a CPU tensor reaches the plain version: any other device goes to
    the kernel path, which raises for a wrapper built without a kernel."""
    jm, _, p = panda
    k = make_cuda_step_derivs(jm, p, **CPU)

    def refuse(*args):
        raise AssertionError("plain version called for a non-CPU tensor")

    k.plain = refuse
    x = torch.zeros((3, 14), dtype=torch.float32, device="meta")
    u = torch.zeros((3, 7), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="wrapper built for cpu"):
        k(x, u, 0.01)
    assert k.launches == 0


# ---------------------------------------------------------------------------
# (d) the batch FDDP
# ---------------------------------------------------------------------------

SOLUTION_FIELDS = ("xs", "us", "K", "k", "cost", "kkt", "gap_norm", "reg",
                   "iters", "converged")


def _arm_refs(js, jm, jp):
    """The smoke test's references: hold the start, reach 3 cm / -2 cm."""
    T = js.horizon
    q0 = jnp.asarray(Q0)
    x0 = jnp.concatenate([q0, jnp.zeros(2)])
    R0, p0 = kinematics.frame_placement(jm, jp, q0, jm.frame_id("tip"))
    refs = jspec.default_references(js, jm, dtype=jnp.float64)
    refs["xref"] = jnp.tile(x0[None], (T + 1, 1))
    if "ee_rot:tip" in refs:
        refs["ee_rot:tip"] = jnp.tile(R0[None], (T + 1, 1, 1))
        refs["ee_trans:tip"] = jnp.tile(
            (p0 + jnp.asarray([0.03, 0.0, -0.02]))[None], (T + 1, 1))
    return refs, np.asarray(x0)


def _multires_spec():
    """`test_fddp_batch.py`'s multi-resolution spec, on the arm."""
    C = jspec.CostItem
    return jspec.ProblemSpec(
        running_costs=(
            C(name="state_reg", kind="state", weight=0.1, update=True),
            C(name="ctrl", kind="control", weight=1e-2, update=True),
        ),
        terminal_costs=(
            C(name="state_reg", kind="state", weight=10.0, update=True),),
        horizon=6, dt=0.01, dt_factor_n_seq=((1, 3), (2, 2), (4, 1)))


# problem: (spec factory, settings, x0 offsets on q [B, 2])
FDDP_PROBLEMS = {
    "arm": (lambda: arm_spec(8),
            dict(max_iters=10, termination_tolerance=1e-8), None),
    "multires": (_multires_spec, dict(max_iters=8), None),
    # per-scenario convergence: the easy start converges first
    "per_scenario": (lambda: arm_spec(8),
                     dict(max_iters=30, termination_tolerance=1e-6),
                     np.asarray([[0.0, 0.0], [0.4, 0.4]])),
}
# case: (problem, the port's sweep). Each problem's JAX reference is one
# compile of the JAX solver with its default "component" sweep, which the
# JAX package's tests hold equal to its dense sweep.
FDDP_CASES = {"component": ("arm", "component"), "dense": ("arm", "dense"),
              "multires": ("multires", "component"),
              "per_scenario": ("per_scenario", "component")}


def _fddp_problem(name, arm):
    jm, jp, _ = arm
    build, kw, offsets = FDDP_PROBLEMS[name]
    js = build()
    refs, x0 = _arm_refs(js, jm, jp)
    if js.running_costs[1].kind == "control":
        refs["xref"] = refs["xref"] + 0.05
    if offsets is None:
        offsets = 0.05 * np.random.default_rng(3).normal(size=(4, 2))
    x0s = np.tile(x0[None], (offsets.shape[0], 1))
    x0s[:, :2] += offsets
    xs0 = np.tile(x0s[:, None, :], (1, js.horizon + 1, 1))
    us0 = np.zeros((offsets.shape[0], js.horizon, 2))
    cf = build_cost_functions(jm, jp, js, dtype=jnp.float64)
    jsolve = jax.jit(jax_make_batch_fddp(jm, jp, js, cf, JaxSettings(**kw)))
    want = jsolve(jnp.asarray(x0s), refs, jnp.asarray(xs0), jnp.asarray(us0))
    return js, kw, refs, (x0s, xs0, us0), want


@pytest.fixture(scope="module")
def fddp_problems():
    return {}  # problem name -> `_fddp_problem`, computed once


@pytest.fixture(scope="module", params=sorted(FDDP_CASES))
def fddp_case(request, arm, fddp_problems):
    problem, riccati = FDDP_CASES[request.param]
    if problem not in fddp_problems:
        fddp_problems[problem] = _fddp_problem(problem, arm)
    js, kw, refs, (x0s, xs0, us0), want = fddp_problems[problem]
    jm, _, p = arm
    solver = make_batch_fddp(jm, p, to_port_spec(js), SolverSettings(**kw),
                             riccati=riccati, **CPU)
    got = solver(torch.as_tensor(x0s),
                 refs_from_numpy({k: np.asarray(v) for k, v in refs.items()},
                                 **CPU),
                 torch.as_tensor(xs0), torch.as_tensor(us0))
    return request.param, want, got


@pytest.mark.parametrize("field", SOLUTION_FIELDS)
def test_batch_fddp_matches_jax(fddp_case, field):
    name, want, got = fddp_case
    g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
    assert g.shape == w.shape
    if field in ("iters", "converged"):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-8)
    if name == "per_scenario" and field == "iters":
        assert g[0] <= g[1]


def test_batch_fddp_refuses_what_is_not_ported(arm):
    jm, _, p = arm
    ps = to_port_spec(arm_spec(4))
    with pytest.raises(NotImplementedError, match="slice 16"):
        make_batch_fddp(jm, p, ps, riccati="pscan", **CPU)
    with pytest.raises(NotImplementedError, match="slice 12"):
        make_batch_fddp(jm, p, dataclasses.replace(ps, soft_contact=object()),
                        **CPU)
    # the pack declines a soft-contact cost; its fallback, CostFunctions,
    # refuses it too
    C = jspec.CostItem
    declined = to_port_spec(dataclasses.replace(
        arm_spec(4), running_costs=(C(name="f", kind="force_tracking"),)))
    with pytest.raises(NotImplementedError, match="slice 12"):
        make_batch_fddp(jm, p, declined, **CPU)
    with pytest.raises(ValueError):
        make_batch_fddp(jm, p, ps, riccati="nope", **CPU)
