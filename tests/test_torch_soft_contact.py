"""The port's soft contact (force-augmented state) vs the JAX package, f64.

`ops/soft_contact.py` on the Panda: the dynamics and the step for a 3-D
and a 1-D contact in the "local" and "local_world_aligned" frames, active
and inactive; the free-flyer variants (the batched step and its Jacobians
are `test_torch_soft_contact_batched.py`'s); the `force_tracking` cost and
the `force_box` constraint through
`CostFunctions`; the YAML block `DAMSoftContactAugmentedFwdDynamics`; the
ring's `f_des` / `w_force` / `contact_active` fields; the force-feedback
warm start (the JAX `test_force_feedback.py::test_ff_warm_start` case);
`OCPTorch.integrate` running the soft step. Inputs from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import PANDA_Q_READY
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.mpc import buffer as jbuffer
from agimus_controller_tpu.mpc.data import OCPResults as JaxResults
from agimus_controller_tpu.mpc.ring import RowLayout as JaxRowLayout
from agimus_controller_tpu.mpc.warm_start import (
    WarmStartShiftPreviousSolutionForceFeedback as JaxFFWarmStart,
)
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.costs import build_cost_functions as jax_build_cf
from agimus_controller_tpu.ocp.yaml_compiler import load_ocp_spec as jax_load_yaml
from agimus_controller_tpu.ops import dynamics as jdyn
from agimus_controller_tpu.ops import soft_contact as jsc
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.mpc import buffer as pbuffer
from agimus_controller_tpu_torch.mpc.data import OCPResults
from agimus_controller_tpu_torch.mpc.ocp_base import OCPParams, OCPTorch
from agimus_controller_tpu_torch.mpc.ring import RowLayout
from agimus_controller_tpu_torch.mpc.warm_start import (
    WarmStartShiftPreviousSolutionForceFeedback,
)
from agimus_controller_tpu_torch.ocp import spec as tspec
from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.ocp.yaml_compiler import load_ocp_spec
from agimus_controller_tpu_torch.ops import dynamics
from agimus_controller_tpu_torch.ops import kinematics, soft_contact
from agimus_controller_tpu_torch.ops.soft_contact import SoftContactConfig

ATOL = 1e-10
ATOL_D = 1e-9
FRAME = "panda_hand_tcp"
SC3 = dict(frame=FRAME, Kp=(200.0,) * 3, Kv=(20.0,) * 3,
           ref="local_world_aligned")
SC1 = dict(SC3, enabled_directions=(False, False, True))
CONTACTS = {"nc3": SC3, "nc1": SC1, "nc3_local": dict(SC3, ref="local"),
            "nc1_local": dict(SC1, ref="local")}
t = torch.as_tensor


def port_spec(js, sc=None):
    """The port's ProblemSpec of a JAX spec, constraints and `sc` (the
    port's SoftContactConfig) included."""
    conv = lambda cls, seq: tuple(cls(**dataclasses.asdict(i)) for i in seq)
    return tspec.ProblemSpec(
        running_costs=conv(tspec.CostItem, js.running_costs),
        terminal_costs=conv(tspec.CostItem, js.terminal_costs),
        constraints=conv(tspec.ConstraintItem, js.constraints),
        horizon=js.horizon, dt=js.dt, dt_factor_n_seq=js.dt_factor_n_seq,
        soft_contact=sc)


@pytest.fixture(scope="module")
def panda():
    jm, jp = jax_load_panda(dtype=np.float64)
    return jm, jp, params_from_numpy(jp, dtype=torch.float64, device="cpu")


def _state(nc, seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([PANDA_Q_READY + rng.normal(size=7) * 0.1,
                        rng.normal(size=7) * 0.3, rng.normal(size=nc) * 5.0])
    return x, rng.normal(size=7) * 2.0


def test_nc_dimensions():
    assert SoftContactConfig(**SC3).nc == 3
    assert SoftContactConfig(**SC1).nc == 1
    assert SoftContactConfig(**SC1).mask_indices() == (2,)
    with pytest.raises(AssertionError):
        SoftContactConfig(frame="f", enabled_directions=(True, True, False)).nc


@pytest.mark.parametrize("active", [1.0, 0.0])
@pytest.mark.parametrize("contact", sorted(CONTACTS))
def test_dynamics_and_step_match_jax(panda, contact, active):
    """(a, f_dot) and the semi-implicit step, active and inactive."""
    jm, jp, p = panda
    jc, pc = (jsc.SoftContactConfig(**CONTACTS[contact]),
              SoftContactConfig(**CONTACTS[contact]))
    x, u = _state(pc.nc, 1)
    for want, got in (
            (jsc.soft_contact_dynamics(jm, jp, jc, jnp.asarray(x),
                                       jnp.asarray(u), active),
             soft_contact.soft_contact_dynamics(jm, p, pc, t(x), t(u),
                                                active)),
            ((jsc.soft_contact_step(jm, jp, jc, jnp.asarray(x),
                                    jnp.asarray(u), 0.01, active),),
             (soft_contact.soft_contact_step(jm, p, pc, t(x), t(u), 0.01,
                                             active),))):
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL)


def test_inactive_contact_freezes_force(panda):
    """With the contact inactive the force state rides along and does not
    act on the joints (JAX `test_inactive_contact_freezes_force`)."""
    jm, _, p = panda
    sc = SoftContactConfig(**SC3)
    x = torch.cat([t(PANDA_Q_READY), torch.full((7,), 0.1,
                                                dtype=torch.float64),
                   t([1.0, 2.0, 3.0], dtype=torch.float64)])
    u = torch.zeros(7, dtype=torch.float64)
    xn = soft_contact.soft_contact_step(jm, p, sc, x, u, 0.01, active=0.0)
    np.testing.assert_allclose(xn[14:].numpy(), [1.0, 2.0, 3.0], atol=1e-12)
    a_off, _ = soft_contact.soft_contact_dynamics(jm, p, sc, x, u, 0.0)
    a_free = dynamics.forward_dynamics(jm, p, x[:7], x[7:14], u)
    np.testing.assert_allclose(a_off.numpy(), a_free.numpy(), atol=1e-12)


def test_contact_force_accelerates_ee(panda):
    """A static arm under gravity compensation and a +z contact force:
    M da = J^T f (JAX `test_contact_force_accelerates_ee`)."""
    jm, _, p = panda
    q = t(PANDA_Q_READY)
    f = t([0.0, 0.0, 10.0], dtype=torch.float64)
    x = torch.cat([q, torch.zeros(7, dtype=torch.float64), f])
    a, _ = soft_contact.soft_contact_dynamics(
        jm, p, SoftContactConfig(**SC3), x,
        dynamics.generalized_gravity(jm, p, q))
    J = kinematics.frame_jacobian(jm, p, q, jm.frame_id(FRAME),
                                  "local_world_aligned")[3:]
    np.testing.assert_allclose((dynamics.mass_matrix(jm, p, q) @ a).numpy(),
                               (J.T @ f).numpy(), atol=1e-9)


@pytest.mark.parametrize("active", [1.0, 0.0])
def test_ff_soft_step_matches_jax(active):
    """The free-flyer variant at a pitched base, full torque."""
    jm, jp = jax_load_panda(dtype=np.float64, free_flyer=True)
    p = params_from_numpy(jp, dtype=torch.float64, device="cpu")
    jc, pc = jsc.SoftContactConfig(**SC3), SoftContactConfig(**SC3)
    rng = np.random.default_rng(6)
    th = 0.7
    x = np.concatenate([rng.normal(size=3), [0.0, np.sin(th / 2), 0.0,
                                             np.cos(th / 2)],
                        PANDA_Q_READY + rng.normal(size=7) * 0.1,
                        rng.normal(size=13) * 0.3, rng.normal(size=3)])
    u = rng.normal(size=13)
    want = jsc.ff_soft_contact_step(jm, jp, jc, jnp.asarray(x),
                                    jnp.asarray(u), 0.01, active)
    got = soft_contact.ff_soft_contact_step(jm, p, pc, t(x), t(u), 0.01,
                                            active)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    wa = jsc.ff_soft_contact_dynamics(jm, jp, jc, jnp.asarray(x),
                                      jnp.asarray(u), active)
    ga = soft_contact.ff_soft_contact_dynamics(jm, p, pc, t(x), t(u), active)
    for w, g in zip(wa, ga):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


def force_jax_spec(T, sc=SC3, constraints=()):
    """The JAX force-feedback tests' OCP (`force_ocp`), with a force_box."""
    C = jspec.CostItem
    state = C(name="state_reg", kind="state", weight=0.1, update=True)
    force = C(name="force_tracking", kind="force_tracking", weight=1.0,
              update=True)
    return jspec.ProblemSpec(
        running_costs=(state, C(name="grav_reg", kind="control_grav",
                                weight=5e-3), force),
        terminal_costs=(state, force), constraints=constraints, horizon=T,
        dt=0.02, soft_contact=jsc.SoftContactConfig(**sc))


STAGE_FIELDS = ("cost", "lx", "lu", "lxx", "lxu", "luu", "xnext", "Fx", "Fu")


@pytest.fixture(scope="module", params=["nc3", "nc1"])
def force_case(request, panda):
    """`force_tracking` and `force_box` through CostFunctions at every node
    of a T=4 horizon, random refs (contact_active mixed)."""
    jm, jp, p = panda
    nc = 3 if request.param == "nc3" else 1
    sc = dict(CONTACTS[request.param], force_lb=(-20.0,) * nc,
              force_ub=(20.0,) * nc)
    js = force_jax_spec(4, sc, (jspec.ConstraintItem(name="fb",
                                                     kind="force_box"),))
    ps = port_spec(js, SoftContactConfig(**sc))
    jcf = jax_build_cf(jm, jp, js, dtype=jnp.float64)
    pcf = build_cost_functions(jm, p, ps, torch.float64)
    rng = np.random.default_rng(7)
    refs = jspec.default_references(js, jm, dtype=jnp.float64)
    refs = {k: jnp.asarray(rng.uniform(0.2, 1.5, np.shape(v)))
            for k, v in refs.items()}
    refs["contact_active"] = jnp.asarray([1.0, 0.0, 1.0, 1.0, 1.0])
    prefs = refs_from_numpy(refs, device="cpu")
    nc = ps.nc
    xs = np.stack([_state(nc, s)[0] for s in range(5)])
    us = rng.normal(size=(4, 7))
    ts = np.arange(4)
    jd, jc = jax.jit(jax.vmap(lambda x, u, n: (
        jcf.stage_derivs(x, u, n, refs), jcf.constraint_derivs(x, u, n, refs))))(
            jnp.asarray(xs[:4]), jnp.asarray(us), jnp.asarray(ts))
    pd = pcf.stage_derivs_b(t(xs[:4]), t(us), t(ts), prefs)
    pc = pcf.constraint_functions.constraint_derivs(t(xs[:4]), t(us), t(ts),
                                                    prefs)
    out = {"want": {f: np.asarray(getattr(jd, f)) for f in STAGE_FIELDS},
           "got": {f: getattr(pd, f).numpy() for f in STAGE_FIELDS}}
    for name, w, g in zip(("g", "lb", "ub", "Gx", "Gu"), jc, pc):
        out["want"][name], out["got"][name] = np.asarray(w), g.numpy()
    for name, w, g in zip(("term_l", "term_lx", "term_lxx"),
                          jcf.terminal_derivs(jnp.asarray(xs[4]), refs),
                          pcf.terminal_derivs(t(xs[4]), prefs)):
        out["want"][name], out["got"][name] = np.asarray(w), g.numpy()
    out["n"] = (pcf.n_constraints, jcf.n_constraints)
    return out


@pytest.mark.parametrize("field", STAGE_FIELDS + (
    "g", "lb", "ub", "Gx", "Gu", "term_l", "term_lx", "term_lxx"))
def test_force_costs_and_box_match_jax(force_case, field):
    tol = ATOL if field in ("cost", "xnext", "g", "lb", "ub",
                            "term_l") else ATOL_D
    np.testing.assert_allclose(force_case["got"][field],
                               force_case["want"][field], rtol=0, atol=tol)
    assert force_case["n"][0] == force_case["n"][1]


def _yaml_tree(**diff):
    """A force-feedback YAML tree: the soft-contact differential with a
    state cost, IAM force bounds, a terminal state cost."""
    res = lambda: {"name": "state_reg", "weight": 0.1, "update": True,
                   "cost": {"class": "CostModelResidual", "residual": {
                       "class": "ResidualModelState"}}}
    return {
        "running_model": {
            "force_lb": [-30.0, -30.0, -30.0], "force_ub": [30.0, 30.0, 0.0],
            "differential": dict({
                "class": "DAMSoftContactAugmentedFwdDynamics",
                "frame_id": FRAME, "costs": [res()]}, **diff)},
        "terminal_model": {"differential": {"costs": [res()]}}}


@pytest.mark.parametrize("variant", ["defaults", "full"])
def test_yaml_soft_contact_block_matches_jax(panda, variant):
    """`DAMSoftContactAugmentedFwdDynamics`: Kp/Kv broadcast to 3, oPc,
    enabled directions, the reference frame, the gravity-torque item, the
    force bounds giving a force_box constraint, the terminal force item."""
    jm, _, _ = panda
    diff = {} if variant == "defaults" else dict(
        Kp=300.0, Kv=[15.0, 15.0, 25.0], oPc=[0.0, 0.0, 0.01],
        enabled_directions=[False, False, True], ref="LOCAL_WORLD_ALIGNED",
        with_gravity_torque_reg=True)
    tree = _yaml_tree(**diff)
    js = jax_load_yaml(tree, jm, horizon=6, dt=0.01)
    ps = load_ocp_spec(tree, jm, horizon=6, dt=0.01)
    assert dataclasses.asdict(ps.soft_contact) == dataclasses.asdict(
        js.soft_contact)
    for mine, ref in ((ps.running_costs, js.running_costs),
                      (ps.terminal_costs, js.terminal_costs),
                      (ps.constraints, js.constraints)):
        assert [dataclasses.asdict(i) for i in mine] == [
            dataclasses.asdict(i) for i in ref]
    assert ps.nc == js.nc


def _weighted_point(i, rng):
    pt = dict(id=i, time_ns=int(i * 1e7),
              robot_configuration=PANDA_Q_READY + rng.normal(size=7) * 0.1,
              robot_velocity=rng.normal(size=7), robot_acceleration=np.zeros(7),
              robot_effort=rng.normal(size=7),
              forces={FRAME: rng.normal(size=6)})
    w = dict(w_robot_configuration=np.full(7, 0.5),
             w_robot_velocity=np.ones(7), w_robot_effort=np.ones(7),
             w_forces={FRAME: (rng.uniform(0.5, 2.0, 6) if i % 3
                               else np.zeros(6))})
    return pt, w


@pytest.mark.parametrize("contact", ["nc3", "nc1"])
def test_ring_soft_fields_match_jax(panda, contact):
    """The row layout's f_des, w_force (masked to the enabled directions)
    and contact_active (1 where the force weight is nonzero): packed rows
    and the unpacked refs equal the JAX package's."""
    jm, _, _ = panda
    js = force_jax_spec(4, CONTACTS[contact])
    ps = port_spec(js, SoftContactConfig(**CONTACTS[contact]))
    jl, pl = JaxRowLayout(js, jm), RowLayout(ps, jm)
    assert [(f.key, f.offset, f.size) for f in pl.fields] == [
        (f.key, f.offset, f.size) for f in jl.fields]
    rng = np.random.default_rng(8)
    rows = []
    for i in range(5):
        pt, w = _weighted_point(i, rng)
        jrow = jl.pack_point(jbuffer.WeightedTrajectoryPoint(
            point=jbuffer.TrajectoryPoint(**pt),
            weights=jbuffer.TrajectoryPointWeights(**w)))
        prow = pl.pack_point(pbuffer.WeightedTrajectoryPoint(
            point=pbuffer.TrajectoryPoint(**pt),
            weights=pbuffer.TrajectoryPointWeights(**w)))
        np.testing.assert_array_equal(prow, np.asarray(jrow))
        rows.append(prow)
    rows = np.stack(rows)
    jrefs = jl.unpack_refs(jnp.asarray(rows), {})
    prefs = pl.unpack_refs(t(rows), {})
    for k in ("f_des", "w_force", "contact_active"):
        np.testing.assert_array_equal(prefs[k].numpy(), np.asarray(jrefs[k]))


def test_ff_warm_start_matches_jax(panda):
    """The force-feedback warm start (JAX `test_ff_warm_start`'s case):
    x0 appends the measured force masked to z, the states shift; the
    shifted previous solution equals the JAX warm start's, a coarse node
    re-integrated through the soft step."""
    jm, jp, p = panda
    T = 4
    ts = np.array([0.01, 0.01, 0.01, 0.02])
    jws, pws = JaxFFWarmStart(), WarmStartShiftPreviousSolutionForceFeedback()
    jws.setup(jm, jp, ts, jsc.SoftContactConfig(**SC1))
    pws.setup(jm, p, ts, SoftContactConfig(**SC1), device="cpu")
    xs = np.random.default_rng(0).normal(size=(T + 1, 15))
    xs[:, :7] += PANDA_Q_READY
    us = np.random.default_rng(1).normal(size=(T, 7))
    jws.update_previous_solution(JaxResults(
        states=xs.copy(), ricatti_gains=np.zeros((T, 7, 15)),
        feed_forward_terms=us.copy()))
    pws.update_previous_solution(OCPResults(
        states=xs.copy(), ricatti_gains=np.zeros((T, 7, 15)),
        feed_forward_terms=us.copy()))
    pt = dict(robot_configuration=PANDA_Q_READY, robot_velocity=np.zeros(7),
              forces={FRAME: np.asarray([0, 0, 0, 1.0, 2.0, 3.0])})
    jx0, jxi, jui = jws.generate(jbuffer.TrajectoryPoint(**pt),
                                 [None] * (T + 1))
    x0, x_init, u_init = pws.generate(pbuffer.TrajectoryPoint(**pt),
                                      [None] * (T + 1))
    assert x0.shape == (15,) and x0[14] == 3.0
    np.testing.assert_allclose(x_init[0], xs[1])
    np.testing.assert_array_equal(x0, np.asarray(jx0))
    np.testing.assert_allclose(np.stack(x_init), np.stack(jxi), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(np.stack(u_init), np.stack(jui), rtol=0,
                               atol=0)


def test_ocp_integrate_runs_the_soft_step(panda):
    """`OCPTorch.integrate` on a force-augmented spec is the soft step at
    node 0 (JAX `OCPJax._integrate0`)."""
    jm, jp, p = panda
    js = force_jax_spec(4)
    sc = SoftContactConfig(**SC3)
    ocp = OCPTorch(jm, p, port_spec(js, sc), OCPParams(
        dt=0.02, horizon_size=4), dtype=torch.float64, device="cpu")
    x, u = _state(3, 9)
    want = jsc.soft_contact_step(jm, jp, jsc.SoftContactConfig(**SC3),
                                 jnp.asarray(x), jnp.asarray(u), 0.02, 1.0)
    np.testing.assert_allclose(ocp.integrate(x, u), np.asarray(want),
                               rtol=0, atol=ATOL)
    assert ocp.solver.backend == "xla" and ocp.solver.kernels == ()


def test_gravity_compensated_rest_keeps_zero_force(panda):
    """At rest under gravity compensation with zero force the contact
    point does not move, so the force state stays 0 (port and JAX)."""
    jm, jp, p = panda
    q = PANDA_Q_READY
    x = np.concatenate([q, np.zeros(10)])
    u = np.asarray(jdyn.generalized_gravity(jm, jp, jnp.asarray(q)))
    got = soft_contact.soft_contact_step(jm, p, SoftContactConfig(**SC3),
                                         t(x), t(u), 0.01)
    np.testing.assert_allclose(got[14:].numpy(), np.zeros(3), atol=1e-9)
    np.testing.assert_allclose(got[:7].numpy(), q, atol=1e-9)
