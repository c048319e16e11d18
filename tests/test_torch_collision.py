"""The port's collision path below the solver vs the JAX package, f64.

Activations, the SO(3)/SE(3) maps and kinematics the residuals call, the
capsule distances, the component-form capsule distance and geometry
placement, the residuals constraints reach, and the constraint side of the
OCP assembly (values, bounds and Jacobians at every node, the terminal row
mask and refs row T) on the Panda with the obstacle sphere of
`test_robot_models.py`. Inputs are made with numpy from fixed seeds.
Tolerances: atol 1e-10 for values, 1e-9 for the constraint rows and their
Jacobians (the JAX side takes `jacfwd`, the port `jacrev`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import PANDA_Q_READY
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.costs import build_cost_functions
from agimus_controller_tpu.ocp.yaml_compiler import load_ocp_spec as jax_load_ocp_spec
from agimus_controller_tpu.ops import activations as jact
from agimus_controller_tpu.ops import batched_costs as jbc
from agimus_controller_tpu.ops import batched_dynamics as jbd
from agimus_controller_tpu.ops import collision as jcol
from agimus_controller_tpu.ops import kinematics as jkin
from agimus_controller_tpu.ops import residuals as jres
from agimus_controller_tpu.ops import spatial as jsp
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.ocp import spec as tspec
from agimus_controller_tpu_torch.ocp.costs import build_constraint_functions
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.ops import activations, collision, kinematics
from agimus_controller_tpu_torch.ops import batched_costs, residuals, spatial
from agimus_controller_tpu_torch.ops.batched_dynamics import _StaticModel
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp
from tests._torch_csqp_cases import YAML, to_port_spec
from tests.test_robot_models import ENV_URDF

PAIR = [("panda_link7_capsule", "obstacle_sphere")]
T = 4
N = 12
t = torch.as_tensor


@pytest.fixture(scope="module")
def panda():
    jm, jp = jax_load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                            dtype=np.float64)
    return jm, jp, params_from_numpy(jp, dtype=torch.float64, device="cpu")


def _qs(n, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return np.asarray(PANDA_Q_READY)[None] + rng.normal(size=(n, 7)) * scale


def _rotations(n, seed):
    rng = np.random.default_rng(seed)
    return np.array(jax.vmap(jsp.exp3)(jnp.asarray(
        rng.normal(size=(n, 3)) * 1.2)))


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["weighted_quad", "exp", "quad_exp"])
@pytest.mark.parametrize("part", ["value", "dr", "drr"])
def test_activation_matches_jax(name, part):
    rng = np.random.default_rng(1)
    r = rng.normal(size=(16, 3)) * 0.02
    w = rng.uniform(0.1, 2.0, (16, 3))
    fn_name = f"{name}_{part}"
    args = () if name == "weighted_quad" else (1e-3,)
    want = getattr(jact, fn_name)(jnp.asarray(r), jnp.asarray(w), *args)
    got = getattr(activations, fn_name)(t(r), t(w), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# SO(3)/SE(3) maps and kinematics
# ---------------------------------------------------------------------------

def test_spatial_maps_match_jax():
    rng = np.random.default_rng(2)
    w = np.concatenate([rng.normal(size=(8, 3)), rng.normal(size=(2, 3)) * 1e-5])
    R = _rotations(10, 3)
    p = rng.normal(size=(10, 3))
    pairs = [
        (spatial.hat(t(w)), jsp.hat(jnp.asarray(w))),
        (spatial.exp3(t(w)), jsp.exp3(jnp.asarray(w))),
        (spatial.matrix_to_quat(t(R)), jsp.matrix_to_quat(jnp.asarray(R))),
        (spatial.log3(t(R)), jsp.log3(jnp.asarray(R))),
        (spatial.log6(t(R), t(p)), jsp.log6(jnp.asarray(R), jnp.asarray(p))),
    ]
    pairs += [(a, b) for a, b in zip(
        spatial.se3_mul((t(R), t(p)), (t(R[::-1].copy()), t(p[::-1].copy()))),
        jsp.se3_mul((jnp.asarray(R), jnp.asarray(p)),
                    (jnp.asarray(R[::-1]), jnp.asarray(p[::-1]))))]
    pairs += [(a, b) for a, b in zip(spatial.se3_inv((t(R), t(p))),
                                     jsp.se3_inv((jnp.asarray(R),
                                                  jnp.asarray(p))))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("frame", ["panda_hand_tcp", "panda_link7", "panda_link0"])
def test_kinematics_match_jax(panda, frame):
    jm, jp, p = panda
    for q in _qs(4, 4):
        for got, want in zip(kinematics.joint_placements(jm, p, t(q)),
                             jkin.joint_placements(jm, jp, jnp.asarray(q))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-10)
        fid = jm.frame_id(frame)
        for got, want in zip(kinematics.frame_placement(jm, p, t(q), fid),
                             jkin.frame_placement(jm, jp, jnp.asarray(q), fid)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# capsule distances
# ---------------------------------------------------------------------------

def test_capsule_capsule_distance_matches_jax():
    rng = np.random.default_rng(5)
    R1, R2 = _rotations(64, 6), _rotations(64, 7)
    p1, p2 = rng.normal(size=(64, 3)) * 0.2, rng.normal(size=(64, 3)) * 0.2
    r1, r2 = rng.uniform(0.01, 0.1, 64), rng.uniform(0.01, 0.1, 64)
    l1 = rng.uniform(0.0, 0.2, 64)
    l2 = np.where(np.arange(64) % 3 == 0, 0.0, rng.uniform(0.0, 0.2, 64))
    # a parallel pair exercises the degenerate-denominator branch
    R2[0] = R1[0]
    args = (R1, p1, r1, l1, R2, p2, r2, l2)
    want = jcol.capsule_capsule_distance(*map(jnp.asarray, args))
    got = collision.capsule_capsule_distance(*map(t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)
    d1, d2 = R1[..., :, 2], R2[..., :, 2]
    for g, w in zip(collision._segment_closest_params(*map(t, (p1, d1, l1, p2, d2, l2))),
                    jcol._segment_closest_params(*map(jnp.asarray, (p1, d1, l1, p2, d2, l2)))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)


def test_pair_distances_match_jax(panda):
    jm, jp, p = panda
    for q in _qs(8, 8):
        for got, want in zip(collision.geometry_placements(jm, p, t(q)),
                             jcol.geometry_placements(jm, jp, jnp.asarray(q))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-10)
        np.testing.assert_allclose(
            collision.pair_distance(jm, p, t(q), 0).numpy(),
            np.asarray(jcol.pair_distance(jm, jp, jnp.asarray(q), 0)),
            rtol=0, atol=1e-10)
        np.testing.assert_allclose(
            collision.all_pair_distances(jm, p, t(q)).numpy(),
            np.asarray(jcol.all_pair_distances(jm, jp, jnp.asarray(q))),
            rtol=0, atol=1e-10)


@pytest.mark.parametrize("override", [False, True])
def test_component_capsule_distance_matches_jax(panda, override):
    """`batched_costs._geom_placement_c` + `_capsule_distance_c` over a batch
    of configurations, with and without a streamed obstacle placement."""
    jm, jp, p = panda
    qs = _qs(N, 9)
    refs = {}
    if override:
        gt = np.array(jp.geom_trans)
        gt[jm.collision_pairs[0][1]] += [-0.05, 0.02, 0.03]
        refs = {"geom_rot": np.array(jp.geom_rot), "geom_trans": gt}
    sm, jsm = _StaticModel(jm, p), jbd._StaticModel(jm, jp)
    oR, op = batched_costs._fk_world(sm, list(t(qs).unbind(1)))
    joR, jop = jbc._fk_world(jsm, [jnp.asarray(qs[:, i]) for i in range(7)])
    gi, gj = jm.collision_pairs[0]
    prefs = refs_from_numpy(refs, device="cpu")
    jrefs = {k: jnp.asarray(v) for k, v in refs.items()}
    poses = [batched_costs._geom_placement_c(jm, p, oR, op, g, prefs)
             for g in (gi, gj)]
    jposes = [jbc._geom_placement_c(jm, jp, joR, jop, g, jrefs) for g in (gi, gj)]
    for (R, pp), (jR, jpp) in zip(poses, jposes):
        for a, b in zip(R + pp, jR + jpp):
            np.testing.assert_allclose(np.broadcast_to(np.asarray(a, float), (N,)),
                                       np.broadcast_to(np.asarray(b), (N,)),
                                       rtol=0, atol=1e-10)
    radius = lambda g: float(jp.geom_radius[g])
    half = lambda g: float(jp.geom_halflen[g])
    got = batched_costs._capsule_distance_c(
        *poses[0], radius(gi), half(gi), *poses[1], radius(gj), half(gj))
    want = jbc._capsule_distance_c(
        *jposes[0], radius(gi), half(gi), *jposes[1], radius(gj), half(gj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------

def test_residuals_match_jax(panda):
    jm, jp, p = panda
    fid = jm.frame_id("panda_hand_tcp")
    rng = np.random.default_rng(10)
    R = _rotations(1, 11)[0]
    pref = rng.normal(size=3) * 0.3
    for q in _qs(4, 12):
        x = np.concatenate([q, rng.normal(size=7)])
        jx, px = jnp.asarray(x), t(x)
        pairs = [
            (residuals.frame_translation_residual(jm, p, px, fid, t(pref)),
             jres.frame_translation_residual(jm, jp, jx, fid, jnp.asarray(pref))),
            (residuals.frame_rotation_residual(jm, p, px, fid, t(R)),
             jres.frame_rotation_residual(jm, jp, jx, fid, jnp.asarray(R))),
            (residuals.frame_placement_residual(jm, p, px, fid, t(R), t(pref)),
             jres.frame_placement_residual(jm, jp, jx, fid, jnp.asarray(R),
                                           jnp.asarray(pref))),
            (residuals.collision_distance_residual(jm, p, px, 0),
             jres.collision_distance_residual(jm, jp, jx, 0)),
            (residuals.state_residual(jm, px, px * 0.5),
             jres.state_residual(jm, jx, jx * 0.5)),
            (residuals.control_residual(px[:7], px[7:]),
             jres.control_residual(jx[:7], jx[7:])),
        ]
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=1e-10)


# ---------------------------------------------------------------------------
# the constraint side of the OCP assembly
# ---------------------------------------------------------------------------

def _box_band_spec():
    """A control_limit box kept off the terminal node and a frame-translation
    band on the hand, which reads per-node refs."""
    return jspec.ProblemSpec(
        running_costs=(jspec.CostItem(name="x", kind="state", weight=0.1,
                                      update=True),),
        terminal_costs=(),
        constraints=(
            jspec.ConstraintItem(name="ubox", kind="control_limit",
                                 terminal=False),
            jspec.ConstraintItem(name="band", kind="frame_translation",
                                 frame="panda_hand_tcp", lower=(-0.02,) * 3,
                                 upper=(0.03,) * 3),
        ),
        horizon=T, dt=0.01)


def _yaml_spec(jm):
    return jax_load_ocp_spec(YAML, jm, horizon=T, dt=0.01,
                             default_ee_frame="panda_hand_tcp")


@pytest.fixture(scope="module", params=["yaml", "box_band"])
def constraint_case(request, panda):
    """JAX and port constraint data at every node of a [T+1, B] trajectory,
    stacked as the batch solvers stack them (terminal: refs row T, u = 0,
    terminal-flagged rows only)."""
    jm, jp, p = panda
    js = _yaml_spec(jm) if request.param == "yaml" else _box_band_spec()
    cf = build_cost_functions(jm, jp, js, dtype=jnp.float64)
    B = 3
    rng = np.random.default_rng(13)
    xs = np.concatenate([_qs((T + 1) * B, 14, 0.2),
                         rng.normal(size=((T + 1) * B, 7))], 1).reshape(
                             T + 1, B, 14)
    us = rng.normal(size=(T, B, 7)) * 40.0  # some outside the effort box
    refs = {k: np.array(v) for k, v in jspec.default_references(
        js, jm, dtype=jnp.float64).items()}
    refs["ee_trans:panda_hand_tcp"] = (rng.normal(size=(T + 1, 3)) * 0.05
                                       + np.asarray([0.3, 0.0, 0.5]))
    gt = np.array(jp.geom_trans)
    gt[jm.collision_pairs[0][1]] = [0.42, 0.0, 0.55]
    refs["geom_trans"] = gt
    jrefs = {k: jnp.asarray(v) for k, v in refs.items()}

    cd = jax.jit(jax.vmap(jax.vmap(cf.constraint_derivs, (0, 0, None, None)),
                          (0, 0, 0, None)))
    g, lb, ub, Gx, Gu = (np.asarray(a) for a in cd(
        jnp.asarray(xs[:-1]), jnp.asarray(us), jnp.arange(T), jrefs))
    gT, lbT, ubT, GxT, _ = (np.asarray(a) for a in jax.vmap(
        cf.constraint_derivs, (0, 0, None, None))(
            jnp.asarray(xs[-1]), jnp.zeros((B, 7)), T, jrefs))
    rmask = np.asarray(cf.terminal_constraint_row_mask)
    want = dict(
        g=np.concatenate([g, gT[None]]),
        lb=np.concatenate([lb, np.where(rmask, lbT, -np.inf)[None]]),
        ub=np.concatenate([ub, np.where(rmask, ubT, np.inf)[None]]),
        Gx=np.concatenate([Gx, GxT[None]]),
        Gu=np.concatenate([Gu, np.zeros_like(Gu[:1])]))
    ps = to_port_spec(js)
    solver = make_batch_sqp(jm, p, ps, CSQPSettings(), device="cpu")
    got = dict(zip(("g", "lb", "ub", "Gx", "Gu"), (a.numpy() for a in solver.constraints_of(
        t(xs), t(us), refs_from_numpy(refs, device="cpu")))))
    vals = dict(zip(("g", "lb", "ub"), (a.numpy() for a in solver.constraint_vals(
        t(xs), t(us), refs_from_numpy(refs, device="cpu")))))
    pcf = build_constraint_functions(jm, p, ps)
    return dict(want=want, got=got, vals=vals, cf=cf, pcf=pcf)


@pytest.mark.parametrize("field", ["g", "lb", "ub", "Gx", "Gu"])
def test_constraint_derivs_match_jax(constraint_case, field):
    np.testing.assert_allclose(constraint_case["got"][field],
                               constraint_case["want"][field], rtol=0,
                               atol=1e-9, err_msg=field)


@pytest.mark.parametrize("field", ["g", "lb", "ub"])
def test_constraint_values_match_jax(constraint_case, field):
    np.testing.assert_allclose(constraint_case["vals"][field],
                               constraint_case["want"][field], rtol=0,
                               atol=1e-9, err_msg=field)


def test_constraint_counts_match_jax(constraint_case):
    cf, pcf = constraint_case["cf"], constraint_case["pcf"]
    assert pcf.n_constraints == cf.n_constraints
    assert pcf.terminal_constraint_row_mask == cf.terminal_constraint_row_mask
    # the case covers violated rows, so the comparison sees the bounds act
    w = constraint_case["want"]
    assert np.any((w["g"] < w["lb"]) | (w["g"] > w["ub"]))


def test_unported_constraint_kind_raises(panda):
    jm, _, p = panda
    spec = dataclasses.replace(to_port_spec(_box_band_spec()), constraints=(
        tspec.ConstraintItem(name="f", kind="force_box"),))
    with pytest.raises(NotImplementedError, match="force_box.*slice 12"):
        build_constraint_functions(jm, p, spec)
