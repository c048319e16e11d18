"""The port's `CostFunctions` vs the JAX package's, f64 on the CPU.

On the 2-DoF arm with a capsule on `l2` and a sphere on the base
(`_torch_csqp_cases.URDF_COLL`), T=6, one spec per activation
(weighted_quad, exp, quad_exp) with every cost kind JAX takes without soft
contact in the running model (streamed and static references and weights,
frame velocities in two conventions, visual servoing against a non-identity
object transform, the collision distance scaled by the streamed `w_coll`,
an inactive item) and five kinds in the terminal model; the refs carry a
moved obstacle (`geom_trans`). `test_torch_constraint_kinds.py` runs the
same checks on the constraint spec and the Panda (`make_case`).

Seven nodes at random states, controls and node times go through every
field of both: `step`, `stage_cost`, `terminal_cost`, `cost_breakdown`
(running and terminal), `cost_derivs`, `stage_derivs`, `terminal_derivs`,
`constraints`, `constraint_derivs` (the JAX functions vmapped over the
nodes, the port's called node by node), and the port's batched forms
(`step_b`, `stage_derivs_b`, `pack`, `value`, `term_pack`, `term_value`,
over per-node times and at one time). Values agree to atol 1e-10, derivative
blocks (lx ... luu, Fx, Fu, Gx, Gu) to atol 1e-9. Each spec is one JAX
compile of every field (~15 s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import PANDA_Q_READY
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.models.urdf import build_model_from_urdf as jax_build
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.costs import build_cost_functions as jax_build_cf
from agimus_controller_tpu.ops.spatial import exp3 as jexp3
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from tests._torch_csqp_cases import URDF_COLL, to_port_spec
from tests.test_ring_control_loop import Q0

T, N = 6, 7
ATOL = 1e-10  # values, residuals, x+
ATOL_D = 1e-9  # derivative blocks
CPU = dict(device="cpu")
C, K = jspec.CostItem, jspec.ConstraintItem


def running_items(act, alpha):
    """Every kind under `act`, streamed and static references/weights."""
    a = dict(activation=act, act_alpha=alpha)
    return (
        C(name="x", kind="state", weight=0.1, update=True, **a),
        C(name="x_static", kind="state", weight=0.3, static_ref=(0.3, -0.7,
          0.1, 0.0), act_weights=(1.0, 2.0, 0.5, 0.5), **a),
        C(name="u", kind="control", weight=1e-2, update=True, **a),
        C(name="grav", kind="control_grav", weight=1e-3,
          act_weights=(1.0, 2.0), **a),
        C(name="pose", kind="frame_placement", weight=10.0, update=True,
          frame="tip", **a),
        C(name="trans", kind="frame_translation", weight=3.0, update=True,
          frame="l2", **a),
        C(name="rot", kind="frame_rotation", weight=2.0, frame="tip",
          act_weights=(0.5,), **a),
        C(name="vel", kind="frame_velocity", weight=0.5, update=True,
          frame="tip", reference_frame="local", **a),
        C(name="vel_w", kind="frame_velocity", weight=0.7, frame="l2",
          reference_frame="world", act_weights=(1.0,) * 6, **a),
        C(name="vs", kind="visual_servoing", weight=4.0, update=True,
          frame="tip", object_frame="obj", **a),
        C(name="coll", kind="collision_distance", weight=2.0, update=True,
          pair_id=0, **a),
        C(name="off", kind="state", weight=9.0, active=False, **a),
    )


def terminal_items(act, alpha):
    a = dict(activation=act, act_alpha=alpha)
    return (
        C(name="x", kind="state", weight=0.2, update=True, **a),
        C(name="pose", kind="frame_placement", weight=50.0, update=True,
          frame="tip", **a),
        C(name="vel", kind="frame_velocity", weight=1.0, update=True,
          frame="tip", reference_frame="local_world_aligned", **a),
        C(name="vs", kind="visual_servoing", weight=5.0, update=True,
          frame="tip", object_frame="obj", **a),
        C(name="coll", kind="collision_distance", weight=3.0, pair_id=0, **a),
    )


CONSTRAINTS = (
    K(name="ubox", kind="control_limit", lower=(-9.0, -8.0),
      upper=(9.0, 8.0), terminal=False),
    K(name="xbox", kind="state", lower=(-1.0,) * 4, upper=(1.0,) * 4),
    K(name="ucon", kind="control", upper=(5.0, 5.0), terminal=False),
    K(name="grav", kind="control_grav", lower=(-3.0, -3.0),
      upper=(3.0, 3.0), terminal=False),
    K(name="vel", kind="frame_velocity", frame="tip",
      reference_frame="local", lower=(-0.2,) * 6, upper=(0.2,) * 6),
    K(name="vs", kind="visual_servoing", frame="tip", lower=(-0.1,) * 6,
      upper=(0.1,) * 6),
    K(name="band", kind="frame_translation", frame="l2",
      lower=(-0.05,) * 3, upper=(0.05,) * 3, terminal=False),
    K(name="coll", kind="collision_distance", pair_id=0, lower=(0.01,)),
)

# spec name -> (activation, alpha); "constraints" is CONSTRAINTS under a
# state and a control cost
ARM_SPECS = {"weighted_quad": ("weighted_quad", 1.0), "exp": ("exp", 0.5),
             "quad_exp": ("quad_exp", 0.3), "constraints": None}
# the running items of the weighted_quad spec only (static variants of kinds
# the other two specs already cover)
VARIANTS = ("x_static", "vel_w", "off")


def arm_spec(name):
    if name == "constraints":
        return jspec.ProblemSpec(
            running_costs=(C(name="x", kind="state", weight=0.1, update=True),
                           C(name="u", kind="control", weight=1e-2)),
            terminal_costs=(C(name="x", kind="state", weight=1.0,
                              update=True),),
            constraints=CONSTRAINTS, horizon=T, dt=2.0 ** -6)
    act, alpha = ARM_SPECS[name]
    running = running_items(act, alpha)
    if name != "weighted_quad":
        running = tuple(i for i in running if i.name not in VARIANTS)
    return jspec.ProblemSpec(
        running_costs=running, terminal_costs=terminal_items(act, alpha),
        horizon=T, dt=2.0 ** -6)


def panda_spec():
    """The flagship spec with quad_exp goal items (alpha 0.02): the
    declined spec of `chip_smoke.py` phase 5a at T=6."""
    g = dict(kind="frame_placement", update=True, frame="panda_hand_tcp",
             activation="quad_exp", act_alpha=0.02)
    return jspec.ProblemSpec(
        running_costs=(
            C(name="state_reg", kind="state", weight=0.1, update=True),
            C(name="control_reg", kind="control_grav", weight=1e-3),
            C(name="goal_tracking", weight=10.0, **g)),
        terminal_costs=(
            C(name="state_reg", kind="state", weight=0.1, update=True),
            C(name="goal_tracking", weight=100.0, **g)),
        horizon=T, dt=2.0 ** -6)


def random_refs(js, jm, jp, rng, nq):
    """The spec's refs with every entry drawn from rng (rotations from
    random rotation vectors), the object transforms and a moved obstacle."""
    rot = lambda *s: np.asarray(jexp3(jnp.asarray(rng.normal(size=s + (3,)))))
    refs = {k: np.array(v) for k, v in jspec.default_references(
        js, jm, dtype=jnp.float64).items()}
    if nq == 2:  # the frames the constraints read
        for f in ("tip", "l2"):
            refs.setdefault(f"ee_rot:{f}", 0.0)
            refs.setdefault(f"ee_trans:{f}", np.zeros((T + 1, 3)))
    for k, v in refs.items():
        if k.startswith("ee_rot:"):
            refs[k] = rot(T + 1)
        elif k.startswith("ee_trans:"):
            refs[k] = rng.normal(size=v.shape) * 0.2 + [0.1, 0.0, 0.5]
        elif k.startswith("wMo_rot"):
            refs[k] = rot()
        else:
            refs[k] = rng.uniform(0.2, 1.5, v.shape)
    refs["xref"] = np.concatenate(
        [np.tile(Q0 if nq == 2 else PANDA_Q_READY, (T + 1, 1)),
         np.zeros((T + 1, nq))], 1) + rng.normal(size=(T + 1, 2 * nq)) * 0.1
    if nq == 2:
        refs["wMo_rot:obj"], refs["wMo_trans:obj"] = rot(), rng.normal(size=3)
        # the constraint's visual servoing reads the object `None`
        refs["wMo_rot:None"], refs["wMo_trans:None"] = rot(), rng.normal(
            size=3) * 0.1
        refs["ee_vel:tip"] = rng.normal(size=(T + 1, 6)) * 0.1
        gt = np.array(jp.geom_trans)
        gt[jm.collision_pairs[0][1]] += [0.02, 0.0, -0.01]
        refs["geom_trans"] = gt
    return refs


def _jax_all(cf, nc):
    """Every field of the JAX `CostFunctions` at one node."""
    def fn(x, u, t, refs):
        out = dict(step=cf.step(x, u, t, refs),
                   stage_cost=cf.stage_cost(x, u, t, refs),
                   terminal_cost=cf.terminal_cost(x, refs),
                   stage_derivs=tuple(cf.stage_derivs(x, u, t, refs)),
                   terminal_derivs=tuple(cf.terminal_derivs(x, refs)),
                   breakdown=cf.cost_breakdown(x, u, t, refs),
                   breakdown_terminal=cf.cost_breakdown(
                       x, u, T, refs, terminal=True))
        if nc:
            out["constraints"] = cf.constraints(x, u, t, refs)
            out["constraint_derivs"] = cf.constraint_derivs(x, u, t, refs)
        return out
    return jax.jit(jax.vmap(fn, in_axes=(0, 0, 0, None)))


def _flat(v):
    """Leaves of a field's value as numpy arrays, in a fixed order."""
    if isinstance(v, dict):
        return [a for k in sorted(v) for a in _flat(v[k])]
    if isinstance(v, (tuple, list)):
        return [a for item in v for a in _flat(item)]
    return [np.asarray(v)]


def _case(jm, jp, js, nq, seed):
    rng = np.random.default_rng(seed)
    refs = random_refs(js, jm, jp, rng, nq)
    q0 = Q0 if nq == 2 else np.asarray(PANDA_Q_READY)
    x = np.concatenate([q0 + rng.normal(size=(N, nq)) * 0.3,
                        rng.normal(size=(N, nq)) * 0.5], 1)
    u = rng.normal(size=(N, nq)) * 2.0
    t = rng.integers(0, T, size=N)
    cf = jax_build_cf(jm, jp, js, dtype=jnp.float64)
    jw = _jax_all(cf, cf.n_constraints)(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(t),
        {k: jnp.asarray(v) for k, v in refs.items()})
    want = {k: _flat(v) for k, v in jw.items()}
    # the JAX stage_derivs' cost part is its cost_derivs
    want["cost_derivs"] = want["stage_derivs"][:6]

    p = params_from_numpy(jp, dtype=torch.float64, **CPU)
    ps = to_port_spec(js)
    pcf = build_cost_functions(jm, p, ps, dtype=torch.float64)
    tr = refs_from_numpy(refs, **CPU)
    tx, tu, tt = (torch.as_tensor(a) for a in (x, u, t))
    per_node = {
        "step": lambda i: pcf.step(tx[i], tu[i], int(t[i]), tr),
        "stage_cost": lambda i: pcf.stage_cost(tx[i], tu[i], int(t[i]), tr),
        "terminal_cost": lambda i: pcf.terminal_cost(tx[i], tr),
        "cost_derivs": lambda i: pcf.cost_derivs(tx[i], tu[i], int(t[i]), tr),
        "stage_derivs": lambda i: tuple(pcf.stage_derivs(tx[i], tu[i],
                                                         tt[i], tr)),
        "terminal_derivs": lambda i: tuple(pcf.terminal_derivs(tx[i], tr)),
        "breakdown": lambda i: pcf.cost_breakdown(tx[i], tu[i], int(t[i]),
                                                  tr),
        "breakdown_terminal": lambda i: pcf.cost_breakdown(
            tx[i], tu[i], T, tr, terminal=True),
    }
    if pcf.n_constraints:
        per_node["constraints"] = lambda i: pcf.constraints(
            tx[i], tu[i], int(t[i]), tr)
        per_node["constraint_derivs"] = lambda i: pcf.constraint_derivs(
            tx[i], tu[i], int(t[i]), tr)
    got = {}
    for name, fn in per_node.items():
        leaves = [_flat(fn(i)) for i in range(N)]
        got[name] = [np.stack([lv[j] for lv in leaves])
                     for j in range(len(leaves[0]))]
    # batched forms over per-node times; at one time, the form over
    # per-node times with that time everywhere
    t0 = int(t[0])
    sd = want["stage_derivs"]
    batched = {
        "step_b": (pcf.step_b(tx, tu, tt, tr), want["step"]),
        "stage_derivs_b": (tuple(pcf.stage_derivs_b(tx, tu, tt, tr)), sd),
        "pack": (pcf.pack(tx, tu, tt, tr), want["cost_derivs"]),
        "pack_one_time": (pcf.pack(tx, tu, t0, tr), _flat(pcf.pack(
            tx, tu, torch.full((N,), t0), tr))),
        "value": (pcf.value(tx, tu, tt, tr), want["stage_cost"]),
        "term_pack": (pcf.term_pack(tx, tr), want["terminal_derivs"]),
        "term_value": (pcf.term_value(tx, tr), want["terminal_cost"]),
    }
    for name, (g, w) in batched.items():
        got[name] = _flat(g)
        want[name] = w
    return want, got, cf, pcf


@pytest.fixture(scope="module")
def arm_model():
    jm, jp = jax_build(URDF_COLL, armature=np.array([0.1, 0.1]),
                       collision_pairs=[("l2_capsule", "obstacle")],
                       dtype=np.float64)
    return jm, jp


def make_case(name, arm_model):
    """(name, want, got, JAX cf, port cf) of one spec."""
    if name == "panda":
        jm, jp = jax_load_panda(dtype=np.float64)
        return (name,) + _case(jm, jp, panda_spec(), 7, seed=4)
    jm, jp = arm_model
    return (name,) + _case(jm, jp, arm_spec(name), 2,
                           seed=sorted(ARM_SPECS).index(name))


FIELDS = ("step", "stage_cost", "terminal_cost", "cost_derivs",
          "stage_derivs", "terminal_derivs", "breakdown",
          "breakdown_terminal", "constraints", "constraint_derivs", "step_b",
          "stage_derivs_b", "pack", "pack_one_time", "value", "term_pack",
          "term_value")
# fields whose leaves from the second on are derivative blocks
DERIVATIVE_FIELDS = ("cost_derivs", "stage_derivs", "terminal_derivs",
                     "constraint_derivs", "stage_derivs_b", "pack",
                     "pack_one_time", "term_pack")


def check_field(case, field):
    name, want, got, _, pcf = case
    if field.startswith("constraint") and not pcf.n_constraints:
        assert field not in got
        return
    assert len(got[field]) == len(want[field]), field
    for i, (g, w) in enumerate(zip(got[field], want[field])):
        assert g.shape == w.shape, (field, i, g.shape, w.shape)
        # constraint bounds may be infinite
        finite = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), finite)
        tol = ATOL_D if field in DERIVATIVE_FIELDS and i > 0 else ATOL
        np.testing.assert_allclose(g[finite], w[finite], rtol=0, atol=tol,
                                   err_msg=f"{name} {field} leaf {i}")


def check_metadata(case):
    name, _, _, cf, pcf = case
    assert pcf.n_constraints == cf.n_constraints, name
    assert pcf.terminal_constraint_mask == cf.terminal_constraint_mask
    assert pcf.terminal_constraint_row_mask == cf.terminal_constraint_row_mask
    assert pcf.ntan is None and cf.ntan is None


@pytest.fixture(scope="module", params=["weighted_quad", "exp", "quad_exp"])
def case(request, arm_model):
    return make_case(request.param, arm_model)


@pytest.mark.parametrize("field", FIELDS)
def test_cost_functions_match_jax(case, field):
    check_field(case, field)


def test_constraint_metadata_match_jax(case):
    check_metadata(case)


def test_soft_contact_is_refused(arm_model):
    jm, jp = arm_model
    p = params_from_numpy(jp, dtype=torch.float64, **CPU)
    ps = to_port_spec(arm_spec("weighted_quad"))
    bad = {
        "soft_contact": dataclasses.replace(ps, soft_contact=object()),
        "force_tracking": dataclasses.replace(ps, running_costs=(
            to_port_spec(jspec.ProblemSpec(
                running_costs=(C(name="f", kind="force_tracking"),),
                terminal_costs=())).running_costs)),
        "force_box": to_port_spec(dataclasses.replace(
            arm_spec("weighted_quad"),
            constraints=(K(name="fb", kind="force_box"),))),
    }
    for what, spec in bad.items():
        with pytest.raises(NotImplementedError, match="slice 12"):
            build_cost_functions(jm, p, spec)
