"""Port's stage/terminal wrappers K1-K4 (plain versions, CPU) vs the JAX
package's Pallas kernel bodies, in f64.

The JAX reference is assembled from the Pallas bodies exactly as the Pallas
kernels' own CPU tests do (`_item_terms_c` + `dynamics_terms` on component
arrays, per-node refs from `gather_node_refs`), on the flagship goal-tracking
spec, on the Pallas test spec without and with its collision item
(quad_exp, alpha 1e-2, `update=True`; plus the pair under the exp activation
in the terminal model), on the shipped collision-avoidance YAML
(quad_exp, alpha 1e-4), on `chip_smoke.py`'s visual-servoing OCP (`vs`:
the visual-servoing pose term and static-weight frame-velocity damping) and
on its `fv` spec (visual servoing plus one frame-velocity item per
convention). The collision specs get a randomized `w_coll` and a
`geom_trans` override that puts the obstacle sphere 1 cm from the link-7
capsule at the ready pose, so the collision term is live; the `vs` and `fv`
specs get a non-identity object transform, randomized pose and velocity
references and weights, and joint velocities of scale 0.5. Tolerances in
f64: x+ and l atol 1e-10; every derivative block atol 1e-8, rtol 1e-8.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from agimus_controller_tpu.models.panda import PANDA_Q_READY
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.yaml_compiler import load_ocp_spec as jax_load_ocp_spec
from agimus_controller_tpu.ops import collision as jcollision
from agimus_controller_tpu.ops import pallas_costs as jpc
from agimus_controller_tpu.ops.batched_dynamics import _StaticModel as JaxStaticModel
from agimus_controller_tpu.ops.pallas_dynamics import dynamics_terms as jax_dynamics_terms
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.ocp import spec as tspec
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.ops import cuda_costs
from tests.test_pallas_kernels import _spec as pallas_test_spec
from tests.test_robot_models import ENV_URDF

T = 4
N = 16
PAIR = [("panda_link7_capsule", "obstacle_sphere")]
STAGE_OUT = ("xnext", "Fx", "Fu", "l", "lx", "lu", "lxx", "lxu", "luu")
TERM_OUT = ("l", "lx", "lxx")


def flagship_jax_spec():
    C = jspec.CostItem
    return jspec.ProblemSpec(
        running_costs=(
            C(name="state_reg", kind="state", weight=0.1, update=True),
            C(name="control_reg", kind="control_grav", weight=1e-3),
            C(name="goal_tracking", kind="frame_placement", weight=10.0,
              update=True, frame="panda_hand_tcp"),
        ),
        terminal_costs=(
            C(name="state_reg", kind="state", weight=0.1, update=True),
            C(name="goal_tracking", kind="frame_placement", weight=100.0,
              update=True, frame="panda_hand_tcp"),
        ),
        horizon=T, dt=0.01)


def mixed_jax_spec():
    s = pallas_test_spec(None, T)
    return dataclasses.replace(s, running_costs=tuple(
        i for i in s.running_costs if i.kind != "collision_distance"))


def to_port_spec(s):
    items = lambda seq: tuple(tspec.CostItem(**dataclasses.asdict(i)) for i in seq)
    return tspec.ProblemSpec(
        running_costs=items(s.running_costs),
        terminal_costs=items(s.terminal_costs), horizon=s.horizon, dt=s.dt,
        dt_factor_n_seq=s.dt_factor_n_seq)


YAML_DIR = (Path(__file__).resolve().parent.parent / "agimus_controller_tpu"
            / "ocp" / "definitions")


def full_jax_spec():
    """The Pallas kernels' test spec with its collision item, plus the same
    pair under the exp activation in the terminal model (`chip_smoke.py`'s
    `full_spec`)."""
    s = pallas_test_spec(None, T)
    return dataclasses.replace(s, terminal_costs=s.terminal_costs + (
        jspec.CostItem(name="coll", kind="collision_distance", weight=3.0,
                       update=True, pair_id=0, activation="exp",
                       act_alpha=2e-2),))


def yaml_jax_spec(model):
    return jax_load_ocp_spec(
        YAML_DIR / "ocp_traj_tracking_collision_avoidance.yaml", model,
        horizon=T, dt=0.01, default_ee_frame="panda_hand_tcp")


def to_jax_spec(s):
    items = lambda seq: tuple(jspec.CostItem(**dataclasses.asdict(i)) for i in seq)
    return jspec.ProblemSpec(
        running_costs=items(s.running_costs),
        terminal_costs=items(s.terminal_costs), horizon=s.horizon, dt=s.dt,
        dt_factor_n_seq=s.dt_factor_n_seq)


SPECS = {"flagship": lambda jm: flagship_jax_spec(),
         "mixed": lambda jm: mixed_jax_spec(),
         "full": lambda jm: full_jax_spec(), "yaml": yaml_jax_spec,
         "vs": lambda jm: jax_load_ocp_spec(
             chip_smoke.VS_OCP, jm, horizon=T, dt=0.01,
             default_ee_frame="panda_hand_tcp"),
         "fv": lambda jm: to_jax_spec(chip_smoke.fv_spec(T))}


def _jax_eval(jm, jp, spec, items, refs, x, u, t_idx, dts, running):
    """The Pallas kernel body on (1, N) component arrays, f64."""
    sm = JaxStaticModel(jm, jp)
    nx = 14
    layout = jpc._ref_layout(spec, jm, items)
    offsets, _ = jpc._slice_layout(layout)
    rows = jpc.gather_node_refs(
        layout, jpc._with_geom_defaults(layout, refs, jp, jnp.float64),
        jnp.asarray(t_idx), N, jnp.float64)

    def rget(key, default="raise"):
        off, ncomp = offsets[key]
        return [rows[off + i][None] for i in range(ncomp)]

    q = [jnp.asarray(x[:, i][None]) for i in range(7)]
    v = [jnp.asarray(x[:, 7 + i][None]) for i in range(7)]
    uc = ([jnp.asarray(u[:, i][None]) for i in range(7)] if running
          else [jnp.zeros((1, N))] * 7)
    acc = {"l": 0.0, "lx": [None] * nx, "lu": [None] * 7,
           "lxx": [None] * nx * nx, "lxu": [None] * nx * 7, "lu_": None,
           "luu": [None] * 49}
    for item in items:
        wgt = float(item.weight)
        if item.kind == "collision_distance" and item.update:
            wgt = wgt * rget("w_coll")[0]  # as the kernel bodies, :482-483
        jpc._item_terms_c(item, jm, jp, sm, q, v, uc, rget, True, wgt, acc)
    ones = jnp.ones((1, N))
    dense = lambda comps, shape: np.stack(
        [np.asarray((0.0 if c is None else c) * ones)[0] for c in comps],
        1).reshape((N,) + shape)
    scale = dts if running else np.ones(N)
    sc = lambda a: a * scale.reshape((N,) + (1,) * (a.ndim - 1))
    out = {"l": sc(np.asarray(acc["l"] * ones)[0]),
           "lx": sc(dense(acc["lx"], (nx,))),
           "lxx": sc(dense(acc["lxx"], (nx, nx)))}
    if running:
        xn, fx, fu = jax_dynamics_terms(sm, q, v, uc, jnp.asarray(dts[None]),
                                        True)
        out.update(xnext=dense(xn, (nx,)), Fx=dense(fx, (nx, nx)),
                   Fu=dense(fu, (nx, 7)), lu=sc(dense(acc["lu"], (7,))),
                   lxu=sc(dense(acc["lxu"], (nx, 7))),
                   luu=sc(dense(acc["luu"], (7, 7))))
    return out, np.asarray(rows).T


@pytest.fixture(scope="module")
def panda():
    jm, jp = jax_load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                            dtype=np.float64)
    return jm, jp, params_from_numpy(jp, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module", params=sorted(SPECS))
def case(request, panda):
    jm, jp, p = panda
    js = SPECS[request.param](jm)
    ps = to_port_spec(js)
    rng = np.random.default_rng(7)
    Tn = T + 1
    refs = {k: np.asarray(v) for k, v in
            jspec.default_references(js, jm, dtype=jnp.float64).items()}
    refs["xref"] = rng.normal(size=(Tn, 14)) * 0.2
    refs["w_x"] = rng.uniform(0.1, 2.0, (Tn, 14))
    if "uref" in refs:
        refs["uref"] = rng.normal(size=(Tn, 7))
        refs["w_u"] = rng.uniform(0.1, 2.0, (Tn, 7))
    refs["ee_trans:panda_hand_tcp"] = (rng.normal(size=(Tn, 3)) * 0.3
                                       + np.asarray([0.4, 0.0, 0.4]))
    collides = "w_coll" in refs
    if collides:
        refs["w_coll"] = rng.uniform(0.5, 1.5, (Tn,))
        # the obstacle sphere 1 cm from the link-7 capsule at the ready pose
        refs["geom_trans"] = chip_smoke.obstacle_near_link7(jm, p).numpy()
    x = (np.concatenate([np.tile(PANDA_Q_READY, (N, 1)), np.zeros((N, 7))], 1)
         + rng.normal(size=(N, 14)) * (0.02 if collides else 0.1))
    u = rng.normal(size=(N, 7)) * 2.0
    t_idx = rng.integers(0, T, size=(N,))
    dts = np.asarray(js.timesteps())[t_idx]
    moving = chip_smoke.moving_refs(js, rng, Tn)
    if moving:
        refs.update(moving)
        x[:, 7:] = rng.normal(size=(N, 7)) * 0.5
    jrefs = {k: jnp.asarray(v) for k, v in refs.items()}
    stage_ref, jrows = _jax_eval(jm, jp, js, js.running_costs, jrefs, x, u,
                                 t_idx, dts, True)
    term_ref, _ = _jax_eval(jm, jp, js, js.terminal_costs, jrefs, x, u,
                            np.full(N, T), dts, False)

    trefs = refs_from_numpy(refs, device="cpu")
    tt = lambda a: torch.as_tensor(a)
    args = (tt(x), tt(u), tt(dts), tt(t_idx), trefs)
    cpu = dict(device="cpu")
    stage = dict(zip(STAGE_OUT, cuda_costs.make_cuda_stage(jm, p, ps, True,
                                                           **cpu)(*args)))
    stage_v = dict(zip(("xnext", "l"), cuda_costs.make_cuda_stage(
        jm, p, ps, False, **cpu)(*args)))
    term = dict(zip(TERM_OUT, cuda_costs.make_cuda_terminal(
        jm, p, ps, True, **cpu)(tt(x), trefs)))
    (term_v,) = cuda_costs.make_cuda_terminal(jm, p, ps, False, **cpu)(
        tt(x), trefs)
    layout = cuda_costs._ref_layout(jm, tuple(ps.running_costs))
    rows = cuda_costs.gather_node_refs(
        layout, cuda_costs.with_geom_defaults(layout, trefs, p), tt(t_idx),
        torch.float64)
    if collides:
        moved = jp._replace(geom_trans=jnp.asarray(refs["geom_trans"]))
        d = np.asarray([jcollision.pair_distance(
            jm, moved, jnp.asarray(xi[:7]), 0) for xi in x])
        assert np.mean((d > -0.01) & (d < 0.03)) > 0.5, d
    return dict(stage_ref=stage_ref, term_ref=term_ref, stage=stage,
                stage_v=stage_v, term=term, term_v=term_v, rows=rows.numpy(),
                jrows=jrows, args=args, kernels=lambda derivs: (
                    cuda_costs.make_cuda_stage(jm, p, ps, derivs, **cpu)))


def _tol(name):
    return (1e-10, 0.0) if name in ("xnext", "l") else (1e-8, 1e-8)


@pytest.mark.parametrize("out", STAGE_OUT)
def test_stage_derivs_k1(case, out):
    atol, rtol = _tol(out)
    np.testing.assert_allclose(case["stage"][out].numpy(), case["stage_ref"][out],
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("out", ("xnext", "l"))
def test_stage_value_k2(case, out):
    np.testing.assert_allclose(case["stage_v"][out].numpy(),
                               case["stage_ref"][out], atol=1e-10, rtol=0)


@pytest.mark.parametrize("out", TERM_OUT)
def test_terminal_derivs_k3(case, out):
    atol, rtol = _tol(out)
    np.testing.assert_allclose(case["term"][out].numpy(), case["term_ref"][out],
                               atol=atol, rtol=rtol)


def test_terminal_value_k4(case):
    np.testing.assert_allclose(case["term_v"].numpy(), case["term_ref"]["l"],
                               atol=1e-10, rtol=0)


@pytest.mark.parametrize("dt_form", ["float", "0-d"])
def test_stage_scalar_dt(case, dt_form):
    """One dt for every node (each spec's steps are uniform), as a Python
    float or a 0-d tensor, broadcast as the Pallas kernels broadcast it:
    K1/K2 give the outputs of the [N] dt, held against the Pallas body."""
    x, u, dts, t_idx, trefs = case["args"]
    assert bool((dts == dts[0]).all())
    dt = float(dts[0]) if dt_form == "float" else dts[0].clone()
    for derivs, outs in ((True, STAGE_OUT), (False, ("xnext", "l"))):
        got = case["kernels"](derivs)(x, u, dt, t_idx, trefs)
        for out, g in zip(outs, got):
            atol, rtol = _tol(out)
            np.testing.assert_allclose(g.numpy(), case["stage_ref"][out],
                                       atol=atol, rtol=rtol)


def test_gathered_rows_match_jax(case):
    np.testing.assert_array_equal(case["rows"], case["jrows"])


def test_uncovered_kind_raises_on_cuda(panda):
    """A spec the kernels do not cover raises before anything is allocated
    on the device; there is no quiet fallback."""
    jm, _, p = panda
    full = to_port_spec(pallas_test_spec(None, T))
    soft = dataclasses.replace(full, soft_contact=object())
    cuda = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="soft contact"):
        cuda_costs.make_cuda_stage(jm, p, soft, True, device=cuda)
    with pytest.raises(NotImplementedError, match="soft contact"):
        cuda_costs.make_cuda_terminal(jm, p, soft, False, device=cuda)
    exp = to_port_spec(flagship_jax_spec())
    exp = dataclasses.replace(exp, running_costs=exp.running_costs[:1] + (
        tspec.CostItem(name="g", kind="frame_placement", activation="exp",
                       frame="panda_hand_tcp"),))
    with pytest.raises(NotImplementedError, match="exp"):
        cuda_costs.make_cuda_stage(jm, p, exp, False, device=cuda)
