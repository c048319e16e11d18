"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from `agimus_controller_tpu_torch/csrc/`:
the stage kernels K1-K4 and the dynamics-step kernels K5a/K5b. Holds K1-K4
against their plain-PyTorch versions on the card on six specs (the
flagship goal tracking, the Pallas kernels' test spec with its collision
item, the shipped collision-avoidance YAML, the visual-servoing OCP
`VS_OCP`, a visual-servoing + frame-velocity spec, and `cap_spec`, with
more ref keys than the kernels' by-value table holds) with every term live,
K1/K2 at N = 19, 100 and 102 400 (`cap_spec` up to 100), also with one dt
for every node (a float, a 0-d tensor), K1-K4 also on the tick's ring-row
views of the refs, and K5a/K5b at the batch path's shapes with per-node and
scalar dt; times each call and its bare launch and computes its bound.
Then drives the port's four main paths, every entry point on the card, the
first three through `FusedTickRunner`:

- the flagship chain: Panda, T=100, f32, unconstrained, checked to converge
  onto the streamed goal;
- the collision path: Panda, T=19, f32, the shipped collision-avoidance OCP
  (quad_exp collision cost and a hard 1 cm distance constraint, solved by
  the batch SQP's ADMM branch) with a streamed goal that pulls link 7 onto
  the band, checked to converge with the band held and active;
- the visual-servoing path: Panda, T=19, f32, `VS_OCP` fed by a
  `GenericVisualServoingTrajectory` over a quintic move, with the object
  detected 2 cm from where the references were re-expressed, checked to
  converge with the planned end effector on the detected target;
- the batch path: `make_batch_fddp` at the JAX bench's batch width, Panda,
  T=100, B=4096, f32, 10 iterations, the flagship spec with a goal 12 cm
  from the ready pose and x0 perturbed per scenario, solved on three x0
  variants (solves/s), after a B=8 solve of the first variant's rows 0-7
  that the B=4096 solve must reproduce.

The tick paths must have launched every stage kernel, the batch path both
step kernels and no stage kernel. Exits non-zero without a result when
there is no CUDA device or any phase fails. The line before the last is
the card's name and power limit, the one before it a JSON object with the
kernels' launches, errors, times and bounds; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# comparison tolerances, kernel vs plain (f32): those of
# tests/test_pallas_kernels.py for the Pallas kernels vs the XLA paths
TOL = {"xnext": (2e-5, 0.0), "Fx": (2e-4, 0.0), "Fu": (2e-5, 0.0),
       "l": (1e-6, 2e-4), "lx": (2e-4, 1e-3), "lu": (2e-5, 1e-3),
       "lxx": (5e-4, 1e-3), "lxu": (2e-5, 1e-3), "luu": (2e-5, 1e-3)}
STAGE_OUT = ("xnext", "Fx", "Fu", "l", "lx", "lu", "lxx", "lxu", "luu")
KERNELS = (  # (name, factory, derivs, Pallas site it replaces)
    ("K1_stage_derivs", "stage", True,
     "agimus_controller_tpu/ops/pallas_costs.py:564"),
    ("K2_stage_value", "stage", False,
     "agimus_controller_tpu/ops/pallas_costs.py:564"),
    ("K3_terminal_derivs", "terminal", True,
     "agimus_controller_tpu/ops/pallas_costs.py:676"),
    ("K4_terminal_value", "terminal", False,
     "agimus_controller_tpu/ops/pallas_costs.py:676"),
    ("K5a_step", "step", False,
     "agimus_controller_tpu/ops/pallas_dynamics.py:208"),
    ("K5b_step_derivs", "step", True,
     "agimus_controller_tpu/ops/pallas_dynamics.py:208"),
)
STAGE_KERNELS = tuple(k for k in KERNELS if k[1] != "step")  # K1-K4
STEP_KERNELS = tuple(k for k in KERNELS if k[1] == "step")  # K5a, K5b
SOURCES = {"stage": "agimus_controller_tpu_torch/csrc/stage_kernels.cu",
           "terminal": "agimus_controller_tpu_torch/csrc/terminal_kernels.cu",
           "step": "agimus_controller_tpu_torch/csrc/step_kernels.cu"}
# the batch path's shapes of the step kernels: K5a steps the B = 4096
# scenarios of a rollout, K5b linearises all T x B = 409 600 nodes
STEP_SIZES = {"K5a_step": 4096, "K5b_step_derivs": 409_600}
# published H100 SXM peaks: device memory rate and fp32 outside the tensor
# cores (the kernels' arithmetic)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PAIR = [("panda_link7_capsule", "obstacle_sphere")]
ENV_URDF = """<?xml version="1.0"?>
<robot name="env">
  <link name="obstacle_base"/>
  <joint name="obstacle_joint" type="fixed">
    <parent link="obstacle_base"/><child link="obstacle"/>
    <origin xyz="0.5 0.0 0.5" rpy="0 0 0"/>
  </joint>
  <link name="obstacle">
    <collision name="obstacle_sphere">
      <geometry><sphere radius="0.1"/></geometry>
    </collision>
  </link>
</robot>
"""



def _cost(name, residual, activation, update=True, weight=1.0):
    return {"name": name, "update": update, "weight": weight,
            "cost": {"class": "CostModelResidual", "activation": activation,
                     "residual": residual}}


_QUAD = {"class": "ActivationModelWeightedQuad", "weights": 1.0}
_DISTANCE = _cost("distance", {"class": "ResidualDistanceCollision",
                               "collision_pair_id": 0},
                  {"class": "ActivationModelQuadExp", "alpha": "1e-4"},
                  update=False)
_GOAL = _cost("goal_tracking", {"class": "ResidualModelFramePlacement", "id": 0},
              _QUAD)
_STATE = _cost("state_reg", {"class": "ResidualModelState"}, _QUAD)
_DAM = "DifferentialActionModelFreeFwdDynamics"
# The tree of `agimus_controller_tpu/ocp/definitions/
# ocp_traj_tracking_collision_avoidance.yaml` as `yaml.safe_load` gives it
# (so "1e-4" and "inf" stay strings); the card's machine has no PyYAML.
COLLISION_OCP = {
    "running_model": {
        "class": "IntegratedActionModelEuler",
        "differential": {
            "class": _DAM,
            "costs": [
                _cost("control_reg", {"class": "ResidualModelControl"}, _QUAD),
                _STATE, _GOAL, _DISTANCE],
            "constraints": [{"name": "collision", "constraint": {
                "class": "ConstraintModelResidual", "lower": 0.01,
                "upper": "inf", "residual": {
                    "class": "ResidualDistanceCollision",
                    "collision_pair_id": 0}}}]}},
    "terminal_model": {
        "class": "IntegratedActionModelEuler",
        "differential": {"class": _DAM, "costs": [_STATE, _GOAL, _DISTANCE]}},
}


_VS = _cost("visual_servoing", {"class": "ResidualModelVisualServoing",
                               "robot_frame": "panda_hand_tcp",
                               "object_frame": "object"}, _QUAD)


def _ee_velocity(reference_frame):
    """End-effector velocity damping with static weights: the dynamic-id
    frame velocity residual, bound to the end effector."""
    return _cost("ee_velocity", {"class": "ResidualModelFrameVelocity", "id": 0,
                                 "reference_frame": reference_frame},
                 {"class": "ActivationModelWeightedQuad",
                  "weights": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]},
                 update=False, weight=0.1)


# A visual-servoing controller in the reference's YAML format (no shipped
# definition has these residuals): the streamed state and control
# references, the visual-servoing pose term on the hand, whose target is the
# streamed object-frame pose composed with the detected object transform
# `wMo_*:object`, and an end-effector velocity damping.
VS_OCP = {
    "running_model": {
        "class": "IntegratedActionModelEuler",
        "differential": {
            "class": _DAM,
            "costs": [_STATE,
                      _cost("control_reg", {"class": "ResidualModelControl"},
                            _QUAD),
                      _VS, _ee_velocity("LOCAL_WORLD_ALIGNED")]}},
    "terminal_model": {
        "class": "IntegratedActionModelEuler",
        "differential": {"class": _DAM,
                         "costs": [_STATE, _VS, _ee_velocity("LOCAL")]}},
}
VEL_FRAMES = ("world", "local", "local_world_aligned")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _port():
    """Import the port from this checkout (never from elsewhere)."""
    sys.path.insert(0, str(ROOT))
    import agimus_controller_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent.parent != ROOT:
        raise RuntimeError(f"port imported from {pkg.__file__}, not {ROOT}")
    return pkg


def flagship_spec(T: int):
    """The flagship goal-tracking OCP of the runtime bench."""
    from agimus_controller_tpu_torch.ocp.spec import CostItem, ProblemSpec

    return ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="control_reg", kind="control_grav", weight=1e-3),
            CostItem(name="goal_tracking", kind="frame_placement", weight=10.0,
                     update=True, frame="panda_hand_tcp"),
        ),
        terminal_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="goal_tracking", kind="frame_placement",
                     weight=100.0, update=True, frame="panda_hand_tcp"),
        ),
        horizon=T, dt=0.01)


def mixed_spec(T: int):
    """The Pallas kernels' test spec without its collision item."""
    from agimus_controller_tpu_torch.ocp.spec import CostItem, ProblemSpec

    return ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="ctrl", kind="control", weight=1e-2, update=True),
            CostItem(name="grav", kind="control_grav", weight=1e-3,
                     act_weights=(1.0,) * 7),
            CostItem(name="goal", kind="frame_placement", weight=10.0,
                     update=True, frame="panda_hand_tcp"),
        ),
        terminal_costs=(
            CostItem(name="state_reg", kind="state", weight=0.2, update=True),
            CostItem(name="goal", kind="frame_placement", weight=50.0,
                     update=True, frame="panda_hand_tcp"),
        ),
        horizon=T, dt=0.02)


def full_spec(T: int):
    """The Pallas kernels' test spec with its collision item (quad_exp,
    alpha 1e-2, scaled by the streamed `w_coll`), plus the same pair under
    the exp activation in the terminal model, so both activations run."""
    import dataclasses

    from agimus_controller_tpu_torch.ocp.spec import CostItem

    s = mixed_spec(T)
    coll = dict(kind="collision_distance", update=True, pair_id=0)
    return dataclasses.replace(
        s, running_costs=s.running_costs + (CostItem(
            name="coll", weight=2.0, activation="quad_exp", act_alpha=1e-2,
            **coll),),
        terminal_costs=s.terminal_costs + (CostItem(
            name="coll", weight=3.0, activation="exp", act_alpha=2e-2,
            **coll),))


def yaml_spec(T: int, model, dt: float = 0.01):
    """The shipped collision-avoidance OCP, compiled by the port."""
    from agimus_controller_tpu_torch.ocp.yaml_compiler import load_ocp_spec

    return load_ocp_spec(COLLISION_OCP, model, horizon=T, dt=dt,
                         default_ee_frame="panda_hand_tcp")


def vs_spec(T: int, model, dt: float = 0.01):
    """The visual-servoing OCP `VS_OCP`, compiled by the port."""
    from agimus_controller_tpu_torch.ocp.yaml_compiler import load_ocp_spec

    return load_ocp_spec(VS_OCP, model, horizon=T, dt=dt,
                         default_ee_frame="panda_hand_tcp")


def fv_spec(T: int):
    """A visual-servoing item and three frame-velocity items on the hand,
    one per convention, streamed weights, in the running and the terminal
    model (the JAX cost-pack tests' frame-velocity spec)."""
    from agimus_controller_tpu_torch.ocp.spec import CostItem, ProblemSpec

    hand = dict(update=True, frame="panda_hand_tcp")

    def items(w_vs, w_vel):
        return (CostItem(name="vs", kind="visual_servoing", weight=w_vs,
                         object_frame="object", **hand),) + tuple(
            CostItem(name=f"vel_{rf}", kind="frame_velocity", weight=w_vel,
                     reference_frame=rf, **hand) for rf in VEL_FRAMES)

    return ProblemSpec(running_costs=items(3.0, 1.0),
                       terminal_costs=items(9.0, 4.0), horizon=T, dt=0.01)


# the Panda links a pose item can track (each with a parent joint)
LINK_FRAMES = tuple(f"panda_link{i}" for i in range(2, 9))


def cap_spec(T: int):
    """More ref keys than the kernels' by-value table holds (`MAX_REFS` =
    24): streamed state and control items and an updated frame_placement
    on each of `LINK_FRAMES`, 25 running keys; the terminal model tracks
    the hand too, 26 keys."""
    from agimus_controller_tpu_torch.ocp.spec import CostItem, ProblemSpec

    poses = lambda frames, w: tuple(
        CostItem(name=f"pose_{f}", kind="frame_placement", weight=w,
                 update=True, frame=f) for f in frames)
    state = CostItem(name="state_reg", kind="state", weight=0.1, update=True)
    return ProblemSpec(
        running_costs=(state, CostItem(name="ctrl", kind="control",
                                       weight=1e-2, update=True))
        + poses(LINK_FRAMES, 1.0),
        terminal_costs=(state,) + poses(LINK_FRAMES + ("panda_hand_tcp",),
                                        10.0),
        horizon=T, dt=0.01)


SPECS = {"flagship": lambda T, model: flagship_spec(T),
         "mixed": lambda T, model: mixed_spec(T),
         "full": lambda T, model: full_spec(T), "yaml": yaml_spec,
         "vs": vs_spec, "fv": lambda T, model: fv_spec(T),
         "cap25": lambda T, model: cap_spec(T)}
CHECKED_SPECS = ("flagship", "full", "yaml", "vs", "fv", "cap25")  # phase 3


def moving_refs(spec, rng, Tn):
    """Numpy refs that make the visual-servoing and frame-velocity terms
    live, for a spec that has them (else {}): a non-identity object
    transform `wMo`, randomized pose weights, frame velocity references and
    their weights. The caller also draws v with scale 0.5."""
    from agimus_controller_tpu_torch.ops.spatial import exp3

    kinds = {i.kind for i in spec.all_costs()}
    out = {}
    if "visual_servoing" in kinds:
        out["wMo_rot:object"] = exp3(torch.as_tensor(
            rng.normal(size=3) * 0.5)).numpy()
        out["wMo_trans:object"] = rng.normal(size=3) * 0.2
        out["w_ee:panda_hand_tcp"] = rng.uniform(0.1, 2.0, (Tn, 6))
    if "frame_velocity" in kinds:
        out["ee_vel:panda_hand_tcp"] = rng.normal(size=(Tn, 6)) * 0.3
        out["w_ee_vel:panda_hand_tcp"] = rng.uniform(0.1, 2.0, (Tn, 6))
    return out


def _collision_items(spec):
    return [i for i in spec.all_costs() if i.kind == "collision_distance"]


def obstacle_near_link7(model, params64, gap=0.01):
    """`geom_trans` [ng, 3] (f64, CPU) with the obstacle sphere `gap` from the
    link-7 capsule at the ready pose, beside the capsule's mid point."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY
    from agimus_controller_tpu_torch.ops.collision import geometry_placements

    gi, gj = model.collision_pairs[0]
    gR, gp = geometry_placements(model, params64, torch.as_tensor(
        PANDA_Q_READY, dtype=torch.float64))
    axis = gR[gi][:, 2].numpy()
    side = np.cross(axis, [0.0, 0.0, 1.0])
    side /= np.linalg.norm(side)
    gt = params64.geom_trans.clone()
    gt[gj] = torch.as_tensor(gp[gi].numpy() + side * (
        float(params64.geom_radius[gi]) + float(params64.geom_radius[gj]) + gap))
    return gt


def randomized_inputs(spec, model, N, seed, device):
    """Refs randomized as the Pallas kernels' tests do; x near the ready
    pose, u ~ 2 N(0, 1); node times uniform over the horizon. With a
    collision item the obstacle sphere is streamed (`geom_trans`) 1 cm from
    the link-7 capsule at the ready pose, `w_coll` is randomized and x stays
    within ~0.02 rad of the ready pose, so the collision term is live. With
    visual-servoing or frame-velocity items, `moving_refs` and v ~ 0.5
    N(0, 1) make those terms live; `cap_spec`'s link poses get random
    targets and weights."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.ocp.spec import default_references

    rng = np.random.default_rng(seed)
    T = spec.horizon
    Tn = T + 1
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device)
    refs = default_references(spec, model, dtype=torch.float32, device=device)
    refs["xref"] = f(rng.normal(size=(Tn, 14)) * 0.2)
    refs["w_x"] = f(rng.uniform(0.1, 2.0, (Tn, 14)))
    refs["uref"] = f(rng.normal(size=(Tn, 7)))
    refs["w_u"] = f(rng.uniform(0.1, 2.0, (Tn, 7)))
    refs["ee_trans:panda_hand_tcp"] = f(
        rng.normal(size=(Tn, 3)) * 0.3 + np.asarray([0.4, 0.0, 0.4]))
    noise = 0.1
    if _collision_items(spec):
        refs["w_coll"] = f(rng.uniform(0.5, 1.5, (Tn,)))
        _, params64 = load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                                 dtype=torch.float64, device="cpu")
        refs["geom_trans"] = f(obstacle_near_link7(model, params64))
        noise = 0.02
    x = f(np.concatenate([np.tile(PANDA_Q_READY, (N, 1)), np.zeros((N, 7))], 1)
          + rng.normal(size=(N, 14)) * noise)
    u = f(rng.normal(size=(N, 7)) * 2.0)
    t_idx = torch.as_tensor(rng.integers(0, T, size=(N,)), device=device)
    dt = f(spec.timesteps())[t_idx]
    moving = moving_refs(spec, rng, Tn)
    if moving:
        refs.update({k: f(v) for k, v in moving.items()})
        x[:, 7:] = f(rng.normal(size=(N, 7)) * 0.5)
    for frame in LINK_FRAMES:  # `cap_spec`'s pose items
        if f"w_ee:{frame}" in refs:
            refs[f"ee_trans:{frame}"] = f(rng.normal(size=(Tn, 3)) * 0.3)
            refs[f"w_ee:{frame}"] = f(rng.uniform(0.1, 2.0, (Tn, 6)))
    return refs, x, u, dt, t_idx


def tick_views(spec, model, refs):
    """`refs` as the tick hands them to the kernels: views into one packed
    [T+1, width] ring-rows tensor (`RowLayout.unpack_refs`, row stride = the
    width) holding the same values; the global keys pass through."""
    from agimus_controller_tpu_torch.mpc.ring import RowLayout

    layout = RowLayout(spec, model)
    Tn = spec.horizon + 1
    rows = torch.zeros((Tn, layout.width), dtype=torch.float32,
                       device=next(iter(refs.values())).device)
    for f in layout.fields:
        if f.key in refs:
            rows[:, f.offset:f.offset + f.size] = refs[f.key].reshape(Tn, f.size)
    return layout.unpack_refs(rows, refs)


def live_share(spec, model, refs, x):
    """Share of the nodes where some collision item's activation exceeds
    1e-3 (f64, CPU): a comparison where it underflows proves nothing."""
    from agimus_controller_tpu_torch.models.panda import load_panda
    from agimus_controller_tpu_torch.ops.collision import pair_distance

    _, params64 = load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                             dtype=torch.float64, device="cpu")
    params64 = params64._replace(geom_trans=refs["geom_trans"].double().cpu())
    d = torch.func.vmap(lambda q: pair_distance(model, params64, q, 0))(
        x[:, :7].double().cpu())
    live = torch.zeros_like(d, dtype=torch.bool)
    for item in _collision_items(spec):
        a = (torch.exp(-d * d / item.act_alpha) if item.activation == "quad_exp"
             else torch.exp(-d.abs() / item.act_alpha))
        live |= a > 1e-3
    return float(live.double().mean())


def cuda_timed_call(fn):
    """(fn()'s result, its time in ms), one call timed by CUDA events."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median time of one call over `reps` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    return float(np.median([cuda_timed_call(fn)[1] for _ in range(reps)]))


def check_outputs(name, got, want, labels):
    """Max abs error of each output; raises when one exceeds its tolerance."""
    errs = {}
    for lab, g, w in zip(labels, got, want):
        atol, rtol = TOL[lab]
        err = (g - w).abs()
        bad = err > atol + rtol * w.abs()
        errs[lab] = float(err.max())
        if not torch.isfinite(g).all() or bool(bad.any()):
            raise AssertionError(
                f"{name}: {lab} disagrees with its plain version: max abs err "
                f"{errs[lab]:.3e} (atol {atol}, rtol {rtol}), "
                f"{int(bad.sum())} entries out of tolerance")
    return errs


def count_ops(fn) -> int:
    """Element operations of `fn()`: every pointwise ATen op it runs,
    counted once per element of its output (a TorchDispatchMode)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.Tag.pointwise in func.tags:
                outs = out if isinstance(out, (tuple, list)) else (out,)
                self.n += sum(o.numel() for o in outs
                              if isinstance(o, torch.Tensor))
            return out

    with Count() as c:
        fn()
    return c.n


def ops_per_node(model_cpu, params_cpu, spec, kind, derivs, refs, x, u, dt,
                 t_idx) -> int:
    """Operations of one wrapper call per node: `count_ops` of the plain
    version on the run's first node, on the CPU (the count does not depend
    on the device). The plain version repeats the kernel's arithmetic in
    component form; its derivatives take closed forms and one `jvp` per
    tangent where the kernel runs one dual-number pass per tangent."""
    from agimus_controller_tpu_torch.ops.cuda_costs import (
        make_cuda_stage,
        make_cuda_terminal,
    )

    cpu = lambda t: t[:1].cpu()
    if kind == "step":
        from agimus_controller_tpu_torch.ops.cuda_dynamics import StepKernel

        k = StepKernel(model_cpu, params_cpu, derivs, "cpu")
        return count_ops(lambda: k.plain(cpu(x), cpu(u), cpu(dt)))
    refs = {k: v.cpu() for k, v in refs.items()}
    if kind == "stage":
        k = make_cuda_stage(model_cpu, params_cpu, spec, derivs, "cpu")
        return count_ops(lambda: k.plain(cpu(x), cpu(u), cpu(dt), cpu(t_idx),
                                         refs))
    k = make_cuda_terminal(model_cpu, params_cpu, spec, derivs, "cpu")
    return count_ops(lambda: k.plain(cpu(x), refs))


def bound_ms(k, kind, n_nodes, ops_node):
    """Least time of one call on the card: the larger of the bytes the
    kernel must move (x, u, dt, the gathered ref rows and the packed
    constants read once; every output written once) over the memory rate
    and its operations over the fp32 rate. Returns (ms, "bytes" or
    "operations")."""
    nx, nj = 2 * k.nj, k.nj
    if kind == "step":
        per_node_in = nx + nj + 1
        per_node_out = nx + (nx * nx + nx * nj if k.derivs else 0)
    elif kind == "stage":
        per_node_in = nx + k.width + nj + 1
        per_node_out = (nx + 1 + nx * nx + nx * nj + nx + nj + nx * nx
                        + nx * nj + nj * nj) if k.derivs else nx + 1
    else:
        per_node_in = nx + k.width
        per_node_out = 1 + nx + nx * nx if k.derivs else 1
    n_bytes = 4 * (n_nodes * (per_node_in + per_node_out)
                   + k._consts.numel())
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_nodes * ops_node / PEAK_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernels(model, params, device, sizes=(19, 100, 102_400)):
    """K1-K4 vs their plain versions on the same CUDA inputs, f32, on the
    checked specs (`cap25` at N = 100 only), with each call's time,
    kernel-only time (CUDA events around the bare launch, inputs, source
    table and outputs prepared) and bound; at a spec's first size also on
    the tick's ring-row views of the same refs and, for K1/K2, with one dt
    for every node (a float and a 0-d tensor). The terminal kernels take
    N // 100 nodes (at least 1) and skip N < 100. Returns {kernel: {spec:
    {N: numbers}}}."""
    from agimus_controller_tpu_torch.models.panda import load_panda
    from agimus_controller_tpu_torch.ops.cuda_costs import (
        make_cuda_stage,
        make_cuda_terminal,
    )

    model_cpu, params_cpu = load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                                       dtype=torch.float32, device="cpu")
    report = {}
    for spec_name in CHECKED_SPECS:
        spec = SPECS[spec_name](100, model)
        for name, kind, derivs, _ in STAGE_KERNELS:
            if kind == "stage":
                k = make_cuda_stage(model, params, spec, derivs, device)
                labels = STAGE_OUT if derivs else ("xnext", "l")
            else:
                k = make_cuda_terminal(model, params, spec, derivs, device)
                labels = ("l", "lx", "lxx") if derivs else ("l",)
            ops_node = None
            # cap25's plain version is the slowest: its K1/K2 run at the
            # flagship tick's N = 100 alone
            spec_sizes = [N for N in sizes if (N >= 100 or kind == "stage")
                          and (N == 100 or spec_name != "cap25")]
            for N in spec_sizes:
                # the tick gives the terminal kernels one node per scenario
                n_nodes = N if kind == "stage" else max(1, N // 100)
                refs, x, u, dt, t_idx = randomized_inputs(
                    spec, model, n_nodes, seed=N + derivs, device=device)
                args = (x, u, dt, t_idx, refs) if kind == "stage" else (x, refs)
                run = lambda: k(*args)
                plain = lambda: k.plain(*args)
                got = run()
                torch.cuda.synchronize()
                # the plain versions take up to seconds a call: the check's
                # call is the one timed
                want, plain_ms = cuda_timed_call(plain)
                errs = check_outputs(f"{name} {spec_name} N={n_nodes}", got,
                                     want, labels)
                views = ""
                if N == spec_sizes[0]:
                    got_v = k(*args[:-1], tick_views(spec, model, refs))
                    torch.cuda.synchronize()
                    for lab, e in check_outputs(
                            f"{name} {spec_name} N={n_nodes} tick views",
                            got_v, want, labels).items():
                        errs[lab] = max(errs[lab], e)
                    same = all(torch.equal(a, b) for a, b in zip(got, got_v))
                    views = f"  tick views {'equal' if same else 'differ'}"
                if kind == "stage" and N == spec_sizes[0]:
                    views += check_scalar_dt(k, name, spec_name, args, labels,
                                             errs)
                ms = cuda_time_ms(run, reps=50)
                prepared, _ = k.prepare(*args)
                kernel_ms = cuda_time_ms(lambda: k.launch(prepared), reps=50)
                if ops_node is None:
                    ops_node = ops_per_node(model_cpu, params_cpu, spec, kind,
                                            derivs, refs, x, u, dt, t_idx)
                b_ms, b_by = bound_ms(k, kind, n_nodes, ops_node)
                live = (f"  collision term live on "
                        f"{live_share(spec, model, refs, x):.0%} of nodes"
                        if "geom_trans" in refs else "")
                print(f"{name:20s} {spec_name:8s} N={n_nodes:6d}  wrapper "
                      f"{ms:9.4f} ms (kernel only {kernel_ms:9.4f} ms)  plain "
                      f"{plain_ms:9.3f} ms  bound "
                      f"{b_ms:.6f} ms ({b_by}, {ops_node} ops/node)  max abs "
                      "err " + " ".join(f"{lab}={e:.2e}"
                                        for lab, e in errs.items())
                      + views + live)
                report.setdefault(name, {}).setdefault(spec_name, {})[
                    n_nodes] = dict(ms=ms, kernel_only_ms=kernel_ms,
                                    plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by,
                                    max_abs_err=max(errs.values()))
    return report


def check_scalar_dt(k, name, spec_name, args, labels, errs):
    """K1/K2 with the first node's dt for every node, as a Python float and
    as a 0-d tensor: each equal bit for bit to the [N] form, which is held
    against the plain version (one plain call; a form that differs is held
    against the plain version itself). The errors go into errs; returns the
    line's note."""
    x, u, dt, t_idx, refs = args
    h = float(dt[0])
    per_node = torch.full_like(dt, h)
    got_n = k(x, u, per_node, t_idx, refs)
    checks = [("[N]", got_n, h)]
    for form, d in (("float", h), ("0-d", dt[0].clone())):
        got = k(x, u, d, t_idx, refs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, got_n)):
            checks.append((form, got, d))
    for form, got, d in checks:
        for lab, e in check_outputs(f"{name} {spec_name} {form} dt", got,
                                    k.plain(x, u, d, t_idx, refs),
                                    labels).items():
            errs[lab] = max(errs[lab], e)
    return f"  scalar dt {'equal' if len(checks) == 1 else 'differs'} to [N]"


def step_inputs(N, seed, device, dt_kind):
    """Random Panda nodes around the ready pose with v and u live:
    q ~ ready + 0.1 N(0, 1), v ~ 0.5 N(0, 1), u ~ 2 N(0, 1); dt per node
    uniform in [0.005, 0.03], or the scalar 0.01."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY

    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    x = f(np.concatenate([np.asarray(PANDA_Q_READY)[None]
                          + rng.normal(size=(N, 7)) * 0.1,
                          rng.normal(size=(N, 7)) * 0.5], 1))
    u = f(rng.normal(size=(N, 7)) * 2.0)
    dt = f(rng.uniform(0.005, 0.03, N)) if dt_kind == "per_node" else 0.01
    return x, u, dt


def check_step_kernels(model, params, device):
    """K5a and K5b vs their plain versions on the same CUDA inputs, f32, at
    the batch path's two sizes, with per-node and scalar dt; each call's
    time and kernel-only time (per-node dt) and bound. Returns {kernel:
    {N: numbers}}."""
    from agimus_controller_tpu_torch.models.panda import load_panda
    from agimus_controller_tpu_torch.ops.cuda_dynamics import StepKernel

    model_cpu, params_cpu = load_panda(dtype=torch.float32, device="cpu")
    report = {}
    for name, kind, derivs, _ in STEP_KERNELS:
        k = StepKernel(model, params, derivs, device)
        labels = ("xnext", "Fx", "Fu") if derivs else ("xnext",)
        for N in sorted(STEP_SIZES.values()):
            errs = {}
            for dt_kind in ("scalar", "per_node"):
                x, u, dt = step_inputs(N, N + derivs, device, dt_kind)
                run = lambda: k(x, u, dt)
                plain = lambda: k.plain(x, u, dt)
                as_tuple = lambda o: o if derivs else (o,)
                got = as_tuple(run())
                torch.cuda.synchronize()
                for lab, e in check_outputs(
                        f"{name} N={N} {dt_kind} dt", got, as_tuple(plain()),
                        labels).items():
                    errs[lab] = max(errs.get(lab, 0.0), e)
            reps = 50 if N <= 4096 else 20
            ms = cuda_time_ms(run, reps=reps)
            prepared, _ = k.prepare(x, u, dt)
            kernel_ms = cuda_time_ms(lambda: k.launch(prepared), reps=reps)
            plain_ms = cuda_time_ms(plain, reps=1, warmup=0)
            ops_node = ops_per_node(model_cpu, params_cpu, None, kind, derivs,
                                    None, x, u, dt, None)
            b_ms, b_by = bound_ms(k, kind, N, ops_node)
            print(f"{name:20s} {'':8s} N={N:6d}  wrapper {ms:9.4f} ms (kernel "
                  f"only {kernel_ms:9.4f} ms)  plain {plain_ms:9.3f} ms  bound "
                  f"{b_ms:.6f} ms ({b_by}, "
                  f"{ops_node} ops/node)  max abs err "
                  + " ".join(f"{lab}={e:.2e}" for lab, e in errs.items()))
            report.setdefault(name, {})[N] = dict(
                ms=ms, kernel_only_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=max(errs.values()))
    return report


def build_slice(device, n_ticks: int = 80):
    """The runtime bench scenario through the port: a PackedTrajectoryBuffer
    streaming a fixed end-effector goal and a FusedTickRunner over it, Panda,
    T=100, f32, plus the drifting measured states of the chain. Returns a
    namespace (runner, x0, xs_init, us_init, x0_seq, goal, ee_pose)."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryPoint,
        TrajectoryPointWeights,
        WeightedTrajectoryPoint,
    )
    from agimus_controller_tpu_torch.mpc.ring import PackedTrajectoryBuffer, RowLayout
    from agimus_controller_tpu_torch.mpc.tick import FusedTickRunner
    from agimus_controller_tpu_torch.ocp.spec import default_references
    from agimus_controller_tpu_torch.ops.batched_costs import _fk_world, _frame_pose_c
    from agimus_controller_tpu_torch.ops.batched_dynamics import _StaticModel, _rnea_c
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings

    T, dtype = 100, torch.float32
    model, params = load_panda(dtype=dtype, device=device)
    spec = flagship_spec(T)
    refs = default_references(spec, model, dtype=dtype, device=device)
    q0 = np.asarray(PANDA_Q_READY)
    x0 = np.concatenate([q0, np.zeros(7)])
    refs["xref"] = torch.as_tensor(np.tile(x0[None], (T + 1, 1)), dtype=dtype,
                                   device=device)
    fid = model.frame_id("panda_hand_tcp")

    # host-side set-up numbers (f64, CPU): EE pose at q0 and gravity torque
    _, params64 = load_panda(dtype=torch.float64, device="cpu")
    sm64 = _StaticModel(model, params64)

    def ee_pose(q):
        ql = [torch.as_tensor(q[i:i + 1], dtype=torch.float64) for i in range(7)]
        oR, op = _fk_world(sm64, ql)
        R, p = _frame_pose_c(model, params64, oR, op, fid)
        return (np.array([float(c) for c in R]).reshape(3, 3),
                np.array([float(c) for c in p]))

    R0, p0 = ee_pose(q0)
    z = [torch.zeros(1, dtype=torch.float64)] * 7
    tau_g = np.array([float(t) for t in _rnea_c(
        sm64, [torch.as_tensor(q0[i:i + 1]) for i in range(7)], z, z)])
    goal = p0 + np.asarray([0.05, -0.05, 0.08])

    def mk(i):
        pt = TrajectoryPoint(
            id=i, time_ns=int(i * 1e7), robot_configuration=q0,
            robot_velocity=np.zeros(7), robot_acceleration=np.zeros(7),
            robot_effort=tau_g,
            end_effector_poses={"panda_hand_tcp": (R0, goal)})
        w = TrajectoryPointWeights(
            w_robot_configuration=np.full(7, 0.1),
            w_robot_velocity=np.full(7, 1.0),
            w_robot_effort=np.ones(7),
            w_end_effector_poses={"panda_hand_tcp": np.ones(6)})
        return WeightedTrajectoryPoint(point=pt, weights=w)

    layout = RowLayout(spec, model)
    buf = PackedTrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[T]),
                                 layout, dtype=dtype, device=device)
    for i in range(3 * T + n_ticks + 40):
        buf.append(mk(i))
    runner = FusedTickRunner(
        model, params, spec, buf.ring, refs,
        CSQPSettings(max_iters=10, reg_init=1e-7, termination_tolerance=1e-4),
        dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    n_total = n_ticks + 40
    drift = rng.normal(size=(n_total, 7)) * 0.002
    x0_seq = torch.as_tensor(np.concatenate(
        [q0[None] + drift, np.zeros((n_total, 7))], axis=1), dtype=dtype,
        device=device)
    return SimpleNamespace(
        runner=runner, x0=x0, xs_init=np.tile(x0[None], (T + 1, 1)),
        us_init=np.tile(tau_g[None], (T, 1)), x0_seq=x0_seq, goal=goal,
        ee_pose=ee_pose)


def run_slice(device):
    """Drive the main path: the first solve at limit 300, 80 ticks at
    limit 2 with a drifting x0 (20 settling, 3 timed chunks of 20), one
    final tick at limit 10. Returns (launches per kernel during the run,
    summary line)."""
    sl = build_slice(device)
    runner, x0_seq = sl.runner, sl.x0_seq
    solver = runner.solver
    names = [k[0] for k in STAGE_KERNELS]

    for k in solver.kernels:
        k.launches = 0
    t0 = time.perf_counter()
    runner.initialize(sl.x0, sl.xs_init, sl.us_init, limit=300)
    _, _, kkt0, it0, conv0 = runner.fetch()
    first_s = time.perf_counter() - t0
    after_init = [k.launches for k in solver.kernels]

    def run_chunk(k0, k):
        t0 = time.perf_counter()
        for i in range(k0, k0 + k):
            runner.step(x0_seq[i], limit=2)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / k

    run_chunk(0, 20)  # settle into the warm-started regime
    syncs0 = solver.host_syncs
    per_tick = [run_chunk(20 + 20 * j, 20) for j in range(3)]
    syncs_per_tick = (solver.host_syncs - syncs0) / 60
    tick_ms = float(np.median(per_tick)) * 1e3
    # final tick with the full iteration budget: the budget-capped chain
    # must have kept the loop converged
    runner.step(x0_seq[0], limit=10)
    K0, u0, kkt, iters, conv = runner.fetch()
    launches = dict(zip(names, (k.launches for k in solver.kernels)))
    for name, a, b in zip(names, after_init, launches.values()):
        if b <= a:
            raise AssertionError(f"{name} was not launched during the ticks")
    if not (np.all(np.isfinite(u0)) and np.all(np.isfinite(K0))):
        raise AssertionError("non-finite control message")
    if not conv:
        raise AssertionError(f"final tick did not converge (kkt={kkt:.2e})")
    xT = runner._xs[-1].double().cpu().numpy()
    _, pT = sl.ee_pose(xT[:7])
    ee_err = float(np.linalg.norm(pT - sl.goal))
    if not ee_err < 0.02:
        raise AssertionError(f"terminal EE error {ee_err:.4f} m >= 0.02 m")
    return launches, (
        f"slice: first solve {first_s:.2f} s, iters={it0} kkt={kkt0:.2e} "
        f"conv={conv0}; tick median {tick_ms:.3f} ms over 3x20 ticks at "
        f"limit 2 (host clock, synchronized); {syncs_per_tick:.2f} host "
        f"syncs per tick in the solver loops; final tick iters={iters} "
        f"kkt={kkt:.2e} conv={conv}; terminal EE error {ee_err * 1e3:.2f} mm; "
        f"launches {launches}")


def run_collision_path(device, n_settle: int = 20, n_timed: int = 20):
    """Drive the collision path: the shipped collision-avoidance OCP on the
    Panda, T=19, f32, through a PackedTrajectoryBuffer and a FusedTickRunner,
    with a streamed end-effector goal that pulls link 7 onto the 1 cm band of
    the obstacle sphere. A first solve at limit 100, `n_settle` ticks at
    limit 2, `n_timed` timed ticks at limit 2, one final tick at limit 10,
    with a measured state drifting around the ready pose (0.005 rad, the
    JAX csqp bench's drift). Returns (launches per kernel, summary line)."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryPoint,
        TrajectoryPointWeights,
        WeightedTrajectoryPoint,
    )
    from agimus_controller_tpu_torch.mpc.ring import PackedTrajectoryBuffer, RowLayout
    from agimus_controller_tpu_torch.mpc.tick import FusedTickRunner
    from agimus_controller_tpu_torch.ocp.spec import default_references
    from agimus_controller_tpu_torch.ops.batched_dynamics import _StaticModel, _rnea_c
    from agimus_controller_tpu_torch.ops.collision import pair_distance
    from agimus_controller_tpu_torch.ops.kinematics import frame_placement
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings

    T, dtype = 19, torch.float32
    model, params = load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                               dtype=dtype, device=device)
    _, params64 = load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                             dtype=torch.float64, device="cpu")
    spec = yaml_spec(T, model)
    q0 = np.asarray(PANDA_Q_READY)
    x0 = np.concatenate([q0, np.zeros(7)])
    R0 = frame_placement(model, params64, torch.as_tensor(q0),
                         model.frame_id("panda_hand_tcp"))[0].numpy()
    z = [torch.zeros(1, dtype=torch.float64)] * 7
    tau_g = np.array([float(v) for v in _rnea_c(
        _StaticModel(model, params64),
        [torch.as_tensor(q0[i:i + 1]) for i in range(7)], z, z)])
    # the csqp bench's target moved 5 cm towards the sphere, with a goal
    # weight that presses link 7 through the quad_exp barrier onto the band;
    # much stronger (3000) and the ADMM at 25 iterations leaves some limit-10
    # ticks unconverged, much weaker (2400) and link 7 stays off the band
    goal = np.asarray([0.45, 0.05, 0.50])

    def point(i):
        pt = TrajectoryPoint(
            id=i, time_ns=int(i * 1e7), robot_configuration=q0,
            robot_velocity=np.zeros(7), robot_acceleration=np.zeros(7),
            robot_effort=tau_g,
            end_effector_poses={"panda_hand_tcp": (R0, goal)})
        w = TrajectoryPointWeights(
            w_robot_configuration=np.full(7, 0.1),
            w_robot_velocity=np.full(7, 1.0), w_robot_effort=np.ones(7),
            w_end_effector_poses={"panda_hand_tcp": np.full(6, 2700.0)})
        return WeightedTrajectoryPoint(point=pt, weights=w)

    n_ticks = n_settle + n_timed + 1
    buf = PackedTrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[T]),
                                 RowLayout(spec, model), dtype=dtype,
                                 device=device)
    for i in range(3 * T + n_ticks + 1):
        buf.append(point(i))
    runner = FusedTickRunner(
        model, params, spec, buf.ring,
        default_references(spec, model, dtype=dtype, device=device),
        CSQPSettings(max_iters=10, max_qp_iters=25, reg_init=1e-7,
                     termination_tolerance=1e-4),
        dtype=dtype, device=device)
    solver = runner.solver
    drift = np.random.default_rng(0).normal(size=(n_ticks, 7)) * 0.005
    x0_seq = torch.as_tensor(np.concatenate([q0[None] + drift,
                                             np.zeros((n_ticks, 7))], 1),
                             dtype=dtype, device=device)

    for k in solver.kernels:
        k.launches = 0
    t0 = time.perf_counter()
    runner.initialize(x0, np.tile(x0[None], (T + 1, 1)),
                      np.tile(tau_g[None], (T, 1)), limit=100)
    _, _, kkt0, it0, conv0 = runner.fetch()
    first_s = time.perf_counter() - t0
    after_init = [k.launches for k in solver.kernels]
    for i in range(n_settle):
        runner.step(x0_seq[i], limit=2)
    _sync(device)
    syncs0, admm0 = solver.host_syncs, solver.admm_iters
    times = []
    for i in range(n_settle, n_settle + n_timed):
        t0 = time.perf_counter()
        runner.step(x0_seq[i], limit=2)
        _sync(device)
        times.append(time.perf_counter() - t0)
    syncs = (solver.host_syncs - syncs0) / n_timed
    admm = (solver.admm_iters - admm0) / n_timed
    runner.step(x0_seq[-1], limit=10)
    K0, u0, kkt, iters, conv = runner.fetch()
    launches = dict(zip([k[0] for k in STAGE_KERNELS],
                        (k.launches for k in solver.kernels)))

    for (name, a), b in zip(zip(launches, after_init), launches.values()):
        if b <= a:
            raise AssertionError(
                f"collision path: {name} was not launched during the ticks")
    if not (np.all(np.isfinite(u0)) and np.all(np.isfinite(K0))):
        raise AssertionError("collision path: non-finite control message")
    if not conv:
        raise AssertionError(
            f"collision path: final tick did not converge (kkt={kkt:.2e})")
    if not admm > 0:
        raise AssertionError("collision path: the ADMM did not run")
    xs = runner.last.xs.double().cpu()
    d = torch.func.vmap(lambda q: pair_distance(model, params64, q, 0))(
        xs[1:, :7])
    d_min = float(d.min())
    if not d_min > 0.01 - 1e-3:
        raise AssertionError(
            f"collision path: band violated on t >= 1, min distance "
            f"{d_min * 1e3:.3f} mm")
    if not d_min < 0.01 + 2e-3:
        raise AssertionError(
            f"collision path: band not active, min distance "
            f"{d_min * 1e3:.3f} mm")
    return launches, (
        f"collision path: first solve {first_s:.2f} s, iters={it0} "
        f"kkt={kkt0:.2e} conv={conv0}; tick median "
        f"{float(np.median(times)) * 1e3:.3f} ms over {n_timed} ticks at "
        f"limit 2 (host clock, synchronized); {syncs:.2f} host syncs and "
        f"{admm:.2f} ADMM iterations per tick; final tick iters={iters} "
        f"kkt={kkt:.2e} conv={conv}; min pair distance on t >= 1 "
        f"{d_min * 1e3:.3f} mm (band 10 mm); launches {launches}")


# the object pose first detected (the JAX cost-pack tests' vision
# transform), and the later detection streamed to the solver: 2 cm along x
WMO_ROTVEC, WMO_TRANS = (0.2, -0.1, 0.3), (0.4, 0.1, 0.2)
WMO_SHIFT = (0.02, 0.0, 0.0)
# a quintic joint-space move from the ready pose
VS_MOVE = (0.15, -0.1, 0.1, 0.15, 0.0, 0.1, 0.0)
# the weights of the JAX trajectory tests' visual-servoing run, with w_q
# and w_qdot lowered from 1 to 0.1: at 1 the state and velocity references
# hold the planned end effector 7-9 mm from the detected target after the
# 41 ticks, at 0.1 it reaches 1.7 mm (CPU rehearsals of this chain, f32)
VS_WEIGHTS = dict(w_q=np.full(7, 0.1), w_qdot=np.full(7, 0.1),
                  w_qddot=np.zeros(7), w_robot_effort=np.full(7, 1e-3),
                  w_pose=np.full(6, 10.0))
VS_RAMP = dict(max_weight=50.0, percent=0.95, time_reach_percent=0.5)
VS_MAX = dict(w_increasing_max_rotation=25.0,
              w_increasing_max_collision_avoidance=4.0,
              w_collision_avoidance=1.0)


def vs_trajectory(model, params, n_points: int, dt: float):
    """The streamed references of the visual-servoing path: a
    `GenericTrajectory` over a quintic move from the ready pose (lasting 60%
    of the points, then held), fed to a `GenericVisualServoingTrajectory`
    whose window covers every point. Returns (generator, first detection
    (R, p))."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY
    from agimus_controller_tpu_torch.ops.spatial import exp3
    from agimus_controller_tpu_torch.trajectories import (
        GenericTrajectory,
        GenericVisualServoingTrajectory,
        QuinticTrajectory,
        WeightIncreasing,
    )

    q0, move = np.asarray(PANDA_Q_READY), np.asarray(VS_MOVE)
    ramp = QuinticTrajectory([0.6 * n_points * dt] * 7)
    pva = [ramp.get_value_at_t(i * dt) for i in range(n_points)]
    gt = GenericTrajectory("panda_hand_tcp", **VS_WEIGHTS)
    gt.initialize(model, params, q0)
    traj = gt.build_trajectory_from_q_dq_ddq_arrays(
        [q0 + move * p for p, _, _ in pva], [move * v for _, v, _ in pva],
        [move * a for _, _, a in pva])
    vs = GenericVisualServoingTrajectory(
        "panda_hand_tcp", dt, **VS_WEIGHTS,
        w_increasing=WeightIncreasing(**VS_RAMP), **VS_MAX)
    vs.initialize(model, params, q0)
    wMo = (exp3(torch.as_tensor(WMO_ROTVEC, dtype=torch.float64)).numpy(),
           np.asarray(WMO_TRANS))
    vs.add_trajectory(traj, visual_servoing_idx_range=(0, n_points),
                      init_in_world_M_object=wMo)
    return vs, wMo


def run_vs_path(device, n_settle: int = 20, n_timed: int = 20):
    """Drive the visual-servoing path: `VS_OCP` on the Panda, T=19, dt 0.01,
    f32, through a `GenericVisualServoingTrajectory`, a
    `PackedTrajectoryBuffer` and a `FusedTickRunner`, with the object
    detected 2 cm along x from where the trajectory was re-expressed. A
    first solve at limit 100, `n_settle` ticks at limit 2, `n_timed` timed
    ticks at limit 2, one final tick at limit 10; each tick starts from the
    previous plan's next state, drifted by 0.002 rad. Returns (launches per
    kernel, summary line)."""
    from agimus_controller_tpu_torch.models.panda import load_panda
    from agimus_controller_tpu_torch.mpc.buffer import DTFactorsNSeq
    from agimus_controller_tpu_torch.mpc.ring import PackedTrajectoryBuffer, RowLayout
    from agimus_controller_tpu_torch.mpc.tick import FusedTickRunner
    from agimus_controller_tpu_torch.ocp.spec import default_references
    from agimus_controller_tpu_torch.ops.kinematics import frame_placement
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings

    T, dt, dtype = 19, 0.01, torch.float32
    model, params = load_panda(dtype=dtype, device=device)
    _, params_traj = load_panda(dtype=torch.float64, device=device)
    _, params64 = load_panda(dtype=torch.float64, device="cpu")
    spec = vs_spec(T, model, dt)
    n_ticks = n_settle + n_timed + 1
    n_points = 3 * T + n_ticks + 1
    vs, (R_o, p_o) = vs_trajectory(model, params_traj, n_points, dt)
    layout = RowLayout(spec, model)
    buf = PackedTrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[T]),
                                 layout, dtype=dtype, device=device)
    for i in range(n_points):
        buf.append(vs.get_traj_point_at_t(i * dt))
    p_det = p_o + np.asarray(WMO_SHIFT)
    refs = default_references(spec, model, dtype=dtype, device=device)
    refs["wMo_rot:object"] = torch.as_tensor(R_o, dtype=dtype, device=device)
    refs["wMo_trans:object"] = torch.as_tensor(p_det, dtype=dtype,
                                               device=device)
    runner = FusedTickRunner(
        model, params, spec, buf.ring, refs,
        CSQPSettings(max_iters=10, reg_init=1e-7, termination_tolerance=1e-4),
        dtype=dtype, device=device)
    solver = runner.solver
    field = {f.key: f for f in layout.fields}
    w_ee, ee_trans = (field[f"{k}:panda_hand_tcp"] for k in ("w_ee", "ee_trans"))
    first = vs.trajectory[0]
    x0 = np.concatenate([first.robot_configuration, first.robot_velocity])
    drift = torch.as_tensor(np.concatenate(
        [np.random.default_rng(0).normal(size=(n_ticks, 7)) * 0.002,
         np.zeros((n_ticks, 7))], 1), dtype=dtype, device=device)

    def tick(i, limit):
        return runner.step(runner.last.xs[1] + drift[i], limit=limit)

    for k in solver.kernels:
        k.launches = 0
    t0 = time.perf_counter()
    runner.initialize(x0, np.tile(x0[None], (T + 1, 1)),
                      np.tile(first.robot_effort[None], (T, 1)), limit=100)
    _, _, kkt0, it0, conv0 = runner.fetch()
    first_s = time.perf_counter() - t0
    after_init = [k.launches for k in solver.kernels]
    for i in range(n_settle):
        tick(i, 2)
    _sync(device)
    syncs0 = solver.host_syncs
    times, w_min = [], np.inf
    for i in range(n_settle, n_settle + n_timed):
        rows = buf.ring.host_horizon_rows()
        w_min = min(w_min, float(rows[0, w_ee.offset:w_ee.offset + 6].min()))
        t0 = time.perf_counter()
        tick(i, 2)
        _sync(device)
        times.append(time.perf_counter() - t0)
    syncs = (solver.host_syncs - syncs0) / n_timed
    rows = buf.ring.host_horizon_rows()
    tick(n_ticks - 1, 10)
    K0, u0, kkt, iters, conv = runner.fetch()
    launches = dict(zip([k[0] for k in STAGE_KERNELS],
                        (k.launches for k in solver.kernels)))

    for (name, a), b in zip(zip(launches, after_init), launches.values()):
        if b <= a:
            raise AssertionError(
                f"visual-servoing path: {name} was not launched during the ticks")
    if not (np.all(np.isfinite(u0)) and np.all(np.isfinite(K0))):
        raise AssertionError("visual-servoing path: non-finite control message")
    if not conv:
        raise AssertionError(
            f"visual-servoing path: final tick did not converge (kkt={kkt:.2e})")
    if not w_min > 0.0:
        raise AssertionError(
            f"visual-servoing path: streamed pose weight {w_min} on a timed tick")
    # the planned terminal end effector against the terminal node's target
    # under the streamed (shifted) detection and under the first one
    term = rows[-1].astype(np.float64)
    p_ref = term[ee_trans.offset:ee_trans.offset + 3]  # in the object frame
    xT = runner.last.xs[-1].double().cpu()
    _, pT = frame_placement(model, params64, xT[:7],
                            model.frame_id("panda_hand_tcp"))
    pT = pT.numpy()
    d_det = float(np.linalg.norm(pT - (R_o @ p_ref + p_det)))
    d_first = float(np.linalg.norm(pT - (R_o @ p_ref + p_o)))
    if not (d_det < 0.01 and d_det < d_first):
        raise AssertionError(
            f"visual-servoing path: terminal end effector {d_det * 1e3:.2f} mm "
            f"from the detected target, {d_first * 1e3:.2f} mm from the first "
            "detection's")
    return launches, (
        f"visual-servoing path: first solve {first_s:.2f} s, iters={it0} "
        f"kkt={kkt0:.2e} conv={conv0}; tick median "
        f"{float(np.median(times)) * 1e3:.3f} ms over {n_timed} ticks at "
        f"limit 2 (host clock, synchronized); {syncs:.2f} host syncs per "
        f"tick; min streamed pose weight on the timed ticks {w_min:.3f}; "
        f"final tick iters={iters} kkt={kkt:.2e} conv={conv}; terminal end "
        f"effector {d_det * 1e3:.3f} mm from the detected target, "
        f"{d_first * 1e3:.3f} mm from the first detection's; launches "
        f"{launches}")


# the batch path: the JAX bench's batch mode (`bench.py:386-438`) with the
# goal of `examples/batch_scenarios.py:54-59`
BATCH_T, BATCH_B, BATCH_ROWS = 100, 4096, 8
BATCH_GOAL = (0.1, 0.05, -0.05)  # from the end effector at the ready pose
BATCH_X0_NOISE = 0.02  # rad on q, per scenario and variant
BATCH_VARIANTS = 3  # x0 variants timed (the JAX bench times 5)


def build_batch(device, n_variants: int = BATCH_VARIANTS):
    """The batch problem: `flagship_spec(100)`, dt 0.01, f32, 10 iterations,
    the goal FK(ready) + BATCH_GOAL, xs tiled from the ready state, us zero,
    x0 variants ready + N(0, 0.02^2) on q (seed 0). Returns a namespace
    (solver, refs, variants [B, nx] each, xs0, us0, goal, ee_dist)."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.ocp.spec import default_references
    from agimus_controller_tpu_torch.ops.batched_costs import _fk_world, _frame_pose_c
    from agimus_controller_tpu_torch.ops.batched_dynamics import _StaticModel
    from agimus_controller_tpu_torch.solver.fddp import SolverSettings
    from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp

    T, B, dtype = BATCH_T, BATCH_B, torch.float32
    model, params = load_panda(dtype=dtype, device=device)
    _, params64 = load_panda(dtype=torch.float64, device="cpu")
    sm64 = _StaticModel(model, params64)
    fid = model.frame_id("panda_hand_tcp")

    def ee_pose(q):
        """End-effector placements at q [n, 7] (f64, CPU)."""
        q = torch.as_tensor(q, dtype=torch.float64).cpu()
        oR, op = _fk_world(sm64, list(q.unbind(1)))
        R, p = _frame_pose_c(model, params64, oR, op, fid)
        return (torch.stack(R, 1).reshape(-1, 3, 3).numpy(),
                torch.stack(p, 1).numpy())

    spec = flagship_spec(T)
    q0 = np.asarray(PANDA_Q_READY)
    x0 = np.concatenate([q0, np.zeros(7)])
    R0, p0 = (a[0] for a in ee_pose(q0[None]))
    goal = p0 + np.asarray(BATCH_GOAL)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    refs = default_references(spec, model, dtype=dtype, device=device)
    refs["xref"] = f(np.tile(x0[None], (T + 1, 1)))
    refs["ee_rot:panda_hand_tcp"] = f(np.tile(R0[None], (T + 1, 1, 1)))
    refs["ee_trans:panda_hand_tcp"] = f(np.tile(goal[None], (T + 1, 1)))
    rng = np.random.default_rng(0)
    variants = [f(x0[None] + np.concatenate(
        [rng.normal(size=(B, 7)) * BATCH_X0_NOISE, np.zeros((B, 7))], 1))
        for _ in range(n_variants)]
    solver = make_batch_fddp(model, params, spec, SolverSettings(max_iters=10),
                             device=device)
    ee_dist = lambda xs: np.linalg.norm(
        ee_pose(xs[:, -1, :7].double().cpu())[1] - goal, axis=1)
    return SimpleNamespace(
        solver=solver, refs=refs, variants=variants, goal=goal,
        xs0=f(np.tile(x0[None, None], (B, T + 1, 1))),
        us0=torch.zeros((B, T, 7), dtype=dtype, device=device),
        ee_dist=ee_dist)


def solve_rows(bp, x0s):
    """One batch solve from the first len(x0s) scenarios' starts."""
    n = x0s.shape[0]
    return bp.solver(x0s, bp.refs, bp.xs0[:n], bp.us0[:n])


def batch_phases(bp, sol, device):
    """Host-clock time (ms, synchronized) of each part of one FDDP
    iteration at the solution's iterate: the K5b linearisation,
    the cost pack over T*B nodes and the terminal pack, the component
    Riccati sweep, and one line-search trial (T K5a steps, then the trial
    cost of all nodes) with its two parts."""
    s = bp.solver
    x0s = bp.variants[0]
    xs = sol.xs.transpose(0, 1).contiguous()
    us = sol.us.transpose(0, 1).contiguous()
    T, B = s.T, xs.shape[1]
    _, dts_flat, t_flat = s._node_data(xs)
    x_flat, u_flat = xs[:-1].reshape(T * B, -1), us.reshape(T * B, -1)

    def timed(fn, reps=3):
        fn()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        _sync(device)
        return (time.perf_counter() - t0) / reps * 1e3, out

    out = {}
    out["K5b over T*B"], _ = timed(lambda: s.step_dk(x_flat, u_flat, dts_flat))
    out["cost pack over T*B"], _ = timed(
        lambda: s.pack.pack(x_flat, u_flat, t_flat, bp.refs))
    out["terminal pack"], _ = timed(lambda: s.pack.term_pack(xs[-1], bp.refs))
    _, (dyn, costs, term) = timed(lambda: s.derivs_of(xs, us, bp.refs), 1)
    fs = s._gaps_of(x0s, xs, dyn[0])
    reg = torch.full((B,), 1e-9, dtype=xs.dtype, device=xs.device)
    out["Riccati sweep"], (ks, Ks, *_) = timed(
        lambda: s.backward(dyn, costs, term, fs, reg))
    out["trial (T K5a + cost)"], _ = timed(
        lambda: s.rollout_alpha(0.5, x0s, xs, us, ks, Ks, fs, bp.refs))
    out["trial cost of all nodes"], _ = timed(
        lambda: s.total_cost(xs, us, bp.refs))
    return out


def run_batch_path(device):
    """Drive the batch path: a B=8 solve of the first variant's rows 0-7
    (also the warm-up), then B=4096 solves on the x0 variants, each timed by
    the host clock ending in a synchronize. Returns (launches per kernel,
    summary lines)."""
    bp = build_batch(device)
    solver = bp.solver
    for k in solver.kernels:
        k.launches = 0
    t0 = time.perf_counter()
    small = solve_rows(bp, bp.variants[0][:BATCH_ROWS])
    _sync(device)
    small_s = time.perf_counter() - t0
    times, sols, syncs = [], [], []
    for x0s in bp.variants:
        s0 = solver.host_syncs
        t0 = time.perf_counter()
        sols.append(solve_rows(bp, x0s))
        _sync(device)
        times.append(time.perf_counter() - t0)
        syncs.append(solver.host_syncs - s0)
    launches = {name: k.launches for (name, *_), k in
                zip(STEP_KERNELS, solver.kernels)}

    for i, sol in enumerate(sols):
        for field in ("xs", "us", "K", "k", "cost", "kkt", "gap_norm"):
            if not bool(torch.isfinite(getattr(sol, field)).all()):
                raise AssertionError(
                    f"batch path: non-finite {field} in variant {i}")
    big = sols[0]
    rows = slice(0, BATCH_ROWS)
    if not (torch.equal(big.iters[rows], small.iters)
            and torch.equal(big.converged[rows], small.converged)):
        raise AssertionError(
            f"batch path: rows 0-{BATCH_ROWS - 1} of the B={BATCH_B} solve "
            f"(iters {big.iters[rows].tolist()}, converged "
            f"{big.converged[rows].tolist()}) differ from the B={BATCH_ROWS} "
            f"solve (iters {small.iters.tolist()}, converged "
            f"{small.converged.tolist()})")
    du = float((big.us[rows] - small.us).abs().max())
    if not du < 1e-3:
        raise AssertionError(
            f"batch path: rows 0-{BATCH_ROWS - 1} us differ from the "
            f"B={BATCH_ROWS} solve by {du:.3e}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"batch path: {name} was not launched")

    t_med = float(np.median(times))
    dist = bp.ee_dist(big.xs)
    dist_small = bp.ee_dist(small.xs)
    phases = batch_phases(bp, big, device)
    c = lambda a: a.double().cpu().numpy()
    return launches, [
        f"batch path (B={BATCH_ROWS}): {small_s:.2f} s, iters "
        f"{small.iters.tolist()}, converged {small.converged.tolist()}, "
        f"terminal end-effector distance to the goal (mm) "
        + " ".join(f"{d * 1e3:.3f}" for d in dist_small),
        f"batch path (B={BATCH_B}, T={BATCH_T}, f32, 10 iterations): solve "
        f"times {' '.join(f'{t:.3f}' for t in times)} s (host clock, "
        f"synchronized); median {t_med:.3f} s = {BATCH_B / t_med:.1f} "
        f"solves/s; mean iterations {float(c(big.iters).mean()):.2f}; "
        f"converged share {float(c(big.converged).mean()):.4f}; kkt median "
        f"{float(np.median(c(big.kkt))):.3e} max {float(c(big.kkt).max()):.3e}"
        f"; gap median {float(np.median(c(big.gap_norm))):.3e} max "
        f"{float(c(big.gap_norm).max()):.3e}; median planned terminal "
        f"end-effector distance to the goal {float(np.median(dist)) * 1e3:.3f}"
        f" mm (start {np.linalg.norm(BATCH_GOAL) * 1e3:.1f} mm); host syncs "
        f"per solve {' '.join(str(n) for n in syncs)}; rows 0-"
        f"{BATCH_ROWS - 1} match the B={BATCH_ROWS} solve (us max abs diff "
        f"{du:.3e}); launches {launches}",
        f"batch path phases at B={BATCH_B} (ms, host clock, synchronized): "
        + "; ".join(f"{k} {v:.3f}" for k, v in phases.items())]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs on the GPU only")
    _port()
    from agimus_controller_tpu_torch.models.panda import load_panda
    from agimus_controller_tpu_torch.ops import _build

    # -- 1. environment
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; TF32 off (matmul and cudnn)")

    # -- 2. build
    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load_library()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    # -- 3. kernels vs plain
    model, params = load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                               dtype=torch.float32, device=device)
    report = check_kernels(model, params, device)
    step_report = check_step_kernels(model, params, device)

    # -- 4. the main paths: the flagship chain, the collision path, the
    # visual-servoing path and the batch path
    launches = {name: 0 for name, *_ in KERNELS}
    for run in (run_slice, run_collision_path, run_vs_path, run_batch_path):
        path_launches, stats = run(device)
        for line in [stats] if isinstance(stats, str) else stats:
            print(line)
        for name, n in path_launches.items():
            launches[name] += n

    # -- 5. result: launches over the four paths, the max error over every
    # checked spec and size; times (wrapper and bare launch) and bounds at
    # the flagship tick shape for K1-K4 and at the batch path's shapes for
    # K5a/K5b (no single PyTorch call computes a fused stage or a dynamics
    # step: no library time)
    kernels = []
    for name, kind, derivs, replaces in KERNELS:
        if kind == "step":
            per_size = step_report[name]
            r = per_size[STEP_SIZES[name]]
        else:
            per_size = {(s, n): v for s, per_n in report[name].items()
                        for n, v in per_n.items()}
            r = report[name]["flagship"][100 if kind == "stage" else 1]
        err = max(v["max_abs_err"] for v in per_size.values())
        kernels.append(dict(name=name, route="cuda", source=SOURCES[kind],
                            replaces=replaces, launches=launches[name],
                            max_abs_err=err, ms=r["ms"],
                            kernel_only_ms=r["kernel_only_ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=None))
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main paths: {missing}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
