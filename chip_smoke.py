"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from `agimus_controller_tpu_torch/csrc/`,
one library per joint count the phases run (`BUILD_NJ`: 2, 7, 8, 17, all
sources at once): the stage kernels K1-K4, the dynamics-step kernels
K5a/K5b and the batch FDDP's Riccati sweep R1. Holds K1-K4
against their plain-PyTorch versions on the card on six specs (the
flagship goal tracking, the Pallas kernels' test spec with its collision
item, the shipped collision-avoidance YAML, the visual-servoing OCP
`VS_OCP`, a visual-servoing + frame-velocity spec, and `cap_spec`, with
more ref keys than the kernels' by-value table holds) with every term live,
K1/K2 at N = 19, 20, 100 and 102 400 (`cap_spec` at 100), also with one
dt for every node (a float, a 0-d tensor), K1-K4 also on the tick's
ring-row views of the refs, and K5a/K5b at every shape the paths launch
them at, with per-node and scalar dt; and the nj = 8 instances of all six
on the 8-joint Tiago-Pro arm (`tiago_spec`) at the sizes phase 7 launches
them at (K1/K2 at N = 20 and 21 and K3/K4 at 1, also on the ring-row
views; K5a/K5b with per-node and scalar dt), and their nj = 17 instances
on the full branched Tiago-Pro (`tiago_full_spec`, both tools) at the same
sizes; and R1 against the plain component sweep in float32 and float64
on seeded LQ data at the batch path's, phase 7 (a)'s and the benchmark
cell's shapes (`RICCATI_CHECK_SIZES`); times each call and its bare launch
and computes its bound. The plain K1-K4 results of a spec's sizes
come from one stacked call (nodes are independent), which also counts the
operations of the bound.
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
  that the B=4096 solve must reproduce, and the same B=8 solve on the
  horizon-parallel Riccati sweep (`riccati="pscan"`), held to the
  component solve's iterations, flags and states; the sweep kernel the
  solver runs (`ops/cuda_riccati.py`, R1) and the pscan sweep are timed
  beside the plain component sweep on the same linearisation, each with
  its largest gain difference to it, R1's gains held to the float64
  sweep's; every component sweep of the solves must have launched R1.

Phase 5 runs the specs the stage kernels decline on the "xla" backend and
the single-scenario solvers. Phase 6 drives the reference-shaped control
loop of the README's Quick start and the demos (`examples/pick_and_place.py`,
`examples/dummy_mpc.py`): the Panda from the model factory with an obstacle
given as xacro, `OCPParams` from the engine config loader, the OCP
registry, the warm starts, `MPC` and `ControllerRuntime`, T=20, dt 0.01,
f32: (a) the pick-and-place loop, held against the JAX package's joint
tracking error; (b) the same in ring mode with the debug streams, one solve
held against host packing; (c) the sine loop at the reference's default
`max_solve_time`; (d) the collision-avoidance OCP through the facade, T=19,
checked to hold the band; then (a)'s recording written as npz, sqlite3 and
mcap and read back equal, (a)'s checkpoint resumed in a fresh `MPC` against
the uninterrupted run, `MPCDebugger`'s cost breakdown against a solve's
cost, the ROS shim's node graph over the in-process bus and the
trajectory-publisher process with its CPU child. Phase 7 drives slice 12:
(a) the Tiago-Pro arm
(nj = 8) through `FusedTickRunner` on the stage kernels, T=20, checked to
converge with the tool error under a quarter of the start's, and
`make_batch_fddp` at B=1024 on the step kernels, rows 0-7 against a B=8
solve; (b) soft contact on the Panda: the batch SQP on the soft step
against `solve_fddp` on the terminal force, an inactive contact freezing
the force state, and an `MPC` loop with the force-feedback warm start;
(c) the quaternion free-flyer at the euler chart's singular pitch:
`solve_fddp` and the manifold batch SQP reaching the hand's goal and
agreeing on it; (b) and (c) also through `FusedTickRunner` (the soft step;
`cf=` on the manifold backend); and the model-parameter sensitivity sweep
on the card against the CPU in f64. Phase 8 drives slice 16, the
multi-device layer, over four slots of the one card (a mesh may name a
device in several slots): (a) `sharded_batch_sqp` on K1-K4, the
keep-away collision CSQP at T=24, B=16, replicated rows equal and each
against the unsharded `make_batch_sqp`; (b) `sharded_batch_fddp` at
B=1024 against the unsharded solve; (c) `make_batch_csqp` and
`sharded_batch_csqp` at B=8 (ADMM counts equal), row 0 against
`solve_csqp`; (d) the horizon-sharded Riccati in f64 against
`parallel_riccati` (T=400) and `solve_fddp_tsharded` against `solve_fddp`
(T=64); (e) two processes sharing the card through the `AGIMUS_*`
environment (gloo), each one's rows against a single-process solve. Phase
9 drives the full 17-DoF Tiago-Pro (a branched tree: the head and both
arms on the prismatic torso; `load_tiago_full`) on the nj = 17 kernels:
both tools' targets through `FusedTickRunner` (phase 7 (a)'s buffer and
schedule, converged, each tool under a quarter of its start error) and
`make_batch_fddp` at B=1024, rows 0-7 against a B=8 solve. Each phase
prints its seconds.

The tick paths must have launched every stage kernel, the batch FDDPs
K5a, K5b and R1 and no stage kernel; phase 9 every kernel at nj = 17. Exits non-zero without a result when
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
    # the batch FDDP's component sweep; the JAX sweep is XLA, no Pallas kernel
    ("R1_riccati", "riccati", None, None),
)
STAGE_KERNELS = tuple(k for k in KERNELS
                      if k[1] in ("stage", "terminal"))  # K1-K4
STEP_KERNELS = tuple(k for k in KERNELS if k[1] == "step")  # K5a, K5b
# `BatchFDDP.kernels` in its order: K5a, K5b and the Riccati sweep
FDDP_KERNELS = STEP_KERNELS + tuple(k for k in KERNELS if k[1] == "riccati")
SOURCES = {"stage": "agimus_controller_tpu_torch/csrc/stage_kernels.cu",
           "terminal": "agimus_controller_tpu_torch/csrc/terminal_kernels.cu",
           "step": "agimus_controller_tpu_torch/csrc/step_kernels.cu",
           "riccati": "agimus_controller_tpu_torch/csrc/riccati_kernels.cu"}
# the shapes of the kernels line: K5a steps the batch path's B = 4096
# scenarios of a rollout, K5b linearises all its T x B = 409 600 nodes; R1
# sweeps the benchmark cell's (nj, T, B)
STEP_SIZES = {"K5a_step": 4096, "K5b_step_derivs": 409_600,
              "R1_riccati": (17, 20, 4096)}
# (nj, T, B) R1 is checked at: the batch path's, phase 7 (a)'s and the
# benchmark cell's (phase 9's batch at B = 1024)
RICCATI_CHECK_SIZES = ((7, 100, 4096), (8, 20, 1024), (17, 20, 4096))
# R1's error against the float64 sweep may exceed twice the plain float32
# sweep's by this much (as a share of the float64 output's largest
# magnitude): ~8 float32 epsilons, what summing a 34-term product in another
# order, with FMA, moves an entry at one step
RICCATI_FLOOR = 1e-6
# the node counts K1/K2 are checked at: every one the paths launch them at
# (B = 1: the T = 19 collision, VS and phase 5 (c) and 6 (d) solves, phase
# 6's T = 20 loops, the flagship tick's T = 100) and 102 400 nodes
STAGE_CHECK_SIZES = (19, 20, 100, 102_400)
# every shape the paths launch the step kernels at, each kernel checked
# against its plain version at all of them: phase 5's ticks step and
# linearise T x B = 100 nodes (B = 1; 100 is no whole number of 16-node K5a
# or 8-node K5b blocks), its batch FDDPs roll out B = 4, 8, 64 nodes a step
# and linearise T x B = 400, 800, 6 400; the batch path's two sizes
STEP_CHECK_SIZES = (4, 8, 64, 100, 400, 800, 4096, 6400, 409_600)
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
_STATE = _cost("state_reg", {"class": "ResidualModelState"}, _QUAD)
_DAM = "DifferentialActionModelFreeFwdDynamics"


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
    """The shipped collision-avoidance OCP (the package's parsed tree of
    the YAML file: the card's machine has no PyYAML), compiled by the
    port."""
    from agimus_controller_tpu_torch.ocp.definitions import (
        TRAJ_TRACKING_COLLISION_AVOIDANCE,
    )
    from agimus_controller_tpu_torch.ocp.yaml_compiler import load_ocp_spec

    return load_ocp_spec(TRAJ_TRACKING_COLLISION_AVOIDANCE, model, horizon=T,
                         dt=dt, default_ee_frame="panda_hand_tcp")


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


def panda_sizes(spec_name, kind):
    """The node counts the Panda's paths launch K1/K2 (`kind` "stage") or
    K3/K4 at: `STAGE_CHECK_SIZES` (`cap25`, whose plain version is the
    slowest, at the flagship tick's N = 100 alone); the terminal kernels
    one node per scenario, N // 100 for N >= 100."""
    sizes = [N for N in STAGE_CHECK_SIZES if N == 100 or spec_name != "cap25"]
    return sizes if kind == "stage" else [N // 100 for N in sizes if N >= 100]


def stacked_plain(k, kind, per_size):
    """One plain call over the nodes of every size's inputs (`per_size`,
    {N: (refs, x, u, dt, t_idx)}): each node is computed from its own
    gathered ref row, so the sizes stack into one call. Returns ({N: the
    plain outputs of that size's nodes}, the call's ms)."""
    xs, us, dts, rows = [], [], [], []
    for refs, x, u, dt, t_idx in per_size.values():
        xs.append(x)
        if kind == "stage":
            us.append(u)
            dts.append((x.new_zeros(x.shape[0]) + dt).to(x.dtype))
            rows.append(k._rows(refs, t_idx, x.dtype))
        else:
            rows.append(k.terminal_rows(x, refs))
    args = (torch.cat(xs), *([torch.cat(us), torch.cat(dts)]
                             if kind == "stage" else ()), torch.cat(rows))
    out, ms = cuda_timed_call(lambda: k.plain_rows(*args))
    want, off = {}, 0
    for N in per_size:
        want[N] = tuple(o[off:off + N] for o in out)
        off += N
    return want, ms


# -- the operations of the bounds, counted on the host beside the card ------
# `count_ops` runs every ATen op of a plain version through Python, about
# twice its eager time; the count per node is the same at every node count
# and on every device, so worker processes count on the CPU at
# `COUNT_NODES` nodes of each spec's inputs while the card checks the
# kernels (`start_counts`)
COUNT_NODES = 19
COUNT_WORKERS = 3
_count_models = {}


def _count_init():
    torch.set_num_threads(1)


def _count_robot(robot, dtype):
    """The CPU model of a count job in `dtype`, built once per worker
    process."""
    if (robot, dtype) not in _count_models:
        if robot == "panda":
            from agimus_controller_tpu_torch.models.panda import load_panda

            _count_models[robot, dtype] = load_panda(
                env_urdf=ENV_URDF, collision_pairs=PAIR, dtype=dtype,
                device="cpu")
        else:
            from agimus_controller_tpu_torch.models.tiago_pro import (
                load_tiago_pro,
            )

            _count_models[robot, dtype] = (
                load_tiago_full if robot == "tiago17" else load_tiago_pro)(
                dtype=dtype, device="cpu")
    return _count_models[robot, dtype]


def count_job(robot, spec_name, kind, derivs):
    """Operations per node of one kernel's plain version (a worker's job):
    `robot` "panda", "tiago" (the arm, nj = 8) or "tiago17" (the full
    Tiago-Pro), `spec_name` a `SPECS` key, "tiago" or "tiago17" (None for
    the step kernels). The plain version runs in f64 on the f32 inputs made
    f64: for an f32 node it takes Fx and Fu in f64 (a second pass over the
    dynamics), which is the reference's accuracy and not the function's
    work."""
    from agimus_controller_tpu_torch.models.tiago_pro import TIAGO_PRO_Q_READY

    model, _ = _count_robot(robot, torch.float32)
    _, params = _count_robot(robot, torch.float64)
    up = lambda *ts: tuple(t.double() for t in ts)
    N = COUNT_NODES
    q_ready = {"tiago": TIAGO_PRO_Q_READY,
               "tiago17": tiago_full_ready()}.get(robot)
    if kind == "step":
        x, u, dt = step_inputs(N, N + derivs, "cpu", "per_node", q_ready)
        return ops_per_node(model, params, None, kind, derivs, None,
                            *up(x, u, dt), None)
    if robot != "panda":
        spec = (tiago_spec if robot == "tiago" else tiago_full_spec)(TIAGO_T)
        refs, x, u, dt, t_idx = tiago_inputs(spec, model, N, N + derivs,
                                             "cpu", q_ready)
    else:
        spec = SPECS[spec_name](100, model)
        refs, x, u, dt, t_idx = randomized_inputs(spec, model, N, N + derivs,
                                                  "cpu")
    from agimus_controller_tpu_torch.ops.cuda_costs import (
        make_cuda_stage,
        make_cuda_terminal,
    )

    refs = {key: v.double() for key, v in refs.items()}
    x, u, dt = up(x, u, dt)
    if kind == "stage":
        k = make_cuda_stage(model, params, spec, derivs, "cpu")
        return count_ops(lambda: k.plain(x, u, dt, t_idx, refs)) / N
    k = make_cuda_terminal(model, params, spec, derivs, "cpu")
    return count_ops(lambda: k.plain(x, refs)) / N


def start_counts():
    """(the pool, {(robot, spec or None, kernel): future ops per node}) of
    every kernel phase 3 checks, submitted in the order phase 3 reads
    them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        COUNT_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_count_init)
    jobs = [("panda", sp, STAGE_KERNELS) for sp in CHECKED_SPECS] + [
        ("panda", None, STEP_KERNELS), ("tiago", "tiago", STAGE_KERNELS),
        ("tiago", None, STEP_KERNELS), ("tiago17", "tiago17", STAGE_KERNELS),
        ("tiago17", None, STEP_KERNELS)]
    counts = {}
    for robot, sp, kernels in jobs:
        for name, kind, derivs, _ in kernels:
            counts[(robot, sp, name)] = pool.submit(count_job, robot, sp,
                                                    kind, derivs)
    return pool, counts


def check_kernels(model, params, device, ops, specs=None, sizes=panda_sizes,
                  inputs=randomized_inputs, timed=("flagship", 100, 1)):
    """K1-K4 vs their plain versions on the same CUDA inputs, f32, on
    `specs` ({name: spec}; the Panda's checked specs by default) at the
    node counts `sizes(spec_name, kind)`, the inputs from
    `inputs(spec, model, N, seed, device)`, with each call's time,
    kernel-only time (CUDA events around the bare launch, inputs, source
    table and outputs prepared) and bound; at node counts under 100 and
    each spec's first, also on the tick's ring-row views of the same refs
    and, for K1/K2, with one dt for every node (a float and a 0-d tensor).
    The plain results of a spec's sizes come from one stacked call
    (`stacked_plain`); `ops(spec_name, kernel)` gives the operations per
    node of the bound (`start_counts`); `timed` = (spec, K1/K2 size, K3/K4
    size) also times one plain call of its own at that size (the result
    line's `plain_ms`). Returns ({kernel: {spec: {N: numbers}}}, seconds
    spent in plain calls)."""
    from agimus_controller_tpu_torch.ops.cuda_costs import (
        make_cuda_stage,
        make_cuda_terminal,
    )

    if specs is None:
        specs = {n: SPECS[n](100, model) for n in CHECKED_SPECS}
    report, plain_s = {}, 0.0
    for spec_name, spec in specs.items():
        for name, kind, derivs, _ in STAGE_KERNELS:
            if kind == "stage":
                k = make_cuda_stage(model, params, spec, derivs, device)
                labels = STAGE_OUT if derivs else ("xnext", "l")
            else:
                k = make_cuda_terminal(model, params, spec, derivs, device)
                labels = ("l", "lx", "lxx") if derivs else ("l",)
            spec_sizes = sizes(spec_name, kind)
            per_size = {N: inputs(spec, model, N, N + derivs, device)
                        for N in spec_sizes}
            t0 = time.perf_counter()
            wants, stacked_ms = stacked_plain(k, kind, per_size)
            plain_s += time.perf_counter() - t0
            for n_nodes, (refs, x, u, dt, t_idx) in per_size.items():
                want = wants[n_nodes]
                args = (x, u, dt, t_idx, refs) if kind == "stage" else (x, refs)
                run = lambda: k(*args)
                got = run()
                torch.cuda.synchronize()
                errs = check_outputs(f"{name} {spec_name} N={n_nodes}", got,
                                     want, labels)
                views = ""
                with_views = n_nodes < 100 or n_nodes == spec_sizes[0]
                if with_views:
                    got_v = k(*args[:-1], tick_views(spec, model, refs))
                    torch.cuda.synchronize()
                    for lab, e in check_outputs(
                            f"{name} {spec_name} N={n_nodes} tick views",
                            got_v, want, labels).items():
                        errs[lab] = max(errs[lab], e)
                    same = all(torch.equal(a, b) for a, b in zip(got, got_v))
                    views = f"  tick views {'equal' if same else 'differ'}"
                if kind == "stage" and with_views:
                    t0 = time.perf_counter()
                    views += check_scalar_dt(k, name, spec_name, args, labels,
                                             errs, want)
                    plain_s += time.perf_counter() - t0
                ms = cuda_time_ms(run, reps=50)
                prepared, _ = k.prepare(*args)
                kernel_ms = cuda_time_ms(lambda: k.launch(prepared), reps=50)
                plain_ms = None
                if (spec_name, n_nodes) == (timed[0], timed[1 if kind ==
                                                             "stage" else 2]):
                    t0 = time.perf_counter()
                    _, plain_ms = cuda_timed_call(lambda: k.plain(*args))
                    plain_s += time.perf_counter() - t0
                ops_node = ops(spec_name, name)
                b_ms, b_by = bound_ms(k, kind, n_nodes, ops_node)
                live = (f"  collision term live on "
                        f"{live_share(spec, model, refs, x):.0%} of nodes"
                        if "geom_trans" in refs else "")
                print(f"{name:20s} {spec_name:8s} N={n_nodes:6d}  wrapper "
                      f"{ms:9.4f} ms (kernel only {kernel_ms:9.4f} ms)  plain "
                      + (f"{plain_ms:9.3f} ms" if plain_ms is not None
                         else "  stacked")
                      + f" (all sizes stacked: {stacked_ms:9.3f} ms)  "
                      f"bound {b_ms:.6f} ms ({b_by}, {ops_node:.1f} ops/node)"
                      "  max abs err " + " ".join(
                          f"{lab}={e:.2e}" for lab, e in errs.items())
                      + views + live)
                report.setdefault(name, {}).setdefault(spec_name, {})[
                    n_nodes] = dict(ms=ms, kernel_only_ms=kernel_ms,
                                    plain_ms=plain_ms,
                                    stacked_plain_ms=stacked_ms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    max_abs_err=max(errs.values()))
    return report, plain_s


def check_scalar_dt(k, name, spec_name, args, labels, errs, want):
    """K1/K2 with the first node's dt for every node, as a Python float and
    as a 0-d tensor: each equal bit for bit to the [N] form, which is held
    against the plain version (one plain call; a form that differs is held
    against the plain version itself). Where the inputs' dt already is that
    value at every node (a uniform horizon), the [N] form's inputs are the
    check's and its plain result `want` is reused. The errors go into errs;
    returns the line's note."""
    x, u, dt, t_idx, refs = args
    h = float(dt[0])
    per_node = torch.full_like(dt, h)
    got_n = k(x, u, per_node, t_idx, refs)
    same_inputs = torch.equal(per_node, dt)
    checks = [("[N]", got_n, h)]
    for form, d in (("float", h), ("0-d", dt[0].clone())):
        got = k(x, u, d, t_idx, refs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, got_n)):
            checks.append((form, got, d))
    for i, (form, got, d) in enumerate(checks):
        plain = (want if i == 0 and same_inputs
                 else k.plain(x, u, d, t_idx, refs))
        for lab, e in check_outputs(f"{name} {spec_name} {form} dt", got,
                                    plain, labels).items():
            errs[lab] = max(errs[lab], e)
    return f"  scalar dt {'equal' if len(checks) == 1 else 'differs'} to [N]"


def step_inputs(N, seed, device, dt_kind, q_ready=None):
    """Random nodes around a ready pose (the Panda's unless `q_ready` is
    given) with v and u live: q ~ ready + 0.1 N(0, 1), v ~ 0.5 N(0, 1),
    u ~ 2 N(0, 1); dt per node uniform in [0.005, 0.03], or the scalar
    0.01."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY

    q_ready = np.asarray(PANDA_Q_READY if q_ready is None else q_ready)
    nj = q_ready.shape[0]
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    x = f(np.concatenate([q_ready[None] + rng.normal(size=(N, nj)) * 0.1,
                          rng.normal(size=(N, nj)) * 0.5], 1))
    u = f(rng.normal(size=(N, nj)) * 2.0)
    dt = f(rng.uniform(0.005, 0.03, N)) if dt_kind == "per_node" else 0.01
    return x, u, dt


def check_step_kernels(model, params, device, ops, sizes=STEP_CHECK_SIZES,
                       q_ready=None, tag=""):
    """K5a and K5b vs their plain versions on the same CUDA inputs, f32, at
    `sizes` (by default every size the Panda's paths launch them at) with
    per-node and scalar dt around `q_ready` (`step_inputs`); each call's
    time and kernel-only time (per-node dt) and bound (`ops(kernel)`, the
    operations per node, `start_counts`), its line labelled `tag`. Returns
    {kernel: {N: numbers}}."""
    from agimus_controller_tpu_torch.ops.cuda_dynamics import StepKernel

    report = {}
    for name, kind, derivs, _ in STEP_KERNELS:
        k = StepKernel(model, params, derivs, device)
        labels = ("xnext", "Fx", "Fu") if derivs else ("xnext",)
        for N in sizes:
            errs = {}
            for dt_kind in ("scalar", "per_node"):
                x, u, dt = step_inputs(N, N + derivs, device, dt_kind,
                                       q_ready)
                run = lambda: k(x, u, dt)
                as_tuple = lambda o: o if derivs else (o,)
                got = as_tuple(run())
                torch.cuda.synchronize()
                # the check's plain call is the one timed (per-node dt last)
                want, plain_ms = cuda_timed_call(lambda: k.plain(x, u, dt))
                for lab, e in check_outputs(
                        f"{name} {tag} N={N} {dt_kind} dt", got, as_tuple(want),
                        labels).items():
                    errs[lab] = max(errs.get(lab, 0.0), e)
            reps = 50 if N <= 6400 else 20
            ms = cuda_time_ms(run, reps=reps)
            prepared, _ = k.prepare(x, u, dt)
            kernel_ms = cuda_time_ms(lambda: k.launch(prepared), reps=reps)
            ops_node = ops(name)
            b_ms, b_by = bound_ms(k, kind, N, ops_node)
            print(f"{name:20s} {tag:8s} N={N:6d}  wrapper {ms:9.4f} ms (kernel "
                  f"only {kernel_ms:9.4f} ms)  plain {plain_ms:9.3f} ms  bound "
                  f"{b_ms:.6f} ms ({b_by}, "
                  f"{ops_node} ops/node)  max abs err "
                  + " ".join(f"{lab}={e:.2e}" for lab, e in errs.items()))
            report.setdefault(name, {})[N] = dict(
                ms=ms, kernel_only_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=max(errs.values()))
    return report


# -- R1, the batch FDDP's Riccati sweep ----------------------------------------
RICCATI_OUTPUTS = ("ks", "Ks", "Qus", "d1", "d2", "bad")


def random_lq(T, B, nj, seed, device="cpu", nx=None):
    """Seeded LQ data of the component sweep, its eleven float64 arguments
    (`riccati_components.backward_components`) for a rigid state (nx = 2 nj,
    nu = nj; `nx` given: another state), time-major and contiguous:
    Fx = I + 0.1 N / sqrt(nx), Fu = 0.1 N, the stage Hessian
    [[lxx, lxu], [lxu^T, luu]] = 0.1 A A^T + 1e-2 I over (nx + nu), the
    terminal lxx = C C^T / nx + 1e-2 I, gaps 0.1 N and reg 10^U(-9, -3) per
    scenario. Where B > 1, scenario 1 has a NaN in Fx at t = T // 2 and,
    where B > 2, scenario 2 an indefinite luu (-1e3 I added), so both must
    come out `bad`. The generator is torch's on `device`, so the card and
    the CPU draw different data from one seed."""
    nx, nu = nx or 2 * nj, nj
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    kw = dict(dtype=torch.float64, device=device)
    N = lambda *s: torch.randn(s, generator=g, **kw)
    eye = lambda n: torch.eye(n, **kw)
    Fx = eye(nx) + 0.1 * N(T, B, nx, nx) / nx ** 0.5
    Fu = 0.1 * N(T, B, nx, nu)
    A = N(T, B, nx + nu, nx + nu)
    H = 0.1 * A @ A.transpose(-1, -2) + 1e-2 * eye(nx + nu)
    C = N(B, nx, nx)
    reg = 10.0 ** (-9.0 + 6.0 * torch.rand(B, generator=g, **kw))
    if B > 1:
        Fx[T // 2, 1, 0, 1] = float("nan")
    if B > 2:
        H[:, 2, nx:, nx:] -= 1e3 * eye(nu)
    c = lambda a: a.contiguous()
    return [c(Fx), c(Fu), N(T, B, nx), N(T, B, nu), c(H[..., :nx, :nx]),
            c(H[..., :nx, nx:]), c(H[..., nx:, nx:]), 0.1 * N(T + 1, B, nx),
            N(B, nx), C @ C.transpose(-1, -2) / nx + 1e-2 * eye(nx), reg]


def riccati_errors(got, want):
    """{output: max |got - want| / max |want|} over the entries of the
    scenarios `want` does not flag `bad`, for ks, Ks, Qus, d1, d2."""
    ok = ~want[5].to(torch.bool).cpu()
    out = {}
    for name, g, w in zip(RICCATI_OUTPUTS[:5], got, want):
        g, w = g.double().cpu(), w.double().cpu()
        rows = ok if g.ndim == 1 else ok.expand(g.shape[:2])
        g, w = g[rows], w[rows]
        out[name] = (float((g - w).abs().max()) / float(w.abs().max())
                     if w.numel() else 0.0)
    return out


def riccati_same_flags(got, want):
    """The two sweeps flag the same scenarios `bad` and agree on which
    entries are finite."""
    if not torch.equal(got[5].cpu().to(torch.bool),
                       want[5].cpu().to(torch.bool)):
        return False
    return all(torch.equal(torch.isfinite(g).cpu(), torch.isfinite(w).cpu())
               for g, w in zip(got[:5], want[:5]))


def riccati_check(where, got, plain, want, outputs=RICCATI_OUTPUTS[:5]):
    """Raises unless the kernel's sweep `got` flags what the float64 sweep
    `want` flags and, on each of `outputs`, errs against it by at most
    twice the plain float32 sweep's error plus `RICCATI_FLOOR`. Returns
    (the kernel's errors, the plain sweep's)."""
    if not (riccati_same_flags(got, want) and riccati_same_flags(plain, want)):
        raise AssertionError(f"{where}: the sweeps flag other scenarios bad "
                             "or other entries non-finite")
    e_got, e_plain = riccati_errors(got, want), riccati_errors(plain, want)
    over = {n: (e_got[n], e_plain[n]) for n in outputs
            if not e_got[n] <= 2 * e_plain[n] + RICCATI_FLOOR}
    if over:
        raise AssertionError(
            f"{where}: error against float64 over twice the plain float32 "
            f"sweep's plus {RICCATI_FLOOR} (kernel, plain): {over}")
    return e_got, e_plain


def riccati_bound_ms(nj, T, B):
    """Least time of one R1 sweep on the card: the larger of the bytes it
    must move (a node's Fx, Fu, lxx, lxu, luu, lx, lu, fs read once and its
    Ks, ks, Qus written once; a scenario's terminal terms, reg, d1, d2) over
    the memory rate and its FMAs (2 flops each) over the fp32 rate: per
    node Vxx Fx and Fx^T M (nx^3 each), Vxx Fu, Fu^T M and Qux^T KK
    (nx^2 nu each), Fu^T N (nx nu^2), the Cholesky (nu^3 / 6), the nx + 1
    solves (nu^2 each), the vector products (2 nx^2 + 2 nx nu + nu^2).
    Returns (ms, "bytes" or "operations")."""
    nx, nu = 2 * nj, nj
    node = 2 * nx * nx + 3 * nx * nu + nu * nu + 2 * nx + 3 * nu
    scenario = nx * nx + 2 * nx + 3  # term_lxx, term_lx, fs[T], reg, d1, d2
    t_bytes = 4 * (T * B * node + B * scenario) / PEAK_BYTES_PER_S
    fma = (2 * nx ** 3 + 3 * nx * nx * nu + nx * nu * nu + nu ** 3 / 6
           + nu * nu * (nx + 1) + 2 * nx * nx + 2 * nx * nu + nu * nu)
    t_ops = 2 * fma * T * B / PEAK_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_riccati_kernels(device):
    """R1 (`ops/cuda_riccati.py`) vs the plain component sweep in float32
    and float64 at `RICCATI_CHECK_SIZES` on `random_lq` data
    (`riccati_check`, every output), each sweep's wrapper and bare-launch
    times, the plain sweep's time and the bound. Returns {(nj, T, B):
    numbers}."""
    from agimus_controller_tpu_torch.ops.cuda_riccati import RiccatiKernel
    from agimus_controller_tpu_torch.solver.riccati_components import (
        backward_components,
    )

    report = {}
    for nj, T, B in RICCATI_CHECK_SIZES:
        a64 = random_lq(T, B, nj, 1000 * nj + 10 * B + T, device)
        a32 = [a.float() for a in a64]
        k = RiccatiKernel(nj, device)
        run = lambda: k(*a32)
        got = run()
        plain, plain_ms = cuda_timed_call(lambda: backward_components(*a32))
        want = backward_components(*a64)
        where = f"R1_riccati nj={nj} T={T} B={B}"
        if got[5].tolist()[:3] != [False, True, True][:B]:
            raise AssertionError(f"{where}: bad flags {got[5][:3].tolist()}")
        e_got, e_plain = riccati_check(where, got, plain, want)
        ok = ~want[5]
        err = max(float((g - p)[ok if g.ndim == 1 else (slice(None), ok)]
                        .abs().max()) for g, p in zip(got[:5], plain[:5]))
        ms = cuda_time_ms(run, reps=20)
        prepared, _ = k.prepare(*a32)
        kernel_ms = cuda_time_ms(lambda: k.launch(prepared), reps=20)
        b_ms, b_by = riccati_bound_ms(nj, T, B)
        print(f"{where:34s} wrapper {ms:9.4f} ms (kernel only "
              f"{kernel_ms:9.4f} ms)  plain {plain_ms:9.3f} ms  bound "
              f"{b_ms:.6f} ms ({b_by})  max abs diff to plain {err:.2e}; "
              "error against f64 (kernel / plain) "
              + " ".join(f"{n}={e_got[n]:.2e}/{e_plain[n]:.2e}"
                         for n in e_got))
        report[(nj, T, B)] = dict(
            ms=ms, kernel_only_ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        del a64, a32, got, plain, want, prepared
    return report


# -- the 8-joint Tiago-Pro arm: K1-K5b at nj = 8 -----------------------------
TIAGO_FRAME = "left_arm_tool_link"
TIAGO_GOAL = (0.10, -0.05, 0.10)  # from the tool at the ready pose
TIAGO_T = 20
# the node counts K1/K2 are checked at: phase 7 (a)'s tick (T x B = 20) and
# one more, ragged against K1's 8 nodes per block
TIAGO_STAGE_SIZES = (20, 21)
# every shape phase 7 (a)'s batch FDDP launches the step kernels at: K5a
# rolls out B = 8 and 1 024 scenarios a step, K5b linearises T x B = 160
# and 20 480 nodes
TIAGO_B = 1024
TIAGO_STEP_SIZES = (8, 160, 1024, 20_480)


def tiago_spec(T: int, frame=TIAGO_FRAME):
    """The Tiago-Pro OCP of the JAX package's second-robot test: state and
    gravity-compensation regularisation and the translation of `frame`
    (the tool; another robot's frame gives that robot the same cost
    model), or of each frame of a tuple (an item "goal_<frame>" each,
    running and terminal: `tiago_full_spec`)."""
    from agimus_controller_tpu_torch.ocp.spec import CostItem, ProblemSpec

    frames = (frame,) if isinstance(frame, str) else tuple(frame)
    name = lambda f: "goal" if isinstance(frame, str) else f"goal_{f}"
    goal = lambda f: dict(kind="frame_translation", update=True, frame=f)
    return ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="ctrl", kind="control_grav", weight=1e-3)) + tuple(
            CostItem(name=name(f), weight=10.0, **goal(f)) for f in frames),
        terminal_costs=tuple(CostItem(name=name(f), weight=100.0, **goal(f))
                             for f in frames),
        horizon=T, dt=0.02)


# -- the full 17-DoF branched Tiago-Pro: K1-K5b at nj = 17 -------------------
TIAGO_FULL_FRAMES = ("left_arm_tool_link", "right_arm_tool_link")
# the full model's armature: the reduced model's 0.05 on every joint
# (`load_tiago_pro` gives the full model none). Without it the wrists'
# inertia (~1e-3 kg m^2) is all their mass matrix holds: the check nodes'
# random torques reach |v+| ~ 200 rad/s in one step, where float32 leaves
# the step past TOL's absolute 2e-5 from its f64 value
# (`examples/full_tiago_f32_step.py`).
TIAGO_FULL_ARMATURE = 0.05
# joints 1-7 of the right arm against the left arm's at one pose: the signs
# that put every link of the right arm at its left twin's place with y
# negated (joints 5 and 7 are 0 in the ready pose)
TIAGO_MIRROR = np.array([-1.0, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0])


def tiago_full_ready():
    """The full Tiago-Pro's ready pose, a 17-vector: the torso lift and the
    left arm at `TIAGO_PRO_Q_READY`'s values, the head at 0, the right arm
    the left's mirror image, (0.15, 0, 0, 0.5, 0.5, -1.2, 1.0, 0.0, 1.1, 0.0,
    -0.5, 0.5, 1.2, 1.0, -0.0, 1.1, -0.0)."""
    from agimus_controller_tpu_torch.models.tiago_pro import TIAGO_PRO_Q_READY

    arm = np.asarray(TIAGO_PRO_Q_READY[1:], dtype=float)
    return np.concatenate([[TIAGO_PRO_Q_READY[0], 0.0, 0.0], arm,
                           TIAGO_MIRROR * arm])


def load_tiago_full(dtype, device):
    """The full 17-DoF Tiago-Pro (`load_tiago_pro(moving_joint_names="all")`)
    with `TIAGO_FULL_ARMATURE` on every joint."""
    from agimus_controller_tpu_torch.models.tiago_pro import load_tiago_pro

    return load_tiago_pro(moving_joint_names="all",
                          armature=np.full(17, TIAGO_FULL_ARMATURE),
                          dtype=dtype, device=device)


def tiago_full_spec(T: int):
    """`tiago_spec` with the translation of both tools: the bimanual
    Tiago-Pro OCP of phase 9 and the nj = 17 kernel checks."""
    return tiago_spec(T, TIAGO_FULL_FRAMES)


def tiago_goal(frame):
    """`TIAGO_GOAL` from the tool of `frame`, its y mirrored for the right
    arm."""
    g = np.asarray(TIAGO_GOAL, dtype=float)
    return g * [1.0, -1.0, 1.0] if frame.startswith("right") else g


def tiago_inputs(spec, model, N, seed, device, q_ready=None):
    """`randomized_inputs` for `tiago_spec`: every ref of the spec drawn
    from the seed (the targets of each frame around (0.3, +-0.3, 0.9), y
    negative for the right arm), x ~ (q_ready + 0.1 N(0, 1), 0.5 N(0, 1))
    around `q_ready` (the Tiago-Pro arm's ready pose by default), u ~
    2 N(0, 1), node times uniform over the horizon."""
    from agimus_controller_tpu_torch.models.tiago_pro import TIAGO_PRO_Q_READY
    from agimus_controller_tpu_torch.ocp.spec import default_references

    q_ready = TIAGO_PRO_Q_READY if q_ready is None else q_ready
    rng = np.random.default_rng(seed)
    Tn, nj = spec.horizon + 1, model.nj
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device)
    refs = default_references(spec, model, dtype=torch.float32, device=device)
    refs["xref"] = f(np.concatenate([np.asarray(q_ready)[None] + rng.normal(
        size=(Tn, nj)) * 0.2, rng.normal(size=(Tn, nj)) * 0.2], 1))
    refs["w_x"] = f(rng.uniform(0.1, 2.0, (Tn, 2 * nj)))
    refs["w_u"] = f(rng.uniform(0.1, 2.0, (Tn, nj)))
    for item in spec.terminal_costs:
        y = -0.3 if item.frame.startswith("right") else 0.3
        refs[f"ee_trans:{item.frame}"] = f(
            rng.normal(size=(Tn, 3)) * 0.2 + np.asarray([0.3, y, 0.9]))
        refs[f"w_ee:{item.frame}"] = f(rng.uniform(0.1, 2.0, (Tn, 6)))
    x, u, _ = step_inputs(N, seed, device, "scalar", q_ready)
    t_idx = torch.as_tensor(rng.integers(0, spec.horizon, size=(N,)),
                            device=device)
    dt = f(spec.timesteps())[t_idx]
    return refs, x, u, dt, t_idx


def check_all_kernels(device):
    """Phase 3: K1-K5b vs their plain versions on the Panda, every checked
    spec at every size its paths launch them at, their nj = 8 instances
    on the Tiago-Pro arm (`tiago_spec`) at phase 7 (a)'s sizes and their
    nj = 17 instances on the full Tiago-Pro (`tiago_full_spec`) at phase 9's,
    the same: K1/K2 at `TIAGO_STAGE_SIZES`, K3/K4 at N = 1, K5a/K5b at
    `TIAGO_STEP_SIZES`; then R1 (`check_riccati_kernels`). The bounds'
    operations are counted on the host by worker processes meanwhile
    (`start_counts`). Returns (K1-K4 {kernel: {spec: {N: numbers}}},
    K5a/K5b and R1 {kernel: {N, (robot, N) or (nj, T, B): numbers}}): the
    Tiago-Pro sizes' errors join each kernel's."""
    from agimus_controller_tpu_torch.models.panda import load_panda
    from agimus_controller_tpu_torch.models.tiago_pro import (
        TIAGO_PRO_Q_READY,
        load_tiago_pro,
    )

    model, params = load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                               dtype=torch.float32, device=device)
    pool, counts = start_counts()
    try:
        report, plain_s = check_kernels(
            model, params, device,
            lambda sp, name: counts[("panda", sp, name)].result())
        step_report = check_step_kernels(
            model, params, device,
            lambda name: counts[("panda", None, name)].result())
        tiago_sizes = lambda _, kind: (TIAGO_STAGE_SIZES if kind == "stage"
                                       else (1,))
        for robot, load, make_spec, q_ready in (
                ("tiago", load_tiago_pro, tiago_spec, TIAGO_PRO_Q_READY),
                ("tiago17", load_tiago_full, tiago_full_spec,
                 tiago_full_ready())):
            tiago = load(dtype=torch.float32, device=device)
            t0 = time.perf_counter()
            tiago_report, tiago_plain_s = check_kernels(
                *tiago, device,
                lambda sp, name: counts[(robot, sp, name)].result(),
                {robot: make_spec(TIAGO_T)}, tiago_sizes,
                lambda *a: tiago_inputs(*a, q_ready),
                timed=(robot, TIAGO_STAGE_SIZES[0], 1))
            for name, per_spec in tiago_report.items():
                report[name].update(per_spec)
            plain_s += tiago_plain_s
            for name, per_n in check_step_kernels(
                    *tiago, device,
                    lambda name: counts[(robot, None, name)].result(),
                    TIAGO_STEP_SIZES, q_ready, robot).items():
                step_report[name].update({(robot, n): v
                                          for n, v in per_n.items()})
            print(f"phase 3: nj={tiago[0].nj} ({robot}) K1-K5b checked in "
                  f"{time.perf_counter() - t0:.1f} s")
        print(f"phase 3: K1-K4 plain calls (stacked, checks and timed) "
              f"{plain_s:.1f} s")
    finally:
        pool.shutdown(cancel_futures=True)
    step_report["R1_riccati"] = check_riccati_kernels(device)
    return report, step_report


def build_slice(device, n_ticks: int = 60, spec=None, keep_away=False):
    """The runtime bench scenario through the port: a PackedTrajectoryBuffer
    streaming a fixed end-effector goal and a FusedTickRunner over it, Panda,
    T=100, f32, plus the drifting measured states of the chain. `spec`
    replaces `flagship_spec(100)`; with `keep_away`, the points also stream
    link 7's keep-away point (`KEEP_AWAY` from link 7 at the ready pose) for
    `keep_away_spec`. Returns a namespace (runner, x0, xs_init, us_init,
    x0_seq, goal, ee_pose, p7, away)."""
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

    from agimus_controller_tpu_torch.ops.kinematics import frame_placement

    T, dtype = 100, torch.float32
    model, params = load_panda(dtype=dtype, device=device)
    spec = flagship_spec(T) if spec is None else spec
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
    fid7 = model.frame_id("panda_link7")
    p7 = lambda q: frame_placement(model, params64, torch.as_tensor(
        q, dtype=torch.float64), fid7)[1].numpy()
    R7 = frame_placement(model, params64, torch.as_tensor(q0), fid7)[0].numpy()
    away = p7(q0) + np.asarray(KEEP_AWAY)
    z = [torch.zeros(1, dtype=torch.float64)] * 7
    tau_g = np.array([float(t) for t in _rnea_c(
        sm64, [torch.as_tensor(q0[i:i + 1]) for i in range(7)], z, z)])
    goal = p0 + np.asarray([0.05, -0.05, 0.08])

    def mk(i):
        poses = {"panda_hand_tcp": (R0, goal)}
        if keep_away:
            poses["panda_link7"] = (R7, away)
        pt = TrajectoryPoint(
            id=i, time_ns=int(i * 1e7), robot_configuration=q0,
            robot_velocity=np.zeros(7), robot_acceleration=np.zeros(7),
            robot_effort=tau_g, end_effector_poses=poses)
        w = TrajectoryPointWeights(
            w_robot_configuration=np.full(7, 0.1),
            w_robot_velocity=np.full(7, 1.0),
            w_robot_effort=np.ones(7),
            w_end_effector_poses={f: np.ones(6) for f in poses})
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
        ee_pose=ee_pose, p7=p7, away=away)


def run_slice(device):
    """Drive the main path: the first solve at limit 300, 60 ticks at
    limit 2 with a drifting x0 (20 settling, 2 timed chunks of 20), one
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
    per_tick = [run_chunk(20 + 20 * j, 20) for j in range(2)]
    syncs_per_tick = (solver.host_syncs - syncs0) / 40
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
        f"conv={conv0}; tick median {tick_ms:.3f} ms over 2x20 ticks at "
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
# the horizon-parallel sweep's B = 8 solve against the component one's: xs,
# f32. The same rows on the CPU in f32 (the plain step versions) differ by
# 4.5e-5 with equal iterations and flags; the bound leaves ~20x that for
# the card's different rounding.
PSCAN_XS_TOL = 1e-3
BATCH_GOAL = (0.1, 0.05, -0.05)  # from the end effector at the ready pose
BATCH_X0_NOISE = 0.02  # rad on q, per scenario and variant
BATCH_VARIANTS = 3  # x0 variants timed (the JAX bench times 5)


def build_batch(device, n_variants: int = BATCH_VARIANTS):
    """The batch problem: `flagship_spec(100)`, dt 0.01, f32, 10 iterations,
    the goal FK(ready) + BATCH_GOAL, xs tiled from the ready state, us zero,
    x0 variants ready + N(0, 0.02^2) on q (seed 0). Returns a namespace
    (solver, the same solver on the horizon-parallel sweep `pscan`, refs,
    variants [B, nx] each, xs0, us0, goal, ee_dist)."""
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
    pscan = make_batch_fddp(model, params, spec, SolverSettings(max_iters=10),
                            riccati="pscan", device=device)
    ee_dist = lambda xs: np.linalg.norm(
        ee_pose(xs[:, -1, :7].double().cpu())[1] - goal, axis=1)
    return SimpleNamespace(
        solver=solver, pscan=pscan, refs=refs, variants=variants, goal=goal,
        xs0=f(np.tile(x0[None, None], (B, T + 1, 1))),
        us0=torch.zeros((B, T, 7), dtype=dtype, device=device),
        ee_dist=ee_dist)


def solve_rows(bp, x0s, solver=None):
    """One batch solve from the first len(x0s) scenarios' starts (by
    `bp.solver` unless `solver` is given)."""
    n = x0s.shape[0]
    return (solver or bp.solver)(x0s, bp.refs, bp.xs0[:n], bp.us0[:n])


def batch_phases(bp, sol, device):
    """Host-clock time (ms, synchronized) of each part of one FDDP
    iteration at the solution's iterate: the K5b linearisation,
    the cost pack over T*B nodes and the terminal pack, the plain component
    Riccati sweep, and one line-search trial (T K5a steps, then the trial
    cost of all nodes) with its two parts; and on the plain sweep's inputs
    the sweep kernel the solver runs (`ops/cuda_riccati.py`), its Ks held
    to the float64 sweep's (`riccati_check`), and the horizon-parallel sweep
    (`riccati_pscan.parallel_riccati`), each with its largest gain
    difference to the plain sweep."""
    from agimus_controller_tpu_torch.solver.riccati_components import (
        backward_components,
    )
    from agimus_controller_tpu_torch.solver.riccati_pscan import (
        parallel_riccati,
    )

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
    _, Fx, Fu = dyn
    _, lx, lu, lxx, lxu, luu = costs
    sweep = (Fx, Fu, lx, lu, lxx, lxu, luu, fs, term[1], term[2], reg)
    out["Riccati sweep"], plain = timed(lambda: backward_components(*sweep))
    ks, Ks = plain[:2]
    # the sweep kernel and the horizon-parallel sweep on the same
    # linearisation; the kernel's gains held to the float64 sweep's by
    # `riccati_check` (at T = 100 both float32 sweeps drift from it, ROADMAP
    # queue 3: Ks, the drift's measure, is the output held here)
    out["Riccati sweep (kernel)"], got = timed(lambda: s.riccati_k(*sweep))
    ks_k, Ks_k = got[:2]
    e_got, e_plain = riccati_check(
        "batch path phases", got, plain,
        backward_components(*(a.double() for a in sweep)), ("Ks",))
    out["kernel Ks error to f64"] = e_got["Ks"]
    out["plain Ks error to f64"] = e_plain["Ks"]
    out["kernel max |dks|"] = float((ks_k - ks).abs().max())
    out["kernel max |dKs|"] = float((Ks_k - Ks).abs().max())
    out["kernel max |dKs| / max |Ks|"] = (out["kernel max |dKs|"]
                                          / float(Ks.abs().max()))
    out["Riccati sweep (pscan)"], (ks_p, Ks_p, *_) = timed(
        lambda: parallel_riccati(lx, lu, lxx, lxu, luu, Fx, Fu, fs, term[1],
                                 term[2], reg))
    out["pscan max |dks|"] = float((ks_p - ks).abs().max())
    out["pscan max |dKs|"] = float((Ks_p - Ks).abs().max())
    out["pscan max |dKs| / max |Ks|"] = (out["pscan max |dKs|"]
                                         / float(Ks.abs().max()))
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
    for k in solver.kernels + bp.pscan.kernels:
        k.launches = 0
    t0 = time.perf_counter()
    small = solve_rows(bp, bp.variants[0][:BATCH_ROWS])
    _sync(device)
    small_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    small_p = solve_rows(bp, bp.variants[0][:BATCH_ROWS], bp.pscan)
    _sync(device)
    pscan_s = time.perf_counter() - t0
    times, sols, syncs = [], [], []
    for x0s in bp.variants:
        s0 = solver.host_syncs
        t0 = time.perf_counter()
        sols.append(solve_rows(bp, x0s))
        _sync(device)
        times.append(time.perf_counter() - t0)
        syncs.append(solver.host_syncs - s0)
    launches = {name: k.launches + kp.launches for (name, *_), k, kp in
                zip(FDDP_KERNELS, solver.kernels, bp.pscan.kernels)}
    # every component sweep of the solves (one an iteration, one for the
    # report) went to R1, none to the plain sweep
    sweeps = sum(int(x.iters.max()) + 1 for x in [small] + sols)
    if solver.riccati_k.launches != sweeps:
        raise AssertionError(
            f"batch path: R1 launched {solver.riccati_k.launches} times "
            f"for {sweeps} component sweeps")

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
    if not (torch.equal(small_p.iters, small.iters)
            and torch.equal(small_p.converged, small.converged)):
        raise AssertionError(
            f"batch path: the pscan B={BATCH_ROWS} solve (iters "
            f"{small_p.iters.tolist()}, converged "
            f"{small_p.converged.tolist()}) differs from the component one "
            f"(iters {small.iters.tolist()}, converged "
            f"{small.converged.tolist()})")
    dx_p = float((small_p.xs - small.xs).abs().max())
    if not dx_p < PSCAN_XS_TOL:
        raise AssertionError(
            f"batch path: the pscan B={BATCH_ROWS} solve's xs differ from "
            f"the component one's by {dx_p:.3e} (bound {PSCAN_XS_TOL})")
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
        f"batch path (B={BATCH_ROWS}, riccati=\"pscan\"): {pscan_s:.2f} s, "
        f"iters and convergence flags equal to the component solve's; xs "
        f"max abs diff {dx_p:.3e} (bound {PSCAN_XS_TOL})",
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
        + "; ".join(f"{k} {v:.3f}" if k.startswith(("Riccati", "K5b",
                                                     "cost", "terminal",
                                                     "trial"))
                    else f"{k} {v:.3e}" for k, v in phases.items())]


# -- phase 5: the fallback backend and the single-scenario solvers ----------
# link 7's keep-away point, from link 7 at the ready pose: away from where
# the goal takes the arm. quad_exp is repulsive (exp(-|r|^2 / alpha) falls
# off with the distance): at alpha 5e-3 the 6.9 cm start distance gives
# 0.38 of the peak, so the term is not flat at the start
KEEP_AWAY = (-0.04, 0.04, -0.04)
KEEP_AWAY_ALPHA = 5e-3
# a posture to keep away from (state under quad_exp, alpha 0.1): the ready
# state with joints 1-3 moved 0.15 rad, 0.51 of the peak at the start
POSTURE_SHIFT = (0.15, 0.15, -0.15, 0.0, 0.0, 0.0, 0.0)
POSTURE_ALPHA = 0.1
FALLBACK_ROWS, FALLBACK_B = 8, 64


def keep_away_spec(T: int, posture=None):
    """The flagship spec plus link 7 kept away from a streamed point
    (`frame_translation` under quad_exp, running and terminal): the stage
    kernels decline the activation on a non-collision item, the batched
    cost pack takes it. With `posture` (a state [14]) also a static
    posture kept away from (`state` under quad_exp): the pack declines that
    too, so the costs come from `CostFunctions`."""
    import dataclasses

    from agimus_controller_tpu_torch.ocp.spec import CostItem

    s = flagship_spec(T)
    away = CostItem(name="keep_away", kind="frame_translation", weight=10.0,
                    update=True, frame="panda_link7", activation="quad_exp",
                    act_alpha=KEEP_AWAY_ALPHA)
    extra = (away,)
    if posture is not None:
        extra += (CostItem(name="posture_away", kind="state", weight=1.0,
                           static_ref=tuple(float(v) for v in posture),
                           activation="quad_exp", act_alpha=POSTURE_ALPHA),)
    return dataclasses.replace(s, running_costs=s.running_costs + extra,
                               terminal_costs=s.terminal_costs + (away,))


def avoided_posture():
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY

    return np.concatenate([np.asarray(PANDA_Q_READY)
                           + np.asarray(POSTURE_SHIFT), np.zeros(7)])


def _median_ms(times):
    return float(np.median(times)) * 1e3


def run_fallback_tick(device, posture: bool, n_ticks: int):
    """Part (a) (`posture` False: the pack route) or (b) (True: the
    `CostFunctions` route): a declined spec through `FusedTickRunner` on the
    "xla" backend, the first solve at limit 300, `n_ticks` ticks at limit 2
    with a drifting x0, one final tick at limit 10. Returns (launches of
    K5a/K5b on the ticks, summary line)."""
    from agimus_controller_tpu_torch.ocp.costs import CostFunctions
    from agimus_controller_tpu_torch.ops.batched_costs import BatchedCostPack

    spec = keep_away_spec(100, avoided_posture() if posture else None)
    sl = build_slice(device, n_ticks=n_ticks + 1, spec=spec, keep_away=True)
    runner, solver = sl.runner, sl.runner.solver
    part = "(b)" if posture else "(a)"
    route = CostFunctions if posture else BatchedCostPack
    if solver.backend != "xla" or not isinstance(solver.costs, route):
        raise AssertionError(
            f"fallback {part}: backend {solver.backend!r} with "
            f"{type(getattr(solver, 'costs', None)).__name__}, expected 'xla' "
            f"with {route.__name__}")
    if hasattr(solver, "stage_dk") or hasattr(solver, "term_dk"):
        raise AssertionError(f"fallback {part}: the solver holds K1-K4")
    for k in solver.kernels:
        k.launches = 0
    t0 = time.perf_counter()
    runner.initialize(sl.x0, sl.xs_init, sl.us_init, limit=300)
    _, _, kkt0, it0, conv0 = runner.fetch()
    first_s = time.perf_counter() - t0
    after_init = [k.launches for k in solver.kernels]
    syncs0 = solver.host_syncs
    times = []
    for i in range(n_ticks):
        t0 = time.perf_counter()
        runner.step(sl.x0_seq[i], limit=2)
        _sync(device)
        times.append(time.perf_counter() - t0)
    syncs = (solver.host_syncs - syncs0) / n_ticks
    runner.step(sl.x0_seq[n_ticks], limit=10)
    K0, u0, kkt, iters, conv = runner.fetch()
    launches = {name: k.launches for (name, *_), k in
                zip(STEP_KERNELS, solver.kernels)}
    for (name, n), a in zip(launches.items(), after_init):
        if not n > a:
            raise AssertionError(
                f"fallback {part}: {name} was not launched during the ticks")
    if not (np.all(np.isfinite(u0)) and np.all(np.isfinite(K0))):
        raise AssertionError(f"fallback {part}: non-finite control message")
    if not (conv and kkt < 1e-4):
        raise AssertionError(
            f"fallback {part}: final tick did not converge (kkt={kkt:.2e})")
    xT = runner._xs[-1].double().cpu().numpy()
    _, pT = sl.ee_pose(xT[:7])
    ee_err = float(np.linalg.norm(pT - sl.goal))
    away = float(np.linalg.norm(sl.p7(xT[:7]) - sl.away))
    if not posture and not ee_err < 0.02:
        raise AssertionError(
            f"fallback (a): terminal EE error {ee_err:.4f} m >= 0.02 m")
    return launches, (
        f"fallback {part} tick, backend {solver.backend} with "
        f"{type(solver.costs).__name__}: first solve {first_s:.2f} s, "
        f"iters={it0} kkt={kkt0:.2e} conv={conv0}; tick median "
        f"{_median_ms(times):.3f} ms over {n_ticks} ticks at limit 2 (host "
        f"clock, synchronized); {syncs:.2f} host syncs per tick; final tick "
        f"iters={iters} kkt={kkt:.2e} conv={conv}; terminal EE error "
        f"{ee_err * 1e3:.2f} mm; link 7 {away * 1e3:.2f} mm from its "
        f"keep-away point (start {np.linalg.norm(KEEP_AWAY) * 1e3:.1f} mm); "
        f"K1-K4 launches 0 (no stage kernel built); launches {launches}")


def keep_away_refs(spec, model, device, dtype=torch.float32):
    """Fixed refs of `keep_away_spec`: the ready state, the hand's goal
    `BATCH_GOAL` from its ready pose, link 7's keep-away point."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.ocp.spec import default_references
    from agimus_controller_tpu_torch.ops.kinematics import frame_placement

    _, params64 = load_panda(dtype=torch.float64, device="cpu")
    q0 = np.asarray(PANDA_Q_READY)
    pose = lambda f: [a.numpy() for a in frame_placement(
        model, params64, torch.as_tensor(q0), model.frame_id(f))]
    R0, p0 = pose("panda_hand_tcp")
    R7, p7 = pose("panda_link7")
    tile = lambda a: torch.as_tensor(np.tile(
        np.asarray(a)[None], (spec.horizon + 1,) + (1,) * np.ndim(a)),
        dtype=dtype, device=device)
    refs = default_references(spec, model, dtype=dtype, device=device)
    refs["xref"] = tile(np.concatenate([q0, np.zeros(7)]))
    refs["ee_rot:panda_hand_tcp"] = tile(R0)
    refs["ee_trans:panda_hand_tcp"] = tile(p0 + np.asarray(BATCH_GOAL))
    refs["ee_rot:panda_link7"] = tile(R7)
    refs["ee_trans:panda_link7"] = tile(p7 + np.asarray(KEEP_AWAY))
    return refs


def run_fallback_fddp(device):
    """Part (b), batch: `make_batch_fddp` on the `CostFunctions` spec,
    T=100, f32, 10 iterations at most, a B=8 solve of rows 0-7 then B=64,
    x0 = ready + N(0, 0.02^2) on q. Returns (launches, summary line)."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.ocp.costs import CostFunctions
    from agimus_controller_tpu_torch.solver.fddp import SolverSettings
    from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp

    T, dtype = 100, torch.float32
    model, params = load_panda(dtype=dtype, device=device)
    spec = keep_away_spec(T, avoided_posture())
    x0 = np.concatenate([np.asarray(PANDA_Q_READY), np.zeros(7)])
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    refs = keep_away_refs(spec, model, device)
    rng = np.random.default_rng(0)
    x0s = f(x0[None] + np.concatenate(
        [rng.normal(size=(FALLBACK_B, 7)) * BATCH_X0_NOISE,
         np.zeros((FALLBACK_B, 7))], 1))
    xs0 = f(np.tile(x0[None, None], (FALLBACK_B, T + 1, 1)))
    us0 = torch.zeros((FALLBACK_B, T, 7), dtype=dtype, device=device)
    solver = make_batch_fddp(model, params, spec, SolverSettings(max_iters=10),
                             device=device)
    if not isinstance(solver.pack, CostFunctions):
        raise AssertionError("fallback (b) batch: the cost pack took the spec")
    for k in solver.kernels:
        k.launches = 0
    n = FALLBACK_ROWS
    t0 = time.perf_counter()
    small = solver(x0s[:n], refs, xs0[:n], us0[:n])
    _sync(device)
    small_s = time.perf_counter() - t0
    s0 = solver.host_syncs
    t0 = time.perf_counter()
    big = solver(x0s, refs, xs0, us0)
    _sync(device)
    big_s = time.perf_counter() - t0
    launches = {name: k.launches for (name, *_), k in
                zip(FDDP_KERNELS, solver.kernels)}
    for field in ("xs", "us", "K", "k", "cost", "kkt", "gap_norm"):
        if not bool(torch.isfinite(getattr(big, field)).all()):
            raise AssertionError(f"fallback (b) batch: non-finite {field}")
    rows = slice(0, n)
    du = float((big.us[rows] - small.us).abs().max())
    if not (torch.equal(big.iters[rows], small.iters)
            and torch.equal(big.converged[rows], small.converged)
            and du < 1e-3):
        raise AssertionError(
            f"fallback (b) batch: rows 0-{n - 1} of B={FALLBACK_B} (iters "
            f"{big.iters[rows].tolist()}) differ from the B={n} solve (iters "
            f"{small.iters.tolist()}), us max abs diff {du:.3e}")
    for name, c in launches.items():
        if c <= 0:
            raise AssertionError(f"fallback (b) batch: {name} not launched")
    c = lambda a: a.double().cpu().numpy()
    return launches, (
        f"fallback (b) batch FDDP with {type(solver.pack).__name__}, T={T}, "
        f"f32: B={n} {small_s:.2f} s, iters {small.iters.tolist()}; "
        f"B={FALLBACK_B} {big_s:.3f} s (host clock, synchronized), mean "
        f"iterations {float(c(big.iters).mean()):.2f}, converged share "
        f"{float(c(big.converged).mean()):.4f}, kkt max "
        f"{float(c(big.kkt).max()):.3e}, {solver.host_syncs - s0} host syncs; "
        f"rows 0-{n - 1} match the B={n} solve (us max abs diff {du:.3e}); "
        f"launches {launches}")


def _collision_problem(device, B):
    """Part (c)'s problem: the collision path's OCP (`yaml_spec(19)`, its
    obstacle and goal weight 2700) with fixed refs, x0 = ready + N(0,
    0.02^2) on q for B rows."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.ocp.spec import default_references
    from agimus_controller_tpu_torch.ops.dynamics import generalized_gravity
    from agimus_controller_tpu_torch.ops.kinematics import frame_placement

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
    tau_g = generalized_gravity(model, params64, torch.as_tensor(q0)).numpy()
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    tile = lambda a: f(np.tile(np.asarray(a)[None], (T + 1,) + (1,) * np.ndim(a)))
    refs = default_references(spec, model, dtype=dtype, device=device)
    refs["xref"] = tile(x0)
    refs["w_x"] = tile(np.concatenate([np.full(7, 0.1), np.ones(7)]))
    refs["uref"] = tile(tau_g)
    refs["ee_rot:panda_hand_tcp"] = tile(R0)
    refs["ee_trans:panda_hand_tcp"] = tile([0.45, 0.05, 0.50])
    refs["w_ee:panda_hand_tcp"] = tile(np.full(6, 2700.0))
    rng = np.random.default_rng(0)
    x0s = x0[None] + 0.02 * np.concatenate(
        [rng.normal(size=(B, 7)), np.zeros((B, 7))], 1)
    return (model, params, spec, refs, f(x0s),
            f(np.tile(x0s[:, None], (1, T + 1, 1))),
            f(np.tile(tau_g[None, None], (B, T, 1))))


# part (c)/(d) agreement: the bounds of the JAX tests the parts follow
# (f64), and the bound checked in f32 on the card where f32 does not reach
# them. (d) on an H100 (PERF.md): us 3.6e-4 and cost 1.1e-6 apart at 12
# iterations, 8.3e-4 and 6.8e-7 at 4, on controls up to tens of N m: both
# solvers reach kkt ~4e-8, f32's noise floor, by the 4th iteration, and
# the two f32 routes to the derivatives (K5b and the cost pack against
# `jacrev` of the plain step and costs) leave that much between their
# iterates; checked at 5e-3 on us and 1e-5 on the cost
SINGLE_BOUNDS = {"(c)": dict(f64=(5e-5, 1e-5), check=(5e-5, 1e-5)),
                 "(d)": dict(f64=(2e-6, 1e-6), check=(5e-3, 1e-5))}


def _agreement(part, du, dcost):
    """Summary of one part's agreement; raises outside the checked bound."""
    (fa, fr), (ca, cr) = (SINGLE_BOUNDS[part][k] for k in ("f64", "check"))
    line = (f"us max abs diff {du:.3e}, cost max rel diff {dcost:.3e}: "
            f"f64 bounds ({fa:g}, {fr:g}) "
            f"{'met' if du <= fa and dcost <= fr else 'not met'} in f32")
    if not (du <= ca and dcost <= cr):
        raise AssertionError(f"single {part}: {line}; checked at ({ca:g}, "
                             f"{cr:g})")
    return line + ("" if (ca, cr) == (fa, fr) else
                   f", checked at ({ca:g}, {cr:g})")


def run_single_csqp(device, rows: int, settings: dict):
    """Part (c): `solve_csqp` over `CostFunctions` against the
    kernel-backed `BatchSQP`, row by row, with `tests/test_sqp_batch.py`'s
    settings but `max_qp_iters` from `settings`. Returns (launches of
    K1-K4, summary line)."""
    from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings, solve_csqp
    from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp

    model, params, spec, refs, x0s, xs0, us0 = _collision_problem(device, rows)
    s = CSQPSettings(**settings)
    batch = make_batch_sqp(model, params, spec, s, device=device)
    if batch.backend != "kernels":
        raise AssertionError(f"single (c): batch backend {batch.backend!r}")
    cf = build_cost_functions(model, params, spec)
    for k in batch.kernels:
        k.launches = 0
    t0 = time.perf_counter()
    sol_b = batch(x0s, refs, xs0, us0)
    _sync(device)
    batch_s = time.perf_counter() - t0
    launches = {name: k.launches for (name, *_), k in
                zip(STAGE_KERNELS, batch.kernels)}
    times, sols = [], []
    for i in range(rows):
        t0 = time.perf_counter()
        sols.append(solve_csqp(cf, x0s[i], refs, xs0[i], us0[i], s))
        _sync(device)
        times.append(time.perf_counter() - t0)
    for sol in sols + [sol_b]:
        if not (bool(torch.isfinite(sol.us).all())
                and bool(torch.isfinite(sol.cost).all())):
            raise AssertionError("single (c): non-finite solution")
    if not float(sol_b.constraint_norm.max()) < 1e-3:
        raise AssertionError("single (c): batch solution violates the band")
    du = max(float((sol_b.us[i] - sols[i].us).abs().max()) for i in range(rows))
    dc = max(abs(float(sol_b.cost[i] - sols[i].cost)) / abs(float(sols[i].cost))
             for i in range(rows))
    agree = _agreement("(c)", du, dc)
    return launches, (
        f"single (c) solve_csqp on yaml_spec(19), f32, {rows} rows, "
        f"max_iters {s.max_iters}, max_qp_iters {s.max_qp_iters}, fixed rho: "
        f"solve median {_median_ms(times):.1f} ms (host clock, synchronized), "
        f"iters {[int(x.iters) for x in sols]}, ADMM iterations "
        f"{[int(x.qp_iters) for x in sols]}, host syncs "
        f"{[x.host_syncs for x in sols]}, backend CostFunctions; BatchSQP "
        f"(backend {batch.backend}) B={rows} {batch_s * 1e3:.1f} ms, iters "
        f"{sol_b.iters.tolist()}, ADMM {sol_b.qp_iters.tolist()}, "
        f"{batch.host_syncs} host syncs; {agree}; launches {launches}")


def run_single_fddp(device, rows: int, max_iters: int):
    """Part (d): `solve_fddp` over `CostFunctions` against `BatchFDDP` (the
    pack and K5a/K5b) on the flagship spec at T=100, f32, from `rows` x0
    rows of `build_batch`'s first variant, `tests/test_fddp_batch.py`'s
    settings but `max_iters`. Returns (launches of K5a, K5b and R1,
    summary line)."""
    from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
    from agimus_controller_tpu_torch.solver.fddp import SolverSettings, solve_fddp
    from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp
    from agimus_controller_tpu_torch.models.panda import load_panda

    bp = build_batch(device, n_variants=1)
    model, params = load_panda(dtype=torch.float32, device=device)
    spec = flagship_spec(BATCH_T)
    s = SolverSettings(max_iters=max_iters, termination_tolerance=1e-8)
    batch = make_batch_fddp(model, params, spec, s, device=device)
    cf = build_cost_functions(model, params, spec)
    x0s, xs0, us0 = bp.variants[0][:rows], bp.xs0[:rows], bp.us0[:rows]
    for k in batch.kernels:
        k.launches = 0
    t0 = time.perf_counter()
    sol_b = batch(x0s, bp.refs, xs0, us0)
    _sync(device)
    batch_s = time.perf_counter() - t0
    launches = {name: k.launches for (name, *_), k in
                zip(FDDP_KERNELS, batch.kernels)}
    times, sols = [], []
    for i in range(rows):
        t0 = time.perf_counter()
        sols.append(solve_fddp(cf, x0s[i], bp.refs, xs0[i], us0[i], s))
        _sync(device)
        times.append(time.perf_counter() - t0)
    for sol in sols + [sol_b]:
        if not (bool(torch.isfinite(sol.us).all())
                and bool(torch.isfinite(sol.cost).all())):
            raise AssertionError("single (d): non-finite solution")
    du = max(float((sol_b.us[i] - sols[i].us).abs().max()) for i in range(rows))
    dc = max(abs(float(sol_b.cost[i] - sols[i].cost)) / abs(float(sols[i].cost))
             for i in range(rows))
    agree = _agreement("(d)", du, dc)
    dist = bp.ee_dist(torch.stack([x.xs for x in sols]))
    return launches, (
        f"single (d) solve_fddp on flagship_spec({BATCH_T}), f32, {rows} rows, "
        f"max_iters {max_iters}: solve median {_median_ms(times):.1f} ms (host "
        f"clock, synchronized), iters {[int(x.iters) for x in sols]}, host "
        f"syncs {[x.host_syncs for x in sols]}, kkt "
        f"{[f'{float(x.kkt):.2e}' for x in sols]}, backend CostFunctions, "
        f"terminal EE distance to the goal (mm) "
        + " ".join(f"{d * 1e3:.2f}" for d in dist)
        + f"; max |us| {float(sol_b.us.abs().max()):.2f}"
        + f"; BatchFDDP B={rows} {batch_s * 1e3:.1f} ms, iters "
        f"{sol_b.iters.tolist()}; {agree}; launches {launches}")


def run_fallback_phase(device, n_ticks_a=10, n_ticks_b=4, csqp_rows=1,
                       csqp_qp_iters=50, fddp_rows=2, fddp_iters=4):
    """Phase 5: (a), (b) and its batch FDDP, (c), (d), with the ticks and
    iterations cut to keep the phase near 2 minutes on the card (the JAX
    tests run (c) at 200 ADMM iterations and 3 rows, (d) at 12
    iterations). Returns (launches per kernel, summary lines)."""
    launches = {name: 0 for name, *_ in KERNELS}
    lines = []
    parts = [
        lambda: run_fallback_tick(device, False, n_ticks_a),
        lambda: run_fallback_tick(device, True, n_ticks_b),
        lambda: run_fallback_fddp(device),
        lambda: run_single_csqp(device, csqp_rows, dict(
            max_iters=20, max_qp_iters=csqp_qp_iters, eps_abs=1e-10,
            termination_tolerance=1e-8, rho=1e-1, adaptive_rho=False,
            soc_iters=0, constraint_envelope=False)),
        lambda: run_single_fddp(device, fddp_rows, fddp_iters),
    ]
    for part in parts:
        t0 = time.perf_counter()
        path_launches, line = part()
        lines.append(f"{line} [{time.perf_counter() - t0:.1f} s]")
        for name, n in path_launches.items():
            launches[name] += n
    return launches, lines


# -- phase 6: the reference-shaped control loop ------------------------------
# examples/pick_and_place.py's and examples/dummy_mpc.py's loop: the Panda
# (7 DoF), T = 20, dt = 0.01 s, f32, every object built through the port's
# entry points on the card (the model factory, the engine config, the OCP
# registry, the warm starts, MPC, ControllerRuntime)
P6_JOINTS = tuple(f"panda_joint{i}" for i in range(1, 8))
P6_T, P6_DT = 20, 0.01
P6_COLLISION_T = 19  # the shipped collision YAML's horizon
# examples/pick_and_place.py: the pick and place poses as offsets from the
# ready pose, the three quintic moves (home -> pick -> place -> home) and
# their durations (s), and the generator's weights
PICK_OFFSET = (0.5, 0.3, 0.0, -0.3, 0.0, 0.2, 0.0)
PLACE_OFFSET = (-0.6, 0.25, 0.1, -0.2, 0.1, 0.3, -0.4)
MOVE_DURATIONS = (1.5, 2.0, 1.5)
PICK_PLACE_WEIGHTS = dict(w_q=(5.0,) * 7, w_qdot=(1.0,) * 7,
                          w_qddot=(0.0,) * 7, w_robot_effort=(1e-3,) * 7,
                          w_pose=(20.0,) * 6)
PICK_PLACE_TICKS = 60
RING_TICKS = 30
SINE_TICKS = 30
COLLISION_TICKS = 10
# the environment of phase 6 in the reference's xacro form (expanded by the
# port's `models/xacro.py`): phase 4's obstacle sphere on a fixed joint
P6_ENV_XACRO = """<?xml version="1.0"?>
<robot xmlns:xacro="http://www.ros.org/wiki/xacro" name="env">
  <xacro:property name="radius" value="0.1"/>
  <xacro:property name="height" value="0.5"/>
  <link name="obstacle_base"/>
  <joint name="obstacle_joint" type="fixed">
    <parent link="obstacle_base"/><child link="obstacle"/>
    <origin xyz="0.5 0.0 ${height}" rpy="0 0 0"/>
  </joint>
  <link name="obstacle">
    <collision name="obstacle_sphere">
      <geometry><sphere radius="${radius}"/></geometry>
    </collision>
  </link>
</robot>
"""
# the JAX package's run of loop (a) (`examples/pick_and_place_reference.py`,
# on the CPU in f32, jax 0.9.0): the largest joint tracking error over its
# 60 ticks, rad (mean 0.003882). The card's run must stay within 2x of it
# plus 0.01 rad.
JAX_PICK_PLACE_MAX_ERR = 0.008432
# (b): the ring's solve against the host-packed one, us (f32)
RING_HOST_TOL = 1e-4


def engine_values(horizon: int, **ocp):
    """An engine configuration in the reference's values layout
    (`agimus_controller_params`), for `load_engine_config`: dt 0.01,
    `max_iter` 10, `max_solve_time` 10.0 s (the JAX closed-loop test's), the
    Panda's armature, phase 4's collision pair, and any `ocp` entry
    given."""
    return {"agimus_controller_params": {
        "rate": 100.0, "constant_delay": False,
        "ocp": {"dt": P6_DT, "horizon_size": horizon,
                "dt_factor_n_seq": {"factors": [1], "n_steps": [horizon]},
                "max_iter": 10, "max_solve_time": 10.0,
                "armature": [0.1] * 7, **ocp},
        "collision_pairs_names": ["pair_1"],
        "pair_1": {"first": PAIR[0][0], "second": PAIR[0][1]}}}


def pick_and_place_moves(q_home, dt: float = P6_DT):
    """The three rest-to-rest quintic moves of `examples/pick_and_place.py`
    as (q, dq, ddq) arrays (its `quintic_join`)."""
    q_pick = q_home + np.asarray(PICK_OFFSET)
    q_place = q_home + np.asarray(PLACE_OFFSET)
    moves = []
    for qa, qb, duration in zip((q_home, q_pick, q_place),
                                (q_pick, q_place, q_home), MOVE_DURATIONS):
        n = max(int(round(duration / dt)), 2)
        s = np.linspace(0.0, duration, n, endpoint=False) / duration
        blend = 10 * s**3 - 15 * s**4 + 6 * s**5
        dblend = (30 * s**2 - 60 * s**3 + 30 * s**4) / duration
        ddblend = (60 * s - 180 * s**2 + 120 * s**3) / duration**2
        dq = qb - qa
        moves.append((qa[None] + blend[:, None] * dq[None],
                      dblend[:, None] * dq[None], ddblend[:, None] * dq[None]))
    return moves


def pick_and_place_generator(model, params):
    """The demo's `GenericTrajectory` of its three moves from the ready
    pose, its FK and RNEA on the params' device."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY
    from agimus_controller_tpu_torch.trajectories import GenericTrajectory

    gen = GenericTrajectory("panda_hand_tcp", **{
        k: np.asarray(v) for k, v in PICK_PLACE_WEIGHTS.items()})
    q_home = np.asarray(PANDA_Q_READY, dtype=float)
    gen.initialize(model, params, q_home)
    for qs, vs, accs in pick_and_place_moves(q_home):
        gen.add_trajectory(gen.build_trajectory_from_q_dq_ddq_arrays(
            qs, vs, accs))
    return gen


def p6_robot(device):
    """The phase's model through the port's model factory: the Panda with
    `P6_ENV_XACRO` grafted on `panda_link0` and phase 4's collision pair,
    f32 on `device`, and an f64 host copy for the checks."""
    from agimus_controller_tpu_torch.models.panda import (
        PANDA_DEFAULT_ARMATURE,
        PANDA_URDF,
    )
    from agimus_controller_tpu_torch.models.urdf import (
        RobotModelParameters,
        build_robot_models,
    )

    def build(dtype, dev):
        return build_robot_models(RobotModelParameters(
            robot_urdf=PANDA_URDF, moving_joint_names=list(P6_JOINTS),
            armature=PANDA_DEFAULT_ARMATURE, env_urdf=P6_ENV_XACRO,
            robot_attachment_frame="panda_link0", collision_as_capsule=True,
            collision_pairs=PAIR, dtype=dtype), dev)

    return build(torch.float32, device), build(torch.float64, "cpu")


def _timed_solves(ocp, device):
    """Wrap `ocp.solve` to record each call's time (host clock, the device
    synchronized); returns the list it fills."""
    times, solve = [], ocp.solve

    def timed(*args, **kw):
        t0 = time.perf_counter()
        res = solve(*args, **kw)
        _sync(device)
        times.append(time.perf_counter() - t0)
        return res

    ocp.solve = timed
    return times


def run_control_loop(device, robot, ocp, buffer, next_point, n_ticks: int,
                     on_tick=None, after_step=None):
    """Drive `ocp` the way the demos do: a shift warm start, a reference
    warm start for the first solve, `MPC` and `ControllerRuntime` over
    `buffer`; the buffer prefilled with 2T+2 points of `next_point()`, then
    `n_ticks` ticks from the ready pose, the measured state closed through
    `ocp.integrate` of the published control, one new point a tick. The
    launch counts of the solver's kernels are set to 0 just before the
    first tick and read after the last. `after_step(it, now, x, mpc)` runs
    after each tick's step (x the measured state), `on_tick(it, q, v)`
    after the state is closed. Returns a namespace of the run, with each
    tick's (time, q, v) and the point appended after it."""
    from agimus_controller_tpu_torch.factory import create_warm_start
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY
    from agimus_controller_tpu_torch.mpc.mpc import MPC
    from agimus_controller_tpu_torch.runtime.controller import (
        ControllerRuntime,
        RuntimeParams,
        Sensor,
    )

    model, params = robot.model, robot.params
    ws = create_warm_start("shift_previous_solution", model, params,
                           timesteps=ocp.spec.timesteps(), device=device)
    ws_ref = create_warm_start("reference", model, params, device=device)
    mpc = MPC()
    mpc.setup(ocp, ws, buffer)
    rt = ControllerRuntime(mpc, buffer, ws_ref, RuntimeParams())
    for _ in range(2 * ocp.n_controls + 2):
        rt.append_reference(next_point())
    solve_times = _timed_solves(ocp, device)
    kernels = ocp.solver.kernels
    for k in kernels:
        k.launches = 0
    q, v = np.asarray(PANDA_Q_READY, dtype=float).copy(), np.zeros(7)
    controls, kkts, iters, phases = [], [], [], []
    states, appended = [], []
    syncs = None
    t_start = time.perf_counter()
    for it in range(n_ticks):
        if it == 1:  # per-tick counts leave out the initialization
            syncs = (ocp.host_syncs, ocp.solver_host_syncs)
            t_start = time.perf_counter()
        now = int(it * ocp.dt * 1e9)
        rt.set_sensor(Sensor(time_ns=now, position=q, velocity=v))
        states.append((now, q.copy(), v.copy()))
        ctrl = rt.step(now_ns=now)
        if ctrl is None:
            raise AssertionError(f"tick {it}: the runtime published nothing")
        if after_step is not None:
            after_step(it, now, np.concatenate([q, v]), mpc)
        x = ocp.integrate(np.concatenate([q, v]), ctrl.feedforward)
        q, v = x[:7].astype(float), x[7:].astype(float)
        dbg = mpc.mpc_debug_data
        controls.append(np.concatenate([ctrl.feedforward,
                                        ctrl.feedback_gain.reshape(-1)]))
        kkts.append(dbg.ocp.kkt_norm)
        iters.append(dbg.ocp.nb_iter)
        if it > 0:
            phases.append((dbg.duration_iteration_ns,
                           dbg.duration_horizon_update_ns,
                           dbg.duration_generate_warm_start_ns,
                           dbg.duration_ocp_solve_ns))
        if on_tick is not None:
            on_tick(it, q, v)
        appended.append(next_point())
        rt.append_reference(appended[-1])
    _sync(device)
    wall = time.perf_counter() - t_start
    launches = [k.launches for k in kernels]
    n = n_ticks - 1
    return SimpleNamespace(
        rt=rt, mpc=mpc, q=q, v=v, states=states, appended=appended,
        controls=np.stack(controls), kkts=kkts,
        iters=iters, launches=launches, first_solve_s=solve_times[0],
        tick_ms=wall / n * 1e3,
        phases_ms=np.median(np.asarray(phases, float), 0) / 1e6,
        facade_syncs=(ocp.host_syncs - syncs[0]) / n,
        solver_syncs=(ocp.solver_host_syncs - syncs[1]) / n)


def _check_loop(part, run, ocp):
    """The checks every part makes: finite controls, the kernels backend
    and every stage kernel launched during the ticks. Returns the
    launches per kernel."""
    if not np.all(np.isfinite(run.controls)):
        raise AssertionError(f"phase 6 {part}: non-finite control")
    if ocp.solver.backend != "kernels":
        raise AssertionError(
            f"phase 6 {part}: backend {ocp.solver.backend!r} "
            f"({ocp.solver.backend_reason}), expected 'kernels'")
    launches = dict(zip([k[0] for k in STAGE_KERNELS], run.launches))
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"phase 6 {part}: {missing} never launched")
    return launches


def _loop_line(part, run, ocp, extra):
    it, hu, ws, solve = run.phases_ms
    return (f"phase 6 {part}: first solve {run.first_solve_s:.3f} s; "
            f"budget_iters {ocp.budget_iters}; tick {run.tick_ms:.3f} ms "
            f"(host clock, mean over ticks 1-{len(run.iters) - 1}); "
            f"MPCDebugData medians: iteration {it:.3f} ms, horizon_update "
            f"{hu:.3f} ms, generate_warm_start {ws:.3f} ms, ocp_solve "
            f"{solve:.3f} ms; host syncs per tick: facade "
            f"{run.facade_syncs:.2f}, solver {run.solver_syncs:.2f}; "
            f"iterations per tick median {float(np.median(run.iters[1:])):.1f}"
            f"; last tick kkt {run.kkts[-1]:.2e}; {extra}")


def run_pick_and_place(device, robot, cfg, io_dir):
    """Part (a): `examples/pick_and_place.py`'s loop, "goal_reaching_yaml"
    over a `TrajectoryBuffer`, fed a `GenericTrajectory` of its three
    quintic moves; every tick recorded by `MPCRecorder`, the `MPC`
    checkpointed after tick `CHECKPOINT_TICK` (into `io_dir`). Returns
    (launches, summary line, the OCP, the run with its recorder)."""
    from agimus_controller_tpu_torch.factory import create_ocp
    from agimus_controller_tpu_torch.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryBuffer,
    )
    from agimus_controller_tpu_torch.runtime import MPCRecorder
    from agimus_controller_tpu_torch.runtime.checkpoint import save_checkpoint

    model, params = robot.model, robot.params
    T = cfg.ocp.horizon_size
    ocp = create_ocp("goal_reaching_yaml", model, params, cfg.ocp,
                     ee_frame="panda_hand_tcp", device=device)
    gen = pick_and_place_generator(model, params)  # index-stepped playback
    errs = []
    recorder = MPCRecorder()

    def on_tick(it, q, v):
        ref_q = gen.trajectory[min(it, len(gen.trajectory) - 1)]
        errs.append(float(np.linalg.norm(q - ref_q.robot_configuration)))

    def after_step(it, now, x, mpc):
        recorder.record(now, x, ocp.ocp_results, mpc.mpc_debug_data)
        if it == CHECKPOINT_TICK:
            save_checkpoint(Path(io_dir) / "tick.npz", mpc)

    run = run_control_loop(
        device, robot, ocp, TrajectoryBuffer(DTFactorsNSeq([1], [T])),
        lambda: gen.get_traj_point_at_t(0.0), PICK_PLACE_TICKS, on_tick,
        after_step)
    run.recorder = recorder
    launches = _check_loop("(a)", run, ocp)
    if not run.kkts[-1] < 1e-4:
        raise AssertionError(
            f"phase 6 (a): last tick kkt {run.kkts[-1]:.2e} >= 1e-4")
    bound = 2 * JAX_PICK_PLACE_MAX_ERR + 0.01
    if not max(errs) <= bound:
        raise AssertionError(
            f"phase 6 (a): joint tracking error {max(errs):.4f} rad > "
            f"{bound:.4f} (2x the JAX package's {JAX_PICK_PLACE_MAX_ERR:.4f}"
            " + 0.01)")
    return launches, _loop_line("(a) pick and place", run, ocp, (
        f"joint tracking error max {max(errs):.4f} rad, mean "
        f"{np.mean(errs):.4f} (JAX f32 on the CPU: max "
        f"{JAX_PICK_PLACE_MAX_ERR:.4f}); launches {launches}")), ocp, run


def run_ring_loop(device, robot, cfg):
    """Part (b): the same loop in ring mode (`PackedTrajectoryBuffer`,
    `ring=buf.ring`, debug streams on), the goal-reaching definition with
    the goal's residual published; then one solve on the ring against the
    host-packed OCP from the same horizon. Returns (launches, summary line,
    the OCP)."""
    import copy
    import dataclasses

    from agimus_controller_tpu_torch.factory import create_ocp
    from agimus_controller_tpu_torch.mpc.buffer import DTFactorsNSeq
    from agimus_controller_tpu_torch.mpc.ring import PackedTrajectoryBuffer, RowLayout
    from agimus_controller_tpu_torch.ocp.definitions import GOAL_REACHING
    from agimus_controller_tpu_torch.ocp.yaml_compiler import load_ocp_spec

    model, params = robot.model, robot.params
    T = cfg.ocp.horizon_size
    tree = copy.deepcopy(GOAL_REACHING)
    for entry in tree["running_model"]["differential"]["costs"]:
        if entry["name"] == "goal_tracking":
            entry["publish_residual"] = True
    ocp_params = dataclasses.replace(cfg.ocp, use_debug_data=True)
    spec = load_ocp_spec(tree, model, horizon=T, dt=P6_DT,
                         default_ee_frame="panda_hand_tcp")
    buf = PackedTrajectoryBuffer(DTFactorsNSeq([1], [T]), RowLayout(spec, model),
                                 dtype=torch.float32, device=device)
    ocp = create_ocp("yaml", model, params, ocp_params, yaml_file=tree,
                     ee_frame="panda_hand_tcp", ring=buf.ring, device=device)
    gen = pick_and_place_generator(model, params)
    ids = iter(range(10**6))

    def next_point():
        i = next(ids)
        wp = gen.get_traj_point_at_t(0.0)
        return dataclasses.replace(wp, point=dataclasses.replace(wp.point, id=i))

    run = run_control_loop(device, robot, ocp, buf, next_point, RING_TICKS)
    launches = _check_loop("(b)", run, ocp)
    dbg = run.mpc.mpc_debug_data.ocp
    shapes = {k: v.shape for k, v in dbg.references.items()}
    want = {"control_reg": (T + 1, 7), "state_reg": (T + 1, 14),
            "goal_tracking": (T + 1, 3)}
    if shapes != want:
        raise AssertionError(f"phase 6 (b): reference streams {shapes}, "
                             f"expected {want}")
    res_shapes = {k: v.shape for k, v in dbg.residuals.items()}
    if res_shapes != {"goal_tracking": (T, 6)} or not np.all(
            np.isfinite(dbg.residuals["goal_tracking"])):
        raise AssertionError(f"phase 6 (b): residual streams {res_shapes}")
    # one solve on the ring against the host-packed OCP, same horizon
    x0 = np.concatenate([run.q, run.v])
    prev = run.mpc._warm_start._previous_solution
    xs, us = list(prev.states), list(prev.feed_forward_terms)
    res_ring = ocp.solve(x0, xs, us)
    host = create_ocp("yaml", model, params, cfg.ocp, yaml_file=tree,
                      ee_frame="panda_hand_tcp", device=device)
    host.set_reference_weighted_trajectory(buf.horizon)
    res_host = host.solve(x0, xs, us)
    gap_us = float(np.abs(res_ring.feed_forward_terms
                          - res_host.feed_forward_terms).max())
    gap_xs = float(np.abs(res_ring.states - res_host.states).max())
    if not gap_us <= RING_HOST_TOL:
        raise AssertionError(
            f"phase 6 (b): ring vs host us {gap_us:.2e} > {RING_HOST_TOL}")
    return launches, _loop_line("(b) ring, debug streams", run, ocp, (
        f"streams {sorted(shapes)} + residual goal_tracking {res_shapes['goal_tracking']}; "
        f"ring vs host-packed solve: us {gap_us:.2e}, xs {gap_xs:.2e} "
        f"(bound us {RING_HOST_TOL}); launches {launches}")), ocp


def run_sine_loop(device, robot):
    """Part (c): `examples/dummy_mpc.py`'s loop: "goal_reaching_yaml" with
    its `OCPParams(dt, horizon_size)` (so the reference's default
    `max_solve_time` of 0.1 s), fed a `SinusWaveConfigurationSpace` at
    amplitude 0.3 rad and period 4 s. After the ticks, one unlimited solve
    from the runtime's state must converge. Returns (launches, summary
    line, the OCP)."""
    from agimus_controller_tpu_torch.factory import create_ocp
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY
    from agimus_controller_tpu_torch.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryBuffer,
    )
    from agimus_controller_tpu_torch.mpc.ocp_base import OCPParams
    from agimus_controller_tpu_torch.trajectories import (
        SinusWaveConfigurationSpace,
        SinWaveParams,
    )

    model, params = robot.model, robot.params
    T = P6_T
    ocp = create_ocp("goal_reaching_yaml", model, params,
                     OCPParams(dt=P6_DT, horizon_size=T),
                     ee_frame="panda_hand_tcp", device=device)
    traj = SinusWaveConfigurationSpace(
        SinWaveParams(amplitude=[0.3] * 7, period=[4.0] * 7,
                      scale_duration=[1.0] * 7),
        "panda_hand_tcp", w_q=np.full(7, 10.0), w_qdot=np.ones(7),
        w_qddot=np.zeros(7), w_robot_effort=np.full(7, 1e-3),
        w_pose=np.zeros(6))
    traj.initialize(model, params, np.asarray(PANDA_Q_READY, dtype=float))
    stream = iter(range(10**6))
    errs = []

    def on_tick(it, q, v):
        ref = traj.get_traj_point_at_t(it * P6_DT).point.robot_configuration
        errs.append(float(np.linalg.norm(q - ref)))

    run = run_control_loop(
        device, robot, ocp, TrajectoryBuffer(DTFactorsNSeq([1], [T])),
        lambda: traj.get_traj_point_at_t(next(stream) * P6_DT), SINE_TICKS,
        on_tick)
    launches = _check_loop("(c)", run, ocp)
    x0 = np.concatenate([run.q, run.v])
    prev = run.mpc._warm_start._previous_solution
    ocp.set_reference_weighted_trajectory(run.mpc._buffer.horizon)
    ocp.solve(x0, list(prev.states), list(prev.feed_forward_terms),
              use_iteration_limits_and_timeout=False)
    final = ocp.debug_data
    if not final.problem_solved:
        raise AssertionError(
            f"phase 6 (c): the unlimited solve after the loop did not "
            f"converge (kkt {final.kkt_norm:.2e}, {final.nb_iter} iterations)")
    return launches, _loop_line(
        "(c) sine, default max_solve_time 0.1 s", run, ocp, (
            f"joint tracking error max {max(errs):.4f} rad; unlimited solve "
            f"after the loop: {final.nb_iter} iterations, kkt "
            f"{final.kkt_norm:.2e}; launches {launches}")), ocp


def run_collision_facade(device, robot, robot64):
    """Part (d): "traj_tracking_collision_avoidance" through the facade
    (host-packed `TrajectoryBuffer`, MPC, ControllerRuntime) at the shipped
    YAML's T = 19, phase 4's goal pulling link 7 onto the 1 cm band of the
    obstacle sphere, `max_qp_iter` 25 and termination tolerance 1e-4 as
    phase 4, the reference's default `max_solve_time` of 0.1 s (so each
    tick runs the iterations the calibrated budget allows, one on the
    card); the ADMM branch and the dual carry through `OCPTorch`. The band must hold (> 9 mm) on the last
    tick's planned trajectory. Returns (launches, summary line, the
    OCP)."""
    from agimus_controller_tpu_torch.factory import create_ocp
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY
    from agimus_controller_tpu_torch.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryBuffer,
        TrajectoryPoint,
        TrajectoryPointWeights,
        WeightedTrajectoryPoint,
    )
    from agimus_controller_tpu_torch.ops import dynamics
    from agimus_controller_tpu_torch.ops.collision import pair_distance
    from agimus_controller_tpu_torch.ops.kinematics import frame_placement
    from agimus_controller_tpu_torch.runtime.config import load_engine_config

    model, params = robot.model, robot.params
    m64, p64 = robot64.model, robot64.params
    T = P6_COLLISION_T
    cfg = load_engine_config(engine_values(
        T, max_qp_iter=25, termination_tolerance=1e-4, max_solve_time=0.1))
    ocp = create_ocp("traj_tracking_collision_avoidance", model, params,
                     cfg.ocp, ee_frame="panda_hand_tcp", device=device)
    q0 = np.asarray(PANDA_Q_READY, dtype=float)
    R0 = frame_placement(m64, p64, torch.as_tensor(q0),
                         m64.frame_id("panda_hand_tcp"))[0].numpy()
    z = torch.zeros(7, dtype=torch.float64)
    tau_g = dynamics.rnea(m64, p64, torch.as_tensor(q0), z, z).numpy()
    goal = np.asarray([0.45, 0.05, 0.50])  # phase 4's
    ids = iter(range(10**6))

    def next_point():
        i = next(ids)
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

    run = run_control_loop(device, robot, ocp,
                           TrajectoryBuffer(DTFactorsNSeq([1], [T])),
                           next_point, COLLISION_TICKS)
    launches = _check_loop("(d)", run, ocp)
    if tuple(ocp._y_carry.shape) != (T + 1, 1):
        raise AssertionError(
            f"phase 6 (d): dual carry {tuple(ocp._y_carry.shape)}")
    qp = ocp.debug_data.nb_qp_iter
    if not qp > 0:
        raise AssertionError("phase 6 (d): the ADMM did not run")
    xs = torch.as_tensor(ocp.ocp_results.states, dtype=torch.float64)
    d = torch.func.vmap(lambda q: pair_distance(m64, p64, q, 0))(xs[1:, :7])
    d_min = float(d.min())
    if not d_min > 0.009:
        raise AssertionError(
            f"phase 6 (d): band violated, min distance {d_min * 1e3:.3f} mm")
    return launches, _loop_line("(d) collision OCP through the facade", run,
                                ocp, (
        f"last tick {qp} ADMM iterations; min pair distance on t >= 1 "
        f"{d_min * 1e3:.3f} mm (band 10 mm, held above 9 mm); |y carry| max "
        f"{float(ocp._y_carry.abs().max()):.3e}; launches {launches}")), ocp


CHECKPOINT_TICK = 30  # (a)'s checkpoint; the resumed MPC runs 31-40
RESUME_TICKS = 10
RESUME_TOL = 1e-5  # f32: the resumed controls against (a)'s, if not equal
ROS_TICKS = 5
PUBLISHER_POINTS = 20


def publisher_trajectory():
    """The trajectory-publisher child's generator (`examples/dummy_mpc.py`'s
    sine waves on the Panda's joints): built in the child, on the CPU."""
    from agimus_controller_tpu_torch.trajectories.base import SinWaveParams
    from agimus_controller_tpu_torch.trajectories.sine_waves import (
        SinusWaveConfigurationSpace,
    )

    return SinusWaveConfigurationSpace(
        SinWaveParams(amplitude=[0.2] * 7, period=[2.0] * 7,
                      scale_duration=[1.0] * 7),
        ee_frame_name="panda_hand_tcp", w_q=np.full(7, 1.0),
        w_qdot=np.full(7, 0.1), w_qddot=np.zeros(7),
        w_robot_effort=np.zeros(7), w_pose=np.full(6, 1.0))


def _same_recording(name, got, want):
    """Two recordings (npz-schema dicts) hold the same keys and arrays."""
    if set(got) != set(want):
        raise AssertionError(f"phase 6 recorder: {name} keys "
                             f"{sorted(set(got) ^ set(want))} differ")
    for k in want:
        if not np.array_equal(np.asarray(got[k], float),
                              np.asarray(want[k], float)):
            raise AssertionError(f"phase 6 recorder: {name} {k} differs")


def run_loop_io(device, robot, cfg, ocp_a, run_a, io_dir):
    """Phase 6's I/O and debugging, on part (a)'s run: (a)'s recording
    written as npz, as a sqlite3 bag and as an uncompressed mcap bag, each
    read back equal; (a)'s checkpoint after tick `CHECKPOINT_TICK` loaded
    into a fresh `MPC` built the same way, which runs the next
    `RESUME_TICKS` ticks on (a)'s states and points, its controls (and
    gains) equal to (a)'s or within `RESUME_TOL`; `MPCDebugger`'s cost
    breakdown of one solve (dt-scaled) summing to that solve's cost within
    1e-4 relative; the ROS shim's node graph over `MessageBus` for
    `ROS_TICKS` ticks; `TrajectoryPublisherProcess` streaming
    `PUBLISHER_POINTS` points into a buffer from its CPU child. Kernel
    launch counts are set to 0 before each part and read after. Returns
    (launches, lines)."""
    from agimus_controller_tpu_torch.factory import create_ocp, create_warm_start
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY
    from agimus_controller_tpu_torch.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryBuffer,
        TrajectoryPoint,
    )
    from agimus_controller_tpu_torch.mpc.mpc import MPC
    from agimus_controller_tpu_torch.runtime import MPCRecorder
    from agimus_controller_tpu_torch.runtime.checkpoint import load_checkpoint
    from agimus_controller_tpu_torch.runtime.controller import (
        ControllerRuntime,
        RuntimeParams,
        Sensor,
    )
    from agimus_controller_tpu_torch.runtime.debugger import MPCDebugger
    from agimus_controller_tpu_torch.runtime.publisher import (
        PublisherParams,
        TrajectoryPublisherProcess,
    )
    from agimus_controller_tpu_torch.runtime.ros_shim import (
        ControllerNodeShim,
        DebuggerNodeShim,
        MessageBus,
        TrajectoryPublisherShim,
    )

    io_dir = Path(io_dir)
    model, params = robot.model, robot.params
    T = cfg.ocp.horizon_size
    launches = {name: 0 for name, *_ in STAGE_KERNELS}

    def fresh_ocp():
        ocp = create_ocp("goal_reaching_yaml", model, params, cfg.ocp,
                         ee_frame="panda_hand_tcp", device=device)
        for k in ocp.solver.kernels:
            k.launches = 0
        return ocp

    def count(ocp):
        for (name, *_), k in zip(STAGE_KERNELS, ocp.solver.kernels):
            launches[name] += k.launches

    # -- the recording, in the three containers
    rec = run_a.recorder
    want = rec.as_mpc_data()
    rec.save(io_dir / "run.npz")
    _same_recording("npz", MPCRecorder.load(io_dir / "run.npz"), want)
    for fmt in ("sqlite3", "mcap"):
        path = io_dir / f"run.{fmt}"
        rec.save_bag(path, fmt=fmt)
        _same_recording(fmt, MPCRecorder.load_bag(path), want)

    # -- resume from the checkpoint into a fresh MPC
    ocp_r = fresh_ocp()
    mpc = MPC()
    mpc.setup(ocp_r, create_warm_start(
        "shift_previous_solution", model, params,
        timesteps=ocp_r.spec.timesteps(), device=device),
        TrajectoryBuffer(DTFactorsNSeq([1], [T])))
    if not load_checkpoint(io_dir / "tick.npz", mpc):
        raise AssertionError("phase 6 checkpoint: no previous solution")
    resumed = []
    for it in range(CHECKPOINT_TICK + 1, CHECKPOINT_TICK + 1 + RESUME_TICKS):
        mpc.append_trajectory_point(run_a.appended[it - 1])
        now, q, v = run_a.states[it]
        res = mpc.run(TrajectoryPoint(
            time_ns=now, robot_configuration=q.copy(),
            robot_velocity=v.copy(), robot_acceleration=np.zeros_like(v)),
            now)
        resumed.append(np.concatenate([res.feed_forward_terms[0],
                                       res.ricatti_gains[0].reshape(-1)]))
    count(ocp_r)
    ref = run_a.controls[CHECKPOINT_TICK + 1:
                         CHECKPOINT_TICK + 1 + RESUME_TICKS]
    d_resume = float(np.abs(np.stack(resumed) - ref).max())
    if not d_resume <= RESUME_TOL:
        raise AssertionError(
            f"phase 6 checkpoint: resumed controls differ from the "
            f"uninterrupted run's by {d_resume:.3e} (bound {RESUME_TOL})")

    # -- the debugger's breakdown of one solve against its cost
    xs = torch.as_tensor(ocp_a.ocp_results.states, device=device)
    us = torch.as_tensor(ocp_a.ocp_results.feed_forward_terms, device=device)
    sol = ocp_a.solver(xs[:1], ocp_a.refs, xs[None], us[None])
    dbg = MPCDebugger(ocp_a)
    out = dbg.evaluate(sol.xs[0].cpu().numpy(), sol.us[0].cpu().numpy())
    dts = ocp_a.spec.timesteps()
    total = (sum(float(np.sum(np.asarray(v, float) * dts))
                 for v in out["running_costs"].values())
             + sum(out["terminal_costs"].values()))
    cost = float(sol.cost[0])
    rel = abs(total - cost) / abs(cost)
    heat = out["grad_heatmap"]
    if not (rel < 1e-4 and np.all(np.isfinite(heat))):
        raise AssertionError(
            f"phase 6 debugger: breakdown sum {total:.6e} vs the solve's cost "
            f"{cost:.6e} (relative {rel:.2e}, bound 1e-4)")
    ee = dbg.ee_path(sol.xs[0].cpu().numpy(), "panda_hand_tcp")

    # -- the ROS shim's node graph over the in-process bus
    ocp_s = fresh_ocp()
    ws = create_warm_start("shift_previous_solution", model, params,
                           timesteps=ocp_s.spec.timesteps(), device=device)
    buf = TrajectoryBuffer(DTFactorsNSeq([1], [T]))
    mpc_s = MPC()
    mpc_s.setup(ocp_s, ws, buf)
    rt = ControllerRuntime(mpc_s, buf, create_warm_start(
        "reference", model, params, device=device), RuntimeParams())
    bus = MessageBus()
    node = ControllerNodeShim(rt, bus=bus)
    viewer = DebuggerNodeShim(bus)
    gen = pick_and_place_generator(model, params)
    publisher = TrajectoryPublisherShim(
        bus, lambda sensor: gen.get_traj_point_at_t(0.0))
    q, v = np.asarray(PANDA_Q_READY, float), np.zeros(7)
    bus.publish("sensor", Sensor(time_ns=0, position=q, velocity=v))
    for _ in range(2 * T + 2):
        publisher.tick()
    for it in range(ROS_TICKS):
        now = int(it * ocp_s.dt * 1e9)
        bus.publish("sensor", Sensor(time_ns=now, position=q, velocity=v))
        ctrl = node.tick(now_ns=now)
        if ctrl is None or not np.all(np.isfinite(ctrl.feedforward)):
            raise AssertionError(f"phase 6 ROS shim: tick {it} published "
                                 f"{None if ctrl is None else 'non-finite'}")
        x = ocp_s.integrate(np.concatenate([q, v]), ctrl.feedforward)
        q, v = x[:7].astype(float), x[7:].astype(float)
        publisher.tick()
    count(ocp_s)
    n_ctrl = len(bus.history("control"))
    markers = bus.latest("mpc_states_prediction_markers")
    if not (n_ctrl == ROS_TICKS and viewer.last_debug is not None
            and markers is not None and markers.shape == (T + 1, 14)):
        raise AssertionError(
            f"phase 6 ROS shim: {n_ctrl} controls on the bus, markers "
            f"{None if markers is None else markers.shape}")

    # -- the trajectory publisher's CPU child feeding a buffer
    pbuf = TrajectoryBuffer(DTFactorsNSeq([1], [T]))
    t0 = time.perf_counter()
    with TrajectoryPublisherProcess(
            publisher_trajectory, PANDA_Q_READY,
            PublisherParams(rate_s=0.0, max_points=PUBLISHER_POINTS)) as pub:
        while not pub.done and time.perf_counter() - t0 < 120.0:
            pub.pump_into(pbuf.append, timeout_s=1.0)
    pub_s = time.perf_counter() - t0
    ids = [pbuf[i].point.id for i in range(len(pbuf))]
    if ids != list(range(PUBLISHER_POINTS)) or not all(
            np.all(np.isfinite(pbuf[i].point.robot_configuration))
            for i in range(len(pbuf))):
        raise AssertionError(f"phase 6 publisher: ids {ids}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"phase 6 I/O: {missing} never launched")
    return launches, [
        f"phase 6 recorder: (a)'s {len(rec.time_ns)} ticks written as npz, "
        f"sqlite3 and mcap ({sum((io_dir / f).stat().st_size for f in ('run.npz', 'run.sqlite3', 'run.mcap'))} "
        "bytes), each read back equal",
        f"phase 6 checkpoint: resumed after tick {CHECKPOINT_TICK} in a fresh "
        f"MPC, ticks {CHECKPOINT_TICK + 1}-{CHECKPOINT_TICK + RESUME_TICKS}: "
        f"controls and gains "
        + ("bit-equal to" if d_resume == 0.0 else
           f"within {d_resume:.3e} of (bound {RESUME_TOL})")
        + " the uninterrupted run's",
        f"phase 6 debugger: cost breakdown of one solve (dt-scaled) "
        f"{total:.6e} against the solve's cost {cost:.6e} (relative "
        f"{rel:.2e}, bound 1e-4); |dL/dx| max {float(heat.max()):.3e}; EE "
        f"path {ee.shape[0]} nodes",
        f"phase 6 ROS shim: {ROS_TICKS} ticks over MessageBus, {n_ctrl} "
        f"controls, markers {tuple(markers.shape)}; publisher process: "
        f"{len(ids)} points from its CPU child in {pub_s:.1f} s; launches "
        f"{launches}"]


def run_control_loop_phase(device):
    """Phase 6: the reference-shaped control loop, parts (a)-(d), then the
    runtime's I/O and debugging on (a)'s run (`run_loop_io`). Returns
    (launches per kernel, summary lines)."""
    import tempfile

    from agimus_controller_tpu_torch.runtime.config import load_engine_config

    robot, robot64 = p6_robot(device)
    # (a) and (b) converge to 1e-4 (the check of (a)); (c) keeps the
    # reference's default termination tolerance, 1e-3
    cfg = load_engine_config(engine_values(P6_T, termination_tolerance=1e-4))
    (ROOT / "build").mkdir(exist_ok=True)
    io_dir = tempfile.TemporaryDirectory(dir=ROOT / "build")
    parts = {"(a)": lambda: run_pick_and_place(device, robot, cfg,
                                               io_dir.name),
             "(b)": lambda: run_ring_loop(device, robot, cfg),
             "(c)": lambda: run_sine_loop(device, robot),
             "(d)": lambda: run_collision_facade(device, robot, robot64)}
    launches = {name: 0 for name, *_ in KERNELS}
    lines, ocps = [], {}
    with io_dir:
        for part, run in parts.items():
            t0 = time.perf_counter()
            got, line, ocps[part], *extra = run()
            lines.append(f"{line} [{time.perf_counter() - t0:.1f} s]")
            for name, n in got.items():
                launches[name] += n
            if part == "(a)":
                run_a = extra[0]
        t0 = time.perf_counter()
        got, io_lines = run_loop_io(device, robot, cfg, ocps["(a)"], run_a,
                                    io_dir.name)
        for name, n in got.items():
            launches[name] += n
    lines += io_lines[:-1] + [
        f"{io_lines[-1]} [{time.perf_counter() - t0:.1f} s]"]
    lines.append(
        f"phase 6: budget_iters {ocps['(a)'].budget_iters} under "
        f"max_solve_time 10.0 s (part (a)), {ocps['(c)'].budget_iters} and "
        f"{ocps['(d)'].budget_iters} under the reference's default 0.1 s "
        "(parts (c) and (d))")
    return launches, lines


# -- phase 7: slice 12 (the Tiago-Pro arm, soft contact, the free-flyer) ----
TIAGO_TICKS = 20
FORCE_T = 10
FORCE_DES = (0.0, 0.0, -10.0)  # N, the commanded contact force
FORCE_F0 = (0.0, 0.0, 5.0)  # N, the force state of the inactive-contact check
FORCE_MPC_TICKS = 10
FF_T = 30
FF_GOAL = (0.05, 0.03, -0.04)  # m, from the hand at the start
FF_PITCH = np.pi / 2  # base pitch: the euler chart's singularity
FF_ROWS = 4


def _tool_position(model, params64, fid):
    """q -> the frame's world position (f64, CPU)."""
    from agimus_controller_tpu_torch.ops.kinematics import frame_placement

    return lambda q: frame_placement(model, params64, torch.as_tensor(
        np.asarray(q, dtype=float)), fid)[1].numpy()


def tiago_problem(device, full=False):
    """Phase 7 (a)'s problem: the Tiago-Pro arm (f32 on `device`, an f64
    host copy), `tiago_spec(TIAGO_T)`, x0 at the ready pose, the tool
    target FK(ready) + `TIAGO_GOAL`, the gravity torque at the ready pose;
    with `full` phase 9's: the full 17-DoF Tiago-Pro (`load_tiago_full`),
    `tiago_full_spec`,
    x0 at `tiago_full_ready()`, each tool's target FK(ready) +
    `tiago_goal(frame)`. `tools`, `p0` and `target` are per frame."""
    from agimus_controller_tpu_torch.models.tiago_pro import (
        TIAGO_PRO_Q_READY,
        load_tiago_pro,
    )
    from agimus_controller_tpu_torch.ops.dynamics import generalized_gravity

    load = load_tiago_full if full else load_tiago_pro
    model, params = load(dtype=torch.float32, device=device)
    _, params64 = load(dtype=torch.float64, device="cpu")
    frames = TIAGO_FULL_FRAMES if full else (TIAGO_FRAME,)
    tools = {f: _tool_position(model, params64, model.frame_id(f))
             for f in frames}
    q0 = tiago_full_ready() if full else np.asarray(TIAGO_PRO_Q_READY,
                                                    dtype=float)
    p0 = {f: tools[f](q0) for f in frames}
    return SimpleNamespace(
        model=model, params=params,
        spec=tiago_full_spec(TIAGO_T) if full else tiago_spec(TIAGO_T),
        frames=frames, tools=tools, q0=q0,
        x0=np.concatenate([q0, np.zeros(model.nj)]), p0=p0,
        target={f: p0[f] + tiago_goal(f) for f in frames},
        tau_g=generalized_gravity(model, params64,
                                  torch.as_tensor(q0)).numpy(),
        label=("phase 9 full Tiago-Pro" if full else "phase 7 (a) Tiago-Pro"))


def _tool_errors(tp, q):
    """{frame: distance of its tool at q from its target} (m)."""
    return {f: float(np.linalg.norm(tp.tools[f](q) - tp.target[f]))
            for f in tp.frames}


def run_tiago_tick(device, full=False):
    """Phase 7 (a), the tick: the Tiago-Pro OCP through a
    `PackedTrajectoryBuffer` and `FusedTickRunner` on backend "auto",
    which must take the stage kernels' nj = 8 instances: the first solve
    at limit 300, `TIAGO_TICKS` ticks at limit 2, one at limit 10; with
    `full` phase 9's, the same on the full Tiago-Pro and the nj = 17
    instances, both tools streamed. Returns (launches of K1-K4 over the
    ticks, line)."""
    from agimus_controller_tpu_torch.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryPoint,
        TrajectoryPointWeights,
        WeightedTrajectoryPoint,
    )
    from agimus_controller_tpu_torch.mpc.ring import (
        PackedTrajectoryBuffer,
        RowLayout,
    )
    from agimus_controller_tpu_torch.mpc.tick import FusedTickRunner
    from agimus_controller_tpu_torch.ocp.spec import default_references
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings

    tp = tiago_problem(device, full)
    T, nj = TIAGO_T, tp.model.nj
    refs = default_references(tp.spec, tp.model, dtype=torch.float32,
                              device=device)

    def point(i):
        return WeightedTrajectoryPoint(
            point=TrajectoryPoint(
                id=i, time_ns=int(i * 2e7), robot_configuration=tp.q0,
                robot_velocity=np.zeros(nj), robot_acceleration=np.zeros(nj),
                robot_effort=tp.tau_g,
                end_effector_poses={f: (np.eye(3), tp.target[f])
                                    for f in tp.frames}),
            weights=TrajectoryPointWeights(
                w_robot_configuration=np.ones(nj),
                w_robot_velocity=np.ones(nj), w_robot_effort=np.ones(nj),
                w_end_effector_poses={f: np.ones(6) for f in tp.frames}))

    buf = PackedTrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[T]),
                                 RowLayout(tp.spec, tp.model),
                                 dtype=torch.float32, device=device)
    for i in range(2 * T + TIAGO_TICKS + 10):
        buf.append(point(i))
    runner = FusedTickRunner(
        tp.model, tp.params, tp.spec, buf.ring, refs,
        CSQPSettings(max_iters=10, reg_init=1e-7, termination_tolerance=1e-4),
        dtype=torch.float32, device=device)
    solver = runner.solver
    if solver.backend != "kernels":
        raise AssertionError(
            f"{tp.label}: backend {solver.backend!r} "
            f"({solver.backend_reason}), expected 'kernels'")
    for k in solver.kernels:
        k.launches = 0
    t0 = time.perf_counter()
    runner.initialize(tp.x0, np.tile(tp.x0[None], (T + 1, 1)),
                      np.tile(tp.tau_g[None], (T, 1)), limit=300)
    _, _, kkt0, it0, _ = runner.fetch()
    first_s = time.perf_counter() - t0
    x0 = torch.as_tensor(tp.x0, dtype=torch.float32, device=device)
    syncs0 = solver.host_syncs
    times = []
    for _ in range(TIAGO_TICKS):
        t0 = time.perf_counter()
        runner.step(x0, limit=2)
        _sync(device)
        times.append(time.perf_counter() - t0)
    syncs = (solver.host_syncs - syncs0) / TIAGO_TICKS
    runner.step(x0, limit=10)
    K0, u0, kkt, iters, conv = runner.fetch()
    launches = dict(zip([k[0] for k in STAGE_KERNELS],
                        (k.launches for k in solver.kernels)))
    if not (np.all(np.isfinite(u0)) and np.all(np.isfinite(K0))):
        raise AssertionError(f"{tp.label}: non-finite control message")
    if not (conv and kkt < 1e-4):
        raise AssertionError(
            f"{tp.label}: final tick did not converge (kkt={kkt:.2e})")
    e0 = _tool_errors(tp, tp.q0)
    eT = _tool_errors(tp, runner._xs[-1, :nj].double().cpu().numpy())
    for f in tp.frames:
        if not eT[f] < 0.25 * e0[f]:
            raise AssertionError(
                f"{tp.label}: {f} error {eT[f]:.4f} m not under 0.25 x the "
                f"start error {e0[f]:.4f} m")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"{tp.label}: {missing} never launched")
    errors = ", ".join(f"{f} {eT[f] * 1e3:.2f} mm (start {e0[f] * 1e3:.2f} "
                       "mm)" for f in tp.frames)
    return launches, (
        f"{tp.label} tick (nj={nj}, T={T}, backend "
        f"{solver.backend}): first solve {first_s:.2f} s, iters={it0} "
        f"kkt={kkt0:.2e}; tick median {_median_ms(times):.3f} ms over "
        f"{TIAGO_TICKS} ticks at limit 2 (host clock, synchronized); "
        f"{syncs:.2f} host syncs per tick; final tick iters={iters} "
        f"kkt={kkt:.2e} conv={conv}; planned tool errors {errors}; "
        f"launches {launches}")


def run_tiago_batch(device, full=False):
    """Phase 7 (a), the batch: `make_batch_fddp` on the Tiago-Pro OCP,
    T = `TIAGO_T`, B = `TIAGO_B`, f32, 10 iterations, x0 = ready +
    N(0, 0.02^2) on q; rows 0-7 must equal a B = 8 solve (iterations and
    convergence equal, us within the batch path's 1e-3); with `full`
    phase 9's, the same on the full Tiago-Pro (K5a/K5b at nj = 17). Returns
    (launches of K5a, K5b and R1, line)."""
    from agimus_controller_tpu_torch.ocp.spec import default_references
    from agimus_controller_tpu_torch.solver.fddp import SolverSettings
    from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp

    tp = tiago_problem(device, full)
    T, B, nj = TIAGO_T, TIAGO_B, tp.model.nj
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device)
    refs = default_references(tp.spec, tp.model, dtype=torch.float32,
                              device=device)
    refs["xref"] = f(np.tile(tp.x0[None], (T + 1, 1)))
    for fr in tp.frames:
        refs[f"ee_trans:{fr}"] = f(np.tile(tp.target[fr][None], (T + 1, 1)))
    rng = np.random.default_rng(0)
    x0s = f(tp.x0[None] + np.concatenate(
        [rng.normal(size=(B, nj)) * BATCH_X0_NOISE, np.zeros((B, nj))], 1))
    xs0 = f(np.tile(tp.x0[None, None], (B, T + 1, 1)))
    us0 = f(np.tile(tp.tau_g[None, None], (B, T, 1)))
    solver = make_batch_fddp(tp.model, tp.params, tp.spec,
                             SolverSettings(max_iters=10), device=device)
    for k in solver.kernels:
        k.launches = 0
    small = solver(x0s[:BATCH_ROWS], refs, xs0[:BATCH_ROWS],
                   us0[:BATCH_ROWS])
    s0 = solver.host_syncs
    t0 = time.perf_counter()
    big = solver(x0s, refs, xs0, us0)
    _sync(device)
    big_s = time.perf_counter() - t0
    launches = {name: k.launches for (name, *_), k in
                zip(FDDP_KERNELS, solver.kernels)}
    for field in ("xs", "us", "K", "k", "cost", "kkt", "gap_norm"):
        if not bool(torch.isfinite(getattr(big, field)).all()):
            raise AssertionError(f"{tp.label} batch: non-finite {field}")
    rows = slice(0, BATCH_ROWS)
    du = float((big.us[rows] - small.us).abs().max())
    if not (torch.equal(big.iters[rows], small.iters)
            and torch.equal(big.converged[rows], small.converged)
            and du < 1e-3):
        raise AssertionError(
            f"{tp.label} batch: rows 0-{BATCH_ROWS - 1} differ from the "
            f"B={BATCH_ROWS} solve (iters {big.iters[rows].tolist()} vs "
            f"{small.iters.tolist()}, us max abs diff {du:.3e})")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"{tp.label} batch: {missing} never launched")
    c = lambda a: a.double().cpu().numpy()
    finals = c(big.xs[:, -1, :nj])
    median = {fr: float(np.median([np.linalg.norm(tp.tools[fr](q)
                                                  - tp.target[fr])
                                   for q in finals])) for fr in tp.frames}
    dist = ", ".join(f"{fr} {median[fr] * 1e3:.3f} mm" for fr in tp.frames)
    return launches, (
        f"{tp.label} batch FDDP (nj={nj}, B={B}, T={T}, f32, 10 "
        f"iterations): solve {big_s:.3f} s = {B / big_s:.1f} solves/s (host "
        f"clock, synchronized), {solver.host_syncs - s0} host syncs; mean "
        f"iterations {float(c(big.iters).mean()):.2f}; converged share "
        f"{float(c(big.converged).mean()):.4f}; median planned tool error "
        f"{dist} (start {np.linalg.norm(TIAGO_GOAL) * 1e3:.1f} mm); rows 0-"
        f"{BATCH_ROWS - 1} match the B={BATCH_ROWS} solve (us max abs diff "
        f"{du:.3e}); launches {launches}")


def soft_contact_config():
    """The JAX package's force-feedback tests' 3-D contact (`SC3`)."""
    from agimus_controller_tpu_torch.ops.soft_contact import SoftContactConfig

    return SoftContactConfig(frame="panda_hand_tcp", Kp=(200.0,) * 3,
                             Kv=(20.0,) * 3, ref="local_world_aligned")


def force_spec(T: int):
    """The force-tracking OCP of the JAX package's force-feedback tests:
    state and gravity-torque regularisation and force tracking, on
    `soft_contact_config()`, dt 0.02."""
    from agimus_controller_tpu_torch.ocp.spec import CostItem, ProblemSpec

    state = CostItem(name="state_reg", kind="state", weight=0.1, update=True)
    force = CostItem(name="force_tracking", kind="force_tracking", weight=1.0,
                     update=True)
    return ProblemSpec(
        running_costs=(state, CostItem(name="grav_reg", kind="control_grav",
                                       weight=5e-3), force),
        terminal_costs=(state, force), horizon=T, dt=0.02,
        soft_contact=soft_contact_config())


def force_problem(device, dtype=torch.float32, f0=(0.0, 0.0, 0.0)):
    """`force_spec(FORCE_T)` on the Panda with the JAX test's refs: x0 the
    ready pose at rest with force f0, w_x 0.05 on q, 0.5 on v, 0 on f,
    f_des `FORCE_DES` weighted 2; the gravity torque as us."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.ocp.spec import default_references
    from agimus_controller_tpu_torch.ops.dynamics import generalized_gravity

    model, params = load_panda(dtype=dtype, device=device)
    spec = force_spec(FORCE_T)
    T1 = FORCE_T + 1
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    x0 = np.concatenate([PANDA_Q_READY, np.zeros(7), f0])
    refs = default_references(spec, model, dtype=dtype, device=device)
    refs["xref"] = f(np.tile(x0[None], (T1, 1)))
    refs["w_x"] = f(np.tile(np.concatenate(
        [np.full(7, 0.05), np.full(7, 0.5), np.zeros(3)])[None], (T1, 1)))
    refs["f_des"] = f(np.tile(np.asarray(FORCE_DES)[None], (T1, 1)))
    refs["w_force"] = f(np.full((T1, 3), 2.0))
    tau_g = generalized_gravity(model, params, f(PANDA_Q_READY))
    return SimpleNamespace(
        model=model, params=params, spec=spec, refs=refs, x0=f(x0),
        xs0=f(np.tile(x0[None], (T1, 1))),
        us0=tau_g[None].expand(FORCE_T, 7).contiguous())


def run_soft_contact(device):
    """Phase 7 (b): soft contact on the Panda, f32 on the card. The batch
    SQP (B = 1, "xla", the soft step) against `solve_fddp` on the force
    OCP: terminal force within 0.3 N of each other (the JAX test's bound),
    both gaps under 1e-4; with `contact_active` zero on every node the
    force state stays at `FORCE_F0` within 1e-5; then `FORCE_MPC_TICKS`
    ticks of `MPC` over `OCPTorch` with the force-feedback warm start, the
    state closed through `OCPTorch.integrate` (the soft step), the last
    tick converged. Returns lines."""
    from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
    from agimus_controller_tpu_torch.solver.fddp import (
        SolverSettings,
        solve_fddp,
    )
    from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp

    fp = force_problem(device)
    t0 = time.perf_counter()
    sol_f = solve_fddp(build_cost_functions(fp.model, fp.params, fp.spec),
                       fp.x0, fp.refs, fp.xs0, fp.us0,
                       SolverSettings(max_iters=60))
    _sync(device)
    fddp_s = time.perf_counter() - t0
    sqp = make_batch_sqp(fp.model, fp.params, fp.spec, CSQPSettings(
        max_iters=60, termination_tolerance=1e-4), device=device)
    if sqp.backend != "xla":
        raise AssertionError(f"phase 7 (b): backend {sqp.backend!r}")
    t0 = time.perf_counter()
    sol_s = sqp(fp.x0[None], fp.refs, fp.xs0[None], fp.us0[None])
    _sync(device)
    sqp_s = time.perf_counter() - t0
    f_sqp = sol_s.xs[0, -1, 14:].double().cpu().numpy()
    f_fddp = sol_f.xs[-1, 14:].double().cpu().numpy()
    df = float(np.abs(f_sqp - f_fddp).max())
    gap = max(float(sol_s.gap_norm.max()), float(sol_f.gap_norm))
    if not (np.all(np.isfinite(f_sqp)) and df < 0.3 and gap < 1e-4):
        raise AssertionError(
            f"phase 7 (b): terminal force {f_sqp} vs solve_fddp's {f_fddp} "
            f"(max diff {df:.3f} N, bound 0.3), largest gap {gap:.2e}")
    # the contact inactive on every node: the force state rides along
    fi = force_problem(device, f0=FORCE_F0)
    fi.refs["contact_active"] = torch.zeros_like(fi.refs["contact_active"])
    fi.refs["w_force"] = torch.zeros_like(fi.refs["w_force"])
    sol_i = make_batch_sqp(fi.model, fi.params, fi.spec,
                           CSQPSettings(max_iters=10), device=device)(
        fi.x0[None], fi.refs, fi.xs0[None], fi.us0[None])
    drift = float((sol_i.xs[0, :, 14:] - torch.as_tensor(
        FORCE_F0, device=device)).abs().max())
    if not drift < 1e-5:
        raise AssertionError(
            f"phase 7 (b): inactive contact, force state moved {drift:.2e}")
    mpc = run_force_mpc(device)
    return [
        f"phase 7 (b) soft contact (Panda, T={FORCE_T}, f32): solve_fddp "
        f"{fddp_s:.2f} s, {int(sol_f.iters)} iterations, {sol_f.host_syncs} "
        f"host syncs, terminal force {np.round(f_fddp, 3).tolist()} N; "
        f"batch SQP ({sqp.backend}, soft step) {sqp_s:.2f} s, "
        f"{int(sol_s.iters[0])} iterations, {sqp.host_syncs} host syncs, "
        f"kkt {float(sol_s.kkt[0]):.2e}, terminal force "
        f"{np.round(f_sqp, 3).tolist()} N (max diff {df:.4f} N); largest gap "
        f"{gap:.2e}; inactive contact: force state held within {drift:.2e}",
        mpc]


def run_force_mpc(device):
    """Phase 7 (b)'s loop: `OCPTorch` on `force_spec` ("sqp", the batch
    SQP at B = 1), `MPC` with the `shift_previous_solution_force_feedback`
    warm start from the registry, a `TrajectoryBuffer` of points streaming
    f_des with its weight; the measured force comes from the closed-loop
    state. Returns the line."""
    from agimus_controller_tpu_torch.factory import create_warm_start
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY
    from agimus_controller_tpu_torch.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryBuffer,
        TrajectoryPoint,
        TrajectoryPointWeights,
        WeightedTrajectoryPoint,
    )
    from agimus_controller_tpu_torch.mpc.mpc import MPC
    from agimus_controller_tpu_torch.mpc.ocp_base import OCPParams, OCPTorch

    fp = force_problem(device)
    T, frame = FORCE_T, soft_contact_config().frame
    dt = fp.spec.dt
    tau_g = fp.us0[0].double().cpu().numpy()
    ocp = OCPTorch(fp.model, fp.params, fp.spec, OCPParams(
        dt=dt, horizon_size=T, solver_iters=10, termination_tolerance=1e-4,
        max_solve_time=10.0), dtype=torch.float32, device=device)
    ws = create_warm_start(
        "shift_previous_solution_force_feedback", fp.model, fp.params,
        timesteps=fp.spec.timesteps(), soft_contact=fp.spec.soft_contact,
        device=device)
    buf = TrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[T]))

    def point(i, q, v, f):
        return TrajectoryPoint(
            id=i, time_ns=int(i * dt * 1e9), robot_configuration=q,
            robot_velocity=v, robot_acceleration=np.zeros(7),
            robot_effort=tau_g,
            forces={frame: np.concatenate([np.zeros(3), f])})

    ref_w = TrajectoryPointWeights(
        w_robot_configuration=np.full(7, 0.05),
        w_robot_velocity=np.full(7, 0.5), w_robot_effort=np.ones(7),
        w_forces={frame: np.concatenate([np.full(3, 2.0), np.zeros(3)])})
    q, v, f = np.asarray(PANDA_Q_READY, float), np.zeros(7), np.zeros(3)
    for i in range(2 * T + FORCE_MPC_TICKS + 2):
        buf.append(WeightedTrajectoryPoint(
            point=point(i, q, v, np.asarray(FORCE_DES)), weights=ref_w))
    mpc = MPC()
    mpc.setup(ocp, ws, buf)
    ocp.set_reference_weighted_trajectory(buf.horizon)
    ocp.solve(np.concatenate([q, v, f]), list(fp.xs0.double().cpu().numpy()),
              list(fp.us0.double().cpu().numpy()),
              use_iteration_limits_and_timeout=False)
    ws.update_previous_solution(ocp.ocp_results)
    times, f_hist = [], []
    for it in range(FORCE_MPC_TICKS):
        t0 = time.perf_counter()
        res = mpc.run(point(it, q, v, f), int(it * dt * 1e9))
        times.append(time.perf_counter() - t0)
        if res is None:
            raise AssertionError(f"phase 7 (b) MPC tick {it}: no result")
        x = ocp.integrate(np.concatenate([q, v, f]),
                          res.feed_forward_terms[0])
        q, v, f = (x[:7].astype(float), x[7:14].astype(float),
                   x[14:].astype(float))
        f_hist.append(f)
    dbg = mpc.mpc_debug_data.ocp
    if not (dbg.problem_solved and np.all(np.isfinite(x))):
        raise AssertionError(
            f"phase 7 (b) MPC: last tick not converged (kkt "
            f"{dbg.kkt_norm:.2e}, {dbg.nb_iter} iterations)")
    return (
        f"phase 7 (b) MPC ({FORCE_MPC_TICKS} ticks, force-feedback warm "
        f"start, {ocp.solver_kind}): tick mean "
        f"{float(np.mean(times[1:])) * 1e3:.3f} ms (host clock); last tick "
        f"iters={dbg.nb_iter} kkt={dbg.kkt_norm:.2e} converged; measured "
        f"force {np.round(f_hist[-1], 3).tolist()} N after "
        f"{FORCE_MPC_TICKS} ticks")


def ff_problem(device, dtype=torch.float32, T=FF_T):
    """Phase 7 (c)'s problem: the JAX package's free-flyer goal solve, the
    Panda on a quaternion free-flyer base at pitch `FF_PITCH`, T nodes,
    full actuation, the hand's goal `FF_GOAL` from its start."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.ocp.ff_costs import build_ff_cost_functions
    from agimus_controller_tpu_torch.ocp.spec import CostItem, ProblemSpec
    from agimus_controller_tpu_torch.ops import lie

    model, params = load_panda(dtype=dtype, device=device, free_flyer=True)
    nv, frame = model.nj, "panda_hand_tcp"
    spec = ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.05,
                     update=True),
            CostItem(name="ctrl", kind="control", weight=1e-4, update=True)),
        terminal_costs=(CostItem(name="goal", kind="frame_placement",
                                 weight=100.0, update=True, frame=frame),),
        horizon=T, dt=0.02)
    cf = build_ff_cost_functions(model, params, spec, dtype=dtype,
                                 actuation="full")
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    th = FF_PITCH
    x0 = lie.join_state(f(np.zeros(3)),
                        f([0.0, np.sin(th / 2), 0.0, np.cos(th / 2)]),
                        f(PANDA_Q_READY), f(np.zeros(nv)))
    fid = model.frame_id(frame)
    R0, p0 = lie.ff_frame_placement(model, params, x0, fid)
    goal = p0 + f(FF_GOAL)
    T1 = T + 1
    refs = {"xref": x0[None].expand(T1, -1).contiguous(),
            "w_x": f(np.tile(np.concatenate(
                [np.full(nv, 0.1), np.full(nv, 1.0)])[None], (T1, 1))),
            "w_u": f(np.ones((T1, nv))), "uref": f(np.zeros((T1, nv))),
            f"ee_rot:{frame}": R0[None].expand(T1, 3, 3).contiguous(),
            f"ee_trans:{frame}": goal[None].expand(T1, 3).contiguous(),
            f"w_ee:{frame}": f(np.ones((T1, 6)))}
    end_error = lambda x: float(torch.linalg.vector_norm(
        lie.ff_frame_placement(model, params, x, fid)[1] - goal))
    return SimpleNamespace(
        model=model, params=params, spec=spec, cf=cf, refs=refs, x0=x0,
        xs0=x0[None].expand(T1, -1).contiguous(),
        us0=f(np.zeros((T, nv))), end_error=end_error,
        hand=lambda x: lie.ff_frame_placement(model, params, x, fid)[1])


def run_freeflyer(device):
    """Phase 7 (c): the quaternion free-flyer on the card in f32:
    `solve_fddp` and the manifold `BatchSQP` at B = `FF_ROWS` on
    `ff_problem`; each ends with the hand under 2 cm from its goal, and the
    two agree on the terminal hand position within 1 mm. Returns the
    line."""
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
    from agimus_controller_tpu_torch.solver.fddp import (
        SolverSettings,
        solve_fddp,
    )
    from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp

    fp = ff_problem(device)
    t0 = time.perf_counter()
    sol_f = solve_fddp(fp.cf, fp.x0, fp.refs, fp.xs0, fp.us0,
                       SolverSettings(max_iters=60,
                                      termination_tolerance=1e-4))
    _sync(device)
    fddp_s = time.perf_counter() - t0
    sqp = make_batch_sqp(fp.model, fp.params, fp.spec, CSQPSettings(
        max_iters=60, termination_tolerance=1e-4), device=device, cf=fp.cf)
    if sqp.backend != "manifold":
        raise AssertionError(f"phase 7 (c): backend {sqp.backend!r}")
    B = FF_ROWS
    t0 = time.perf_counter()
    sol_s = sqp(fp.x0[None].expand(B, -1), fp.refs,
                fp.xs0[None].expand(B, -1, -1), fp.us0[None].expand(B, -1, -1))
    _sync(device)
    sqp_s = time.perf_counter() - t0
    err_f = fp.end_error(sol_f.xs[-1])
    err_s = max(fp.end_error(sol_s.xs[b, -1]) for b in range(B))
    gap = max(float(torch.linalg.vector_norm(
        fp.hand(sol_s.xs[b, -1]) - fp.hand(sol_f.xs[-1])))
        for b in range(B))
    finite = bool(torch.isfinite(sol_f.us).all() & torch.isfinite(
        sol_s.us).all())
    if not (finite and err_f < 0.02 and err_s < 0.02 and gap < 1e-3):
        raise AssertionError(
            f"phase 7 (c): hand errors solve_fddp {err_f:.4f} m, BatchSQP "
            f"{err_s:.4f} m (bound 0.02), apart by {gap * 1e3:.3f} mm "
            "(bound 1)")
    return (
        f"phase 7 (c) quaternion free-flyer (Panda, pitch pi/2, T={FF_T}, "
        f"full actuation, f32): solve_fddp {fddp_s:.2f} s, "
        f"{int(sol_f.iters)} iterations, {sol_f.host_syncs} host syncs, hand "
        f"error {err_f * 1e3:.3f} mm; manifold BatchSQP (B={B}) "
        f"{sqp_s:.2f} "
        f"s, iterations {sol_s.iters.tolist()}, {sqp.host_syncs} host "
        f"syncs, hand error max {err_s * 1e3:.3f} mm; the two {gap * 1e3:.4f}"
        " mm apart")


SOFT_TICKS = 3
FF_TICKS = 2
FF_TICK_T = 10


def run_soft_tick(device):
    """Phase 7 (b) through the fused tick: `force_spec(FORCE_T)` on the
    Panda streamed through a `PackedTrajectoryBuffer` (f_des `FORCE_DES`
    weighted 2, the contact active), `FusedTickRunner` ("xla", the soft
    step) for an initial solve and `SOFT_TICKS` ticks, f32. Every control
    finite, the first solve's terminal force within 0.3 N of the batch
    SQP's on the same refs (the JAX test's bound). Returns the line."""
    from agimus_controller_tpu_torch.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryPoint,
        TrajectoryPointWeights,
        WeightedTrajectoryPoint,
    )
    from agimus_controller_tpu_torch.mpc.ring import (
        PackedTrajectoryBuffer,
        RowLayout,
    )
    from agimus_controller_tpu_torch.mpc.tick import FusedTickRunner
    from agimus_controller_tpu_torch.ocp.spec import default_references
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
    from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp

    fp = force_problem(device)
    T, frame = FORCE_T, soft_contact_config().frame
    x0 = fp.x0.double().cpu().numpy()
    tau_g = fp.us0[0].double().cpu().numpy()

    def point(i):
        return WeightedTrajectoryPoint(
            point=TrajectoryPoint(
                id=i, time_ns=int(i * fp.spec.dt * 1e9),
                robot_configuration=x0[:7], robot_velocity=x0[7:14],
                robot_effort=tau_g, forces={frame: np.concatenate(
                    [np.zeros(3), np.asarray(FORCE_DES)])}),
            weights=TrajectoryPointWeights(
                w_robot_configuration=np.full(7, 0.05),
                w_robot_velocity=np.full(7, 0.5), w_robot_effort=np.ones(7),
                w_forces={frame: np.concatenate([np.full(3, 2.0),
                                                 np.zeros(3)])}))

    buf = PackedTrajectoryBuffer(DTFactorsNSeq([1], [T]),
                                 RowLayout(fp.spec, fp.model),
                                 dtype=torch.float32, device=device)
    for i in range(2 * T + 2):
        buf.append(point(i))
    settings = CSQPSettings(max_iters=60, termination_tolerance=1e-4)
    runner = FusedTickRunner(
        fp.model, fp.params, fp.spec, buf.ring, default_references(
            fp.spec, fp.model, dtype=torch.float32, device=device), settings,
        dtype=torch.float32, device=device)
    if (runner.solver.backend, runner.solver.soft) != ("xla", True):
        raise AssertionError(
            f"phase 7 (b) tick: backend {runner.solver.backend!r}")
    xs0 = fp.xs0.double().cpu().numpy()
    us0 = fp.us0.double().cpu().numpy()
    t0 = time.perf_counter()
    first = runner.initialize(x0, xs0, us0, limit=60)
    f_tick = first.xs[-1, 14:].double().cpu().numpy()
    msgs = [runner.fetch()]
    ticks_s = []
    for k in range(SOFT_TICKS):
        buf.append(point(2 * T + 2 + k))
        t1 = time.perf_counter()
        runner.step(x0, limit=10)
        msgs.append(runner.fetch())
        ticks_s.append(time.perf_counter() - t1)
    total_s = time.perf_counter() - t0
    sol = make_batch_sqp(fp.model, fp.params, fp.spec, settings,
                         device=device)(fp.x0[None], fp.refs, fp.xs0[None],
                                        fp.us0[None])
    f_sqp = sol.xs[0, -1, 14:].double().cpu().numpy()
    df = float(np.abs(f_tick - f_sqp).max())
    finite = all(np.all(np.isfinite(m[0])) and np.all(np.isfinite(m[1]))
                 for m in msgs)
    if not (finite and df < 0.3):
        raise AssertionError(
            f"phase 7 (b) tick: terminal force {f_tick} vs the batch SQP's "
            f"{f_sqp} (max diff {df:.3f} N, bound 0.3), finite {finite}")
    return (f"phase 7 (b) soft contact through FusedTickRunner (xla, soft "
            f"step, f32): initial solve + {SOFT_TICKS} ticks {total_s:.2f} s "
            f"(ticks {' '.join(f'{t:.3f}' for t in ticks_s)} s), iterations "
            f"{[m[3] for m in msgs]}, last kkt {msgs[-1][2]:.2e}; first "
            f"solve's terminal force {np.round(f_tick, 3).tolist()} N, "
            f"{df:.4f} N from the batch SQP's")


def ff_tick_problem(device, dtype=torch.float32):
    """Phase 7 (c)'s tick: `ff_problem`'s robot, start and goal at
    T = `FF_TICK_T`, without the state cost (the ring's rows hold xref at
    the model's nx, the tangent width, where the quaternion state is one
    wider; ROADMAP queue 3): control regularisation and the terminal hand
    placement, streamed through a `PackedTrajectoryBuffer`."""
    from agimus_controller_tpu_torch.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryPoint,
        TrajectoryPointWeights,
        WeightedTrajectoryPoint,
    )
    from agimus_controller_tpu_torch.mpc.ring import (
        PackedTrajectoryBuffer,
        RowLayout,
    )
    from agimus_controller_tpu_torch.ocp.ff_costs import build_ff_cost_functions
    from agimus_controller_tpu_torch.ocp.spec import (
        CostItem,
        ProblemSpec,
        default_references,
    )

    fp = ff_problem(device, dtype, T=FF_TICK_T)
    model, frame = fp.model, "panda_hand_tcp"
    spec = ProblemSpec(
        running_costs=(fp.spec.running_costs[1],),
        terminal_costs=fp.spec.terminal_costs, horizon=FF_TICK_T,
        dt=fp.spec.dt)
    cf = build_ff_cost_functions(model, fp.params, spec, dtype=dtype,
                                 actuation="full")
    goal = fp.refs[f"ee_trans:{frame}"][0].double().cpu().numpy()
    R0 = fp.refs[f"ee_rot:{frame}"][0].double().cpu().numpy()

    def point(i):
        return WeightedTrajectoryPoint(
            point=TrajectoryPoint(
                id=i, time_ns=int(i * spec.dt * 1e9),
                robot_configuration=np.zeros(model.nq),
                robot_velocity=np.zeros(model.nv),
                robot_effort=np.zeros(model.nv),
                end_effector_poses={frame: (R0, goal)}),
            weights=TrajectoryPointWeights(
                w_robot_configuration=np.zeros(model.nq),
                w_robot_velocity=np.zeros(model.nv),
                w_robot_effort=np.ones(model.nv),
                w_end_effector_poses={frame: np.ones(6)}))

    buf = PackedTrajectoryBuffer(DTFactorsNSeq([1], [FF_TICK_T]),
                                 RowLayout(spec, model), dtype=dtype,
                                 device=device)
    for i in range(2 * FF_TICK_T + 2):
        buf.append(point(i))
    return SimpleNamespace(
        fp=fp, spec=spec, cf=cf, buf=buf, point=point,
        base=default_references(spec, model, dtype=dtype, device=device))


def run_ff_tick(device):
    """Phase 7 (c) through the fused tick: `FusedTickRunner(cf=...)` (the
    "manifold" backend) on `ff_tick_problem`, f32: an initial solve from
    the start and `FF_TICKS` ticks on the same streamed goal (each tick's
    refs equal the first's). The manifold `BatchSQP` then solves those refs
    to convergence from the last tick's solution; each tick's terminal hand
    lies within 1 mm of its. Returns the line."""
    from agimus_controller_tpu_torch.mpc.ring import gather_horizon_rows
    from agimus_controller_tpu_torch.mpc.tick import FusedTickRunner
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
    from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp

    tp = ff_tick_problem(device)
    fp, ring = tp.fp, tp.buf.ring
    settings = CSQPSettings(max_iters=60, termination_tolerance=1e-4)
    runner = FusedTickRunner(fp.model, fp.params, tp.spec, ring, tp.base,
                             settings, dtype=torch.float32, device=device,
                             cf=tp.cf)
    if runner.solver.backend != "manifold":
        raise AssertionError(
            f"phase 7 (c) tick: backend {runner.solver.backend!r}")
    hidx, mask = ring.gather_spec()
    hidx = torch.as_tensor(hidx, device=device)

    def refs_at(slot):
        return ring.layout.unpack_refs(
            gather_horizon_rows(ring.sync(), slot, hidx, mask), tp.base)

    refs0 = refs_at(torch.as_tensor(ring.device_state()[1], device=device))
    x0 = fp.x0.double().cpu().numpy()
    outs, ticks_s = [], []
    for k in range(FF_TICKS + 1):
        t0 = time.perf_counter()
        if k == 0:
            out = runner.initialize(x0, fp.xs0.double().cpu().numpy(),
                                    fp.us0.double().cpu().numpy(), limit=60)
        else:
            tp.buf.append(tp.point(2 * FF_TICK_T + 1 + k))
            slot = runner._slot
            out = runner.step(x0, limit=10)
            refs = refs_at(slot)
            if not all(torch.equal(refs[key], refs0[key]) for key in refs0):
                raise AssertionError(f"phase 7 (c) tick {k}: refs changed")
        _sync(device)
        ticks_s.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(out.us).all()):
            raise AssertionError(f"phase 7 (c) tick {k}: non-finite controls")
        outs.append(out)
    t0 = time.perf_counter()
    sol = make_batch_sqp(fp.model, fp.params, tp.spec, settings,
                         device=device, cf=tp.cf)(
        fp.x0[None], refs0, outs[-1].xs[None], outs[-1].us[None])
    _sync(device)
    sqp_s = time.perf_counter() - t0
    hand = fp.hand(sol.xs[0, -1])
    gaps = [float(torch.linalg.vector_norm(fp.hand(o.xs[-1]) - hand))
            for o in outs]
    if not (bool(sol.converged[0]) and max(gaps) < 1e-3):
        raise AssertionError(
            f"phase 7 (c) tick: terminal hands {max(gaps) * 1e3:.3f} mm from "
            f"the batch SQP's (bound 1), its convergence "
            f"{bool(sol.converged[0])}")
    return (f"phase 7 (c) free-flyer through FusedTickRunner(cf=...) "
            f"(manifold, T={FF_TICK_T}, f32): initial solve + {FF_TICKS} "
            f"ticks {' '.join(f'{t:.2f}' for t in ticks_s)} s, iterations "
            f"{[int(o.iters) for o in outs]}; the manifold BatchSQP to "
            f"convergence {sqp_s:.2f} s ({int(sol.iters[0])} iterations); "
            f"terminal hands {max(gaps) * 1e3:.4f} mm from its at most")


def run_sensitivity(device):
    """Phase 7: `next_state_sensitivity` on the Panda in f64 on the card,
    against the same call on the CPU (within 1e-9). Returns the line."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.parallel import (
        next_state_sensitivity,
        sensitivity_svd,
    )

    rng = np.random.default_rng(0)
    x0 = np.concatenate([np.asarray(PANDA_Q_READY) + rng.normal(size=7) * 0.1,
                         rng.normal(size=7) * 0.3])
    u0 = rng.normal(size=7) * 2.0
    model, params = load_panda(dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    S, labels = next_state_sensitivity(model, params, x0, u0)
    card_s = time.perf_counter() - t0
    S_cpu, _ = next_state_sensitivity(
        *load_panda(dtype=torch.float64, device="cpu"), x0, u0)
    d = float(np.abs(S - S_cpu).max())
    if not (S.shape == (len(labels), 14) and d <= 1e-9):
        raise AssertionError(
            f"phase 7 sensitivity: card vs CPU {d:.3e} (bound 1e-9)")
    s = sensitivity_svd(S)[1]
    return (f"phase 7 sensitivity (Panda, f64): {len(labels) + 1} params "
            f"rows in one vmapped Euler step, {card_s:.3f} s on the card; "
            f"S {S.shape}, card vs CPU max abs diff {d:.3e} (bound 1e-9); "
            f"singular values {s[0]:.4e} .. {s[-1]:.4e}")


def run_slice12_phase(device):
    """Phase 7: (a) the Tiago-Pro arm on K1-K5b's nj = 8 instances, (b)
    soft contact (also through the fused tick), (c) the quaternion
    free-flyer (also through the fused tick with `cf=`), and the
    model-parameter sensitivity sweep. Returns (launches per kernel,
    lines)."""
    launches = {name: 0 for name, *_ in KERNELS}
    lines = []
    for part in (run_tiago_tick, run_tiago_batch):
        t0 = time.perf_counter()
        got, line = part(device)
        lines.append(f"{line} [{time.perf_counter() - t0:.1f} s]")
        for name, n in got.items():
            launches[name] += n
    t0 = time.perf_counter()
    soft = run_soft_contact(device)
    lines += soft[:-1] + [f"{soft[-1]} [{time.perf_counter() - t0:.1f} s]"]
    for part in (run_soft_tick, run_freeflyer, run_ff_tick, run_sensitivity):
        t0 = time.perf_counter()
        lines.append(f"{part(device)} [{time.perf_counter() - t0:.1f} s]")
    return launches, lines


def run_full_tiago_phase(device):
    """Phase 9: the full 17-DoF branched Tiago-Pro on K1-K5b's nj = 17
    instances, f32, T = `TIAGO_T`, dt 0.02: both tools' translations
    through `FusedTickRunner` (phase 7 (a)'s buffer and schedule) and
    `make_batch_fddp` at B = `TIAGO_B` on K5a, K5b and R1, rows 0-7 against
    a B = 8 solve. Returns (launches per kernel, lines)."""
    launches = {name: 0 for name, *_ in KERNELS}
    lines = []
    for part in (run_tiago_tick, run_tiago_batch):
        t0 = time.perf_counter()
        got, line = part(device, full=True)
        lines.append(f"{line} [{time.perf_counter() - t0:.1f} s]")
        for name, n in got.items():
            launches[name] += n
    return launches, lines


# -- phase 8: the multi-device layer (slice 16) on one card -----------------
MESH_SLOTS = 4  # slots of the one card (the JAX tests' virtual devices)
KEEP_AWAY_GOAL = (0.45, 0.05, 0.55)  # the hand's goal, world frame
MESH_T, MESH_B = 24, 16  # (a): 4 rows per slot
MESH_FDDP_B = 1024  # (b): 256 rows per slot
CSQP_B = 8  # (c): 2 rows per slot
CSQP_SETTINGS = dict(max_iters=4, max_qp_iters=25, reg_init=1e-7)
TSHARD_T, TSHARD_FDDP_T = 400, 64  # (d), float64
TSHARD_TOL = 1e-9
TINY_T, TINY_ROWS = 8, 2  # (e): the two-process solve, rows per process
# the rule phase 4 holds its rows 0-7 to: iterations and flags equal, us
# within this
ROWS_US_TOL = 1e-3


def batch_mesh(device, n=MESH_SLOTS):
    """The single-process global mesh over n slots of `device`, after the
    multi-process init (a no-op alone), collapsed to its batch axis (as the
    JAX package's two-process worker does)."""
    from agimus_controller_tpu_torch.parallel import (
        initialize_distributed,
        make_global_mesh,
    )
    from agimus_controller_tpu_torch.parallel.mesh import Mesh

    if initialize_distributed():
        raise AssertionError("phase 8: a single process joined a group")
    mesh = make_global_mesh(t_shards=1, devices=[device] * n)
    if mesh.shape != {"batch": n, "t": 1}:
        raise AssertionError(f"phase 8: global mesh {mesh.shape}")
    return Mesh(mesh.devices.reshape(-1), ("batch",),
                mesh.process_ids.reshape(-1))


def keep_away_problem(device, B, dtype=torch.float32, seed=None):
    """The collision keep-away CSQP of the JAX package's multi-chip dryrun:
    the Panda with phase 4's obstacle, a 2 cm band on link 7's capsule
    (`collision_distance`), the hand pulled to `KEEP_AWAY_GOAL`, T=24.
    Returns (model, params, spec, refs, x0s, xs0, us0): every row starts
    at the ready state, or ready + N(0, 0.02^2) on q with `seed`."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.ocp.spec import (
        ConstraintItem,
        CostItem,
        ProblemSpec,
        default_references,
    )
    from agimus_controller_tpu_torch.ops.kinematics import frame_placement

    T = MESH_T
    model, params = load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                               dtype=dtype, device=device)
    goal = dict(kind="frame_placement", update=True, frame="panda_hand_tcp")
    spec = ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="ctrl", kind="control", weight=1e-3,
                     act_weights=(1.0,) * 7),
            CostItem(name="goal", weight=10.0, **goal)),
        terminal_costs=(CostItem(name="goal", weight=100.0, **goal),),
        constraints=(ConstraintItem(name="coll", kind="collision_distance",
                                    pair_id=0, lower=(0.02,)),),
        horizon=T, dt=0.01)
    _, params64 = load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                             dtype=torch.float64, device="cpu")
    q0 = np.asarray(PANDA_Q_READY)
    x0 = np.concatenate([q0, np.zeros(7)])
    R0 = frame_placement(model, params64, torch.as_tensor(q0),
                         model.frame_id("panda_hand_tcp"))[0].numpy()
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    tile = lambda a: f(np.tile(np.asarray(a)[None],
                               (T + 1,) + (1,) * np.ndim(a)))
    refs = default_references(spec, model, dtype=dtype, device=device)
    refs["xref"] = tile(x0)
    refs["ee_rot:panda_hand_tcp"] = tile(R0)
    refs["ee_trans:panda_hand_tcp"] = tile(KEEP_AWAY_GOAL)
    x0s = np.tile(x0[None], (B, 1))
    if seed is not None:
        x0s[:, :7] += 0.02 * np.random.default_rng(seed).normal(size=(B, 7))
    return (model, params, spec, refs, f(x0s),
            f(np.tile(x0s[:, None], (1, T + 1, 1))),
            torch.zeros((B, T, 7), dtype=dtype, device=device))


def _rows_agree(part, got, want):
    """Phase 4's rule for rows solved apart: iterations and flags equal, us
    within `ROWS_US_TOL`. Returns the us difference."""
    du = float((got.us - want.us).abs().max())
    if not (torch.equal(got.iters, want.iters)
            and torch.equal(got.converged, want.converged)
            and du < ROWS_US_TOL):
        raise AssertionError(
            f"phase 8 {part}: sharded rows (iters {got.iters.tolist()}, "
            f"converged {got.converged.tolist()}) differ from the unsharded "
            f"solve's (iters {want.iters.tolist()}, converged "
            f"{want.converged.tolist()}), us max abs diff {du:.3e}")
    return du


def _finite(part, sol):
    for field in ("xs", "us", "K", "k", "cost", "kkt"):
        if not bool(torch.isfinite(getattr(sol, field)).all()):
            raise AssertionError(f"phase 8 {part}: non-finite {field}")


def _timed(device, fn):
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _path_launches(part, solver, names):
    """The launches of the solver built for the mesh's card, zeroed before
    the path ran; raises where one kernel did not launch."""
    got = {name: k.launches for name, k in zip(names, solver.kernels)}
    if len(got) != len(names) or min(got.values()) <= 0:
        raise AssertionError(f"phase 8 {part}: launches {got}")
    return got


def run_sharded_sqp(device, mesh):
    """(a) `sharded_batch_sqp` on the "auto" backend over the mesh's slots:
    the keep-away problem at B=16 from the ready state (2 SQP and 10 ADMM
    iterations, the dryrun's settings) against the unsharded
    `make_batch_sqp`; the replicated rows must be equal."""
    from agimus_controller_tpu_torch.parallel.mesh import sharded_batch_sqp
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
    from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp

    model, params, spec, refs, x0s, xs0, us0 = keep_away_problem(device,
                                                                 MESH_B)
    s = CSQPSettings(max_iters=2, max_qp_iters=10, reg_init=1e-7)
    sharded = sharded_batch_sqp(model, params, spec, None, s, mesh)
    solver = sharded.solver(mesh.slots("batch")[0][0])
    if solver.backend != "kernels":
        raise AssertionError(f"phase 8 (a): backend {solver.backend!r} "
                             f"({solver.backend_reason})")
    plain = make_batch_sqp(model, params, spec, s, device=device)
    for k in solver.kernels:
        k.launches = 0
    sol, sharded_s = _timed(device, lambda: sharded(x0s, refs, xs0, us0))
    launches = _path_launches("(a)", solver,
                              [name for name, *_ in STAGE_KERNELS])
    ref, plain_s = _timed(device, lambda: plain(x0s, refs, xs0, us0))
    _finite("(a)", sol)
    for f in sol._fields:
        v = getattr(sol, f)
        if isinstance(v, torch.Tensor) and not bool(
                (v == v[:1]).all() | (v.isnan() & v[:1].isnan()).all()):
            raise AssertionError(f"phase 8 (a): replicated rows differ in {f}")
    du = _rows_agree("(a)", sol, ref)
    return launches, (
        f"phase 8 (a) sharded_batch_sqp (backend {solver.backend}) over "
        f"{len(mesh.slots('batch'))} slots of {device}, keep-away T={MESH_T}, "
        f"B={MESH_B}, f32: {sharded_s:.3f} s against the unsharded "
        f"{plain_s:.3f} s (host clock, synchronized); iters "
        f"{sol.iters.tolist()[:1]}, ADMM {sol.qp_iters.tolist()[:1]}, band "
        f"violation {float(sol.constraint_norm.max()):.2e}; replicated rows "
        f"equal; us max abs diff to unsharded {du:.3e}; launches {launches}")


def run_sharded_fddp(device, mesh):
    """(b) `sharded_batch_fddp` on the flagship batch problem (phase 4's, 10
    iterations) at B=1024 over the mesh's slots, against the unsharded
    B=1024 solve."""
    from agimus_controller_tpu_torch.models.panda import load_panda
    from agimus_controller_tpu_torch.parallel.mesh import sharded_batch_fddp
    from agimus_controller_tpu_torch.solver.fddp import SolverSettings

    bp = build_batch(device, n_variants=1)
    model, params = load_panda(dtype=torch.float32, device=device)
    sharded = sharded_batch_fddp(model, params, flagship_spec(BATCH_T), None,
                                 SolverSettings(max_iters=10), mesh)
    solver = sharded.solver(mesh.slots("batch")[0][0])
    n = MESH_FDDP_B
    args = (bp.variants[0][:n], bp.refs, bp.xs0[:n], bp.us0[:n])
    for k in solver.kernels:
        k.launches = 0
    sol, sharded_s = _timed(device, lambda: sharded(*args))
    launches = _path_launches("(b)", solver,
                              [name for name, *_ in FDDP_KERNELS])
    ref, plain_s = _timed(device, lambda: bp.solver(*args))
    _finite("(b)", sol)
    du = _rows_agree("(b)", sol, ref)
    c = lambda a: a.double().cpu().numpy()
    return launches, (
        f"phase 8 (b) sharded_batch_fddp over {len(mesh.slots('batch'))} "
        f"slots, flagship T={BATCH_T}, B={n}, f32: {sharded_s:.3f} s against "
        f"the unsharded {plain_s:.3f} s (host clock, synchronized); mean "
        f"iterations {float(c(sol.iters).mean()):.2f}, converged share "
        f"{float(c(sol.converged).mean()):.4f}; iterations and flags equal, "
        f"us max abs diff {du:.3e}; launches {launches}")


def run_batch_csqp(device, mesh):
    """(c) `make_batch_csqp` and `sharded_batch_csqp` on (a)'s problem at
    B=8 with perturbed starts: the sharded rows against the unsharded ones
    (the shards exit each ADMM loop together), row 0 against `solve_csqp`
    (phase 5 (c)'s bounds)."""
    from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
    from agimus_controller_tpu_torch.parallel.mesh import sharded_batch_csqp
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings, solve_csqp
    from agimus_controller_tpu_torch.solver.csqp_batch import make_batch_csqp

    model, params, spec, refs, x0s, xs0, us0 = keep_away_problem(
        device, CSQP_B, seed=0)
    cf = build_cost_functions(model, params, spec)
    s = CSQPSettings(**CSQP_SETTINGS)
    batch = make_batch_csqp(model, params, spec, cf, s, device=device)
    sharded = sharded_batch_csqp(model, params, spec, cf, s, mesh)
    solver = sharded.solver(mesh.slots("batch")[0][0])
    for k in solver.kernels + batch.kernels:
        k.launches = 0
    sol, sharded_s = _timed(device, lambda: sharded(x0s, refs, xs0, us0))
    launches = _path_launches("(c)", solver,
                              [name for name, *_ in STEP_KERNELS])
    ref, batch_s = _timed(device, lambda: batch(x0s, refs, xs0, us0))
    batch_launches = _path_launches("(c) unsharded", batch,
                                    [name for name, *_ in STEP_KERNELS])
    _finite("(c)", sol)
    du = _rows_agree("(c)", sol, ref)
    if not torch.equal(sol.qp_iters, ref.qp_iters):
        raise AssertionError(
            f"phase 8 (c): sharded ADMM counts {sol.qp_iters.tolist()} != "
            f"unsharded {ref.qp_iters.tolist()}")
    one, single_s = _timed(device, lambda: solve_csqp(
        cf, x0s[0], refs, xs0[0], us0[0], s))
    agree = _agreement("(c)", float((ref.us[0] - one.us).abs().max()),
                       abs(float(ref.cost[0] - one.cost)) / abs(float(one.cost)))
    for name, n in batch_launches.items():
        launches[name] += n
    return launches, (
        f"phase 8 (c) make_batch_csqp B={CSQP_B} {batch_s:.3f} s, "
        f"sharded_batch_csqp over {len(mesh.slots('batch'))} slots "
        f"{sharded_s:.3f} s (host clock, synchronized), keep-away T={MESH_T}, "
        f"f32, {CSQP_SETTINGS}: iters {ref.iters.tolist()}, ADMM "
        f"{ref.qp_iters.tolist()} (equal sharded), us max abs diff sharded "
        f"{du:.3e}; row 0 against solve_csqp ({single_s:.3f} s): {agree}; "
        f"launches {launches}")


def random_lqr(T, nx, nu, seed=0, device="cpu"):
    """A random well-posed LQR (f64), the JAX package's
    `tests/test_riccati_sharded.py::_random_lqr`: (lx, lu, lxx, lxu, luu,
    Fx, Fu, fs [T+1], term_lx, term_lxx)."""
    rng = np.random.default_rng(seed)
    sym = lambda a: 0.5 * (a + np.swapaxes(a, -1, -2))
    lxx = sym(rng.normal(size=(T, nx, nx)) * 0.1) + 2.0 * np.eye(nx)
    luu = sym(rng.normal(size=(T, nu, nu)) * 0.1) + 2.0 * np.eye(nu)
    lxu = rng.normal(size=(T, nx, nu)) * 0.05
    lx = rng.normal(size=(T, nx))
    lu = rng.normal(size=(T, nu))
    Fx = np.tile(np.eye(nx), (T, 1, 1)) + rng.normal(size=(T, nx, nx)) * 0.02
    Fu = rng.normal(size=(T, nx, nu)) * 0.1
    fs = rng.normal(size=(T + 1, nx)) * 0.01
    term_lx = rng.normal(size=(nx,))
    term_lxx = sym(rng.normal(size=(nx, nx)) * 0.1) + 3.0 * np.eye(nx)
    return [torch.as_tensor(a, dtype=torch.float64, device=device) for a in
            (lx, lu, lxx, lxu, luu, Fx, Fu, fs, term_lx, term_lxx)]


def _close(a, b, rtol=TSHARD_TOL, atol=0.1 * TSHARD_TOL):
    """(within rtol/atol, the max abs difference)."""
    d = (a - b).abs()
    return bool((d <= atol + rtol * b.abs()).all()), float(d.max())


def run_tsharded(device, mesh):
    """(d) the horizon-sharded Riccati in f64 on the card over the mesh's
    slots (axis "t"): `make_tsharded_riccati` against `parallel_riccati`
    at T=400, and `solve_fddp_tsharded` against `solve_fddp` on the
    flagship OCP at T=64, 2 iterations, the iterates within 1e-9."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.ocp.costs import build_cost_functions
    from agimus_controller_tpu_torch.ocp.spec import default_references
    from agimus_controller_tpu_torch.parallel.mesh import Mesh
    from agimus_controller_tpu_torch.solver.fddp import SolverSettings, solve_fddp
    from agimus_controller_tpu_torch.solver.riccati_pscan import parallel_riccati
    from agimus_controller_tpu_torch.solver.riccati_sharded import (
        make_tsharded_riccati,
        solve_fddp_tsharded,
    )

    tmesh = Mesh(mesh.devices, ("t",))
    a = random_lqr(TSHARD_T, 14, 7, device=device)
    reg = 1e-6
    got, shard_s = _timed(device, lambda: make_tsharded_riccati(tmesh)(
        *a[:7], a[7][1:], a[8], a[9], reg))
    b = lambda x: x[:, None]
    want, scan_s = _timed(device, lambda: parallel_riccati(
        *(b(x) for x in a[:8]), a[8][None], a[9][None],
        torch.tensor([reg], dtype=torch.float64, device=device)))
    errs = []
    for name, g, w in zip(("ks", "Ks", "Qus", "d1", "d2"),
                          got[:3] + got[5:], [w[:, 0] for w in want[:3]]
                          + [want[3][0], want[4][0]]):
        ok, e = _close(g, w)
        errs.append(e)
        if not ok:
            raise AssertionError(f"phase 8 (d): sharded Riccati {name} off "
                                 f"by {e:.3e} (rtol {TSHARD_TOL})")
    T = TSHARD_FDDP_T
    model, params = load_panda(dtype=torch.float64, device=device)
    spec = flagship_spec(T)
    cf = build_cost_functions(model, params, spec, torch.float64)
    refs = default_references(spec, model, dtype=torch.float64, device=device)
    x0 = torch.cat([torch.as_tensor(PANDA_Q_READY, dtype=torch.float64),
                    torch.zeros(7, dtype=torch.float64)]).to(device)
    refs["xref"] = x0[None].repeat(T + 1, 1)
    problem = (cf, x0, refs, x0[None].repeat(T + 1, 1),
               torch.zeros((T, 7), dtype=torch.float64, device=device))
    s = SolverSettings(max_iters=2, n_alphas=4)
    ref, fddp_s = _timed(device, lambda: solve_fddp(*problem, s))
    sol, tfddp_s = _timed(device, lambda: solve_fddp_tsharded(*problem, s,
                                                              tmesh))
    diffs = {}
    for f in ("xs", "us", "K", "k", "cost", "kkt"):
        diffs[f] = float((getattr(sol, f) - getattr(ref, f)).abs().max())
    if not (max(diffs.values()) <= TSHARD_TOL
            and int(sol.iters) == int(ref.iters)):
        raise AssertionError(f"phase 8 (d): solve_fddp_tsharded off by "
                             f"{diffs} (bound {TSHARD_TOL})")
    return (
        f"phase 8 (d) horizon-sharded Riccati over {len(tmesh.slots('t'))} "
        f"slots, f64: T={TSHARD_T} {shard_s * 1e3:.1f} ms against "
        f"parallel_riccati {scan_s * 1e3:.1f} ms (host clock, synchronized), "
        f"max abs diff {max(errs):.3e}; solve_fddp_tsharded T={T}, 2 "
        f"iterations, {tfddp_s:.2f} s against solve_fddp {fddp_s:.2f} s, "
        f"max abs diff {max(diffs.values()):.3e} (bound {TSHARD_TOL})")


def tiny_problem(device, dtype=torch.float64):
    """The JAX package's two-process test problem
    (`tests/_distributed_problem.py`) on the port: the Panda, T=8,
    goal tracking. Returns (model, params, spec, refs, x0_of) with x0_of(i)
    scenario i's start, the ready pose with a deterministic per-scenario
    joint offset."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.ocp.spec import (
        CostItem,
        ProblemSpec,
        default_references,
    )

    T = TINY_T
    model, params = load_panda(dtype=dtype, device=device)
    goal = dict(kind="frame_placement", update=True, frame="panda_hand_tcp")
    spec = ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="ctrl", kind="control_grav", weight=1e-3),
            CostItem(name="goal", weight=10.0, **goal)),
        terminal_costs=(CostItem(name="goal", weight=100.0, **goal),),
        horizon=T, dt=0.01)
    refs = default_references(spec, model, dtype=dtype, device=device)
    x0 = np.concatenate([np.asarray(PANDA_Q_READY, np.float64), np.zeros(7)])
    refs["xref"] = torch.as_tensor(np.tile(x0[None], (T + 1, 1)),
                                   dtype=dtype, device=device)

    def x0_of(i: int) -> np.ndarray:
        out = x0.copy()
        out[:7] += 0.02 * (1 + i) * np.sin(1.0 + np.arange(7.0))
        return out

    return model, params, spec, refs, x0_of


TINY_SETTINGS = dict(max_iters=4, reg_init=1e-7)


def distributed_worker(out_path: str, device: str):
    """One process of a two-process sharded solve (the `AGIMUS_*`
    environment gives the coordinator, the count and the rank): the global
    mesh (on the CPU, two slots per process; on a card, each process's
    cards), its own `TINY_ROWS` scenarios through `host_local_to_global`,
    `sharded_batch_sqp` on the "xla" backend; writes its rows, their global
    indices, the group's backend and the step kernels' launches to
    `out_path` (npz)."""
    from agimus_controller_tpu_torch.parallel import (
        host_local_to_global,
        initialize_distributed,
        make_global_mesh,
    )
    from agimus_controller_tpu_torch.parallel import distributed
    from agimus_controller_tpu_torch.parallel.mesh import Mesh, sharded_batch_sqp
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings

    if not initialize_distributed():
        raise AssertionError("multi-process launch not detected")
    nproc, pid = distributed.process_count(), distributed.process_index()
    if nproc != 2:
        raise AssertionError(f"{nproc} processes")
    dev = torch.device(device)
    mesh = make_global_mesh(t_shards=1, devices=(
        [dev] * 4 if dev.type == "cpu" else None))
    mesh_b = Mesh(mesh.devices.reshape(-1), ("batch",),
                  mesh.process_ids.reshape(-1))
    dtype = torch.float64 if dev.type == "cpu" else torch.float32
    model, params, spec, refs, x0_of = tiny_problem(dev, dtype)
    T = spec.horizon
    x0s = np.stack([x0_of(pid * TINY_ROWS + i) for i in range(TINY_ROWS)])
    x0s, xs0, us0 = host_local_to_global(mesh_b, (
        torch.as_tensor(x0s, dtype=dtype),
        torch.as_tensor(np.repeat(x0s[:, None], T + 1, 1), dtype=dtype),
        torch.zeros((TINY_ROWS, T, 7), dtype=dtype)))
    if x0s.global_size != nproc * TINY_ROWS:
        raise AssertionError(f"global batch {x0s.global_size}")
    solver = sharded_batch_sqp(model, params, spec, None,
                               CSQPSettings(**TINY_SETTINGS), mesh_b,
                               backend="xla")
    sol = solver(x0s, refs, xs0, us0)
    local = solver.solver(solver.local[0])
    np.savez(out_path,
             idx=np.arange(sol.us.start, sol.us.start + TINY_ROWS),
             us=sol.us.data.double().cpu().numpy(),
             iters=sol.iters.data.cpu().numpy(),
             converged=sol.converged.data.cpu().numpy(),
             backend=np.asarray(distributed.backend()),
             launches=np.asarray([k.launches for k in local.kernels]))
    print(f"worker {pid}: rows {sol.us.start}..{sol.us.start + TINY_ROWS - 1}"
          f" on {solver.local} -> {out_path}", flush=True)


def start_workers(script, out_dir: Path, device: str, extra=()):
    """Start two `script` processes (`script out_path device *extra`) as
    one group through the `AGIMUS_*` environment, coordinator on a free
    localhost port; returns (the processes, their output paths) for
    `finish_workers`."""
    import os
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    outs = [out_dir / f"worker{i}.npz" for i in range(2)]
    procs = []
    for pid in range(2):
        env = dict(os.environ, AGIMUS_COORDINATOR=f"localhost:{port}",
                   AGIMUS_NUM_PROCESSES="2", AGIMUS_PROCESS_ID=str(pid),
                   PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(outs[pid]), device, *extra],
            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs, outs


def finish_workers(procs, outs, timeout=300):
    """Wait for `start_workers`' processes (killing any still running after
    `timeout` s or on an error); returns their npz results in rank order.
    Raises with both logs if a worker failed."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("worker failed:\n" + "\n---\n".join(logs))
    return [dict(np.load(o)) for o in outs]


def launch_workers(script, out_dir: Path, device: str, extra=()):
    """`start_workers` then `finish_workers`."""
    return finish_workers(*start_workers(script, out_dir, device, extra))


def tiny_reference(device, dtype, n):
    """The single-process solve of the two-process problem's n rows."""
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
    from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp

    model, params, spec, refs, x0_of = tiny_problem(device, dtype)
    T = spec.horizon
    x0s = np.stack([x0_of(i) for i in range(n)])
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    solver = make_batch_sqp(model, params, spec,
                            CSQPSettings(**TINY_SETTINGS), device=device,
                            backend="xla")
    return solver(f(x0s), refs, f(np.repeat(x0s[:, None], T + 1, 1)),
                  torch.zeros((n, T, 7), dtype=dtype, device=device))


def start_two_processes(device, out_dir: Path):
    """(e)'s two `chip_smoke.py --worker` processes on `device`, started
    before (a) so that their start-up runs beside (a)-(d); returns the
    handle `run_two_processes` takes."""
    return start_workers(ROOT / "chip_smoke.py", out_dir, device.type,
                         ("--worker",)), time.perf_counter()


def run_two_processes(device, started):
    """(e) two processes sharing the card through the `AGIMUS_*` path (the
    group on gloo: NCCL refuses two ranks on one card), `TINY_ROWS` rows
    each, f32 (`start_two_processes`): each process's rows against the
    single-process solve of the four rows (phase 4's rule). Returns (the
    workers' K5a/K5b launches, line)."""
    (procs, outs), t0 = started
    results = finish_workers(procs, outs)
    wall = time.perf_counter() - t0
    n = 2 * TINY_ROWS
    ref = tiny_reference(device, torch.float64 if device.type == "cpu"
                         else torch.float32, n)
    got = {}
    for r in results:
        if str(r["backend"]) != "gloo":
            raise AssertionError(f"phase 8 (e): backend {r['backend']}")
        for k, i in enumerate(r["idx"]):
            got[int(i)] = (r["us"][k], int(r["iters"][k]),
                           bool(r["converged"][k]))
    if sorted(got) != list(range(n)):
        raise AssertionError(f"phase 8 (e): rows {sorted(got)}")
    du = 0.0
    for i in range(n):
        us, it, conv = got[i]
        du = max(du, float(np.abs(us - ref.us[i].double().cpu().numpy()).max()))
        if (it, conv) != (int(ref.iters[i]), bool(ref.converged[i])) or \
                not du < ROWS_US_TOL:
            raise AssertionError(
                f"phase 8 (e): row {i} (iters {it}, converged {conv}) against "
                f"the single-process solve (iters {int(ref.iters[i])}, "
                f"converged {bool(ref.converged[i])}), us diff {du:.3e}")
    launches = {name: int(sum(r["launches"][j] for r in results))
                for j, (name, *_) in enumerate(STEP_KERNELS)}
    return launches, (
        f"phase 8 (e) two processes on {device} (group backend gloo, "
        f"AGIMUS_* environment), tiny T={TINY_T}, {TINY_ROWS} rows each, "
        f"{str(ref.us.dtype).replace('torch.', '')}, "
        f"'xla' backend: {wall:.1f} s from their start, beside (a)-(d); "
        f"rows equal the "
        f"single-process solve by phase 4's rule (us max abs diff {du:.3e}, "
        f"iters {ref.iters.tolist()}); launches {launches}")


def run_multi_device_phase(device):
    """Phase 8: the multi-device layer on one card, four slots of it: (a)
    the batch-sharded SQP on K1-K4, (b) the batch-sharded FDDP and (c) the
    batch CSQP on K5a/K5b, (d) the horizon-sharded Riccati in f64, (e) two
    processes sharing the card, started before (a) and joined after (d).
    Returns (launches per kernel, lines)."""
    import tempfile

    launches = {name: 0 for name, *_ in KERNELS}
    lines = []
    mesh = batch_mesh(device)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        started = start_two_processes(device, Path(tmp))
        try:
            for part in (run_sharded_sqp, run_sharded_fddp, run_batch_csqp,
                         run_tsharded,
                         lambda d, m: run_two_processes(d, started)):
                t0 = time.perf_counter()
                out = part(device, mesh)
                got, line = out if isinstance(out, tuple) else ({}, out)
                lines.append(f"{line} [{time.perf_counter() - t0:.1f} s]")
                for name, n in got.items():
                    launches[name] += n
        finally:
            for p in started[0][0]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return launches, lines


# the joint counts the phases run: the 2-DoF arm (phases 5 and 8), the
# Panda, the Tiago-Pro arm (phase 7) and the full Tiago-Pro (phase 9)
BUILD_NJ = (2, 7, 8, 17)


def build_kernels(build):
    """Phase 2: `build.build_many(BUILD_NJ)`, every source of every count at
    once, each library loaded; prints each library and ptxas's register,
    stack and spill lines. Returns {nj: library path}."""
    t0 = time.perf_counter()
    built = build.build_many(BUILD_NJ)
    print(f"built {len(built)} libraries in {time.perf_counter() - t0:.1f} s")
    for nj, (path, log) in zip(BUILD_NJ, built):
        build.load_library(nj)
        print(f"nj={nj}: {path.name}")
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "stack frame")):
                print("  ptxas:", line.strip())
    return {nj: path for nj, (path, _) in zip(BUILD_NJ, built)}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs on the GPU only")
    _port()
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

    # -- 2. build every joint count's library at once
    t0 = time.perf_counter()
    build_kernels(_build)
    print(f"phase 2 took {time.perf_counter() - t0:.1f} s")

    # -- 3. kernels vs plain, on the Panda and at nj = 8 on the Tiago-Pro arm
    t0 = time.perf_counter()
    report, step_report = check_all_kernels(device)
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s")

    # -- 4. the main paths: the flagship chain, the collision path, the
    # visual-servoing path and the batch path
    t0 = time.perf_counter()
    launches = {name: 0 for name, *_ in KERNELS}
    for run in (run_slice, run_collision_path, run_vs_path, run_batch_path):
        path_launches, stats = run(device)
        for line in [stats] if isinstance(stats, str) else stats:
            print(line)
        for name, n in path_launches.items():
            launches[name] += n
    print(f"phase 4 took {time.perf_counter() - t0:.1f} s")

    # -- 5. the fallback backend and the single-scenario solvers, then
    # -- 6. the reference-shaped control loop and the runtime's I/O, then
    # -- 7. slice 12: the Tiago-Pro arm on the nj = 8 kernels, soft contact
    # and the quaternion free-flyer (also through the fused tick), the
    # sensitivity sweep, then
    # -- 8. slice 16: the mesh, the sharded solvers, the batch CSQP, the
    # horizon-sharded Riccati, two processes on the card, then
    # -- 9. the full 17-DoF Tiago-Pro on the nj = 17 kernels: the fused tick
    # and the batch FDDP
    for number, phase in ((5, run_fallback_phase), (6, run_control_loop_phase),
                          (7, run_slice12_phase), (8, run_multi_device_phase),
                          (9, run_full_tiago_phase)):
        t0 = time.perf_counter()
        path_launches, lines = phase(device)
        for line in lines:
            print(line)
        for name, n in path_launches.items():
            launches[name] += n
        print(f"phase {number} took {time.perf_counter() - t0:.1f} s")

    # -- result: launches over the paths of phases 4-9, the max error over
    # every checked spec and size; times (wrapper and bare launch) and bounds at
    # the flagship tick shape for K1-K4, at the batch path's shapes for
    # K5a/K5b and at the benchmark cell's for R1 (no single PyTorch call
    # computes a fused stage, a dynamics step or the sweep: no library time)
    kernels = []
    for name, kind, derivs, replaces in KERNELS:
        if kind in ("step", "riccati"):
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
    if sys.argv[3:4] == ["--worker"]:  # one process of phase 8 (e)
        distributed_worker(sys.argv[1], sys.argv[2])
    else:
        main()
