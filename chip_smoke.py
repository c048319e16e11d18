"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written stage kernels (K1-K4) from `agimus_controller_tpu_torch/
csrc/`, holds each against its plain-PyTorch version on the card, then drives
the port's main path — the fused MPC tick (`FusedTickRunner`) on the Panda,
T=100, f32 — through a chained run and checks that it converged onto the
streamed goal and went through every kernel. Exits non-zero without a result
when there is no CUDA device or any phase fails. The line before the last is
a JSON object with the kernels' launches, errors and times; the last line is
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
)
SOURCE = "agimus_controller_tpu_torch/csrc/stage_kernels.cu"
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


def randomized_inputs(spec, model, N, seed, device):
    """Refs randomized as the Pallas kernels' tests do; x near the ready
    pose, u ~ 2 N(0, 1); node times uniform over the horizon."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY
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
    x = f(np.concatenate([np.tile(PANDA_Q_READY, (N, 1)), np.zeros((N, 7))], 1)
          + rng.normal(size=(N, 14)) * 0.1)
    u = f(rng.normal(size=(N, 7)) * 2.0)
    t_idx = torch.as_tensor(rng.integers(0, T, size=(N,)), device=device)
    dt = f(spec.timesteps())[t_idx]
    return refs, x, u, dt, t_idx


def cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median time of one call over `reps` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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


def check_kernels(model, params, device, sizes=(100, 102_400)):
    """K1-K4 vs their plain versions on the same CUDA inputs, f32."""
    from agimus_controller_tpu_torch.ops.cuda_costs import (
        make_cuda_stage,
        make_cuda_terminal,
    )

    report = {}
    for spec_name, spec in (("flagship", flagship_spec(100)),
                            ("mixed", mixed_spec(100))):
        for name, kind, derivs, _ in KERNELS:
            if kind == "stage":
                k = make_cuda_stage(model, params, spec, derivs, device)
                labels = STAGE_OUT if derivs else ("xnext", "l")
            else:
                k = make_cuda_terminal(model, params, spec, derivs, device)
                labels = ("l", "lx", "lxx") if derivs else ("l",)
            for N in sizes:
                # the tick gives the terminal kernels one node per scenario
                n_nodes = N if kind == "stage" else max(1, N // 100)
                refs, x, u, dt, t_idx = randomized_inputs(
                    spec, model, n_nodes, seed=N + derivs, device=device)
                if kind == "stage":
                    run = lambda: k(x, u, dt, t_idx, refs)
                    plain = lambda: k.plain(x, u, dt, t_idx, refs)
                else:
                    run = lambda: k(x, refs)
                    plain = lambda: k.plain(x, refs)
                got = run()
                torch.cuda.synchronize()
                errs = check_outputs(f"{name} {spec_name} N={n_nodes}", got,
                                     plain(), labels)
                ms = cuda_time_ms(run, reps=50)
                plain_ms = cuda_time_ms(plain, reps=5, warmup=1)
                print(f"{name:20s} {spec_name:8s} N={n_nodes:6d}  kernel "
                      f"{ms:9.4f} ms  plain {plain_ms:9.3f} ms  max abs err "
                      + " ".join(f"{lab}={e:.2e}" for lab, e in errs.items()))
                if spec_name == "flagship":
                    report.setdefault(name, {})[n_nodes] = dict(
                        ms=ms, plain_ms=plain_ms,
                        max_abs_err=max(errs.values()))
    return report


def build_slice(device, n_ticks: int = 120):
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
    _, params64 = load_panda(dtype=torch.float64)
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
    """Drive the main path: the first solve at limit 300, 120 ticks at
    limit 2 with a drifting x0, one final tick at limit 10. Returns
    (launches per kernel during the run, summary line)."""
    sl = build_slice(device)
    runner, x0_seq = sl.runner, sl.x0_seq
    solver = runner.solver
    names = [k[0] for k in KERNELS]

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
    per_tick = [run_chunk(20 + 20 * j, 20) for j in range(5)]
    syncs_per_tick = (solver.host_syncs - syncs0) / 100
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
        f"conv={conv0}; tick median {tick_ms:.3f} ms over 5x20 ticks at "
        f"limit 2 (host clock, synchronized); {syncs_per_tick:.2f} host "
        f"syncs per tick in the solver loops; final tick iters={iters} "
        f"kkt={kkt:.2e} conv={conv}; terminal EE error {ee_err * 1e3:.2f} mm; "
        f"launches {launches}")


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
    model, params = load_panda(
        env_urdf=ENV_URDF,
        collision_pairs=[("panda_link7_capsule", "obstacle_sphere")],
        dtype=torch.float32, device=device)
    report = check_kernels(model, params, device)

    # -- 4. the slice
    launches, slice_stats = run_slice(device)
    print(slice_stats)

    # -- 5. result
    kernels = []
    for name, kind, derivs, replaces in KERNELS:
        tick_n = 100 if kind == "stage" else 1
        r = report[name][tick_n]
        kernels.append(dict(name=name, route="cuda", source=SOURCE,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
