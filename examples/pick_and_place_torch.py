"""Offline pick-and-place MPC demo on the PyTorch port (the port's copy of
`examples/pick_and_place.py`; reference:
`agimus_controller_examples/main/panda_pick_and_place/main.py:32-200`).

The three phases (approach, transfer, retreat) are joint-space quintic
splines between waypoints, fed through `GenericTrajectory` into the full
MPC loop (`ControllerRuntime`, `MPC`, the "goal_reaching_yaml" OCP) with
debug capture and plot dumps.

Usage:  python examples/pick_and_place_torch.py [--ticks N] [--out DIR]
            [--horizon T] [--device cuda|cpu]
"""

import argparse
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def quintic_join(q_a, q_b, duration, dt):
    """Joint-space quintic segment q_a -> q_b (rest-to-rest)."""
    n = max(int(round(duration / dt)), 2)
    ts = np.linspace(0.0, duration, n, endpoint=False)
    s = ts / duration
    blend = 10 * s**3 - 15 * s**4 + 6 * s**5
    dblend = (30 * s**2 - 60 * s**3 + 30 * s**4) / duration
    ddblend = (60 * s - 180 * s**2 + 120 * s**3) / duration**2
    dq = q_b - q_a
    qs = q_a[None] + blend[:, None] * dq[None]
    vs = dblend[:, None] * dq[None]
    accs = ddblend[:, None] * dq[None]
    return qs, vs, accs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--out", type=str,
                    default=str(ROOT / "build" / "pick_and_place"))
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from agimus_controller_tpu_torch.factory import (
        create_ocp,
        create_warm_start,
    )
    from agimus_controller_tpu_torch.models.panda import (
        PANDA_Q_READY,
        load_panda,
    )
    from agimus_controller_tpu_torch.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryBuffer,
    )
    from agimus_controller_tpu_torch.mpc.mpc import MPC
    from agimus_controller_tpu_torch.mpc.ocp_base import OCPParams
    from agimus_controller_tpu_torch.plots.plots_utils import plot_mpc_data
    from agimus_controller_tpu_torch.runtime.controller import (
        ControllerRuntime,
        RuntimeParams,
        Sensor,
    )
    from agimus_controller_tpu_torch.runtime.recorder import MPCRecorder
    from agimus_controller_tpu_torch.trajectories import GenericTrajectory

    device = args.device
    model, params = load_panda(device=device)
    T, dt = args.horizon, 0.01
    ocp = create_ocp(
        "goal_reaching_yaml", model, params,
        OCPParams(dt=dt, horizon_size=T), ee_frame="panda_hand_tcp",
        device=device,
    )
    buffer = TrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[T]))
    ws = create_warm_start("shift_previous_solution", model, params,
                           timesteps=ocp.spec.timesteps(), device=device)
    ws_ref = create_warm_start("reference", model, params, device=device)
    mpc = MPC()
    mpc.setup(ocp, ws, buffer)
    rt = ControllerRuntime(mpc, buffer, ws_ref, RuntimeParams())

    # three-phase "pick and place" in joint space
    q_home = np.asarray(PANDA_Q_READY, dtype=float)
    q_pick = q_home + np.asarray([0.5, 0.3, 0.0, -0.3, 0.0, 0.2, 0.0])
    q_place = q_home + np.asarray([-0.6, 0.25, 0.1, -0.2, 0.1, 0.3, -0.4])
    gen = GenericTrajectory(
        "panda_hand_tcp", w_q=np.full(7, 5.0), w_qdot=np.ones(7),
        w_qddot=np.zeros(7), w_robot_effort=np.full(7, 1e-3),
        w_pose=np.full(6, 20.0))
    gen.initialize(model, params, q_home)
    for (qa, qb, dur) in [(q_home, q_pick, 1.5), (q_pick, q_place, 2.0),
                          (q_place, q_home, 1.5)]:
        qs, vs, accs = quintic_join(qa, qb, dur, dt)
        gen.add_trajectory(gen.build_trajectory_from_q_dq_ddq_arrays(qs, vs, accs))

    # stream + closed loop
    t_stream = 0.0
    for _ in range(2 * T + 2):
        rt.append_reference(gen.get_traj_point_at_t(t_stream))
        t_stream += dt
    q, v = q_home.copy(), np.zeros(7)
    rec = MPCRecorder()
    errs = []
    t0 = time.time()
    for it in range(args.ticks):
        now = int(it * dt * 1e9)
        rt.set_sensor(Sensor(time_ns=now, position=q, velocity=v))
        ctrl = rt.step(now_ns=now)
        assert ctrl is not None
        x = ocp.integrate(np.concatenate([q, v]), ctrl.feedforward)
        q, v = x[:7], x[7:]
        rec.record(now, x, ocp.ocp_results, mpc.mpc_debug_data)
        rt.append_reference(gen.get_traj_point_at_t(t_stream))
        if not gen.trajectory_is_done:
            t_stream += dt
        ref_q = gen.trajectory[min(it, len(gen.trajectory) - 1)].robot_configuration
        errs.append(np.linalg.norm(q - ref_q))
    wall = time.time() - t0

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rec.save(out / "mpc_run.npz")
    plot_mpc_data(rec.as_mpc_data(), which_plots=["computation_time", "iter"],
                  dump_path=str(out))
    print(f"{args.ticks} MPC ticks in {wall:.1f}s "
          f"({args.ticks / wall:.1f} Hz effective)")
    print(f"tracking error mean {np.mean(errs):.4f} rad, max {np.max(errs):.4f} rad")
    print(f"artifacts in {out}")


if __name__ == "__main__":
    main()
