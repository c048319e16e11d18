"""Offline sine-tracking MPC loop on the PyTorch port (the port's copy of
`examples/dummy_mpc.py`; reference:
`agimus_controller_examples/scripts/dummy_mpc_test.py` — a long receding-
horizon run against a sine configuration-space target, no ROS).

Usage:  python examples/dummy_mpc_torch.py [--ticks N] [--horizon T]
            [--device cuda|cpu]
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=300)
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
    from agimus_controller_tpu_torch.runtime.controller import (
        ControllerRuntime,
        RuntimeParams,
        Sensor,
    )
    from agimus_controller_tpu_torch.trajectories import (
        SinusWaveConfigurationSpace,
        SinWaveParams,
    )

    device = args.device
    model, params = load_panda(device=device)
    T, dt = args.horizon, 0.01
    ocp = create_ocp("goal_reaching_yaml", model, params,
                     OCPParams(dt=dt, horizon_size=T),
                     ee_frame="panda_hand_tcp", device=device)
    buffer = TrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[T]))
    ws = create_warm_start("shift_previous_solution", model, params,
                           timesteps=ocp.spec.timesteps(), device=device)
    ws_ref = create_warm_start("reference", model, params, device=device)
    mpc = MPC()
    mpc.setup(ocp, ws, buffer)
    rt = ControllerRuntime(mpc, buffer, ws_ref, RuntimeParams())

    q_ready = np.asarray(PANDA_Q_READY, dtype=float)
    traj = SinusWaveConfigurationSpace(
        SinWaveParams(amplitude=[0.3] * 7, period=[4.0] * 7,
                      scale_duration=[1.0] * 7),
        "panda_hand_tcp", w_q=np.full(7, 10.0), w_qdot=np.ones(7),
        w_qddot=np.zeros(7), w_robot_effort=np.full(7, 1e-3),
        w_pose=np.zeros(6))
    traj.initialize(model, params, q_ready)

    t_stream = 0.0
    for _ in range(2 * T + 2):
        rt.append_reference(traj.get_traj_point_at_t(t_stream))
        t_stream += dt
    q, v = q_ready.copy(), np.zeros(7)
    errs, solve_ms = [], []
    t0 = time.time()
    for it in range(args.ticks):
        now = int(it * dt * 1e9)
        rt.set_sensor(Sensor(time_ns=now, position=q, velocity=v))
        ctrl = rt.step(now_ns=now)
        assert ctrl is not None
        x = ocp.integrate(np.concatenate([q, v]), ctrl.feedforward)
        q, v = x[:7], x[7:]
        ref = traj.get_traj_point_at_t(it * dt)
        errs.append(np.linalg.norm(q - ref.point.robot_configuration))
        solve_ms.append(mpc.mpc_debug_data.duration_ocp_solve_ns / 1e6)
        rt.append_reference(traj.get_traj_point_at_t(t_stream))
        t_stream += dt
    wall = time.time() - t0
    print(f"{args.ticks} ticks in {wall:.1f}s | tracking err mean "
          f"{np.mean(errs):.4f} rad max {np.max(errs):.4f} rad | "
          f"solve p50 {np.percentile(solve_ms[2:], 50):.1f} ms")


if __name__ == "__main__":
    main()
