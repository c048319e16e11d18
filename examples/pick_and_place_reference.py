"""The JAX package's run of `chip_smoke.py` phase 6 (a): the pick-and-place
loop of `examples/pick_and_place.py` through the reference-shaped API, on
the CPU in f32.

    PYTHONPATH=. JAX_PLATFORMS=cpu python examples/pick_and_place_reference.py

The Panda from `build_robot_models` with an obstacle sphere given as xacro,
`OCPParams` from `load_engine_config` (horizon 20, dt 0.01, `max_iter` 10,
`max_solve_time` 10 s, termination tolerance 1e-4), "goal_reaching_yaml",
the shift and reference warm starts, `MPC` and `ControllerRuntime` over a
`TrajectoryBuffer` fed a `GenericTrajectory` of the demo's three quintic
moves; 60 ticks, the measured state closed through `ocp.integrate`. Prints
the joint tracking error (the demo's: |q - trajectory[tick]|): its largest
value is `chip_smoke.JAX_PICK_PLACE_MAX_ERR`, which the card's run of the
port is held to. The configuration is imported from `chip_smoke.py` (whose
top level imports no JAX), so the two runs share one copy.
"""

import time

import numpy as np

from chip_smoke import (
    P6_ENV_XACRO,
    P6_JOINTS,
    P6_T,
    PAIR,
    PICK_PLACE_TICKS,
    PICK_PLACE_WEIGHTS,
    engine_values,
    pick_and_place_moves,
)


def main():
    import jax.numpy as jnp

    from agimus_controller_tpu.factory import create_ocp, create_warm_start
    from agimus_controller_tpu.models.panda import (
        PANDA_DEFAULT_ARMATURE,
        PANDA_Q_READY,
        PANDA_URDF,
    )
    from agimus_controller_tpu.models.urdf import (
        RobotModelParameters,
        build_robot_models,
    )
    from agimus_controller_tpu.mpc.buffer import DTFactorsNSeq, TrajectoryBuffer
    from agimus_controller_tpu.mpc.mpc import MPC
    from agimus_controller_tpu.runtime.config import load_engine_config
    from agimus_controller_tpu.runtime.controller import (
        ControllerRuntime,
        RuntimeParams,
        Sensor,
    )
    from agimus_controller_tpu.trajectories import GenericTrajectory

    robot = build_robot_models(RobotModelParameters(
        robot_urdf=PANDA_URDF, moving_joint_names=list(P6_JOINTS),
        armature=PANDA_DEFAULT_ARMATURE, env_urdf=P6_ENV_XACRO,
        robot_attachment_frame="panda_link0", collision_as_capsule=True,
        collision_pairs=PAIR, dtype=np.float32))
    model, params = robot.model, robot.params
    cfg = load_engine_config(engine_values(P6_T, termination_tolerance=1e-4))
    T = cfg.ocp.horizon_size
    ocp = create_ocp("goal_reaching_yaml", model, params, cfg.ocp,
                     ee_frame="panda_hand_tcp", dtype=jnp.float32)
    buffer = TrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[T]))
    ws = create_warm_start("shift_previous_solution", model, params,
                           timesteps=ocp.spec.timesteps())
    ws_ref = create_warm_start("reference", model, params)
    mpc = MPC()
    mpc.setup(ocp, ws, buffer)
    rt = ControllerRuntime(mpc, buffer, ws_ref, RuntimeParams())

    gen = GenericTrajectory("panda_hand_tcp", **{
        k: np.asarray(v) for k, v in PICK_PLACE_WEIGHTS.items()})
    q_home = np.asarray(PANDA_Q_READY, dtype=float)
    gen.initialize(model, params, q_home)
    for qs, vs, accs in pick_and_place_moves(q_home):
        gen.add_trajectory(gen.build_trajectory_from_q_dq_ddq_arrays(
            qs, vs, accs))
    for _ in range(2 * T + 2):
        rt.append_reference(gen.get_traj_point_at_t(0.0))
    q, v = q_home.copy(), np.zeros(7)
    errs, kkts = [], []
    t0 = time.time()
    for it in range(PICK_PLACE_TICKS):
        now = int(it * ocp.dt * 1e9)
        rt.set_sensor(Sensor(time_ns=now, position=q, velocity=v))
        ctrl = rt.step(now_ns=now)
        assert ctrl is not None
        x = ocp.integrate(np.concatenate([q, v]), ctrl.feedforward)
        q, v = x[:7].astype(float), x[7:].astype(float)
        ref_q = gen.trajectory[min(it, len(gen.trajectory) - 1)]
        errs.append(float(np.linalg.norm(q - ref_q.robot_configuration)))
        kkts.append(mpc.mpc_debug_data.ocp.kkt_norm)
        rt.append_reference(gen.get_traj_point_at_t(0.0))
    print(f"{PICK_PLACE_TICKS} ticks in {time.time() - t0:.1f} s (CPU, f32, "
          f"compiles included); budget_iters {ocp.budget_iters}; last tick "
          f"kkt {kkts[-1]:.3e}")
    print(f"joint tracking error: max {max(errs):.6f} rad, mean "
          f"{np.mean(errs):.6f} rad")


if __name__ == "__main__":
    main()
