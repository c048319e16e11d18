"""Trajectory factories for the port's publisher-process tests: module-level
callables a spawned child can import, importing only the port."""

import numpy as np


def make_sine_traj():
    """`test_publisher_process._make_traj` over the port's generator."""
    from agimus_controller_tpu_torch.trajectories.base import SinWaveParams
    from agimus_controller_tpu_torch.trajectories.sine_waves import (
        SinusWaveConfigurationSpace,
    )

    return SinusWaveConfigurationSpace(
        SinWaveParams(amplitude=[0.2] * 7, period=[2.0] * 7,
                      scale_duration=[1.0] * 7),
        ee_frame_name="panda_hand_tcp",
        w_q=np.full(7, 1.0), w_qdot=np.full(7, 0.1),
        w_qddot=np.zeros(7), w_robot_effort=np.zeros(7),
        w_pose=np.full(6, 1.0))


def make_broken_traj():
    """A factory that fails in the child."""
    raise RuntimeError("trajectory factory failed")
