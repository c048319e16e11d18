"""Built-in Franka Panda 7-DoF model fixture.

The reference obtains the Panda from the external `franka_description` xacro
package (`agimus_controller_examples/.../utils/set_models_and_mpc.py:18-44`,
tests: `agimus_controller/tests/test_robot_models.py`). That package is not
vendored here; instead this module carries a self-contained URDF with the
public Franka Emika Panda kinematics (joint origins/limits from
franka_description) and the identified inertial parameters of Gaz et al. 2019
("Dynamic Identification of the Franka Emika Panda Robot..."), which is what
franka_description ships. Collision geometry is a capsule approximation per
link (the reference reduces meshes to capsules anyway,
`factory/robot_model.py:261-302`).
"""

from __future__ import annotations

import numpy as np
import torch

from .urdf import build_model_from_urdf

# default joint armature used throughout the reference configs
# (`agimus_controller_ros/agimus_controller_parameters.yaml:27-30`)
PANDA_DEFAULT_ARMATURE = np.full(7, 0.1)

# a comfortable elbow-down home configuration (franka "ready" pose)
PANDA_Q_READY = np.array([0.0, -0.785398, 0.0, -2.356194, 0.0, 1.570796, 0.785398])

PANDA_URDF = """<?xml version="1.0" ?>
<robot name="panda">
  <link name="panda_link0">
    <inertial>
      <origin xyz="-0.041018 -0.00014 0.049974" rpy="0 0 0"/>
      <mass value="0.629769"/>
      <inertia ixx="0.00315" ixy="8.2904e-7" ixz="0.00015" iyy="0.00388" iyz="8.2299e-6" izz="0.004285"/>
    </inertial>
    <collision name="panda_link0_capsule">
      <origin xyz="-0.04 0 0.05" rpy="0 1.5707963 0"/>
      <geometry><cylinder radius="0.09" length="0.12"/></geometry>
    </collision>
  </link>
  <joint name="panda_joint1" type="revolute">
    <parent link="panda_link0"/><child link="panda_link1"/>
    <origin xyz="0 0 0.333" rpy="0 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.8973" upper="2.8973" effort="87" velocity="2.1750"/>
  </joint>
  <link name="panda_link1">
    <inertial>
      <origin xyz="0.003875 0.002081 -0.04762" rpy="0 0 0"/>
      <mass value="4.970684"/>
      <inertia ixx="0.70337" ixy="-0.000139" ixz="0.006772" iyy="0.70661" iyz="0.019169" izz="0.009117"/>
    </inertial>
    <collision name="panda_link1_capsule">
      <origin xyz="0 0 -0.1915" rpy="0 0 0"/>
      <geometry><cylinder radius="0.09" length="0.283"/></geometry>
    </collision>
  </link>
  <joint name="panda_joint2" type="revolute">
    <parent link="panda_link1"/><child link="panda_link2"/>
    <origin xyz="0 0 0" rpy="-1.5707963267948966 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-1.7628" upper="1.7628" effort="87" velocity="2.1750"/>
  </joint>
  <link name="panda_link2">
    <inertial>
      <origin xyz="-0.003141 -0.02872 0.003495" rpy="0 0 0"/>
      <mass value="0.646926"/>
      <inertia ixx="0.007962" ixy="-0.003925" ixz="0.010254" iyy="0.02811" iyz="0.000704" izz="0.025995"/>
    </inertial>
    <collision name="panda_link2_capsule">
      <origin xyz="0 -0.09 0" rpy="1.5707963 0 0"/>
      <geometry><cylinder radius="0.09" length="0.12"/></geometry>
    </collision>
  </link>
  <joint name="panda_joint3" type="revolute">
    <parent link="panda_link2"/><child link="panda_link3"/>
    <origin xyz="0 -0.316 0" rpy="1.5707963267948966 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.8973" upper="2.8973" effort="87" velocity="2.1750"/>
  </joint>
  <link name="panda_link3">
    <inertial>
      <origin xyz="0.027518 0.039252 -0.066502" rpy="0 0 0"/>
      <mass value="3.228604"/>
      <inertia ixx="0.037242" ixy="-0.004761" ixz="-0.011396" iyy="0.036155" iyz="-0.012805" izz="0.01083"/>
    </inertial>
    <collision name="panda_link3_capsule">
      <origin xyz="0 0 -0.0745" rpy="0 0 0"/>
      <geometry><cylinder radius="0.08" length="0.15"/></geometry>
    </collision>
  </link>
  <joint name="panda_joint4" type="revolute">
    <parent link="panda_link3"/><child link="panda_link4"/>
    <origin xyz="0.0825 0 0" rpy="1.5707963267948966 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-3.0718" upper="-0.0698" effort="87" velocity="2.1750"/>
  </joint>
  <link name="panda_link4">
    <inertial>
      <origin xyz="-0.05317 0.104419 0.027454" rpy="0 0 0"/>
      <mass value="3.587895"/>
      <inertia ixx="0.025853" ixy="0.007796" ixz="-0.001332" iyy="0.019552" iyz="0.008641" izz="0.028323"/>
    </inertial>
    <collision name="panda_link4_capsule">
      <origin xyz="-0.0825 0.06 0" rpy="1.5707963 0 0"/>
      <geometry><cylinder radius="0.08" length="0.12"/></geometry>
    </collision>
  </link>
  <joint name="panda_joint5" type="revolute">
    <parent link="panda_link4"/><child link="panda_link5"/>
    <origin xyz="-0.0825 0.384 0" rpy="-1.5707963267948966 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.8973" upper="2.8973" effort="12" velocity="2.6100"/>
  </joint>
  <link name="panda_link5">
    <inertial>
      <origin xyz="-0.011953 0.041065 -0.038437" rpy="0 0 0"/>
      <mass value="1.225946"/>
      <inertia ixx="0.035549" ixy="-0.002117" ixz="-0.004037" iyy="0.029474" iyz="0.000229" izz="0.008627"/>
    </inertial>
    <collision name="panda_link5_capsule">
      <origin xyz="0 0.04 -0.125" rpy="0 0 0"/>
      <geometry><cylinder radius="0.07" length="0.22"/></geometry>
    </collision>
  </link>
  <joint name="panda_joint6" type="revolute">
    <parent link="panda_link5"/><child link="panda_link6"/>
    <origin xyz="0 0 0" rpy="1.5707963267948966 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-0.0175" upper="3.7525" effort="12" velocity="2.6100"/>
  </joint>
  <link name="panda_link6">
    <inertial>
      <origin xyz="0.060149 -0.014117 -0.010517" rpy="0 0 0"/>
      <mass value="1.666555"/>
      <inertia ixx="0.001964" ixy="0.000109" ixz="-0.001158" iyy="0.004354" iyz="0.000341" izz="0.005433"/>
    </inertial>
    <collision name="panda_link6_capsule">
      <origin xyz="0.04 0 0" rpy="0 1.5707963 0"/>
      <geometry><cylinder radius="0.07" length="0.08"/></geometry>
    </collision>
  </link>
  <joint name="panda_joint7" type="revolute">
    <parent link="panda_link6"/><child link="panda_link7"/>
    <origin xyz="0.088 0 0" rpy="1.5707963267948966 0 0"/><axis xyz="0 0 1"/>
    <limit lower="-2.8973" upper="2.8973" effort="12" velocity="2.6100"/>
  </joint>
  <link name="panda_link7">
    <inertial>
      <origin xyz="0.010517 -0.004252 0.061597" rpy="0 0 0"/>
      <mass value="0.735522"/>
      <inertia ixx="0.012516" ixy="-0.000428" ixz="-0.001196" iyy="0.010027" iyz="-0.000741" izz="0.004815"/>
    </inertial>
    <collision name="panda_link7_capsule">
      <origin xyz="0 0 0.08" rpy="0 0 0"/>
      <geometry><cylinder radius="0.06" length="0.12"/></geometry>
    </collision>
  </link>
  <joint name="panda_joint8" type="fixed">
    <parent link="panda_link7"/><child link="panda_link8"/>
    <origin xyz="0 0 0.107" rpy="0 0 0"/>
  </joint>
  <link name="panda_link8"/>
  <joint name="panda_hand_joint" type="fixed">
    <parent link="panda_link8"/><child link="panda_hand"/>
    <origin xyz="0 0 0" rpy="0 0 -0.7853981633974483"/>
  </joint>
  <link name="panda_hand">
    <inertial>
      <origin xyz="-0.01 0 0.03" rpy="0 0 0"/>
      <mass value="0.73"/>
      <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.0025" iyz="0" izz="0.0017"/>
    </inertial>
    <collision name="panda_hand_capsule">
      <origin xyz="0 0 0.04" rpy="1.5707963 0 0"/>
      <geometry><cylinder radius="0.05" length="0.14"/></geometry>
    </collision>
  </link>
  <joint name="panda_hand_tcp_joint" type="fixed">
    <parent link="panda_hand"/><child link="panda_hand_tcp"/>
    <origin xyz="0 0 0.1034" rpy="0 0 0"/>
  </joint>
  <link name="panda_hand_tcp"/>
</robot>
"""

PANDA_SRDF = """<?xml version="1.0" ?>
<robot name="panda">
  <disable_collisions link1="panda_link0" link2="panda_link1" reason="Adjacent"/>
  <disable_collisions link1="panda_link1" link2="panda_link2" reason="Adjacent"/>
  <disable_collisions link1="panda_link2" link2="panda_link3" reason="Adjacent"/>
  <disable_collisions link1="panda_link3" link2="panda_link4" reason="Adjacent"/>
  <disable_collisions link1="panda_link4" link2="panda_link5" reason="Adjacent"/>
  <disable_collisions link1="panda_link5" link2="panda_link6" reason="Adjacent"/>
  <disable_collisions link1="panda_link6" link2="panda_link7" reason="Adjacent"/>
  <disable_collisions link1="panda_link7" link2="panda_hand" reason="Adjacent"/>
  <disable_collisions link1="panda_link6" link2="panda_hand" reason="Never"/>
  <disable_collisions link1="panda_link0" link2="panda_link2" reason="Never"/>
  <disable_collisions link1="panda_link1" link2="panda_link3" reason="Never"/>
  <disable_collisions link1="panda_link2" link2="panda_link4" reason="Never"/>
  <disable_collisions link1="panda_link0" link2="panda_link3" reason="Never"/>
  <disable_collisions link1="panda_link0" link2="panda_link4" reason="Never"/>
  <disable_collisions link1="panda_link1" link2="panda_link4" reason="Never"/>
  <disable_collisions link1="panda_link3" link2="panda_link5" reason="Never"/>
  <disable_collisions link1="panda_link4" link2="panda_link6" reason="Never"/>
  <disable_collisions link1="panda_link5" link2="panda_link7" reason="Never"/>
  <disable_collisions link1="panda_link4" link2="panda_hand" reason="Never"/>
</robot>
"""


def load_panda(
    armature: np.ndarray | None = None,
    env_urdf: str | None = None,
    robot_attachment_frame: str = "panda_link0",
    self_collision: bool = False,
    collision_pairs=(),
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
    free_flyer: bool = False,
):
    """Build the Panda (RobotModel, ModelParams) with tensors on ``device``.
    ``free_flyer=True`` mounts it on a 6-DoF floating base (nq = 13)."""
    return build_model_from_urdf(
        PANDA_URDF,
        armature=PANDA_DEFAULT_ARMATURE if armature is None else armature,
        env_urdf=env_urdf,
        robot_attachment_frame=robot_attachment_frame if env_urdf else "",
        srdf=PANDA_SRDF if self_collision else None,
        collision_as_capsule=True,
        collision_pairs=collision_pairs,
        self_collision=self_collision,
        dtype=dtype,
        device=device,
        free_flyer=free_flyer,
    )
