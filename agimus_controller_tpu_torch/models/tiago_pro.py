"""Tiago-Pro-class second robot fixture: branched kinematic tree.

Port of the JAX package's `models/tiago_pro.py` (the same URDF string,
constants and reduction); the tensors go to the requested device.

The reference supports Tiago-Pro alongside the Panda (offline plotting
rebuilds it from xacro and locks everything but one 7-DoF arm,
`agimus_controller_ros/mpc_plot_node.py:34-97`). The real robot description
is a PAL xacro package not vendored here; this module generates a
structurally equivalent model — mobile-manipulator torso with a prismatic
lift, a 2-DoF head, and TWO 7-DoF arms branching from the torso — with
plausible inertial parameters. It exercises everything the Panda cannot:
branched trees (two arms share the torso ancestors), prismatic joints in
the serial chain, and reduction by locking whole subtrees.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from .urdf import build_model_from_urdf

TIAGO_PRO_Q_READY = np.array([0.15, 0.5, 0.5, -1.2, 1.0, 0.0, 1.1, 0.0])
"""torso lift + the 7 left-arm joints (the reduced single-arm model)."""


def _link(name, mass, com, inertia_diag, capsule=None):
    cap = ""
    if capsule is not None:
        r, l, xyz, rpy = capsule
        cap = (f'<collision name="{name}_capsule">'
               f'<origin xyz="{xyz}" rpy="{rpy}"/>'
               f'<geometry><cylinder radius="{r}" length="{l}"/></geometry>'
               f"</collision>")
    ixx, iyy, izz = inertia_diag
    return (f'<link name="{name}"><inertial>'
            f'<origin xyz="{com}" rpy="0 0 0"/><mass value="{mass}"/>'
            f'<inertia ixx="{ixx}" ixy="0" ixz="0" iyy="{iyy}" iyz="0" izz="{izz}"/>'
            f"</inertial>{cap}</link>")


def _joint(name, jtype, parent, child, xyz, rpy, axis, lo, hi,
           effort=50.0, vel=2.0):
    return (f'<joint name="{name}" type="{jtype}">'
            f'<parent link="{parent}"/><child link="{child}"/>'
            f'<origin xyz="{xyz}" rpy="{rpy}"/><axis xyz="{axis}"/>'
            f'<limit lower="{lo}" upper="{hi}" effort="{effort}" velocity="{vel}"/>'
            f"</joint>")


def _arm(side: str, y: float):
    """One 7-DoF arm hanging from the torso at lateral offset ``y``."""
    s = f"{side}_arm"
    sign = 1.0 if y > 0 else -1.0
    parts = [
        _joint(f"{s}_1_joint", "revolute", "torso_link", f"{s}_1_link",
               f"0.02 {y} 0.30", f"{-sign * 1.5707963} 0 0", "0 0 1",
               -2.7, 2.7),
        _link(f"{s}_1_link", 2.2, "0 0 -0.06", (0.011, 0.011, 0.004),
              (0.05, 0.12, "0 0 -0.06", "0 0 0")),
        _joint(f"{s}_2_joint", "revolute", f"{s}_1_link", f"{s}_2_link",
               "0.0 0.0 -0.12", "1.5707963 0 0", "0 0 1", -1.9, 1.9),
        _link(f"{s}_2_link", 2.0, "0 -0.05 0", (0.010, 0.004, 0.010),
              (0.05, 0.10, "0 -0.05 0", "1.5707963 0 0")),
        _joint(f"{s}_3_joint", "revolute", f"{s}_2_link", f"{s}_3_link",
               "0 -0.20 0", "-1.5707963 0 0", "0 0 1", -2.7, 2.7),
        _link(f"{s}_3_link", 1.8, "0 0 -0.08", (0.008, 0.008, 0.003),
              (0.045, 0.14, "0 0 -0.08", "0 0 0")),
        _joint(f"{s}_4_joint", "revolute", f"{s}_3_link", f"{s}_4_link",
               "0.0 0.0 -0.16", "1.5707963 0 0", "0 0 1", -2.2, 0.1),
        _link(f"{s}_4_link", 1.6, "0 -0.05 0", (0.007, 0.003, 0.007),
              (0.04, 0.10, "0 -0.05 0", "1.5707963 0 0")),
        _joint(f"{s}_5_joint", "revolute", f"{s}_4_link", f"{s}_5_link",
               "0 -0.18 0", "-1.5707963 0 0", "0 0 1", -2.7, 2.7),
        _link(f"{s}_5_link", 1.2, "0 0 -0.06", (0.004, 0.004, 0.002),
              (0.035, 0.10, "0 0 -0.06", "0 0 0")),
        _joint(f"{s}_6_joint", "revolute", f"{s}_5_link", f"{s}_6_link",
               "0.0 0.0 -0.12", "1.5707963 0 0", "0 0 1", -1.4, 1.4),
        _link(f"{s}_6_link", 0.8, "0 -0.02 0", (0.002, 0.001, 0.002)),
        _joint(f"{s}_7_joint", "revolute", f"{s}_6_link", f"{s}_7_link",
               "0 -0.06 0", "-1.5707963 0 0", "0 0 1", -2.7, 2.7),
        _link(f"{s}_7_link", 0.5, "0 0 -0.03", (0.001, 0.001, 0.0008),
              (0.03, 0.05, "0 0 -0.03", "0 0 0")),
        _joint(f"{s}_tool_joint", "fixed", f"{s}_7_link", f"{s}_tool_link",
               "0 0 -0.08", "0 0 0", "0 0 1", 0, 0),
        _link(f"{s}_tool_link", 0.1, "0 0 0", (1e-4, 1e-4, 1e-4)),
    ]
    return "".join(parts)


def tiago_pro_urdf() -> str:
    body = [
        '<?xml version="1.0"?><robot name="tiago_pro">',
        _link("base_link", 30.0, "0 0 0.15", (0.8, 0.8, 0.6),
              (0.25, 0.25, "0 0 0.15", "0 0 0")),
        _joint("torso_lift_joint", "prismatic", "base_link", "torso_link",
               "0 0 0.60", "0 0 0", "0 0 1", 0.0, 0.35, effort=500.0,
               vel=0.5),
        _link("torso_link", 12.0, "0 0 0.15", (0.25, 0.25, 0.10),
              (0.15, 0.35, "0 0 0.15", "0 0 0")),
        _joint("head_1_joint", "revolute", "torso_link", "head_1_link",
               "0.02 0 0.40", "0 0 0", "0 0 1", -1.3, 1.3),
        _link("head_1_link", 0.8, "0 0 0.03", (0.002, 0.002, 0.002)),
        _joint("head_2_joint", "revolute", "head_1_link", "head_2_link",
               "0.05 0 0.05", "0 0 0", "0 1 0", -1.0, 1.0),
        _link("head_2_link", 1.2, "0.02 0 0.05", (0.004, 0.004, 0.003)),
        _arm("left", 0.22),
        _arm("right", -0.22),
        "</robot>",
    ]
    return "".join(body)


TIAGO_PRO_LEFT_ARM_JOINTS = [
    "torso_lift_joint",
    "left_arm_1_joint", "left_arm_2_joint", "left_arm_3_joint",
    "left_arm_4_joint", "left_arm_5_joint", "left_arm_6_joint",
    "left_arm_7_joint",
]


def load_tiago_pro(
    moving_joint_names=None,
    q0: np.ndarray | None = None,
    armature: np.ndarray | None = None,
    dtype: torch.dtype = torch.float32,
    free_flyer: bool = False,
    device: torch.device | str = DEFAULT_DEVICE,
):
    """Build the Tiago-Pro (RobotModel, ModelParams).

    Default reduction mirrors the reference's single-arm usage
    (`mpc_plot_node.py:34-97`): torso lift + left arm movable, the right
    arm and head locked at zero and merged into the torso. Pass
    ``moving_joint_names="all"`` for the full 17-DoF branched model.
    ``free_flyer=True`` mounts it on a 6-DoF floating base; the tensors go
    to ``device``.
    """
    if moving_joint_names == "all":
        moving = None
    elif moving_joint_names is None:
        moving = list(TIAGO_PRO_LEFT_ARM_JOINTS)
    else:
        moving = list(moving_joint_names)
    n_moving = None if moving is None else len(moving)
    if armature is None and n_moving is not None:
        armature = np.full(n_moving, 0.05)
    return build_model_from_urdf(
        tiago_pro_urdf(),
        moving_joint_names=moving,
        q0=q0,
        armature=armature,
        collision_as_capsule=True,
        dtype=dtype,
        device=device,
        free_flyer=free_flyer,
    )
