"""The benchmark's plain reference: a URDF reader, rigid-body kinematics
and dynamics, the OCP's costs and a Riccati pass, in plain PyTorch.

It imports nothing of the program under test and takes nothing the program
made: the configuration's URDF text, armature, cost items and goals are
read from the benchmark's own files.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import Robot
from .ocp import Costs
from .urdf import read_urdf


def goals_of(tree_robot: Robot, q_ready, offsets):
    """Per goal frame, the target (R, p): the frame's placement at
    `q_ready` (float64), its position moved by the frame's offset, as the
    program receives them (`as_input`)."""
    q = torch.as_tensor(np.asarray(q_ready, float), dtype=torch.float64)
    out = {}
    for frame, off in offsets.items():
        R, p = tree_robot.frame_placement(q, frame)
        out[frame] = (as_input(R.numpy()),
                      as_input(p.numpy() + np.asarray(off, float)))
    return out


def as_input(a):
    """`a` as the program receives it: rounded to float32 (its precision),
    then held in float64."""
    return np.asarray(a, dtype=np.float32).astype(np.float64)


def build(config, urdf_text, goal_offsets, dtype=torch.float64, device="cpu",
          tf32=False):
    """(Robot, Costs, goals) of a configuration (the parsed JSON of its
    file) with its URDF text; `goal_offsets`: frame -> [3] offset from the
    frame's position at the ready pose."""
    tree = read_urdf(urdf_text)
    names = config.get("joints")
    if names is not None and list(names) != tree.joint_names:
        raise ValueError(f"joint order {tree.joint_names} differs from the "
                         f"configuration's {names}")
    goals = goals_of(Robot(tree, config["armature"]), config["q_ready"],
                     goal_offsets)
    robot = Robot(tree, config["armature"], dtype, device, tf32)
    q = np.asarray(config["q_ready"], float)
    xref = as_input(np.concatenate([q, np.zeros_like(q)]))
    costs = Costs(robot, config["running_costs"], config["terminal_costs"],
                  xref, goals)
    return robot, costs, goals
