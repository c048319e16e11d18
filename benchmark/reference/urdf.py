"""A URDF reader of the reference: the moving joints of a kinematic tree,
their fixed placements, the bodies' spatial inertias and the named frames.

Fixed joints are folded into their parent joint: a link attached by fixed
joints moves with the nearest moving joint above it, its inertia is added
to that joint's body, and its frame is kept as a named frame of that joint.
Moving joints are numbered in depth-first order over the tree, children in
document order. Revolute (and continuous) and prismatic joints are read;
the root link is fixed to the world and carries no dynamics.

Plain numpy, float64.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np


def rpy_matrix(rpy) -> np.ndarray:
    """R = Rz(yaw) Ry(pitch) Rx(roll), the URDF convention."""
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def skew(v) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def _origin(elem):
    """(R, p) of an <origin> element (identity when absent)."""
    if elem is None:
        return np.eye(3), np.zeros(3)
    xyz = np.array([float(s) for s in elem.get("xyz", "0 0 0").split()])
    rpy = np.array([float(s) for s in elem.get("rpy", "0 0 0").split()])
    return rpy_matrix(rpy), xyz


def spatial_inertia(mass, com, inertia_com) -> np.ndarray:
    """6x6 spatial inertia [[Ic + m cx cx^T, m cx], [m cx^T, m 1]] of a body
    whose centre of mass is at `com` with rotational inertia `inertia_com`
    about it, in motion order [w; v]."""
    cx = skew(com)
    out = np.zeros((6, 6))
    out[:3, :3] = inertia_com + mass * cx @ cx.T
    out[:3, 3:] = mass * cx
    out[3:, :3] = mass * cx.T
    out[3:, 3:] = mass * np.eye(3)
    return out


def motion_transform(R, p) -> np.ndarray:
    """6x6 motion transform from a parent frame to a child frame placed at
    (R, p) in the parent: [[R^T, 0], [-R^T px, R^T]]."""
    out = np.zeros((6, 6))
    out[:3, :3] = R.T
    out[3:, 3:] = R.T
    out[3:, :3] = -R.T @ skew(p)
    return out


@dataclass
class Tree:
    """The moving joints in depth-first order and the frames on them."""

    joint_names: list = field(default_factory=list)
    joint_types: list = field(default_factory=list)  # "revolute" | "prismatic"
    parents: list = field(default_factory=list)  # -1 for the world
    fixed_rot: list = field(default_factory=list)  # joint frame in parent joint
    fixed_trans: list = field(default_factory=list)
    axes: list = field(default_factory=list)  # unit axis in the joint frame
    inertias: list = field(default_factory=list)  # 6x6 in the joint frame
    frames: dict = field(default_factory=dict)  # name -> (joint, R, p)

    @property
    def nj(self) -> int:
        return len(self.joint_names)


def read_urdf(text: str) -> Tree:
    """The `Tree` of a URDF document."""
    root_el = ET.fromstring(text)
    links = {el.get("name"): el for el in root_el.findall("link")}
    joints = root_el.findall("joint")
    children = {}
    child_links = set()
    for j in joints:
        parent = j.find("parent").get("link")
        children.setdefault(parent, []).append(j)
        child_links.add(j.find("child").get("link"))
    roots = [n for n in links if n not in child_links]
    if len(roots) != 1:
        raise ValueError(f"a URDF tree has one root link, found {roots}")
    tree = Tree()

    def body_inertia(link_el):
        inert = link_el.find("inertial")
        if inert is None:
            return np.zeros((6, 6))
        R, c = _origin(inert.find("origin"))
        m = float(inert.find("mass").get("value"))
        i = inert.find("inertia")
        g = lambda k: float(i.get(k, "0"))
        I = np.array([[g("ixx"), g("ixy"), g("ixz")],
                      [g("ixy"), g("iyy"), g("iyz")],
                      [g("ixz"), g("iyz"), g("izz")]])
        return spatial_inertia(m, c, R @ I @ R.T)

    def walk(link, joint, R, p):
        """`link` is rigidly attached to moving joint `joint` (-1: the
        world) at placement (R, p) in that joint's frame."""
        tree.frames[link] = (joint, R, p)
        if joint >= 0:
            X = motion_transform(R, p)
            tree.inertias[joint] = (tree.inertias[joint]
                                    + X.T @ body_inertia(links[link]) @ X)
        for j in children.get(link, []):
            jR, jp = _origin(j.find("origin"))
            R2, p2 = R @ jR, p + R @ jp
            child = j.find("child").get("link")
            jtype = j.get("type")
            if jtype == "fixed":
                walk(child, joint, R2, p2)
                continue
            if jtype == "continuous":
                jtype = "revolute"
            if jtype not in ("revolute", "prismatic"):
                raise ValueError(f"joint type {jtype!r} is not read")
            ax = j.find("axis")
            axis = np.array([float(s) for s in (
                ax.get("xyz") if ax is not None else "1 0 0").split()])
            tree.joint_names.append(j.get("name"))
            tree.joint_types.append(jtype)
            tree.parents.append(joint)
            tree.fixed_rot.append(R2)
            tree.fixed_trans.append(p2)
            tree.axes.append(axis / np.linalg.norm(axis))
            tree.inertias.append(np.zeros((6, 6)))
            walk(child, tree.nj - 1, np.eye(3), np.zeros(3))

    walk(roots[0], -1, np.eye(3), np.zeros(3))
    return tree
