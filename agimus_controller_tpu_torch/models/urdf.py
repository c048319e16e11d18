"""URDF/SRDF -> static model arrays compiler (host-side, numpy).

Replacement for the reference model factory
(`agimus_controller/factory/robot_model.py:88-351`), which loads URDFs with
Pinocchio, appends an environment model (`:214-229`), locks joints into a
reduced model (`:231-259`), converts collision shapes to capsules (`:261-302`)
and configures SRDF self-collision pairs (`:304-330`). Here all of that runs
once at build time in numpy (the same code as the JAX package's
`models/urdf.py`) and emits a hashable `RobotModel` topology plus
`ModelParams` tensors on the requested device and dtype.
"""

from __future__ import annotations

import dataclasses
import math
import xml.etree.ElementTree as ET
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .model import Frame, Geometry, RobotModel, params_from_numpy


# ---------------------------------------------------------------------------
# numpy SE(3) helpers (host-side only)
# ---------------------------------------------------------------------------

def _rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def _se3_mul(a: Tuple[np.ndarray, np.ndarray], b: Tuple[np.ndarray, np.ndarray]):
    Ra, pa = a
    Rb, pb = b
    return Ra @ Rb, Ra @ pb + pa


def _se3_id():
    return np.eye(3), np.zeros(3)


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * (K @ K)


# ---------------------------------------------------------------------------
# URDF intermediate representation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Inertial:
    mass: float = 0.0
    com: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    inertia: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((3, 3)))


@dataclasses.dataclass
class _Geom:
    name: str
    gtype: str  # capsule | sphere | cylinder | box
    placement: Tuple[np.ndarray, np.ndarray]  # in link frame
    radius: float = 0.0
    halflen: float = 0.0
    size: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))


@dataclasses.dataclass
class _Link:
    name: str
    inertial: _Inertial
    geoms: List[_Geom]


@dataclasses.dataclass
class _Joint:
    name: str
    jtype: str  # revolute | continuous | prismatic | fixed
    parent: str
    child: str
    origin: Tuple[np.ndarray, np.ndarray]
    axis: np.ndarray
    lower: float = -np.inf
    upper: float = np.inf
    effort: float = np.inf
    velocity: float = np.inf


def _parse_origin(elem: Optional[ET.Element]) -> Tuple[np.ndarray, np.ndarray]:
    if elem is None:
        return _se3_id()
    xyz = np.fromstring(elem.get("xyz", "0 0 0"), sep=" ")
    rpy = np.fromstring(elem.get("rpy", "0 0 0"), sep=" ")
    return _rpy_to_matrix(rpy), xyz


def _parse_inertial(elem: Optional[ET.Element]) -> _Inertial:
    if elem is None:
        return _Inertial()
    mass = float(elem.find("mass").get("value")) if elem.find("mass") is not None else 0.0
    R, p = _parse_origin(elem.find("origin"))
    out = _Inertial(mass=mass, com=p)
    ine = elem.find("inertia")
    if ine is not None:
        ixx = float(ine.get("ixx", 0)); iyy = float(ine.get("iyy", 0))
        izz = float(ine.get("izz", 0)); ixy = float(ine.get("ixy", 0))
        ixz = float(ine.get("ixz", 0)); iyz = float(ine.get("iyz", 0))
        I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        # inertia given in the <origin> frame about the CoM; rotate to link frame
        out.inertia = R @ I @ R.T
    return out


def _parse_geoms(link_elem: ET.Element, link_name: str) -> List[_Geom]:
    geoms: List[_Geom] = []
    for i, col in enumerate(link_elem.findall("collision")):
        geo = col.find("geometry")
        if geo is None:
            continue
        placement = _parse_origin(col.find("origin"))
        name = col.get("name", f"{link_name}_{i}")
        if geo.find("cylinder") is not None:
            c = geo.find("cylinder")
            geoms.append(
                _Geom(name, "cylinder", placement, radius=float(c.get("radius")),
                      halflen=0.5 * float(c.get("length")))
            )
        elif geo.find("capsule") is not None:
            c = geo.find("capsule")
            geoms.append(
                _Geom(name, "capsule", placement, radius=float(c.get("radius")),
                      halflen=0.5 * float(c.get("length")))
            )
        elif geo.find("sphere") is not None:
            s = geo.find("sphere")
            geoms.append(_Geom(name, "sphere", placement, radius=float(s.get("radius"))))
        elif geo.find("box") is not None:
            b = geo.find("box")
            size = np.fromstring(b.get("size"), sep=" ")
            geoms.append(_Geom(name, "box", placement, size=size))
        # meshes are dropped, as in the reference capsule path
        # (`factory/robot_model.py:296-302` removes non-primitive shapes)
    return geoms


def _parse_urdf(urdf: str) -> Tuple[str, Dict[str, _Link], List[_Joint], str]:
    root = ET.fromstring(urdf)
    robot_name = root.get("name", "robot")
    links: Dict[str, _Link] = {}
    for le in root.findall("link"):
        name = le.get("name")
        links[name] = _Link(name, _parse_inertial(le.find("inertial")),
                            _parse_geoms(le, name))
    joints: List[_Joint] = []
    children = set()
    for je in root.findall("joint"):
        axis_elem = je.find("axis")
        axis = (np.fromstring(axis_elem.get("xyz"), sep=" ")
                if axis_elem is not None else np.array([1.0, 0.0, 0.0]))
        j = _Joint(
            name=je.get("name"),
            jtype=je.get("type"),
            parent=je.find("parent").get("link"),
            child=je.find("child").get("link"),
            origin=_parse_origin(je.find("origin")),
            axis=axis,
        )
        lim = je.find("limit")
        if lim is not None:
            j.lower = float(lim.get("lower", -np.inf))
            j.upper = float(lim.get("upper", np.inf))
            j.effort = float(lim.get("effort", np.inf))
            j.velocity = float(lim.get("velocity", np.inf))
        if j.jtype == "continuous":
            j.jtype = "revolute"
            j.lower, j.upper = -np.inf, np.inf
        joints.append(j)
        children.add(j.child)
    roots = [n for n in links if n not in children]
    if len(roots) != 1:
        raise ValueError(f"URDF must have exactly one root link, got {roots}")
    return robot_name, links, joints, roots[0]


# ---------------------------------------------------------------------------
# Inertia composition (fixed-joint merging / model reduction)
# ---------------------------------------------------------------------------

def _merge_inertia(a: _Inertial, b: _Inertial, b_placement) -> _Inertial:
    """Merge body b (placed at ``b_placement`` in a's frame) into a."""
    Rb, pb = b_placement
    mb = b.mass
    cb = Rb @ b.com + pb
    Ib = Rb @ b.inertia @ Rb.T
    m = a.mass + mb
    if m <= 0.0:
        return _Inertial()
    c = (a.mass * a.com + mb * cb) / m
    out = _Inertial(mass=m, com=c)
    I = np.zeros((3, 3))
    for mi, ci, Ii in ((a.mass, a.com, a.inertia), (mb, cb, Ib)):
        d = ci - c
        I = I + Ii + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    out.inertia = I
    return out


# ---------------------------------------------------------------------------
# Model construction
# ---------------------------------------------------------------------------

def _box_to_capsule(g: _Geom) -> _Geom:
    """Approximate a box by a capsule along its longest axis (conservative
    radius = half-diagonal of the cross section)."""
    order = np.argsort(g.size)
    long_ax, mid, short = order[2], order[1], order[0]
    radius = 0.5 * math.hypot(g.size[mid], g.size[short])
    halflen = max(0.5 * g.size[long_ax] - radius, 0.0)
    R, p = g.placement
    # rotate capsule z-axis onto the long axis
    z = np.zeros(3); z[long_ax] = 1.0
    if long_ax == 0:
        Rl = _axis_angle(np.array([0.0, 1.0, 0.0]), math.pi / 2)
    elif long_ax == 1:
        Rl = _axis_angle(np.array([1.0, 0.0, 0.0]), -math.pi / 2)
    else:
        Rl = np.eye(3)
    return _Geom(g.name, "capsule", (R @ Rl, p), radius=radius, halflen=halflen)


def _capsulize(geoms: List[_Geom]) -> List[_Geom]:
    """Convert primitive shapes to capsules/spheres, mirroring the reference's
    cylinder(+2 spheres)->capsule pass (`factory/robot_model.py:261-302`)."""
    out: List[_Geom] = []
    for g in geoms:
        if g.gtype == "cylinder":
            out.append(_Geom(g.name, "capsule", g.placement, g.radius, g.halflen))
        elif g.gtype == "box":
            out.append(_box_to_capsule(g))
        elif g.gtype in ("capsule", "sphere"):
            out.append(g)
    # drop the 2 cap-spheres that accompany a same-named cylinder-as-capsule
    # (franka_description-style "link_0" cylinder + "link_1"/"link_2" spheres)
    return out


def _parse_srdf_disabled(srdf: str) -> List[Tuple[str, str]]:
    root = ET.fromstring(srdf)
    return [
        (e.get("link1"), e.get("link2"))
        for e in root.findall("disable_collisions")
    ]


@dataclasses.dataclass
class RobotModelParameters:
    """Build parameters. API mirrors the reference `RobotModelParameters`
    (`factory/robot_model.py:12-85`) minus the pinocchio/coal specifics;
    ``dtype`` is the tensors' (the JAX package's is a numpy dtype)."""

    q0: np.ndarray = dataclasses.field(default_factory=lambda: np.array([]))
    free_flyer: bool = False  # floating base (6-DoF chart, see build_model_from_urdf)
    moving_joint_names: List[str] = dataclasses.field(default_factory=list)
    robot_urdf: Union[Path, str] = ""
    env_urdf: Union[None, Path, str] = None
    srdf: Union[None, Path, str] = None
    robot_attachment_frame: str = ""
    collision_as_capsule: bool = False
    collision_pairs: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    self_collision: bool = False
    armature: np.ndarray = dataclasses.field(default_factory=lambda: np.array([]))
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if not self.robot_urdf:
            raise ValueError("Robot URDF can not be an empty string.")
        if isinstance(self.robot_urdf, Path) and not self.robot_urdf.is_file():
            raise ValueError(f"Robot URDF file '{self.robot_urdf}' doesn't exist!")
        if isinstance(self.env_urdf, Path) and not self.env_urdf.is_file():
            raise ValueError(f"Environment URDF file '{self.env_urdf}' doesn't exist!")
        if isinstance(self.srdf, Path) and not self.srdf.is_file():
            raise ValueError(f"SRDF file '{self.srdf}' doesn't exist!")
        self.armature = np.asarray(self.armature, dtype=np.float64)
        if self.armature.size == 0:
            self.armature = np.zeros(len(self.moving_joint_names))
        if len(self.armature) != len(self.moving_joint_names):
            raise ValueError(
                "Armature must have the same shape as moving_joint_names. "
                f"Got {self.armature.shape} and {len(self.moving_joint_names)}."
            )


def _read(src: Union[Path, str]) -> str:
    if isinstance(src, Path):
        text = src.read_text()
    elif "<" not in src:  # looks like a path string
        text = Path(src).read_text()
    else:
        text = src
    if "http://www.ros.org/wiki/xacro" in text:
        # a reference-shipped .xacro drops in directly (the reference
        # expands xacro at runtime, `mpc_plot_node.py:34-97`)
        from .xacro import expand_xacro

        text = expand_xacro(text)
    return text


def build_model_from_urdf(
    urdf: Union[Path, str],
    moving_joint_names: Optional[Sequence[str]] = None,
    q0: Optional[np.ndarray] = None,
    armature: Optional[np.ndarray] = None,
    env_urdf: Union[None, Path, str] = None,
    robot_attachment_frame: str = "",
    srdf: Union[None, Path, str] = None,
    collision_as_capsule: bool = False,
    collision_pairs: Sequence[Tuple[str, str]] = (),
    self_collision: bool = False,
    gravity: Sequence[float] = (0.0, 0.0, -9.81),
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = DEFAULT_DEVICE,
    free_flyer: bool = False,
):
    """Compile a URDF (plus optional env URDF + SRDF) into static arrays.

    Joints not in ``moving_joint_names`` are locked at their ``q0`` value and
    their child bodies merged into the parent (the reference's
    `pin.buildReducedModel` path, `factory/robot_model.py:231-259`). The env
    URDF is grafted onto ``robot_attachment_frame`` (`pin.appendModel` analog,
    `:214-229`).

    ``free_flyer=True`` mounts the robot on a floating base (the reference's
    `StateMultibody` free-flyer option, `factory/robot_model.py:17`),
    realized as a 6-single-DoF chart: 3 world-axis prismatic joints
    (x, y, z) then 3 revolute joints (euler Z-Y-X), so the entire engine —
    kinematics, RNEA/CRBA, batch solvers — works unchanged on the extended
    vector state. This chart is exact everywhere except the euler
    singularity at pitch = ±pi/2; a quaternion Lie-group state is the
    planned upgrade for unbounded base rotation. ``q0``/``armature`` may
    cover either the full extended model or just the original joints (base
    entries are then zero-filled).
    """
    device = resolve_device(device)
    name, links, joints, root = _parse_urdf(_read(urdf))

    n_ff = 0
    if free_flyer:
        ff_spec = [
            ("root_joint_tx", "prismatic", (1.0, 0.0, 0.0)),
            ("root_joint_ty", "prismatic", (0.0, 1.0, 0.0)),
            ("root_joint_tz", "prismatic", (0.0, 0.0, 1.0)),
            ("root_joint_rz", "revolute", (0.0, 0.0, 1.0)),
            ("root_joint_ry", "revolute", (0.0, 1.0, 0.0)),
            ("root_joint_rx", "revolute", (1.0, 0.0, 0.0)),
        ]
        n_ff = len(ff_spec)
        universe = "__ff_universe__"
        links[universe] = _Link(universe, _Inertial(), [])
        prev = universe
        ff_joints = []
        for i, (jn, jt, ax) in enumerate(ff_spec):
            child = root if i == n_ff - 1 else f"__ff_link_{i}__"
            if child != root:
                links[child] = _Link(child, _Inertial(), [])
            ff_joints.append(_Joint(
                name=jn, jtype=jt, parent=prev, child=child,
                origin=_se3_id(), axis=np.asarray(ax, float),
            ))
            prev = child
        joints = ff_joints + joints
        root = universe

    if env_urdf is not None:
        if not robot_attachment_frame:
            raise ValueError("robot_attachment_frame required with env_urdf")
        env_name, env_links, env_joints, env_root = _parse_urdf(_read(env_urdf))
        for ln, lk in env_links.items():
            if ln in links:
                raise ValueError(f"duplicate link {ln} between robot and env URDFs")
            links[ln] = lk
        # graft: fixed joint from the attachment frame's link to the env
        # root. With a floating base the environment must stay world-fixed
        # (the reference appends the *robot* to the environment at an env
        # frame, `factory/robot_model.py:206-227`), so graft onto the world
        # root above the 6-DoF base instead of a robot link.
        attach_parent = root if free_flyer else robot_attachment_frame
        joints = joints + [
            _Joint(
                name=f"attach_{env_name}", jtype="fixed",
                parent=attach_parent, child=env_root,
                origin=_se3_id(), axis=np.array([0.0, 0.0, 1.0]),
            )
        ] + env_joints

    joint_by_child = {j.child: j for j in joints}
    children_of: Dict[str, List[_Joint]] = {}
    for j in joints:
        children_of.setdefault(j.parent, []).append(j)

    # full ordered list of movable joints (URDF document order along the tree)
    def _tree_joints(link: str) -> List[_Joint]:
        out = []
        for j in children_of.get(link, []):
            out.append(j)
            out += _tree_joints(j.child)
        return out

    all_joints = _tree_joints(root)
    movable_all = [j for j in all_joints if j.jtype != "fixed"]
    ff_names = {j.name for j in movable_all[:n_ff]} if n_ff else set()
    if moving_joint_names is None:
        moving_joint_names = [j.name for j in movable_all]
    elif n_ff:
        # the floating base is always movable
        moving_joint_names = (
            [j.name for j in movable_all[:n_ff]]
            + [n for n in moving_joint_names if n not in ff_names])
    unknown = set(moving_joint_names) - {j.name for j in movable_all}
    if unknown:
        raise ValueError(f"moving_joint_names not in model: {sorted(unknown)}")

    # q0 indexed over *all* movable joints of the full model, reference-style
    q0_full = np.zeros(len(movable_all)) if q0 is None else np.asarray(q0, float)
    if n_ff and q0_full.shape[0] == len(movable_all) - n_ff:
        q0_full = np.concatenate([np.zeros(n_ff), q0_full])  # base at origin
    if q0_full.shape[0] != len(movable_all):
        raise ValueError(
            f"q0 must cover the full model ({len(movable_all)} movable joints), "
            f"got {q0_full.shape[0]}"
        )
    locked_q = {
        j.name: q0_full[i]
        for i, j in enumerate(movable_all)
        if j.name not in moving_joint_names
    }

    # --- walk the tree, accumulating fixed/locked transforms -----------------
    jnames: List[str] = []
    jtypes: List[str] = []
    parents: List[int] = []
    joint_rot, joint_trans, axes = [], [], []
    inertials: List[_Inertial] = []
    limits: List[Tuple[float, float, float, float]] = []
    frames: List[Frame] = []
    frame_rot, frame_trans = [], []
    geoms: List[Geometry] = []
    geom_rot, geom_trans, geom_radius, geom_halflen = [], [], [], []
    geom_names_by_link: Dict[str, List[int]] = {}

    def _add_frame(nm: str, parent_joint: int, placement):
        R, p = placement
        frames.append(Frame(nm, parent_joint, len(frames)))
        frame_rot.append(R)
        frame_trans.append(p)

    def _add_geoms(link: _Link, parent_joint: int, placement):
        gl = _capsulize(link.geoms) if collision_as_capsule else [
            g for g in link.geoms if g.gtype in ("capsule", "sphere", "cylinder", "box")
        ]
        if not collision_as_capsule:
            gl = _capsulize(gl)  # engine-side shapes are capsules/spheres only
        ids = []
        for g in gl:
            gid = len(geoms)
            geoms.append(Geometry(g.name, parent_joint, g.gtype, gid))
            R, p = _se3_mul(placement, g.placement)
            geom_rot.append(R)
            geom_trans.append(p)
            geom_radius.append(g.radius)
            geom_halflen.append(g.halflen)
            ids.append(gid)
        geom_names_by_link.setdefault(link.name, []).extend(ids)

    def _walk(link_name: str, parent_joint_idx: int, placement):
        """placement: transform of ``link_name``'s frame in the parent joint
        frame (identity when the link owns joint ``parent_joint_idx``)."""
        link = links[link_name]
        if parent_joint_idx >= 0:
            inertials[parent_joint_idx] = _merge_inertia(
                inertials[parent_joint_idx], link.inertial, placement
            )
        _add_frame(link_name, parent_joint_idx, placement)
        _add_geoms(link, parent_joint_idx, placement)
        for j in children_of.get(link_name, []):
            j_placement = _se3_mul(placement, j.origin)
            if j.jtype == "fixed" or j.name in locked_q:
                extra = _se3_id()
                if j.name in locked_q:
                    qv = locked_q[j.name]
                    if j.jtype == "revolute":
                        extra = (_axis_angle(j.axis, qv), np.zeros(3))
                    elif j.jtype == "prismatic":
                        extra = (np.eye(3), j.axis * qv)
                _walk(j.child, parent_joint_idx, _se3_mul(j_placement, extra))
            else:
                idx = len(jnames)
                jnames.append(j.name)
                jtypes.append(j.jtype)
                parents.append(parent_joint_idx)
                R, p = j_placement
                joint_rot.append(R)
                joint_trans.append(p)
                axes.append(j.axis / np.linalg.norm(j.axis))
                inertials.append(_Inertial())
                limits.append((j.lower, j.upper, j.velocity, j.effort))
                _walk(j.child, idx, _se3_id())

    # root link's own inertia is fixed to the world: it does not enter dynamics
    _walk(root, -1, _se3_id())

    # --- collision pairs -----------------------------------------------------
    pair_set: List[Tuple[int, int]] = []

    def _link_pairs(l1: str, l2: str):
        for a in geom_names_by_link.get(l1, []):
            for b in geom_names_by_link.get(l2, []):
                pair_set.append((min(a, b), max(a, b)))

    if self_collision and srdf is not None:
        # SRDF lists *disabled* pairs; enable everything else between links
        disabled = {tuple(sorted(p)) for p in _parse_srdf_disabled(_read(srdf))}
        lnames = [ln for ln in geom_names_by_link if geom_names_by_link[ln]]
        for i, l1 in enumerate(lnames):
            for l2 in lnames[i + 1:]:
                if tuple(sorted((l1, l2))) not in disabled:
                    _link_pairs(l1, l2)
    for (g1, g2) in collision_pairs:
        # explicit pairs are geometry names (reference `:320-330`)
        by_name = {g.name: g.index for g in geoms}
        if g1 in by_name and g2 in by_name:
            a, b = by_name[g1], by_name[g2]
            pair_set.append((min(a, b), max(a, b)))
        else:
            _link_pairs(g1, g2)  # allow link names too
    pair_set = sorted(set(pair_set))

    nj = len(jnames)
    arm = np.zeros(nj) if armature is None else np.asarray(armature, float)
    if n_ff and arm.shape[0] == nj - n_ff:
        arm = np.concatenate([np.zeros(n_ff), arm])  # no rotor on the base
    if arm.shape[0] != nj:
        raise ValueError(f"armature length {arm.shape[0]} != nj {nj}")

    model = RobotModel(
        name=name,
        joint_names=tuple(jnames),
        joint_types=tuple(jtypes),
        parents=tuple(parents),
        frames=tuple(frames),
        geometries=tuple(geoms),
        collision_pairs=tuple(pair_set),
    )
    f = lambda x: np.asarray(x, dtype=np.float64)
    lim = np.asarray(limits) if limits else np.zeros((0, 4))
    arrays = dict(
        joint_rot=f(np.stack(joint_rot) if joint_rot else np.zeros((0, 3, 3))),
        joint_trans=f(np.stack(joint_trans) if joint_trans else np.zeros((0, 3))),
        axis=f(np.stack(axes) if axes else np.zeros((0, 3))),
        mass=f([b.mass for b in inertials]),
        com=f(np.stack([b.com for b in inertials]) if inertials else np.zeros((0, 3))),
        inertia=f(np.stack([b.inertia for b in inertials]) if inertials else np.zeros((0, 3, 3))),
        armature=f(arm),
        frame_rot=f(np.stack(frame_rot)),
        frame_trans=f(np.stack(frame_trans)),
        q_lower=f(lim[:, 0]),
        q_upper=f(lim[:, 1]),
        velocity_limit=f(lim[:, 2]),
        effort_limit=f(lim[:, 3]),
        geom_rot=f(np.stack(geom_rot) if geom_rot else np.zeros((0, 3, 3))),
        geom_trans=f(np.stack(geom_trans) if geom_trans else np.zeros((0, 3))),
        geom_radius=f(geom_radius),
        geom_halflen=f(geom_halflen),
        gravity=f(np.asarray(gravity)),
    )
    params = params_from_numpy(
        SimpleNamespace(**arrays), dtype=dtype, device=device)
    return model, params


class RobotModels:
    """Reference-API facade (`RobotModels`, `factory/robot_model.py:88-351`):
    builds both the full and the reduced model from `RobotModelParameters`,
    their tensors on ``device``."""

    def __init__(self, params: RobotModelParameters,
                 device: torch.device | str = DEFAULT_DEVICE):
        device = resolve_device(device)
        self._params = params
        self.full_model, self.full_params = build_model_from_urdf(
            params.robot_urdf,
            moving_joint_names=None,
            env_urdf=params.env_urdf,
            robot_attachment_frame=params.robot_attachment_frame,
            srdf=params.srdf,
            collision_as_capsule=params.collision_as_capsule,
            collision_pairs=params.collision_pairs,
            self_collision=params.self_collision,
            dtype=params.dtype,
            device=device,
            free_flyer=params.free_flyer,
        )
        q0 = params.q0 if params.q0.size else None
        self.model, self.params = build_model_from_urdf(
            params.robot_urdf,
            moving_joint_names=params.moving_joint_names or None,
            q0=q0,
            armature=params.armature if params.moving_joint_names else None,
            env_urdf=params.env_urdf,
            robot_attachment_frame=params.robot_attachment_frame,
            srdf=params.srdf,
            collision_as_capsule=params.collision_as_capsule,
            collision_pairs=params.collision_pairs,
            self_collision=params.self_collision,
            dtype=params.dtype,
            device=device,
            free_flyer=params.free_flyer,
        )

    @property
    def robot_model(self):
        return self.model

    @property
    def armature(self):
        return self.params.armature


def build_robot_models(params: RobotModelParameters,
                       device: torch.device | str = DEFAULT_DEVICE) -> RobotModels:
    return RobotModels(params, device)
