"""Static robot model structures.

The *topology* (`RobotModel`) is plain Python — tuples of ints and strings,
hashable — while every *numeric constant* lives in `ModelParams`, a
NamedTuple of tensors on one device and dtype.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device


class ModelParams(NamedTuple):
    """Numeric model constants (tensors).

    Shapes use nj = number of movable joints, nf = number of frames,
    ng = number of collision geometries.
    """

    # joint placements in the parent joint frame (fixed part of the chain)
    joint_rot: torch.Tensor  # [nj, 3, 3]
    joint_trans: torch.Tensor  # [nj, 3]
    axis: torch.Tensor  # [nj, 3] unit joint axis in the joint frame
    # per-body (== per movable joint) inertial constants, in the joint frame
    mass: torch.Tensor  # [nj]
    com: torch.Tensor  # [nj, 3]
    inertia: torch.Tensor  # [nj, 3, 3] rotational inertia about the CoM
    armature: torch.Tensor  # [nj] rotor inertia added to the mass-matrix diagonal
    # operational frames attached to joints
    frame_rot: torch.Tensor  # [nf, 3, 3]
    frame_trans: torch.Tensor  # [nf, 3]
    # limits
    q_lower: torch.Tensor  # [nj]
    q_upper: torch.Tensor  # [nj]
    velocity_limit: torch.Tensor  # [nj]
    effort_limit: torch.Tensor  # [nj]
    # collision geometry (capsules/spheres: halflen == 0 -> sphere)
    geom_rot: torch.Tensor  # [ng, 3, 3] placement in parent joint frame
    geom_trans: torch.Tensor  # [ng, 3]
    geom_radius: torch.Tensor  # [ng]
    geom_halflen: torch.Tensor  # [ng]
    # gravity vector in the world frame
    gravity: torch.Tensor  # [3]


def params_from_numpy(p, dtype: torch.dtype = torch.float64,
                      device: torch.device | str = DEFAULT_DEVICE) -> ModelParams:
    """Port's `ModelParams` from any object carrying the same fields as numpy
    arrays (e.g. the JAX package's `ModelParams`)."""
    device = resolve_device(device)
    return ModelParams(*(
        torch.as_tensor(np.asarray(getattr(p, f)), dtype=dtype, device=device)
        for f in ModelParams._fields))


@dataclasses.dataclass(frozen=True)
class Frame:
    name: str
    parent_joint: int  # -1 = universe (the root)
    index: int


@dataclasses.dataclass(frozen=True)
class Geometry:
    name: str
    parent_joint: int  # -1 = world-fixed (environment) geometry
    gtype: str  # "capsule" | "sphere" (boxes are capsule-approximated)
    index: int


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static kinematic topology. Hashable.

    Reference equivalent: the pinocchio `pin.Model` + `pin.GeometryModel` pair
    produced by `RobotModels` (`factory/robot_model.py:88-351`), flattened to
    arrays for a fixed tree.
    """

    name: str
    joint_names: Tuple[str, ...]
    joint_types: Tuple[str, ...]  # "revolute" | "prismatic"
    parents: Tuple[int, ...]  # parent movable-joint index, -1 for root
    frames: Tuple[Frame, ...]
    geometries: Tuple[Geometry, ...]
    collision_pairs: Tuple[Tuple[int, int], ...]  # geometry index pairs

    @property
    def nj(self) -> int:
        return len(self.joint_names)

    @property
    def nq(self) -> int:
        return self.nj

    @property
    def nv(self) -> int:
        return self.nj

    @property
    def nx(self) -> int:
        return self.nq + self.nv

    @property
    def nframes(self) -> int:
        return len(self.frames)

    @property
    def ngeoms(self) -> int:
        return len(self.geometries)

    def frame_id(self, name: str) -> int:
        for f in self.frames:
            if f.name == name:
                return f.index
        raise KeyError(f"unknown frame {name!r}; have {[f.name for f in self.frames]}")

    def joint_id(self, name: str) -> int:
        return self.joint_names.index(name)

    def geometry_id(self, name: str) -> int:
        for g in self.geometries:
            if g.name == name:
                return g.index
        raise KeyError(f"unknown geometry {name!r}")

    def neutral(self, params: ModelParams) -> torch.Tensor:
        """Neutral configuration: midpoint of finite limits, else zero
        (pinocchio `pin.neutral` analog)."""
        lo, hi = params.q_lower, params.q_upper
        finite = torch.isfinite(lo) & torch.isfinite(hi)
        return torch.where(finite, 0.5 * (lo + hi), torch.zeros_like(lo))
