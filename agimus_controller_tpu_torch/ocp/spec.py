"""Static OCP problem specification and runtime reference tensors.

The spec is hashable static metadata; everything that changes per tick
(references, weights, obstacle poses, visual-servoing transforms) lives in a
flat dict of tensors ("refs") indexed by node. Same data model as the JAX
package's `ocp/spec.py`.

Reference weight conventions preserved (`trajectory.py:84-158`):
- state residual activation weights = [w_robot_configuration, w_robot_velocity]
- control weights = w_robot_effort
- EE pose weights = 6-vector ordered [w_rot(3), w_trans(3)] (the library-wide
  [w; v] twist order; converted at the MPC boundary).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.model import RobotModel


COST_KINDS = (
    "state",
    "control",
    "control_grav",
    "frame_placement",
    "frame_translation",
    "frame_rotation",
    "frame_velocity",
    "visual_servoing",
    "collision_distance",
    "force_tracking",  # soft-contact force cost (force_feedback_mpc f_des)
)

ACTIVATION_KINDS = ("weighted_quad", "exp", "quad_exp")


@dataclasses.dataclass(frozen=True)
class CostItem:
    """One cost term: weight * activation(residual). Static config only.

    Mirrors `CostModelSumItem` + residual/activation DSL nodes
    (`ocp_croco_generic.py:560-592`)."""

    name: str
    kind: str  # one of COST_KINDS
    weight: float = 1.0
    update: bool = False  # pull references/weights from per-node refs arrays
    activation: str = "weighted_quad"
    act_alpha: float = 1.0  # exp/quad_exp activations
    act_weights: Optional[Tuple[float, ...]] = None  # static fallback weights
    frame: Optional[str] = None  # frame name for frame_* kinds
    pair_id: Optional[int] = None  # collision pair for collision_distance
    reference_frame: str = "world"  # frame_velocity convention
    object_frame: Optional[str] = None  # visual servoing: vision transform key
    static_ref: Optional[Tuple[float, ...]] = None  # xref/uref/pose when not updated
    active: bool = True
    publish_residual: bool = False

    def __post_init__(self):
        if self.kind not in COST_KINDS:
            raise ValueError(f"unknown cost kind {self.kind!r}")
        if self.activation not in ACTIVATION_KINDS:
            raise ValueError(f"unknown activation {self.activation!r}")

    def residual_dim(self, model: RobotModel, nc: int = 0) -> int:
        return {
            "state": model.nx + nc,
            "control": model.nv,
            "control_grav": model.nv,
            "frame_placement": 6,
            "frame_translation": 3,
            "frame_rotation": 3,
            "frame_velocity": 6,
            "visual_servoing": 6,
            "collision_distance": 1,
            "force_tracking": max(nc, 1),
        }[self.kind]


@dataclasses.dataclass(frozen=True)
class ConstraintItem:
    """Inequality constraint lb <= g(x, u) <= ub over a residual.

    Mirrors `ConstraintModelResidual` / `ConstraintModelControlLimit`
    (`ocp_croco_generic.py:594-654`). ``kind`` reuses COST_KINDS plus
    "control_limit" (box at +-effort_limit)."""

    name: str
    kind: str
    lower: Tuple[float, ...] = ()
    upper: Tuple[float, ...] = ()
    frame: Optional[str] = None
    pair_id: Optional[int] = None
    reference_frame: str = "world"
    # also enforced at the terminal node — the reference's
    # `active_on_terminal_node` defaults to true (`ocp_croco_generic.py:598`)
    terminal: bool = True

    def residual_dim(self, model: RobotModel, nc: int = 0) -> int:
        if self.kind == "control_limit":
            return model.nv
        if self.kind == "force_box":
            return max(nc, 1)
        return CostItem(name="_", kind=self.kind).residual_dim(model, nc)


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """A full OCP: running/terminal cost sets, constraints, horizon timing.

    ``dt_factor_n_seq``: ((factor, n_steps), ...) non-uniform horizon spec —
    the reference's `DTFactorsNSeq` (`ocp_param_base.py:6-28`)."""

    running_costs: Tuple[CostItem, ...]
    terminal_costs: Tuple[CostItem, ...]
    constraints: Tuple[ConstraintItem, ...] = ()
    horizon: int = 20  # number of controls T (nodes = T + 1)
    dt: float = 0.01
    dt_factor_n_seq: Tuple[Tuple[int, int], ...] = ()
    # force-feedback tier: soft-contact augmented dynamics (not ported yet)
    soft_contact: Optional[object] = None

    def __post_init__(self):
        if self.dt_factor_n_seq:
            n = sum(ns for _, ns in self.dt_factor_n_seq)
            if n != self.horizon:
                raise ValueError(
                    f"dt_factor_n_seq covers {n} steps != horizon {self.horizon}"
                    " (reference asserts the same, ocp_param_base.py:79)"
                )

    @property
    def n_controls(self) -> int:
        return self.horizon

    @property
    def nc(self) -> int:
        """Contact-force state dimension (0 without soft contact)."""
        return self.soft_contact.nc if self.soft_contact is not None else 0

    def state_dim(self, model: RobotModel) -> int:
        """nx of the (possibly force-augmented) state."""
        return model.nx + self.nc

    def timesteps(self) -> np.ndarray:
        """Per-node dt, `[T]` (reference `OCPParamsBaseCroco.timesteps`,
        `ocp_param_base.py:67-78`)."""
        if not self.dt_factor_n_seq:
            return np.full(self.horizon, self.dt)
        out = []
        for factor, n_steps in self.dt_factor_n_seq:
            out += [self.dt * factor] * n_steps
        return np.asarray(out)

    @property
    def total_time(self) -> float:
        return float(self.timesteps().sum())

    def all_costs(self):
        return tuple(self.running_costs) + tuple(self.terminal_costs)


def default_references(
    spec: ProblemSpec, model: RobotModel, dtype: torch.dtype = torch.float32,
    device: torch.device | str = DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """Allocate the runtime refs dict with neutral values.

    Keys (allocated only when some cost consumes them):
      xref [T+1,nx], w_x [T+1,nx], uref [T+1,nu], w_u [T+1,nu],
      ee_rot:<frame> [T+1,3,3], ee_trans:<frame> [T+1,3], w_ee:<frame> [T+1,6],
      ee_vel:<frame> [T+1,6], w_ee_vel:<frame> [T+1,6],
      w_coll [T+1], wMo_rot:<obj> [3,3], wMo_trans:<obj> [3].
    """
    T = spec.horizon
    nxs = spec.state_dim(model)
    kw = dict(dtype=dtype, device=resolve_device(device))
    refs: Dict[str, torch.Tensor] = {}
    eye3 = torch.eye(3, **kw).expand(T + 1, 3, 3).contiguous()
    if spec.soft_contact is not None:
        refs["contact_active"] = torch.ones((T + 1,), **kw)
    for item in spec.all_costs():
        if item.kind == "state":
            refs.setdefault("xref", torch.zeros((T + 1, nxs), **kw))
            refs.setdefault("w_x", torch.ones((T + 1, nxs), **kw))
        elif item.kind in ("control", "control_grav"):
            refs.setdefault("uref", torch.zeros((T + 1, model.nv), **kw))
            refs.setdefault("w_u", torch.ones((T + 1, model.nv), **kw))
        elif item.kind in ("frame_placement", "frame_translation",
                           "frame_rotation", "visual_servoing"):
            refs.setdefault(f"ee_rot:{item.frame}", eye3.clone())
            refs.setdefault(f"ee_trans:{item.frame}", torch.zeros((T + 1, 3), **kw))
            refs.setdefault(f"w_ee:{item.frame}", torch.ones((T + 1, 6), **kw))
            if item.kind == "visual_servoing":
                refs.setdefault(f"wMo_rot:{item.object_frame}", torch.eye(3, **kw))
                refs.setdefault(f"wMo_trans:{item.object_frame}", torch.zeros(3, **kw))
        elif item.kind == "frame_velocity":
            refs.setdefault(f"ee_vel:{item.frame}", torch.zeros((T + 1, 6), **kw))
            refs.setdefault(f"w_ee_vel:{item.frame}", torch.ones((T + 1, 6), **kw))
        elif item.kind == "collision_distance":
            refs.setdefault("w_coll", torch.ones((T + 1,), **kw))
        elif item.kind == "force_tracking":
            refs.setdefault("f_des", torch.zeros((T + 1, spec.nc), **kw))
            refs.setdefault("w_force", torch.zeros((T + 1, spec.nc), **kw))
    return refs


def refs_from_numpy(refs, dtype: torch.dtype = torch.float64,
                    device: torch.device | str = DEFAULT_DEVICE
                    ) -> Dict[str, torch.Tensor]:
    """Port's refs dict from any mapping of array-likes (e.g. a JAX refs
    dict), converted through numpy."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in refs.items()}


def slice_refs(refs: Dict[str, torch.Tensor], t):
    """Per-node view of the refs dict: node-indexed tensors are gathered at t,
    global tensors (visual-servoing transforms, geom overrides) pass through."""
    out = {}
    for k, v in refs.items():
        if k.startswith(("wMo_", "geom_")):
            out[k] = v
        else:
            out[k] = v[t]
    return out
