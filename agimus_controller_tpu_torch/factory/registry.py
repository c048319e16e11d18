"""Name-keyed OCP / warm-start factories (functional version of the
reference's stub registries, `factory/ocp.py` / `factory/warm_start.py`).

Port of the JAX package's `factory/registry.py`. The two named YAML OCPs
compile the shipped definitions from their parsed trees
(`ocp/definitions.py`), so they need no PyYAML; the ``yaml`` entry parses a
file or text and imports PyYAML for it. Every entry takes ``device``
(default the card) and builds there.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..device import DEFAULT_DEVICE
from ..mpc.ocp_base import OCPParams, OCPTorch
from ..mpc.warm_start import (
    WarmStartReference,
    WarmStartShiftPreviousSolution,
    WarmStartShiftPreviousSolutionForceFeedback,
)
from ..ocp import definitions
from ..ocp.goal_reaching import OCPGoalReaching
from ..ocp.yaml_compiler import load_ocp_spec

OCP_REGISTRY: Dict[str, Callable] = {}
WARM_START_REGISTRY: Dict[str, Callable] = {}


def register_ocp(name: str):
    def deco(fn):
        OCP_REGISTRY[name] = fn
        return fn
    return deco


def register_warm_start(name: str):
    def deco(fn):
        WARM_START_REGISTRY[name] = fn
        return fn
    return deco


@register_ocp("goal_reaching")
def _goal_reaching(model, params, ocp_params: OCPParams, *, ee_frame,
                   dtype=torch.float32, device=DEFAULT_DEVICE, **kw):
    return OCPGoalReaching(model, params, ocp_params, ee_frame, dtype=dtype,
                           device=device, **kw)


@register_ocp("yaml")
def _yaml(model, params, ocp_params: OCPParams, *, yaml_file, ee_frame=None,
          dtype=torch.float32, ring=None, device=DEFAULT_DEVICE, **kw):
    """``yaml_file``: a path, YAML text or a parsed tree."""
    spec = load_ocp_spec(
        yaml_file, model, horizon=ocp_params.horizon_size, dt=ocp_params.dt,
        dt_factor_n_seq=tuple(ocp_params.dt_factor_n_seq),
        default_ee_frame=ee_frame,
    )
    return OCPTorch(model, params, spec, ocp_params, dtype=dtype, ring=ring,
                    device=device)


@register_ocp("goal_reaching_yaml")
def _goal_reaching_yaml(model, params, ocp_params, *, ee_frame, **kw):
    return _yaml(model, params, ocp_params,
                 yaml_file=definitions.GOAL_REACHING, ee_frame=ee_frame, **kw)


@register_ocp("traj_tracking_collision_avoidance")
def _collision(model, params, ocp_params, *, ee_frame, **kw):
    return _yaml(model, params, ocp_params,
                 yaml_file=definitions.TRAJ_TRACKING_COLLISION_AVOIDANCE,
                 ee_frame=ee_frame, **kw)


@register_warm_start("reference")
def _ws_reference(model, params, device=DEFAULT_DEVICE, **kw):
    ws = WarmStartReference()
    ws.setup(model, params, device=device)
    return ws


@register_warm_start("shift_previous_solution")
def _ws_shift(model, params, *, timesteps, device=DEFAULT_DEVICE, **kw):
    ws = WarmStartShiftPreviousSolution()
    ws.setup(model, params, timesteps, device=device)
    return ws


@register_warm_start("shift_previous_solution_force_feedback")
def _ws_shift_ff(model, params, *, timesteps, soft_contact,
                 device=DEFAULT_DEVICE, **kw):
    ws = WarmStartShiftPreviousSolutionForceFeedback()
    ws.setup(model, params, timesteps, soft_contact, device=device)
    return ws


def create_ocp(name: str, model, params, ocp_params: OCPParams, **kwargs):
    """Instantiate a registered OCP by name (reference `factory/ocp.py`
    contract, implemented)."""
    if name not in OCP_REGISTRY:
        raise KeyError(f"unknown OCP {name!r}; registered: {sorted(OCP_REGISTRY)}")
    return OCP_REGISTRY[name](model, params, ocp_params, **kwargs)


def create_warm_start(name: str, model, params, **kwargs):
    """Instantiate a registered warm start by name."""
    if name not in WARM_START_REGISTRY:
        raise KeyError(
            f"unknown warm start {name!r}; registered: {sorted(WARM_START_REGISTRY)}"
        )
    return WARM_START_REGISTRY[name](model, params, **kwargs)
