"""Hand-coded goal-reaching OCP (reference `OCPCrocoGoalReaching`,
`ocp/ocp_croco_goal_reaching.py:9-213`): the same problem as the YAML
definition but constructed programmatically — stateReg + ctrlReg +
goalTracking(frame placement) per node with per-tick reference updates.

Port of the JAX package's `ocp/goal_reaching.py`, over `OCPTorch`."""

from __future__ import annotations

import torch

from ..device import DEFAULT_DEVICE
from ..models.model import ModelParams, RobotModel
from ..mpc.ocp_base import OCPParams, OCPTorch
from .spec import CostItem, ProblemSpec


class OCPGoalReaching(OCPTorch):
    def __init__(
        self,
        model: RobotModel,
        params: ModelParams,
        ocp_params: OCPParams,
        ee_frame: str,
        w_state: float = 1.0,
        w_control: float = 1.0,
        w_goal_running: float = 1.0,
        w_goal_terminal: float = 1.0,
        dtype: torch.dtype = torch.float32,
        device: torch.device | str = DEFAULT_DEVICE,
    ):
        model.frame_id(ee_frame)  # validate (single-EE, reference `:164-167`)
        spec = ProblemSpec(
            running_costs=(
                CostItem(name="ctrlReg", kind="control", weight=w_control, update=True),
                CostItem(name="stateReg", kind="state", weight=w_state, update=True),
                CostItem(name="goalTracking", kind="frame_placement",
                         weight=w_goal_running, update=True, frame=ee_frame),
            ),
            terminal_costs=(
                CostItem(name="stateReg", kind="state", weight=w_state, update=True),
                CostItem(name="goalTracking", kind="frame_placement",
                         weight=w_goal_terminal, update=True, frame=ee_frame),
            ),
            horizon=ocp_params.horizon_size,
            dt=ocp_params.dt,
            dt_factor_n_seq=tuple(ocp_params.dt_factor_n_seq),
        )
        super().__init__(model, params, spec, ocp_params, dtype=dtype,
                         device=device)
