"""The port's entry points run on the card unless the caller asks for the
host.

With `torch.cuda.is_available` patched to False, every public factory
called without a device raises and says to pass `device="cpu"`, instead of
carrying on with the plain versions on the host; with `device="cpu"` each
one builds.
"""

import numpy as np
import pytest
import torch

from agimus_controller_tpu_torch.factory import create_ocp, create_warm_start
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.models.panda import load_panda
from agimus_controller_tpu_torch.models.urdf import (
    RobotModelParameters,
    RobotModels,
    build_model_from_urdf,
    build_robot_models,
)
from agimus_controller_tpu_torch.mpc.buffer import DTFactorsNSeq
from agimus_controller_tpu_torch.mpc.ocp_base import OCPParams, OCPTorch
from agimus_controller_tpu_torch.mpc.ring import (
    PackedTrajectoryBuffer,
    RefRing,
    RowLayout,
)
from agimus_controller_tpu_torch.mpc.tick import (
    FusedTick,
    FusedTickRunner,
    make_fused_tick,
)
from agimus_controller_tpu_torch.mpc.warm_start import (
    WarmStartReference,
    WarmStartShiftPreviousSolution,
)
from agimus_controller_tpu_torch.ocp.goal_reaching import OCPGoalReaching
from agimus_controller_tpu_torch.ocp.spec import (
    CostItem,
    ProblemSpec,
    default_references,
    refs_from_numpy,
)
from agimus_controller_tpu_torch.ops.cuda_costs import (
    StageKernel,
    TerminalKernel,
    make_cuda_stage,
    make_cuda_terminal,
)
from agimus_controller_tpu_torch.ops.batched_costs import make_batched_cost_pack
from agimus_controller_tpu_torch.ops.cuda_dynamics import (
    StepKernel,
    make_cuda_step,
    make_cuda_step_derivs,
)
from agimus_controller_tpu_torch.solver.fddp_batch import BatchFDDP, make_batch_fddp
from agimus_controller_tpu_torch.solver.sqp_batch import BatchSQP, make_batch_sqp
from tests.test_ring_control_loop import URDF_2DOF

T = 4
SEQ = DTFactorsNSeq(factors=[1], n_steps=[T])


@pytest.fixture(scope="module")
def arm():
    model, params = build_model_from_urdf(URDF_2DOF, dtype=torch.float64,
                                          device="cpu")
    spec = ProblemSpec(
        running_costs=(CostItem(name="x", kind="state", update=True),
                       CostItem(name="goal", kind="frame_placement",
                                update=True, frame="tip")),
        terminal_costs=(CostItem(name="x", kind="state", update=True),),
        horizon=T, dt=0.01)
    ring = RefRing(RowLayout(spec, model), SEQ, dtype=torch.float64,
                   device="cpu")
    return dict(model=model, params=params, spec=spec, ring=ring)


def _refs(a, **kw):
    return default_references(a["spec"], a["model"], dtype=torch.float64, **kw)


ENTRY_POINTS = {
    "load_panda": lambda a, kw: load_panda(**kw),
    "build_model_from_urdf": lambda a, kw: build_model_from_urdf(URDF_2DOF, **kw),
    "params_from_numpy": lambda a, kw: params_from_numpy(
        type(a["params"])(*(t.numpy() for t in a["params"])), **kw),
    "default_references": lambda a, kw: _refs(a, **kw),
    "refs_from_numpy": lambda a, kw: refs_from_numpy(
        {"xref": np.zeros((T + 1, 4))}, **kw),
    "RefRing": lambda a, kw: RefRing(RowLayout(a["spec"], a["model"]), SEQ,
                                     **kw),
    "PackedTrajectoryBuffer": lambda a, kw: PackedTrajectoryBuffer(
        SEQ, RowLayout(a["spec"], a["model"]), **kw),
    "StageKernel": lambda a, kw: StageKernel(a["model"], a["params"],
                                             a["spec"], True, **kw),
    "TerminalKernel": lambda a, kw: TerminalKernel(a["model"], a["params"],
                                                   a["spec"], True, **kw),
    "make_cuda_stage": lambda a, kw: make_cuda_stage(
        a["model"], a["params"], a["spec"], True, **kw),
    "make_cuda_terminal": lambda a, kw: make_cuda_terminal(
        a["model"], a["params"], a["spec"], False, **kw),
    "StepKernel": lambda a, kw: StepKernel(a["model"], a["params"], True,
                                           **kw),
    "make_cuda_step": lambda a, kw: make_cuda_step(a["model"], a["params"],
                                                   **kw),
    "make_cuda_step_derivs": lambda a, kw: make_cuda_step_derivs(
        a["model"], a["params"], **kw),
    "make_batched_cost_pack": lambda a, kw: make_batched_cost_pack(
        a["model"], a["params"], a["spec"], **kw),
    "BatchFDDP": lambda a, kw: BatchFDDP(a["model"], a["params"], a["spec"],
                                         **kw),
    "make_batch_fddp": lambda a, kw: make_batch_fddp(
        a["model"], a["params"], a["spec"], **kw),
    "BatchSQP": lambda a, kw: BatchSQP(a["model"], a["params"], a["spec"],
                                       **kw),
    "make_batch_sqp": lambda a, kw: make_batch_sqp(
        a["model"], a["params"], a["spec"], **kw),
    "make_batch_sqp_xla": lambda a, kw: make_batch_sqp(
        a["model"], a["params"], a["spec"], backend="xla", **kw),
    "FusedTick": lambda a, kw: FusedTick(a["model"], a["params"], a["spec"],
                                         a["ring"], **kw),
    "make_fused_tick": lambda a, kw: make_fused_tick(
        a["model"], a["params"], a["spec"], a["ring"], **kw),
    "make_fused_tick_xla": lambda a, kw: make_fused_tick(
        a["model"], a["params"], a["spec"], a["ring"], backend="xla", **kw),
    "FusedTickRunner": lambda a, kw: FusedTickRunner(
        a["model"], a["params"], a["spec"], a["ring"],
        _refs(a, device="cpu"), dtype=torch.float64, **kw),
    "OCPTorch": lambda a, kw: OCPTorch(a["model"], a["params"], a["spec"],
                                       dtype=torch.float64, **kw),
    "OCPTorch_ring": lambda a, kw: OCPTorch(
        a["model"], a["params"], a["spec"], dtype=torch.float64,
        ring=a["ring"], **kw),
    "OCPGoalReaching": lambda a, kw: OCPGoalReaching(
        a["model"], a["params"], OCPParams(horizon_size=T), "tip", **kw),
    "create_ocp": lambda a, kw: create_ocp(
        "goal_reaching_yaml", a["model"], a["params"],
        OCPParams(horizon_size=T), ee_frame="tip", **kw),
    "create_warm_start_reference": lambda a, kw: create_warm_start(
        "reference", a["model"], a["params"], **kw),
    "create_warm_start_shift": lambda a, kw: create_warm_start(
        "shift_previous_solution", a["model"], a["params"],
        timesteps=a["spec"].timesteps(), **kw),
    "WarmStartReference.setup": lambda a, kw: WarmStartReference().setup(
        a["model"], a["params"], **kw) or True,
    "WarmStartShiftPreviousSolution.setup": lambda a, kw: (
        WarmStartShiftPreviousSolution().setup(
            a["model"], a["params"], a["spec"].timesteps(), **kw) or True),
    "RobotModels": lambda a, kw: RobotModels(
        RobotModelParameters(robot_urdf=URDF_2DOF), **kw),
    "build_robot_models": lambda a, kw: build_robot_models(
        RobotModelParameters(robot_urdf=URDF_2DOF), **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(arm, name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        ENTRY_POINTS[name](arm, {})


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_host_when_asked(arm, name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ENTRY_POINTS[name](arm, {"device": "cpu"}) is not None
