"""MPC orchestration layer (reference L3/L4: `mpc.py`, `trajectory.py`,
`warm_start_*.py`, `mpc_data.py`, `ocp_base.py`): the reference buffer, the
OCP facade, warm starts and the MPC loop; the device-resident ring
(`ring.py`) and the fused tick (`tick.py`) beside them."""

from .buffer import (
    DTFactorsNSeq,
    TrajectoryBuffer,
    TrajectoryPoint,
    TrajectoryPointWeights,
    WeightedTrajectoryPoint,
    interpolate_weights,
)
from .data import MPCDebugData, OCPDebugData, OCPResults
from .mpc import MPC
from .ocp_base import OCPBase, OCPParams, OCPTorch
from .warm_start import (
    WarmStartBase,
    WarmStartReference,
    WarmStartShiftPreviousSolution,
    WarmStartShiftPreviousSolutionForceFeedback,
)

__all__ = [
    "DTFactorsNSeq",
    "MPC",
    "MPCDebugData",
    "OCPBase",
    "OCPDebugData",
    "OCPParams",
    "OCPResults",
    "OCPTorch",
    "TrajectoryBuffer",
    "TrajectoryPoint",
    "TrajectoryPointWeights",
    "WarmStartBase",
    "WarmStartReference",
    "WarmStartShiftPreviousSolution",
    "WarmStartShiftPreviousSolutionForceFeedback",
    "WeightedTrajectoryPoint",
    "interpolate_weights",
]
