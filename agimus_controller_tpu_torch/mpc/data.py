"""MPC/OCP result and debug data types (reference: `mpc_data.py:7-43`).

Port of the JAX package's `mpc/data.py` (numpy only, the same code): the
solver's results are read back to numpy arrays once per solve."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class OCPResults:
    """Output of one OCP solve (reference `OCPResults`, `mpc_data.py:7-13`)."""

    states: np.ndarray  # [T+1, nx]
    ricatti_gains: np.ndarray  # [T, nu, nx]
    feed_forward_terms: np.ndarray  # [T, nu]


@dataclasses.dataclass
class OCPDebugData:
    """Solver telemetry (reference `OCPDebugData`, `mpc_data.py:16-30`)."""

    result: List = dataclasses.field(default_factory=list)
    references: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    residuals: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    kkt_norm: float = 0.0
    nb_iter: int = 0
    nb_qp_iter: int = 0
    problem_solved: bool = False


@dataclasses.dataclass
class MPCDebugData:
    """Per-tick MPC telemetry incl. ns-phase timers (reference `MPCDebugData`,
    `mpc_data.py:33-43`)."""

    ocp: Optional[OCPDebugData] = None
    reference_id: Optional[int] = None
    duration_iteration_ns: int = 0
    duration_horizon_update_ns: int = 0
    duration_generate_warm_start_ns: int = 0
    duration_ocp_solve_ns: int = 0
