"""Feasibility-driven DDP (Crocoddyl `SolverFDDP` semantics): settings and
solution.

The settings dataclass and the solution tuple of the JAX package's
`solver/fddp.py` (`SolverSettings`, `Solution`), with the same fields and
defaults; the batch FDDP (`fddp_batch`) and the batch SQP (`csqp`) read
them. The single-scenario `solve_fddp` is not ported yet: it needs the
generic `CostFunctions` (ROADMAP queue 1, slice 11).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Static solver configuration (mirrors `OCPParamsBaseCroco`,
    `ocp_param_base.py:31-85`, solver side)."""

    max_iters: int = 10
    n_alphas: int = 10  # step ladder alpha_i = 0.5 ** i
    termination_tolerance: float = 1e-3  # KKT inf-norm
    reg_init: float = 1e-9
    reg_min: float = 1e-9
    reg_max: float = 1e9
    reg_inc: float = 10.0
    reg_dec: float = 10.0
    use_filter_line_search: bool = True  # mim_solvers default in the reference
    accept_ratio: float = 0.1  # fraction of expected decrease to accept


class Solution(NamedTuple):
    """A solve's result; the batch solver gives every field a leading [B]."""

    xs: torch.Tensor  # [T+1, nx]
    us: torch.Tensor  # [T, nu]
    K: torch.Tensor  # [T, nu, nx] Riccati feedback gains
    k: torch.Tensor  # [T, nu] feed-forward corrections (last pass)
    cost: torch.Tensor
    kkt: torch.Tensor  # KKT inf-norm (criterion of mim_solvers SQP)
    gap_norm: torch.Tensor
    iters: torch.Tensor
    reg: torch.Tensor
    converged: torch.Tensor
