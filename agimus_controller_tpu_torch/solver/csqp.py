"""Solver settings of the batch SQP (mim_solvers `SolverCSQP` semantics).

The settings dataclasses of the JAX package's `solver/fddp.py`
(`SolverSettings`) and `solver/csqp.py` (`CSQPSettings`), with the same
fields and defaults. The port's batch solver reads all of them: the ADMM
fields (`max_qp_iters`, `eps_*`, `rho`, `adaptive_rho`,
`constraint_envelope`, `envelope_tol`, `soc_iters`) drive its constrained
branch. `sweep_f64` is not ported: the sweeps run in the trajectory dtype.
"""

from __future__ import annotations

import dataclasses


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


@dataclasses.dataclass(frozen=True)
class CSQPSettings(SolverSettings):
    max_qp_iters: int = 200
    eps_abs: float = 1e-6
    eps_rel: float = 0.0
    rho: float = 1e-1
    # OSQP-style per-scenario rho adaptation between SQP iterations
    adaptive_rho: bool = True
    # constraint-envelope acceptance in the filter line search
    constraint_envelope: bool = True
    envelope_tol: float = 1e-5
    # second-order (Maratos) correction iterations of the ADMM step
    soc_iters: int = 4
