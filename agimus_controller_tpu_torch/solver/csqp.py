"""Solver settings of the batch SQP (mim_solvers `SolverCSQP` semantics).

`CSQPSettings` of the JAX package's `solver/csqp.py`, with the same fields
and defaults, over `SolverSettings` (whose home is `solver/fddp.py`, as in
the JAX package; imported here so every existing import keeps working). The
port's batch solver reads all of them: the ADMM fields (`max_qp_iters`,
`eps_*`, `rho`, `adaptive_rho`, `constraint_envelope`, `envelope_tol`,
`soc_iters`) drive its constrained branch. `sweep_f64` is not ported: the
sweeps run in the trajectory dtype.
"""

from __future__ import annotations

import dataclasses

from .fddp import SolverSettings

__all__ = ["CSQPSettings", "SolverSettings"]


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
