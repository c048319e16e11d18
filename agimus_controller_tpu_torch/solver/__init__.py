"""OCP solvers: the batch multiple-shooting SQP (`sqp_batch`), the batch
FDDP (`fddp_batch`) and the single-scenario `solve_fddp` (`fddp`) and
`solve_csqp` (`csqp`)."""

from .csqp import CSQPSettings, CSQPSolution, solve_csqp
from .fddp import Solution, SolverSettings, solve_fddp
