"""OCP solvers: the unconstrained batch multiple-shooting SQP (`sqp_batch`)."""
