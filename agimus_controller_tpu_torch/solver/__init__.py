"""OCP solvers: the batch multiple-shooting SQP (`sqp_batch`) and the batch
FDDP (`fddp_batch`)."""
