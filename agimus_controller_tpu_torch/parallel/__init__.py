"""Scenario batching and device meshes (SURVEY.md §2c): the batch axis over
scenarios (perturbed initial states, model parameters, weight schedules)
is the engine's primary parallel dimension. Port of the JAX package's
`parallel/`: the mesh and the sharded batch solvers (`mesh.py`), the
multi-process runtime over `torch.distributed` (`distributed.py`) and the
model-parameter sensitivity sweep (`sensitivity.py`)."""

from .distributed import (
    DistributedConfig,
    host_local_to_global,
    initialize_distributed,
    make_global_mesh,
)
from .mesh import batch_solve, make_batch_solver, make_mesh, sharded_batch_solver
from .sensitivity import (
    next_state_sensitivity,
    perturbed_params_batch,
    sensitivity_svd,
)
