"""Scenario batching (SURVEY.md §2c): the batch axis over scenarios
(perturbed initial states, model parameters, weight schedules) is the
engine's primary parallel dimension. Port of the JAX package's
`parallel/`: the model-parameter sensitivity sweep; the device mesh and
the multi-process runtime (`mesh.py`, `distributed.py`) are not ported
yet (ROADMAP queue 1, slice 16)."""

from .sensitivity import (
    next_state_sensitivity,
    perturbed_params_batch,
    sensitivity_svd,
)
