"""OCP layer: static problem specs and runtime reference dicts."""

from .spec import (
    ConstraintItem,
    CostItem,
    ProblemSpec,
    default_references,
    refs_from_numpy,
    slice_refs,
)
