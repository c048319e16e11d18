"""OCP layer: static problem specs and runtime reference dicts, the cost
functions (`costs.py`) and those of the quaternion free-flyer state
(`ff_costs.py`)."""

from .costs import CostFunctions, build_cost_functions
from .ff_costs import (
    FF_CONSTRAINT_KINDS,
    FF_COST_KINDS,
    FFCostFunctions,
    build_ff_cost_functions,
)
from .spec import (
    ConstraintItem,
    CostItem,
    ProblemSpec,
    default_references,
    make_timesteps,
    refs_from_numpy,
    slice_refs,
)
