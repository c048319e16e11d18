"""Component-form rigid-body numerics (plain PyTorch), the fused stage
kernels K1-K4 (`cuda_costs.py`) and step kernels K5a/K5b
(`cuda_dynamics.py`, sources under `csrc/`), soft contact
(`soft_contact.py`) and the quaternion free-flyer state (`lie.py`)."""

from .soft_contact import (
    SoftContactConfig,
    ff_soft_contact_dynamics,
    ff_soft_contact_step,
    soft_contact_dynamics,
    soft_contact_step,
)

__all__ = [
    "SoftContactConfig",
    "ff_soft_contact_dynamics",
    "ff_soft_contact_step",
    "soft_contact_dynamics",
    "soft_contact_step",
]
