"""Factory registries for OCPs and warm starts.

The reference ships these as unimplemented stubs
(`agimus_controller/factory/ocp.py:1-24`, `factory/warm_start.py:1-17`,
all bodies `pass`); here they are functional registries (port of the JAX
package's `factory/`)."""

from .registry import (
    OCP_REGISTRY,
    WARM_START_REGISTRY,
    create_ocp,
    create_warm_start,
    register_ocp,
    register_warm_start,
)

__all__ = [
    "OCP_REGISTRY",
    "WARM_START_REGISTRY",
    "create_ocp",
    "create_warm_start",
    "register_ocp",
    "register_warm_start",
]
