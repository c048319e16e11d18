"""agimus_controller_tpu_torch — the PyTorch/CUDA port of agimus_controller_tpu.

The same whole-body MPC engine, in PyTorch, for an NVIDIA Hopper GPU. Module
paths mirror the JAX package (`agimus_controller_tpu`), so each module's
reference is found at the same path there; a Pallas module `pallas_X.py`
becomes `cuda_X.py`, whose hand-written kernels live under `csrc/`.

- ``models`` — URDF -> `RobotModel` topology + `ModelParams` tensors.
- ``ocp``    — static problem specs and runtime reference dicts.
- ``ops``    — component-form rigid-body numerics (plain PyTorch) and the
               fused stage/terminal kernels (`ops/cuda_costs.py`).
- ``solver`` — the unconstrained batch multiple-shooting SQP.
- ``mpc``    — reference buffer, device-resident ring, fused MPC tick.

This package never imports JAX.
"""

__version__ = "0.1.0"
