"""agimus_controller_tpu_torch — the PyTorch/CUDA port of agimus_controller_tpu.

The same whole-body MPC engine, in PyTorch, for an NVIDIA Hopper GPU. Module
paths mirror the JAX package (`agimus_controller_tpu`), so each module's
reference is found at the same path there; a Pallas module `pallas_X.py`
becomes `cuda_X.py`, whose hand-written kernels live under `csrc/`.

- ``models`` — URDF -> `RobotModel` topology + `ModelParams` tensors.
- ``ocp``    — static problem specs, the YAML compiler, runtime reference
               dicts and the constraint rows.
- ``ops``    — component-form rigid-body numerics and batched cost packs
               (plain PyTorch), the fused stage/terminal kernels
               (`ops/cuda_costs.py`) and the dynamics-step kernels
               (`ops/cuda_dynamics.py`).
- ``solver`` — the batch multiple-shooting SQP with its ADMM branch, and
               the batch FDDP.
- ``mpc``    — reference buffer, device-resident ring, fused MPC tick.
- ``trajectories`` — reference generators and the visual-servoing state
               machine.

Every entry point runs on the card (``device="cuda"``) unless the caller
passes ``device="cpu"`` (`device.py`). This package never imports JAX.
"""

__version__ = "0.1.0"
