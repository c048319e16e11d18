"""Component-form rigid-body numerics (plain PyTorch) and the fused stage
kernels K1-K4 (`cuda_costs.py`, sources under `csrc/`)."""
