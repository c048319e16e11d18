"""Model-sensitivity sweep demo on the PyTorch port (the port's copy of
`examples/model_sensitivity.py`; reference:
`agimus_controller_examples/main/model_sensibility/evaluate_model_sensibility.py`).

Perturbs every body's inertia/CoM/mass one at a time (10*nq scenarios) and
computes next-state sensitivities in ONE batched device call, then the SVD
spectrum — replacing the reference's serial python loop.

Usage:  python examples/model_sensitivity_torch.py [--device cuda|cpu]
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from agimus_controller_tpu_torch.models.panda import (
        PANDA_Q_READY,
        load_panda,
    )
    from agimus_controller_tpu_torch.ops import dynamics
    from agimus_controller_tpu_torch.parallel.sensitivity import (
        next_state_sensitivity,
        sensitivity_svd,
    )

    model, params = load_panda(device=args.device)
    f32 = dict(dtype=torch.float32, device=params.mass.device)
    q0 = torch.as_tensor(PANDA_Q_READY, **f32)
    x0 = torch.cat([q0, torch.zeros(7, **f32)])
    u0 = dynamics.generalized_gravity(model, params, q0) + 1.0  # excite

    S, labels = next_state_sensitivity(model, params, x0.cpu().numpy(),
                                       u0.cpu().numpy(), dt=0.01)
    _, s, _ = sensitivity_svd(S)
    print(f"{S.shape[0]} perturbation scenarios in one batched call")
    print("singular value spectrum (top 10):")
    for i, sv in enumerate(s[:10]):
        print(f"  sigma_{i} = {sv:.3e}")
    top = np.argsort(np.linalg.norm(S, axis=1))[::-1][:5]
    print("most influential parameters:")
    for i in top:
        print(f"  {labels[i]:18s} |dx+/dp| = {np.linalg.norm(S[i]):.3e}")


if __name__ == "__main__":
    main()
